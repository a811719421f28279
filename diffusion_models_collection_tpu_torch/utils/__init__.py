"""Checkpoints, the JAX-to-PyTorch weight bridge and small helpers."""
