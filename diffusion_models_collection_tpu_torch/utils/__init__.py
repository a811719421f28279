"""The trainer and its optimizer, EMA, learning-rate schedules, tracking
and profiling; checkpoints, the JAX-to-PyTorch weight bridge and small
helpers."""
