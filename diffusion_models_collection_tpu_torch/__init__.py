"""PyTorch/CUDA port of the diffusion models collection for NVIDIA Hopper.

The JAX package `diffusion_models_collection_tpu` is the reference; this
package mirrors its module names and public layouts (NHWC images, (B,) int
timesteps and labels) and runs in PyTorch, with hand-written CUDA kernels
where the JAX package had Pallas kernels (`ops/`, `csrc/`). It never imports
JAX.

Ported so far: the class-conditional UNet and DiM (diffusion Mamba),
sampled with DDIM or DDPM and classifier-free guidance (`sample.py`) and
trained with the DDPM objective (`train.py`).
"""

__version__ = "0.1.0"
