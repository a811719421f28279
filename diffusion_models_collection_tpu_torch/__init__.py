"""PyTorch/CUDA port of the diffusion models collection for NVIDIA Hopper.

The JAX package `diffusion_models_collection_tpu` is the reference; this
package mirrors its module names and public layouts (NHWC images, (B,) int
timesteps and labels) and runs in PyTorch, with hand-written CUDA kernels
where the JAX package had Pallas kernels (`ops/`, `csrc/`). It never imports
JAX.

Ported so far: the class-conditional UNet, DiM (diffusion Mamba) and DiT,
sampled with DDPM, DDIM, DPM-Solver++ (2M, SDE) or UniPC and
classifier-free guidance (`sample.py`) and trained with the DDPM objective
(`train.py`), or trained and sampled as flow matching or EDM; measured by
`evaluate.py` and served over HTTP by `serve.py`, batched or through the
continuous-batching engine (`serving_engine.py`).
"""

__version__ = "0.1.0"
