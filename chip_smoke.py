"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. It builds the port's kernels from
`diffusion_models_collection_tpu_torch/csrc/`, holds each against its plain
PyTorch version at the shapes of the CIFAR-10 UNet (configs/cifar10_unet.py),
the CIFAR-10 DiM (configs/cifar10_dim.py) and the CIFAR-10 DiT
(configs/cifar10_dit.py), and later of the VAE, the guidance classifier and
the 64x64 SR stage, and drives the main paths of those models through the
port's entry points. The UNet's:

* sampling: the forward kernels at batch 32 and at the sampling run's own
  batch of 160 rows (80 images, cond + uncond), full-width UNet forwards at
  both batches and a short sampling run against the plain versions, then 80
  images with DDIM-50 and classifier-free guidance (scale 3) through
  `diffusion_models_collection_tpu_torch.sample` from a randomly
  initialised checkpoint; then the same under DPM-Solver++ (20 steps), its
  SDE form (20), UniPC (10) and DDIM on a Karras grid (50), each with a
  10-step trajectory against the plain versions first (the SDE form with
  one explicit noise list for both runs) and exactly one forward's launches
  per model call;
* serving, from the same checkpoint through
  `diffusion_models_collection_tpu_torch.serve` (DDIM-50, CFG 3, 16 images
  a batch or 16 slots): the batched mode behind a ThreadingHTTPServer on
  127.0.0.1 (/healthz, an npy request against `sample_with_cfg` on the same
  seeded draw, a png request decoded by the port's `read_png`); the
  continuous engine in fp32 and in bf16 (16 images in one submit against
  `sample_with_cfg` at batch 16, two single-image requests admitted five
  steps apart each against its row of a pool-shaped `sample_with_cfg`, then
  the JAX bench leg's traffic cut to an eighth of its length: 8 single-image
  requests from 8 client threads, p50/p99 latency and images/s, beside 16
  images in one batch),
  one forward's launches a step; and what the engine's admission of one row
  and read-back of one slot cost against a pool's worth;
* editing and training-free knobs: a 10-step, 8-image trajectory of each
  against the plain versions, with the plain run's own sensitivity to a
  1e-6 change of its input beside it (DDIM img2img and inpainting at
  strength 0.5, DDPM RePaint, DDIM with two restarts, DDIM inversion; PAG
  on the UNet and the DiT, DeepCache at depth 1 and 2 and FreeU held
  without the x0 constraint and printed with it), then 16 images CFG 3 on a
  20-step grid through `sample` for each (`--init_image` and `--mask` PNGs
  written by the port, strength 0.5; RePaint `--repaint_jump 10
  --repaint_resample 2` at strength 0.035; `--restarts 2`; `--pag_scale 2`, also on the DiT;
  `--deepcache 3` at depth 1 and 2, also on the bf16 UNet; `--freeu
  1.1,1.2,0.9,0.2`) with exact launches (a PAG call 90 GroupNorm+SiLU and 11
  attention launches, a DeepCache shallow call 11 and 0 at depth 1, 21 and
  5 at depth 2), the kept pixels of the masked runs equal to the init
  image, samples/s; and DDIM-20 inversion of 16 images and back, its
  round-trip error printed;
* training: the GroupNorm+SiLU backward kernel at every shape of the UNet
  at batch 160 and 128, at a ragged shape and at a group too large for
  shared memory, against its plain version and against autograd through the
  plain forward; the attention backward kernel at every shape of a batch-128
  train step and in each of its forms (fused with tiles of 32 and of 64
  rows, one key tile and several; two kernels beyond the fused form's
  length limit and, forced, at the train step's main shape), the
  full-width UNet's loss and gradients against the plain
  versions, then three epochs of `diffusion_models_collection_tpu_torch.
  train` on the committed CIFAR-10 fixtures (200 images, one batch of 128
  an epoch), train images/s through the trainer's own step with the
  kernels and with the plain versions, and `sample` from the checkpoint it
  wrote with DDIM-10 and with DDPM over a 50-step schedule (`--config`);
* flow matching and EDM: the same config with `diffusion_type` set to
  'flow_matching' and then 'edm': the loss and gradients against the plain
  versions, three epochs of `train` on the fixtures with one train step's
  launches a step, train images/s, and `sample` from the checkpoint it
  wrote (flow Euler 50 steps and Heun 25, EDM Heun 18; CFG 3), with one
  forward's launches per model call (Heun: 2 S - 1 calls).

The DiM's, at full width (hidden 384, depth 12, patch 2, state 16: the scan
runs at L = 256, D = 768, N = 16 in each of the 12 blocks):

* the selective-scan kernels against their plain versions: the forward at
  batch 32 and 160 (the sampling batch), states off and on, and at L = 48
  and 100 (a ragged last block), also at N = 8 and 32 and D = 200; the
  backward at batch 32 and 128 (the training batch); the backward with no saved states at the same batches,
  at L = 100 and at L = 1024; the time-split forward and backward at
  L = 1024 (batch 16 and 2) and L = 1000, also against the whole-sequence
  kernels; the per-call times of the whole-sequence and the time-split
  kernels on the card at L = 1024 for batch 1 to 128 (the data behind the
  scan's routing rules), and of the time-split kernels at each chunk size;
  and the reverse sweep that the
  three backward kernels share in each of its forms (four and eight states
  a lane, time blocks of 32 and 16 steps, a channel count that is no
  multiple of its tile);
* sampling: full-width forwards at batch 32 and 160 and a DDIM-10 CFG
  trajectory against the plain versions, then 80 images with DDIM-50 and
  CFG 3 through `sample` from a checkpoint of those random weights (the
  adaLN-Zero parameters drawn small but not zero, so the scans reach the
  output);
* training: the full-width loss and gradients against the plain versions,
  every parameter's gradient non-zero, then three epochs of `train` on the
  fixtures at batch 128, train images/s with the kernels and with the
  plain versions, and `sample` DDIM-10 from the checkpoint it wrote;
* training with `remat: True` (gradient checkpointing: each block's scan
  saves no states, runs forward twice and rebuilds the states in its
  backward): loss and gradients at batch 128 against the plain versions
  and against the same weights without remat, then the same `train` and
  `sample` run, with the peak device memory beside the run without remat;
* the same DiM on 64x64 images (L = 1024, the `synthetic` dataset, batch
  16), whose scans under a gradient take what the routing rules pick there
  (the time-split forward, then the whole-sequence backward from its
  states): loss and gradients against the plain versions, one epoch (32
  steps) of `train`, train images/s, and `sample` DDIM-10 from its
  checkpoint; then one epoch (64 steps) of `train` at batch 8, where the
  rules take the time-split backward too.

The DiT's, at full width (hidden 384, depth 12, 6 heads of 64, patch 2: the
attention runs at L = 256, d = 64 in each of the 12 blocks; dropout 0.1 on
the attention probabilities and in the MLP in training):

* the attention kernels' dropout forms against their plain versions with
  the same seed: at the training shape (BH 768, L 256, d 64, p 0.1) timed
  beside the same call at p = 0 and `F.scaled_dot_product_attention` with
  dropout, then at L 16, 64, 100, 300 (a ragged tile) and 1025 (the
  two-kernel backward beyond 1024), at d 48 (the DiM's attention fallback) and with
  the two-kernel backward forced; and a read-back of the mask: with v = I
  the output is P o Z exactly, so its zeros must be the dropped keys of
  `philox_keep_mask`, bit for bit;
* sampling: full-width forwards at batch 32 and 160 and a DDIM-10 CFG
  trajectory against the plain versions, then 80 images with DDIM-50 and
  CFG 3 through `sample` (600 forward launches, none in the dropout form),
  samples/s with the kernels and with the plain versions;
* training, in train mode with dropout on: the loss and gradients at batch
  128 against the plain versions (the CPU and CUDA generators reseeded
  before each run, so both draw the same attention and MLP masks), 12
  forward and 12 backward launches in the dropout form, then the same under
  `remat` (24 forward launches, the recompute drawing the same masks) and
  against the run without; three epochs of `train` on the fixtures with and
  without `remat`, train images/s with the kernels and with the plain
  versions, and `sample` DDIM-10 from the checkpoint;
* the DiM with `use_attention_fallback` (8 heads of 48 in place of the
  Mamba mixer): forwards and gradients against the plain versions, 12
  attention launches a forward and no scan launch.

Then mixed precision (`mixed_precision: 'bf16'`: bf16 convs, linears and
activations on float32 parameters, float32 eps):

* the bf16 forms of GroupNorm+SiLU (forward and backward) and of the
  attention kernels (forward and backward, at p = 0 and with dropout, the
  backward fused and in two kernels) against their plain versions at every
  shape of the UNet's sampling forward and train step and of the DiT's, timed
  beside `F.scaled_dot_product_attention` on the same bf16 inputs, and at
  shapes that are no tile multiples and groups that are no whole vectors;
* for each of the UNet, the DiM (whose scans stay float32) and the DiT:
  full-width forwards and the loss and gradients against the plain
  versions, 80 images DDIM-50 CFG 3 through `sample --mixed_precision bf16`
  and three epochs of `train` from the config with `mixed_precision:
  'bf16'`, samples/s, train images/s and peak memory beside the float32
  figures of the same run; the DiT also under DPM-Solver++ (20 steps).

Then the metrics and `evaluate` (no kernel of their own: the metric networks
are cuDNN convolutions and matrix products, always float32):

* InceptionV3 pool features and logits (8 images at 32x32, 2 at 299x299) and
  LPIPS distances (8 pairs at 32x32) on the card against the same networks
  on the CPU; InceptionV3 images/s at batch 50; tr sqrtm of a 512x512
  covariance product by Newton-Schulz on the card beside scipy's on the host;
* `diffusion_models_collection_tpu_torch.evaluate` on a full-width UNet
  checkpoint (DDIM-20, CFG 3, 50 samples in one batch, SWD; FID as the port
  computes it, with scipy's sqrtm on the host, and beside it FID with tr
  sqrtm from two eigendecompositions on the card, which every later
  `evaluate` run of the script uses) and on the
  DiT in bf16 (DDIM-20, 50 samples), against the fixtures' 50-image test
  split: exact launches (900 GroupNorm+SiLU and 220 attention; 240 bf16
  attention), every metric finite, the metric networks float32, and the
  seconds of each stage.

Then latent diffusion, both stages of configs/cifar10_vae.py and
configs/cifar10_latent_unet.py at full width (`phase_latent`): a VAE forward
(2,385,227 parameters) against the plain versions; K1 and K1b at every
GroupNorm+SiLU shape of the VAE at batch 128 (C 64 at 32x32, eight channels a
group; the decoder's 128 -> 64 transition) and K2 and K3 at its attention (4
heads of d 32 at L 256), float32 and bf16; three one-batch epochs of `train`
for the VAE (22 K1 + 2 K2 + 22 K1b + 2 K3 a step, its reconstruction grid at
the last), `tools/compute_latent_scale` on its checkpoint, three epochs of
`train` for the latent UNet from a copy of its config naming that checkpoint
and scale (the frozen encoder's 11 K1 + 1 K2, then 35 K1 + 11 K2 + 35 K1b +
11 K3 a step), train images/s and peak memory of both; `sample` DDIM-50 CFG
1.8 of 80 images (1750 K1 + 550 K2 and one decode) against the same call on
the plain versions, img2img at strength 0.5 through the posterior mode,
`--mask` refused; `evaluate` (DDIM-20, 50 samples, SWD); `serve` batched and
`--continuous` over HTTP, each 16-image request against `sample_with_cfg` and
`decode` of the same draw, then 8 single-image requests from 8 clients
decoded on their handlers' threads.

Then classifier guidance and SR3 super-resolution (no kernel of their own):

* `phase_classifier`: configs/cifar10_classifier.py at full width (the UNet's
  encoder half, 1,832,778 parameters): the cross-entropy and every gradient at
  its batch of 256 against the plain versions (13 K1 + 2 K2 + 13 K1b + 2 K3 a
  step), three one-batch epochs of `train` on the fixtures, train images/s at
  256 with the kernels and the plain versions, peak memory;
* `phase_guided`: from the trained UNet's checkpoint and the classifier's, a
  guided DDIM-10 CFG trajectory against the plain versions (held without the
  x0 clamp, printed with it), then `sample --classifier_checkpoint
  --classifier_scale 2` of 80 images DDIM-50 CFG 3 beside the unguided run (a
  guided call: 45 + 13 K1, 11 + 2 K2 and the classifier's 13 K1b + 2 K3, the
  backward kernels inside the sampler's no_grad), and 16 images at scale 0
  equal to the unguided run bit for bit;
* `phase_sr`: configs/celeba64_sr_unet.py at full width on the `synthetic`
  dataset at 64x64 (74,054,787 parameters, 6 channels in): the largest batch
  of 256, 128, 64 whose step fits; K1 and K1b at every GroupNorm+SiLU shape
  of that step (the generic form where a group outgrows shared memory,
  timed with its bound) and K2, K3 at d 64 (L 256) and d 128 (L 64), timed
  beside `F.scaled_dot_product_attention`; the loss and gradients against the
  plain versions; one epoch of `train` (45 K1 + 11 K2 + 45 K1b + 11 K3 a
  step), train images/s and peak memory; `sample --sr_source` on a PNG
  written there; the two-stage cascade of `tools/cascade.py` from the trained
  32x32 UNet to 64x64.

Then the DiT's last three families:

* `phase_moe`: configs/cifar10_dit_moe.py at full width (hidden 384, depth
  12, 6 heads, 8 experts, top 2, capacity 1.25: 131,862,636 parameters): a
  forward at batch 160 and a train step at 128 (dropout 0.1; the loss with
  0.01 times the load-balance loss) against the plain versions, on the
  kernel run's routing (a near-tie token may route apart at float
  rounding: how many do when left free is printed), in float32 and bf16; 12
  K2 a forward, 12 K2 and 12 K3 in the dropout form a step; 80 images
  DDIM-50 CFG 3 through `sample` and one epoch of `train` at batch 128,
  each in float32 and bf16, samples/s, train images/s and peak memory; a
  16-image `serve --continuous` request against `sample_with_cfg`;
* `phase_tome`: the key-bias forms of K2 and K3 (float32 and bf16) against
  their plain versions at BH 960 and ToMe's merged lengths L' 128 and 179
  (d 64), timed beside `F.scaled_dot_product_attention` with the bias as an
  additive mask, and with dropout at BH 768; the DiT (configs/cifar10_dit.py)
  with ratio 0.5, with and without `tome_mlp`: forwards at batch 160 against
  the plain versions on the kernel run's merge plans; 80 images DDIM-50 CFG
  3 through `sample --tome_ratio 0.5 [--tome_mlp]` in float32 and bf16 (12 K2
  in the key-bias form a forward), samples/s beside the unmerged DiT's; three
  epochs of `train` with merging (12 K2 and 12 K3 in the key-bias and dropout
  forms a step), in each precision;
* `phase_int8`: the same DiT weights with `quant='int8'`: a forward at batch
  160 with its 48 int8 products and its distance from the float forward,
  then `sample --quantize int8` in float32 and bf16, samples/s beside the
  float DiT's;
* `phase_fewstep`: the UNet config as a consistency model: the loss and
  gradients of consistency training against the plain versions (90 K1,
  22 K2, 45 K1b, 11 K3 a step), three epochs of `train` on two grid stages
  and train images/s, in fp32 and bf16; of its checkpoint, `sample` with
  2 steps and CFG 3 against the same inside `plain_kernels()`, `evaluate`
  of 50 samples, a 16-image `serve` request against `sample_with_cfg` on
  its draw, and `--continuous`'s refusal; `tools/distill.py` from the
  trained UNet, consistency (CFG 3 inside) and progressive (8 -> 4
  steps), 135 K1, 33 K2, 45 K1b, 11 K3 a step, and a sample of each
  result; `tools/reflow.py` from the flow-matching UNet `phase_process`
  trained (128 pairs, 10 Euler steps with CFG 3, then 4 steps) and a
  1-step sample of its round; 12 DDPM steps with AdamW, Adafactor and
  Lion (images/s, peak memory, the optimizer state's bytes).

Then the kernels as `torch.library` operators and the sampler export, and
the DiT at 64x64:

* `phase_export`: `torch.library.opcheck` on every `dmc::` operator with
  CUDA tensors; then `serving.export_sampler` of the fp32 UNet, the bf16 DiT
  and the latent UNet with its decode (random weights; DDIM-50 CFG 3, 16
  images), each blob loaded back and run from one x_T beside the live
  `sample_with_cfg`: bit for bit, exact launches (the scan's own extra
  model call on a torch that makes one), export, save and load seconds,
  the blob's size, samples/s beside the live sampler's;
* `phase_dit64`: configs/cifar10_dit.py at 64x64 on `synthetic` (L 1024):
  in fp32 and bf16 the largest of batch 128, 64, 32, 16 whose step fits,
  the loss and gradients at batch 4 in train mode against the plain
  versions (12 K2 + 12 K3 in the dropout form), one epoch of `train`,
  train images/s and peak memory, 16 images DDIM-20 CFG 3 through `sample`
  (12 K2 a forward); K3's fused and two-kernel forms at the fp32 training
  shape (BH = batch x 6, L 1024, d 64) in fp32 and bf16 at p 0 and 0.1,
  with K2, `F.scaled_dot_product_attention` and the bounds beside them.

Then the parallel layouts (`phase_parallel`, `parallel/` of the port):

* `phase_ddp`: the fp32 UNet through `DiffusionTrainer` under DDP at world
  1 (NCCL, this process): three steps at batch 128 from the same weights on
  the same draws as the trainer without a process group (losses and
  parameters within 1e-6, one step's launches a step), train images/s of
  both and the DDP step's overhead;
* `phase_e7`: K2 and K3's dropout forms at a tensor-parallel rank's head
  grid (heads 3..5 of the DiT's 6 at batch 128) in float32 and bf16, with
  and without the key bias, fused and two-kernel backward, against the
  plain versions at the same grid; the kernel's mask read back (v = I)
  against the rank's slice of the single-device mask;
* a gloo world of two processes on the card (`tools/dryrun_multichip.py`
  `launch`; NCCL refuses two ranks on one device): the DiT (dropout 0.1) at
  TP 2, DP 2, FSDP 2, SP 2 and PP 2 and the DiM at TP 2, DP 2, SP 2 and
  PP 2 (and the legs `chip_smoke_pipeline.py` adds: the MoE DiT at EP 2
  and DP 2), one `train_step` each at
  global batch 32, each rank's loss and gathered gradients against the
  one-process step on the same batch (1e-5, 1e-4), a rank's launches (12
  K2 + 12 K3 in the dropout form, at SP 2 in E6's form, at PP 2 two
  microbatches of a stage's 6 blocks; 12 K6 + 12 K8 on the DiM's 384
  channels a rank at TP 2, on all 768 at DP 2 and on 16 rows at PP 2, 24 +
  24 stated scans at SP 2), and the peak memory a rank under FSDP beside
  DDP's.

Then sequence parallelism (`phase_sequence_parallel`, in
`chip_smoke_sequence.py` beside this script): E6 (K2 and K3 of a seq rank's
queries against every key, dropout rows keyed on the global row) and E4
(the scan from and to a state) against their plain versions, and the SP 2
legs of `phase_parallel`'s world (their step seconds and peak memory a rank
beside DP 2's); then pipeline and expert parallelism
(`phase_pipeline_expert`, in `chip_smoke_pipeline.py`): K2's mask of a
microbatch read back at its `batch0`, and the PP and EP legs beside DP 2's
with the draw replay's cost; before them the widths past the kernels'
one-tile forms (`phase_shapes`, in `chip_smoke_shapes.py`): K2/K3's wide
forms at head_dim 136 to 384 and every scan entry at 33 to 128 states
against their plain versions, the int8 product at widths `torch._int_mm`
refuses, and the DiM at `state_size` 64 and the DiT at `num_heads` 2 through
`sample.main`, their loss and gradients and `train.main`, fp32 and bf16,
with exact launches; then data parallelism outside `train`
(`phase_data_parallel`, in `chip_smoke_data.py`): `sample.main` (the
trained fp32 UNet, DDIM-20 CFG 3, 16 images at batch 16), `evaluate.main`
(32 images), the in-training grid of a DDP UNet, `tools.distill` and
`tools.reflow` in a gloo world of two processes on the card against one
process's run of the same call: images, metrics, losses and weights within
their bars, a rank's launches equal to one process's, rank 0 alone
writing, and samples/s and the all-gather's share of sampling beside one
process's; then the batched `serve` daemon split over a gloo world of two
processes (`phase_serve_data_parallel`, in `chip_smoke_serve.py`): the
trained UNet at `--batch_size 16`, DDIM-20, rank 0 answering HTTP, each
answer bit for bit the one-process run on the ranks' row blocks, a rank's
launches a request 900 K1 and 220 K2, an idle gap longer than the control
timeout, SIGTERM stopping both ranks with exit code 0, and images/s and the
p50 of a request beside one process's.

Every phase prints its seconds. Each path is run with every launch count
set to 0 just before it and read
just after, and checks that every GroupNorm+SiLU, attention and scan call
(forward and backward) of its run went through a kernel, and that the other
model's kernels did not run. Every failure raises; there is no fallback. The
last line of standard output is one JSON object with "ok": true; the line
before it lists each kernel with its launches, error, times, the least time
the card could take for the same calls (`bound_ms`, from the shapes, at the
peak rate of the inputs' type: the bf16 tensor cores' for the bf16 attention
forms) and, where one PyTorch call computes the same function, that call's
time (`library_ms`; the port never calls it; attention's on (1, BH, L, d),
since on 3-D tensors PyTorch takes its unfused math path).

TF32 off throughout. Kernel times are medians of CUDA-event
timings after warm-up; samples/s is the generation loop of one
`sample.main` call; train images/s is the median of CUDA-synchronised
steps; all on the card named in the output.
"""

import contextlib
import copy
import gc
import http.client
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from scipy import linalg

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from diffusion_models_collection_tpu_torch import (  # noqa: E402
    evaluate,
    factory,
    metrics,
    sample,
    serve,
    serving,
    train,
)
from diffusion_models_collection_tpu_torch.diffusion import DDIM  # noqa: E402
from diffusion_models_collection_tpu_torch.diffusion import (  # noqa: E402
    ConsistencyModel,
)
from diffusion_models_collection_tpu_torch.diffusion import base as dbase  # noqa: E402
from diffusion_models_collection_tpu_torch.diffusion import (  # noqa: E402
    consistency as cm_lib,
)
from diffusion_models_collection_tpu_torch.diffusion import DDPM  # noqa: E402
from diffusion_models_collection_tpu_torch.diffusion import (  # noqa: E402
    karras_timesteps,
)
from diffusion_models_collection_tpu_torch.diffusion.deepcache import (  # noqa: E402
    deepcache_sample,
)
from diffusion_models_collection_tpu_torch.diffusion.guidance import (  # noqa: E402
    classifier_guided_model_fn,
)
from diffusion_models_collection_tpu_torch.diffusion.pag import (  # noqa: E402
    pag_model_fn,
)
from diffusion_models_collection_tpu_torch.metrics import (  # noqa: E402
    lpips_score,
)
from diffusion_models_collection_tpu_torch.models import unet as unet_mod  # noqa: E402
from diffusion_models_collection_tpu_torch.models.moe import MoeMlp  # noqa: E402
from diffusion_models_collection_tpu_torch.ops import (  # noqa: E402
    _build,
    _library,
    flash_attention,
    fused_norm,
    quant,
)
from diffusion_models_collection_tpu_torch.ops import tome as tome_ops  # noqa: E402
from diffusion_models_collection_tpu_torch.ops import (  # noqa: E402
    selective_scan as scan,
)
from diffusion_models_collection_tpu_torch.ops.plain import plain_kernels  # noqa: E402
from diffusion_models_collection_tpu_torch.parallel.fsdp import (  # noqa: E402
    sharded_fraction,
)
from diffusion_models_collection_tpu_torch.parallel.mesh import (  # noqa: E402
    init_process_group,
)
from diffusion_models_collection_tpu_torch.tools import (  # noqa: E402
    cascade,
    compute_latent_scale,
)
from diffusion_models_collection_tpu_torch.tools import (  # noqa: E402
    distill as distill_tool,
)
from diffusion_models_collection_tpu_torch.tools import (  # noqa: E402
    reflow as reflow_tool,
)
from diffusion_models_collection_tpu_torch.tools.dryrun_multichip import (  # noqa: E402
    launch,
)
from diffusion_models_collection_tpu_torch.utils import checkpoint  # noqa: E402
from diffusion_models_collection_tpu_torch.utils import sr  # noqa: E402
from diffusion_models_collection_tpu_torch.utils.reflow_trainer import (  # noqa: E402
    ReflowTrainer,
)
from diffusion_models_collection_tpu_torch.utils.tracker import (  # noqa: E402
    NullTracker,
)
from diffusion_models_collection_tpu_torch.utils.trainer import (  # noqa: E402
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.latent import (  # noqa: E402
    LatentCodec,
)
from diffusion_models_collection_tpu_torch.utils.helpers import (  # noqa: E402
    load_config,
    read_png,
    resolve_image_size,
    write_png,
)

CONFIG = ROOT / "configs" / "cifar10_unet.py"
GN_SHAPES = [(32, 32, 128), (32, 32, 256), (32, 32, 384), (16, 16, 128),
             (16, 16, 256), (16, 16, 384), (16, 16, 512), (8, 8, 256),
             (8, 8, 512), (4, 4, 256), (4, 4, 512)]
GN_RAGGED = (3, 5, 7, 24)  # B, H, W, C: C % 8 == 0, H*W odd
# a group of 64 x 64 x 16 floats, 256 KB: more than a block's shared memory
GN_LARGE = (4, 64, 64, 128)
ATTN_LENGTHS = (256, 64, 16, 100)
ATTN_BH, HEAD_DIM = 128, 64
# (L, d) of the forward kernel's forms and shapes the UNet does not give
# it: tiles of 32 rows at d 32, whole and in two tiles, tiles of 128 at d 32,
# tiles of 64 at d 128, many key tiles, one row
ATTN_FWD_FORMS = [(16, 32), (32, 64), (33, 64), (256, 32), (256, 128),
                  (1024, 64), (1, 8)]
CHECK_BATCH = 32
SAMPLES, STEPS, CFG_SCALE = 80, 50, 3.0
GN_PER_FORWARD, ATTN_PER_FORWARD = 45, 11
# Kernel launches of one UNet forward and of one train step
UNET_FORWARD = {"gn": GN_PER_FORWARD, "attn": ATTN_PER_FORWARD}
UNET_STEP = dict(UNET_FORWARD, gn_bwd=GN_PER_FORWARD,
                 attn_bwd=ATTN_PER_FORWARD)
# Max-rel is max|kernel - plain| / max|plain|. The kernel and the plain
# version sum in other orders; float32 rounding puts both near 1e-7
# relative, so 2e-5 leaves room and still catches a wrong index.
TOL_OUT = 2e-5
TOL_LSE = 1e-5  # absolute, on values of about log(L) + max score
# A full forward chains 45 norms and 11 attentions through 60 convs.
TOL_UNET = 1e-4
TOL_TRAJ = 5e-4  # 10 DDIM steps with CFG and dynamic thresholding
# The attention backward sums dS = P (dO V^T - delta) over L keys, a
# difference of two products of similar size, so it loses more digits.
TOL_BWD = 1e-4
ATTN_BWD_HEAD_DIMS = (32, 128)  # at L 256, beside the UNet's d = 64
# L 257 and 1024 fused with more key tiles (4 dq shares at most before PR
# 19's `flash_attention.FUSED_MAX_LEN` of 1024); beyond it, the two-kernel form
ATTN_BWD_LONG = (1024, 257, 1025)
TRAIN_BATCH, TRAIN_EPOCHS = 128, 3
# the trained UNet's DDPM run: the schedule's timesteps (1000 in the config)
DDPM_CUT = 50
# a timed train run: the median of 2 synchronised steps after 1 (the
# trainer has run its epochs by then), kept short so that the script stays
# inside its time as phases are added (5 until the batched `serve` split's
# phase came, 3 until the shapes phase came)
TRAIN_WARMUP, TRAIN_TIMED = 1, 2
# Loss of one full-width forward, and the flattened gradient as max-abs
# difference over max-abs: a backward chains 60 conv backwards and the GN
# recomputes through 45 norms.
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
FIXTURE_DATA = ROOT / "tests" / "fixtures" / "data"

DIT_CONFIG = ROOT / "configs" / "cifar10_dit.py"
ATTN_PER_DIT_FORWARD = 12  # one attention in each DiT block
DIT_FORWARD = {"attn": ATTN_PER_DIT_FORWARD}
# a train step in train mode: every attention in the dropout form
DIT_STEP = {"attn": ATTN_PER_DIT_FORWARD, "attn_dropout": ATTN_PER_DIT_FORWARD,
            "attn_bwd": ATTN_PER_DIT_FORWARD,
            "attn_bwd_dropout": ATTN_PER_DIT_FORWARD}
# under `remat: True` each block's forward runs twice, with the same masks
DIT_REMAT_STEP = dict(DIT_STEP, attn=2 * ATTN_PER_DIT_FORWARD,
                      attn_dropout=2 * ATTN_PER_DIT_FORWARD)
DIT_HEADS, DIT_LENGTH, DIT_HEAD_DIM = 6, 256, 64
ATTN_DROPOUT = 0.1  # the DiT's and the DiM's `dropout`
ATTN_DROPOUT_SEED = 0x0123_4567_89AB_CDEF
# (L, d) of the dropout forms the DiT's step does not take: ragged tiles,
# the short-sequence forms, the two-kernel backward beyond L 1024, and d 48
# (the DiM's attention fallback: hidden 384 in 8 heads)
ATTN_DROPOUT_FORMS = [(16, 64), (64, 64), (100, 64), (300, 64), (1025, 64),
                      (256, 48), (100, 48)]
TRAIN_SEED = 1234  # reseeds the generators before each run of a train step

DIM_CONFIG = ROOT / "configs" / "cifar10_dim.py"
SCAN_PER_FORWARD = 12  # one scan in each DiM block
DIM_FORWARD = {"scan_fwd": SCAN_PER_FORWARD}
DIM_STEP = dict(DIM_FORWARD, scan_fwd_states=SCAN_PER_FORWARD,
                scan_bwd=SCAN_PER_FORWARD)
# Under `remat: True` a block's forward runs twice (the recompute in the
# backward) and keeps no scan states; the backward rebuilds them (K7)
DIM_REMAT_STEP = {"scan_fwd": 2 * SCAN_PER_FORWARD,
                  "scan_bwd_nostate": SCAN_PER_FORWARD}
# The 64x64 DiM: L = 1024 in 32 time blocks, batch 16. Under a gradient
# its scans take what `scan.split_forward` and `scan.split_backward` pick at
# (16, 1024, 768): the time-split forward (K9) and K8's whole reverse sweep
# from K9's states; its forwards without one are K5
DIM64_SIZE, DIM64_BATCH = 64, 16
DIM64_LENGTH = (DIM64_SIZE // 2) ** 2  # patch 2
DIM64_STEP = {"scan_fwd_split": SCAN_PER_FORWARD,
              "scan_bwd": SCAN_PER_FORWARD}
# The same model trained at batch 8, where the rules take the time-split
# backward (K10) too: one epoch, launches only
DIM64_SMALL_BATCH = 8
DIM64_SMALL_STEP = {"scan_fwd_split": SCAN_PER_FORWARD,
                    "scan_bwd_split": SCAN_PER_FORWARD}
SYNTHETIC_IMAGES = 512  # the `synthetic` dataset's size
SCAN_D, SCAN_N = 768, 16  # d_inner = 2 * hidden, state size
# (batch, L): the check, sampling and training batches at the model's L, the
# two other time blocks (L = 48: T = 16; L = 100: a ragged last block), and
# the 64x64 DiM's sampling forward (8 images under CFG at L = 1024)
SCAN_FWD_CASES = [(CHECK_BATCH, 256), (2 * SAMPLES, 256), (128, 256),
                  (CHECK_BATCH, 48), (CHECK_BATCH, 100), (DIM64_BATCH, 1024)]
# (batch, L, D, N) for the forms of the forward walk that the main paths do
# not take: eight states a lane (N > 16), N below a lane's four, time blocks
# of 16 steps with a ragged last one, D no multiple of 64 or of 4; each runs
# with states off and on
SCAN_FWD_FORMS = [(8, 256, 768, 32), (4, 1024, 768, 32), (8, 100, 200, 8),
                  (4, 1000, 200, 16), (4, 48, 768, 16), (3, 1024, 201, 5)]
SCAN_BWD_CASES = [(CHECK_BATCH, 256), (TRAIN_BATCH, 256)]
# K7: the same, a ragged L, and L = 1024, where the rebuilt block states do
# not fit shared memory and go to a scratch buffer in device memory
SCAN_NOSTATE_CASES = SCAN_BWD_CASES + [(CHECK_BATCH, 100), (16, 1024)]
# K9, K10: the 64x64 DiM's training batches (16; 8, where K10 runs) and a
# small one at its L, and a ragged L (63 time blocks of 16 steps, the last
# of 8)
SCAN_SPLIT_CASES = [(DIM64_BATCH, 1024), (DIM64_SMALL_BATCH, 1024), (2, 1024),
                    (16, 1000)]
# (batch, L, D, N) for the forms of the reverse sweep that the main paths do
# not take: eight states a lane (N > 16) with K7's states filling its
# shared-memory budget, then in device scratch; and four states a lane with
# N 8, time blocks of 16 steps, a ragged last one, D no multiple of 64
SCAN_SWEEP_FORMS = [(8, 256, 768, 32), (4, 1024, 768, 32), (8, 100, 200, 8)]
SCAN_SWEEP_LENGTH, SCAN_SWEEP_BATCHES = 1024, (1, 2, 4, 8, 16, 32, 64, 128)
# K9, K10 at each of these chunk sizes (time blocks in a chunk) for these
# batches: the data behind `scan.fwd_chunk_blocks` and `scan.bwd_chunk_blocks`
SCAN_CHUNK_SWEEP = (1, 2, 4, 6, 8, 11, 16)
SCAN_CHUNK_BATCHES = (1, 2, 16, 32)
# The scan forward keeps the recurrence in float32 like its plain version,
# in another order of rounding: 2e-5 as the other forwards. Its backward
# runs an adjoint over L steps and sums dB, dC over D: 1e-4 as K3.
TOL_SCAN_FWD, TOL_SCAN_BWD = 2e-5, 1e-4


# read_launches() key -> the scan wrappers' launch counter: K5/K6, K6, K8,
# K7, K9, K10
SCAN_COUNTERS = {"scan_fwd": "FWD_LAUNCHES",
                 "scan_fwd_states": "FWD_STATES_LAUNCHES",
                 "scan_bwd": "BWD_LAUNCHES",
                 "scan_bwd_nostate": "BWD_NOSTATE_LAUNCHES",
                 "scan_fwd_split": "FWD_SPLIT_LAUNCHES",
                 "scan_bwd_split": "BWD_SPLIT_LAUNCHES",
                 "scan_fwd_state": "FWD_STATE_LAUNCHES",
                 "scan_bwd_state": "BWD_STATE_LAUNCHES"}
# Published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores. A kernel's bound is the larger of its bytes over the one and
# its operations over the other.
PEAK_BYTES_PER_S, PEAK_FP32_OPS_PER_S = 3.35e12, 67e12
# The dense rate of the tensor cores on bf16 products with float32
# accumulation: the rate of the bound of the bf16 attention forms, whose
# inputs are bf16 and whose products run there (`cuda_core_bound_ms` beside
# it is the same work at the float32 CUDA-core rate, the bound of a form
# that computed it on the CUDA cores)
PEAK_BF16_TC_OPS_PER_S = 989e12
# The special-function units evaluate 16 exponentials a clock and SM where
# the FMA pipes do 128 multiply-adds (256 operations): a sixteenth of the
# float32 peak. Not part of `bound_ms`, which counts an exponential as one
# operation; printed beside it for the scans.
PEAK_EXP_PER_S = PEAK_FP32_OPS_PER_S / 16


def max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@contextlib.contextmanager
def clock(name):
    """Print the seconds a phase of the script took."""
    start = time.perf_counter()
    yield
    print(f"{name}: {time.perf_counter() - start:.1f} s", flush=True)


def median_ms(fn, reps=30, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(fn, calls=10, reps=5):
    """Per call, the card's own time: `calls` launches captured in a CUDA
    graph and replayed between one pair of events (the median of `reps`
    replays), so no launch waits on the host, as in a step whose host runs
    ahead of the card. `fn` has run before (its one-time set-up is done)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class Bound:
    """The least time an H100 could take for some calls: for each call the
    larger of bytes / 3.35 TB/s (every input read once, every output
    written once) and operations / `ops_per_s` (by default 67 TFLOP/s,
    float32 outside the tensor cores; an exponential counted as one
    operation), summed over the calls."""

    def __init__(self, ops_per_s=PEAK_FP32_OPS_PER_S):
        self.ops_per_s = ops_per_s
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, n_bytes, n_ops, calls=1):
        bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
        ops_ms = 1e3 * n_ops / self.ops_per_s
        self.ms += calls * max(bytes_ms, ops_ms)
        self.bytes_ms += calls * bytes_ms
        self.ops_ms += calls * ops_ms
        return self

    def keys(self):
        return {"bound_ms": self.ms,
                "bound_by": ("bytes" if self.bytes_ms >= self.ops_ms
                             else "operations")}


def gn_work(b, h, w, c, elem=4):
    """GroupNorm+SiLU: x in, y out (`elem` bytes each: 4, or 2 in bf16),
    float32 scale and bias; per element the mean and variance sums (3),
    normalise and affine (4), SiLU (4)."""
    n = b * h * w * c
    return elem * 2 * n + 4 * 2 * c, 11 * n


def gn_bwd_work(b, h, w, c, elem=4):
    """GroupNorm+SiLU backward: x and g in, dx out (`elem` bytes each),
    float32 scale, bias and the per-image dscale, dbias rows; per element
    the pre-activation (4), the SiLU's derivative (8), the four sums (7) and
    dx (5)."""
    n = b * h * w * c
    return elem * 3 * n + 4 * (2 * c + 2 * b * c), 24 * n


def attn_work(bh, seq, d, backward=False, elem=4, keys=None):
    """Attention forward: q, k, v in, o out (`elem` bytes each: 4, or 2 in
    bf16) and float32 lse out; QK^T and PV (2 L^2 d multiply-adds) and the
    softmax (5 an entry). Backward: q, k, v, o, dO and lse in, dq, dk, dv
    out; five such products and the softmax's. `keys`: Lk when it is not
    `seq` (E6: q, o, dO, dq of `seq` rows, k, v, dk, dv of Lk, the products
    `seq` Lk d)."""
    keys = seq if keys is None else keys
    q_side, k_side = bh * seq * d, bh * keys * d
    if backward:
        return (elem * 4 * (q_side + k_side) + 4 * bh * seq,
                bh * seq * keys * (10 * d + 8))
    return (elem * 2 * (q_side + k_side) + 4 * bh * seq,
            bh * seq * keys * (4 * d + 5))


def scan_work(kind, batch, length, d_inner=768, n_state=16, state=False):
    """The scan's bytes and operations. Forward ("fwd", with "fwd_states"
    also `bound` out): x, dt in, y out, B, C, A in; per state and step the
    decay (2, the exponential as one), the update (3) and the output (2).
    Backward from states ("bwd"; "bwd_nostate" reads no `bound` and walks
    forward once more): x, dt, g in, dx, ddt out, B, C in, dB, dC out, A in,
    dA out; per state and step one recompute of h (5) and the adjoint with
    its five gradients (16). `state` (E4): also h_in read and h_out written
    (forward), the cotangent of h_out read and dh_in written (backward)."""
    rows = batch * length
    states = rows * d_inner * n_state
    small = 4 * (2 * rows * n_state + d_inner * n_state)
    # h_in and h_out, or the cotangent of h_out and dh_in
    stated = 4 * 2 * batch * d_inner * n_state if state else 0
    bound = 4 * batch * len(scan._blocks(length)) * n_state * d_inner
    if kind in ("fwd", "fwd_states"):
        return (4 * 3 * rows * d_inner + small + stated
                + (bound if kind == "fwd_states" else 0)), 7 * states
    n_bytes = 4 * 5 * rows * d_inner + 2 * small + stated
    if kind == "bwd":
        return n_bytes + bound, 21 * states
    return n_bytes, 26 * states


def reset_launches():
    fused_norm.LAUNCHES = 0
    fused_norm.BWD_LAUNCHES = 0
    fused_norm.BF16_LAUNCHES = 0
    fused_norm.BWD_BF16_LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = 0
    flash_attention.DROPOUT_LAUNCHES = 0
    flash_attention.BWD_DROPOUT_LAUNCHES = 0
    flash_attention.BF16_LAUNCHES = 0
    flash_attention.BWD_BF16_LAUNCHES = 0
    flash_attention.BIAS_LAUNCHES = 0
    flash_attention.BWD_BIAS_LAUNCHES = 0
    flash_attention.CROSS_LAUNCHES = 0
    flash_attention.BWD_CROSS_LAUNCHES = 0
    flash_attention.WIDE_LAUNCHES = 0
    flash_attention.BWD_WIDE_LAUNCHES = 0
    quant.PRODUCTS = 0
    for counter in SCAN_COUNTERS.values():
        setattr(scan, counter, 0)


def read_launches():
    """Every kernel's launches; `gn`, `attn` and their backward count every
    form, `*_dropout`, `*_bf16`, `*_bias` (the key-bias forms) and
    `*_cross` (queries against longer keys, E6) and `*_wide` (head_dim past
    128) the launches in that form; `int8` the int8 products (a library
    call, not a kernel of the port: counted to show the int8 path ran)."""
    return {"gn": fused_norm.LAUNCHES, "gn_bwd": fused_norm.BWD_LAUNCHES,
            "gn_bf16": fused_norm.BF16_LAUNCHES,
            "gn_bwd_bf16": fused_norm.BWD_BF16_LAUNCHES,
            "attn": flash_attention.LAUNCHES,
            "attn_bwd": flash_attention.BWD_LAUNCHES,
            "attn_dropout": flash_attention.DROPOUT_LAUNCHES,
            "attn_bwd_dropout": flash_attention.BWD_DROPOUT_LAUNCHES,
            "attn_bf16": flash_attention.BF16_LAUNCHES,
            "attn_bwd_bf16": flash_attention.BWD_BF16_LAUNCHES,
            "attn_bias": flash_attention.BIAS_LAUNCHES,
            "attn_bwd_bias": flash_attention.BWD_BIAS_LAUNCHES,
            "attn_cross": flash_attention.CROSS_LAUNCHES,
            "attn_bwd_cross": flash_attention.BWD_CROSS_LAUNCHES,
            "attn_wide": flash_attention.WIDE_LAUNCHES,
            "attn_bwd_wide": flash_attention.BWD_WIDE_LAUNCHES,
            "int8": quant.PRODUCTS,
            **{key: getattr(scan, counter)
               for key, counter in SCAN_COUNTERS.items()}}


def expect(**counts):
    """A `read_launches()` dict: the given counts, every other one 0."""
    return {key: counts.get(key, 0) for key in read_launches()}


def scaled(counts, n):
    """`expect` with each of `counts` times n."""
    return expect(**{key: n * c for key, c in counts.items()})


def device_line():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return smi


def phase_tensor_cores():
    """The bf16 attention forms run on the tensor cores: every `*_bf16_*`
    attention kernel of the built library has HMMA instructions in its SASS
    (`cuobjdump -sass`), no float32 form, delta or dq-sum kernel has any.
    One line a bf16 kernel with its HMMA count (`phase_build` printed the
    registers and spills of every kernel)."""
    SASS_READ["thread"].join()
    products = SASS_READ["products"]
    bf16 = {n: c for n, c in products.items() if "_bf16_" in n}
    for kernel, count in sorted(bf16.items()):
        print(f"  tensor cores: {count} HMMA in {kernel}")
    missing = [n for n, c in bf16.items() if c == 0]
    stray = [n for n, c in products.items() if c and n not in bf16]
    if not bf16 or missing or stray:
        raise AssertionError(f"tensor-core products: bf16 attention kernels "
                             f"without HMMA {missing or list(bf16) or 'none'}"
                             f", float32 ones with HMMA {stray}")
    print(f"tensor cores: HMMA in all {len(bf16)} bf16 attention kernels, "
          f"in none of the other {len(products) - len(bf16)} attention "
          "kernels")


# the tensor-core products of the attention kernels, read from the built
# library's SASS by `cuobjdump` (20-25 s on the host) in a thread that
# `phase_build` starts and `phase_tensor_cores` joins, while the card works
SASS_READ = {}


def read_sass():
    SASS_READ["products"] = flash_attention.tensor_core_products()


def phase_build():
    start = time.perf_counter()
    _build.library()
    SASS_READ["thread"] = threading.Thread(target=read_sass, daemon=True)
    SASS_READ["thread"].start()
    wall = time.perf_counter() - start
    print(f"kernel build: {_build.build_info['path']} "
          f"(nvcc {_build.build_info['seconds']:.1f} s, load {wall:.1f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")


def gn_case(b, h, w, c, gen):
    """x (mean 0.5, sigma 2), scale, bias and an output gradient."""
    x = torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias, torch.randn(b, h, w, c, generator=gen,
                                       device="cuda")


def check_gn(label, b, h, w, c, gen, timed=True):
    """K1 and K1b at one shape: the forward and its statistics against the
    plain versions, the backward against its plain version and against
    autograd through the plain forward (the recompute it replaced). Returns
    the worst absolute errors (forward, backward) and the ms of the kernels,
    their plain versions and the recompute."""
    x, scale, bias, g = gn_case(b, h, w, c, gen)
    y, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    ref = fused_norm.group_norm_silu_ref(x, scale, bias, 8)
    stats_ref = fused_norm.group_norm_silu_stats_ref(x, 8)
    grads = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    plain = fused_norm.group_norm_silu_bwd_ref(x, scale, bias, g, stats_ref, 8)
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    out = fused_norm.group_norm_silu_ref(*leaves, 8)

    def recompute():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    auto = recompute()
    torch.cuda.synchronize()
    rels = [max_rel(y, ref), max_rel(stats, stats_ref)]
    rels_bwd = [max_rel(o, r) for refs in (plain, auto)
                for o, r in zip(grads, refs)]
    errs = (max((y - ref).abs().max().item(),
                (stats - stats_ref).abs().max().item()),
            max((o - r).abs().max().item() for o, r in zip(grads, plain)))
    times = {}
    if timed:
        times = {
            "fwd": median_ms(
                lambda: fused_norm.group_norm_silu_fwd(x, scale, bias, 8)),
            "fwd_plain": median_ms(
                lambda: fused_norm.group_norm_silu_ref(x, scale, bias, 8)),
            "bwd": median_ms(lambda: fused_norm.group_norm_silu_bwd(
                x, scale, bias, g, stats, 8)),
            "bwd_plain": median_ms(lambda: fused_norm.group_norm_silu_bwd_ref(
                x, scale, bias, g, stats_ref, 8), reps=10),
            "recompute": median_ms(recompute, reps=10)}
    print(f"{label} B={b} {h}x{w}x{c} "
          f"[{fused_norm.kernel_form(x.shape, 8)}; backward: "
          f"{fused_norm.kernel_form(x.shape, 8, True)}]: y/stats max_rel "
          f"{rels[0]:.3e} {rels[1]:.3e}; dx/dscale/dbias vs plain "
          f"{' '.join(f'{r:.3e}' for r in rels_bwd[:3])}, vs autograd of the "
          f"plain forward {' '.join(f'{r:.3e}' for r in rels_bwd[3:])}"
          + (f"; kernel {times['fwd']:.4f} ms plain {times['fwd_plain']:.4f} "
             f"ms; backward kernel {times['bwd']:.4f} ms plain "
             f"{times['bwd_plain']:.4f} ms recompute {times['recompute']:.4f} "
             "ms" if timed else ""))
    if not max(rels + rels_bwd) <= TOL_OUT:
        raise AssertionError(f"{label} {b}x{h}x{w}x{c}: max_rel {rels} "
                             f"{rels_bwd} > {TOL_OUT}")
    return errs, times


def phase_gn(gen):
    """K1 and K1b at every GroupNorm+SiLU shape of the UNet at the check
    batch, then untimed at the sampling and training batches, at a ragged
    shape and at a group too large for shared memory (the generic kernels).
    Returns the worst absolute errors (forward, backward)."""
    worst = [0.0, 0.0]
    cases = [("gn_silu", (CHECK_BATCH, *s), True) for s in GN_SHAPES]
    cases += [("gn_silu", (batch, *s), False)
              for batch in (2 * SAMPLES, TRAIN_BATCH) for s in GN_SHAPES]
    cases += [("gn_silu ragged", GN_RAGGED, True),
              ("gn_silu large group", GN_LARGE, True)]
    for label, shape, timed in cases:
        errs, _ = check_gn(label, *shape, gen, timed=timed)
        worst = [max(w, e) for w, e in zip(worst, errs)]
    return worst


def attention_fwd_form(seq, d, dtype=torch.float32):
    """The form of K2 that the wrapper takes for this shape, in words."""
    width = flash_attention.padded_head_dim(d, dtype)
    tile = flash_attention.fwd_tile(seq, width, dtype)
    dmax = 32 if width <= 32 else 64 if width <= 64 else 128
    if dtype == torch.bfloat16:  # key tiles of 64, or 16 in the 16-row form
        keys = min(tile, 64)
        return (f"tensor cores, {tile // 16} warps of 16 rows, "
                f"{-(-seq // keys)} key tile{'s' if seq > keys else ''} of "
                f"{keys}, d padded to {width} (tiles of {dmax})")
    return (f"tiles of {tile} rows, {-(-seq // tile)} key tile"
            f"{'s' if seq > tile else ''}, d padded to {dmax}")


def check_attention_fwd(label, bh, seq, d, gen, timed=False):
    """K2 against its plain version on one float32 input, the line naming
    its form; with `timed` also the kernel's, the plain version's and
    `F.scaled_dot_product_attention`'s time on (1, BH, L, d) (never called
    by the port). Returns the worst absolute error and the times."""
    q, k, v = (torch.randn(bh, seq, d, generator=gen, device="cuda")
               for _ in range(3))
    o, lse = flash_attention.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    rel = max_rel(o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    line = (f"{label} BH={bh} L={seq} d={d} [{attention_fwd_form(seq, d)}]: "
            f"o max_rel {rel:.3e} lse max_abs {lse_err:.3e}")
    times = {}
    if timed:
        times = {
            "fwd": median_ms(
                lambda: flash_attention.flash_attention_fwd(q, k, v)),
            "fwd_plain": median_ms(
                lambda: flash_attention.flash_attention_fwd_ref(q, k, v)),
            "fwd_library": median_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None]))}
        line += (" kernel {fwd:.4f} ms plain {fwd_plain:.4f} ms "
                 "scaled_dot_product_attention {fwd_library:.4f} ms"
                 ).format(**times)
    print(line)
    if not (rel <= TOL_OUT and lse_err <= TOL_LSE):
        raise AssertionError(f"{label} L={seq} d={d}: o {rel}, lse {lse_err}")
    return max((o - o_ref).abs().max().item(), lse_err), times


def phase_attn(gen):
    """K2 against its plain version at BH 128, d 64 and L 256, 64, 16, 100
    (timed), then in the forms the UNet does not take; each line names the
    form. Returns the worst absolute error."""
    cases = [(seq, HEAD_DIM, True) for seq in ATTN_LENGTHS]
    cases += [(seq, d, False) for seq, d in ATTN_FWD_FORMS]
    return max(check_attention_fwd("flash_attn_fwd", ATTN_BH, seq, d, gen,
                                   timed)[0]
               for seq, d, timed in cases)


def phase_unet(config, gen):
    """One full-width forward with the kernels against the same forward with
    the plain versions; records the shapes each kernel sees per forward."""
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").eval()
    gn_shapes, attn_shapes = [], []
    hooks = [m.register_forward_pre_hook(
                 lambda mod, args, acc=gn_shapes: acc.append(
                     tuple(args[0].shape[1:])))
             for m in model.modules()
             if isinstance(m, unet_mod.FusedGroupNormSiLU)]
    hooks += [m.register_forward_pre_hook(
                  lambda mod, args, acc=attn_shapes: acc.append(
                      tuple(args[0].shape[1:])))
              for m in model.modules() if isinstance(m, unet_mod.AttentionBlock)]
    n_params = sum(p.numel() for p in model.parameters())
    # CHECK_BATCH, then the sampling run's batch (cond + uncond); the latter
    # also lets cuDNN choose its algorithms for that batch outside the timing
    for batch in (CHECK_BATCH, 2 * SAMPLES):
        x = torch.randn(batch, 32, 32, 3, generator=gen, device="cuda")
        t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
        y = torch.randint(0, 11, (batch,), generator=gen, device="cuda")
        with torch.no_grad():
            out = model(x, t, y)
            for h in hooks:
                h.remove()
            with plain_kernels():
                ref = model(x, t, y)
        torch.cuda.synchronize()
        rel = max_rel(out, ref)
        print(f"UNet forward B={batch} ({n_params} parameters): kernels vs "
              f"plain max_rel {rel:.3e}")
        if not (out.shape == (batch, 32, 32, 3)
                and torch.isfinite(out).all() and rel <= TOL_UNET):
            raise AssertionError(f"UNet forward B={batch}: shape "
                                 f"{tuple(out.shape)}, max_rel {rel}")
    print(f"  {len(gn_shapes)} GN+SiLU and {len(attn_shapes)} attention "
          "calls per forward")
    if (len(gn_shapes), len(attn_shapes)) != (GN_PER_FORWARD, ATTN_PER_FORWARD):
        raise AssertionError("unexpected kernel calls per forward: "
                             f"{len(gn_shapes)}, {len(attn_shapes)}")
    return model, gn_shapes, attn_shapes


def phase_trajectory(model, gen):
    """10 DDIM steps with CFG from one noise, kernels against plain."""
    ddim = DDIM(num_timesteps=1000, num_inference_steps=10)
    noise = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    labels = torch.arange(1, 9, device="cuda")

    def run():
        return ddim.sample_with_cfg(model, noise.shape, labels, None,
                                    cfg_scale=CFG_SCALE, init_noise=noise)

    out = run()
    with plain_kernels():
        ref = run()
    torch.cuda.synchronize()
    rel = max_rel(out, ref)
    print(f"DDIM-10 CFG trajectory, 8 images: kernels vs plain max_rel "
          f"{rel:.3e}")
    if not (torch.isfinite(out).all() and rel <= TOL_TRAJ):
        raise AssertionError(f"trajectory max_rel {rel}")


def phase_main_shapes(gn_shapes, attn_shapes, batch, gen):
    """Each kernel against its plain version at every shape one UNet forward
    gives it at the sampling batch (cond + uncond), with the same bars as
    above; returns the kernel time, the plain time and (attention) the
    time of `F.scaled_dot_product_attention`, which the port never calls,
    of one forward's worth of calls, summed over those shapes; the worst
    absolute errors; and the bounds of the same calls."""
    totals = {"gn": [0.0, 0.0, None], "attn": [0.0, 0.0, 0.0]}
    worst_abs = {"gn": 0.0, "attn": 0.0}
    bounds = {"gn": Bound(), "attn": Bound()}
    for (c, h, w), n in sorted(
            {s: gn_shapes.count(s) for s in gn_shapes}.items()):
        x = torch.randn(batch, h, w, c, generator=gen, device="cuda") * 2 + 0.5
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        out = fused_norm.group_norm_silu_fwd(x, scale, bias, 8)
        ref = fused_norm.group_norm_silu_ref(x, scale, bias, 8)
        torch.cuda.synchronize()
        rel = max_rel(out, ref)
        worst_abs["gn"] = max(worst_abs["gn"], (out - ref).abs().max().item())
        ms = median_ms(lambda: fused_norm.group_norm_silu_fwd(x, scale, bias, 8))
        plain = median_ms(
            lambda: fused_norm.group_norm_silu_ref(x, scale, bias, 8))
        totals["gn"][0] += n * ms
        totals["gn"][1] += n * plain
        bounds["gn"].add(*gn_work(batch, h, w, c), n)
        print(f"  main path: gn_silu_fwd B={batch} {h}x{w}x{c} x{n}: max_rel "
              f"{rel:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms")
        if not rel <= TOL_OUT:
            raise AssertionError(f"gn_silu_fwd {batch}x{h}x{w}x{c}: max_rel "
                                 f"{rel} > {TOL_OUT}")
    for (c, h, w), n in sorted(
            {s: attn_shapes.count(s) for s in attn_shapes}.items()):
        heads = 4
        bh, seq, d = batch * heads, h * w, c // heads
        q, k, v = (torch.randn(bh, seq, d, generator=gen, device="cuda")
                   for _ in range(3))
        o, lse = flash_attention.flash_attention_fwd(q, k, v)
        o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        rel = max_rel(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        worst_abs["attn"] = max(worst_abs["attn"],
                                (o - o_ref).abs().max().item(), lse_err)
        ms = median_ms(lambda: flash_attention.flash_attention_fwd(q, k, v))
        plain = median_ms(
            lambda: flash_attention.flash_attention_fwd_ref(q, k, v))
        library = median_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None]))
        totals["attn"][0] += n * ms
        totals["attn"][1] += n * plain
        totals["attn"][2] += n * library
        bounds["attn"].add(*attn_work(bh, seq, d), n)
        print(f"  main path: flash_attn_fwd BH={bh} L={seq} d={d} x{n} "
              f"[{attention_fwd_form(seq, d)}]: o "
              f"max_rel {rel:.3e} lse max_abs {lse_err:.3e} kernel {ms:.4f} "
              f"ms plain {plain:.4f} ms scaled_dot_product_attention "
              f"{library:.4f} ms")
        if not (rel <= TOL_OUT and lse_err <= TOL_LSE):
            raise AssertionError(f"flash_attn_fwd BH={bh} L={seq}: o {rel}, "
                                 f"lse {lse_err}")
    return totals, worst_abs, bounds


def phase_gn_train_step(gn_shapes, gen):
    """K1 and K1b at every GroupNorm+SiLU shape of one UNet train step (batch
    128), each times the calls a step makes of it: the worst absolute error
    of the backward, the summed ms (forward kernel; backward kernel, its
    plain version, and the recompute through the plain forward that the
    backward was before), and the backward's bound."""
    totals = {"fwd": 0.0, "bwd": 0.0, "bwd_plain": 0.0, "recompute": 0.0}
    worst, bound = 0.0, Bound()
    for (c, h, w), n in sorted(
            {s: gn_shapes.count(s) for s in gn_shapes}.items()):
        errs, times = check_gn(f"  train step x{n}: gn_silu", TRAIN_BATCH, h, w,
                               c, gen)
        worst = max(worst, errs[1])
        for key in totals:
            totals[key] += n * times[key]
        bound.add(*gn_bwd_work(TRAIN_BATCH, h, w, c), n)
    print(f"GroupNorm+SiLU per UNet train step at batch {TRAIN_BATCH} "
          f"({len(gn_shapes)} calls): forward kernel {totals['fwd']:.3f} ms; "
          f"backward kernel {totals['bwd']:.3f} ms, its plain version "
          f"{totals['bwd_plain']:.3f} ms, the recompute through the plain "
          f"forward {totals['recompute']:.3f} ms; the backward's bound "
          f"{bound.ms:.3f} ms ({bound.keys()['bound_by']})")
    return worst, totals, bound


def phase_sample_main(label, config, model, per_forward, tmp,
                      compare_plain=False, flags=(), method="ddim",
                      steps=STEPS, calls=None, expected=None,
                      samples=SAMPLES):
    """`samples` images (80), CFG 3, through `sample.main` with `--sampling_method
    method` at `steps` steps (DDIM-50 by default) from a checkpoint of
    `model`'s weights and `config`, with `flags` added to its command line
    and exactly one `per_forward` (a `read_launches()` subset) for each
    model call the sampler makes (`model_calls`), or exactly `expected`
    launches over `calls` model calls where the caller gives them. With
    `compare_plain`, the same call again inside `plain_kernels()`, with no
    launch, for the plain versions' samples/s. Returns the launches and the
    sampling seconds (and the plain run's)."""
    ckpt = Path(tmp) / f"{config['model_type']}_random.pth"
    checkpoint.save_checkpoint(ckpt, model.state_dict(), config)
    argv = ["--checkpoint", str(ckpt), "--sampling_method", method,
            "--cfg_scale", str(CFG_SCALE), "--num_samples", str(samples),
            "--batch_size", str(samples), "--seed", "0", "--device", "cuda",
            "--output_dir", tmp, "--output_name", "samples.png",
            "--num_inference_steps", str(steps), *flags]
    if calls is None:
        calls = model_calls(config, method, steps)
    # the caller ran the model at this batch, so cuDNN, cuBLAS and the
    # kernel library are warm
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    result = sample.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_launches()
    images = result["samples"]
    if not (images.shape == (samples, *image_shape(config))
            and np.isfinite(images).all()):
        raise AssertionError(f"{label} samples: shape {images.shape}, "
                             f"finite {np.isfinite(images).all()}")
    for name in ("samples.png", "samples.npy"):
        if not (Path(tmp) / name).is_file():
            raise AssertionError(f"{label}: {name} was not written")
    if expected is None:
        expected = scaled(per_forward, calls)
    if launches != expected:
        raise AssertionError(f"{label} kernel launches {launches}, expected "
                             f"{expected}")
    print(f"sample.main {label}: {samples} images, {method}-{steps} "
          f"({calls} model calls), CFG {CFG_SCALE}: sampling "
          f"{result['sampling_seconds']:.3f} s "
          f"({samples / result['sampling_seconds']:.2f} samples/s), whole "
          f"call {wall:.3f} s; launches {launches}")
    if not compare_plain:
        return launches, result["sampling_seconds"]
    with plain_kernels():
        reset_launches()
        plain = sample.main(argv)
        torch.cuda.synchronize()
        plain_launched = read_launches()
    print(f"sample.main {label} inside plain_kernels(): sampling "
          f"{plain['sampling_seconds']:.3f} s "
          f"({samples / plain['sampling_seconds']:.2f} samples/s); launches "
          f"{plain_launched}")
    if any(plain_launched.values()):
        raise AssertionError(f"{label} plain sampling launched "
                             f"{plain_launched}")
    return launches, result["sampling_seconds"], plain["sampling_seconds"]


def model_calls(config, method, steps):
    """The model calls of one sampling run of `config`'s process under
    `method` at `steps` steps: 2 S - 1 for Heun (flow matching's `heun` and
    EDM; their last step is first order and makes one call), S for flow's
    Euler, all T steps for DDPM, else the grid's length (a Karras grid may
    be shorter than the steps asked for)."""
    kind = str(config.get("diffusion_type", "ddpm"))
    if kind == "edm" or (kind == "flow_matching"
                         and config.get("flow_solver") == "heun"):
        return 2 * steps - 1
    if kind == "flow_matching":
        return steps
    if method == "ddpm":
        return config["num_timesteps"]
    if config.get("timestep_spacing") == "karras":
        schedule = factory.get_diffusion(config, method).schedule
        return len(karras_timesteps(schedule, steps,
                                    config.get("karras_rho", 7.0)))
    return steps


def attention_bwd_case(bh, seq, d, gen):
    """Inputs of one backward: q, k, v, the forward's o and lse, dO."""
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = flash_attention.flash_attention_fwd_ref(q, k, v)
    return q, k, v, o, do, lse


def attention_bwd_form(seq, d, fused=None, dtype=torch.float32):
    """The form of K3 that the wrapper takes for this shape, in words."""
    tile = flash_attention.bwd_tile(
        seq, flash_attention.padded_head_dim(d, dtype), dtype)
    tiles = -(-seq // tile)
    if fused is None:
        fused = flash_attention.bwd_fused(seq)
    if not fused:
        return f"two kernels, tiles of {tile} rows"
    return (f"fused, {tiles} key tile{'s' if tiles > 1 else ''} of {tile} "
            f"rows{', dq shares summed' if tiles > 1 else ''}")


def check_attention_bwd(label, args, fused=None):
    """K3 (in the form the wrapper picks, or `fused` forces) against its
    plain version on one input; returns the worst absolute error, the
    kernel and plain times, and the time of autograd's backward through
    `F.scaled_dot_product_attention` (never called by the port) for the
    same q, k, v and dO."""
    label += f" [{attention_bwd_form(*args[0].shape[1:], fused)}]"
    grads = flash_attention.flash_attention_bwd(*args, fused=fused)
    refs = flash_attention.flash_attention_bwd_ref(*args)
    torch.cuda.synchronize()
    rels = [max_rel(g, r) for g, r in zip(grads, refs)]
    worst_abs = max((g - r).abs().max().item() for g, r in zip(grads, refs))
    ms = median_ms(
        lambda: flash_attention.flash_attention_bwd(*args, fused=fused))
    plain = median_ms(lambda: flash_attention.flash_attention_bwd_ref(*args))
    qkv = [t.detach()[None].requires_grad_() for t in args[:3]]
    out = F.scaled_dot_product_attention(*qkv)
    library = median_ms(lambda: torch.autograd.grad(
        out, qkv, args[4][None], retain_graph=True))
    print(f"{label}: dq/dk/dv max_rel {rels[0]:.3e} {rels[1]:.3e} "
          f"{rels[2]:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms "
          f"scaled_dot_product_attention's backward {library:.4f} ms")
    if not max(rels) <= TOL_BWD:
        raise AssertionError(f"{label}: max_rel {rels} > {TOL_BWD}")
    return worst_abs, ms, plain, library


def phase_attn_bwd(attn_shapes, gen):
    """K3 against `flash_attention_bwd_ref` at BH 128 in every form it has
    (L 256, 64, 16, 100, 257 and 1024 at d 64 and d 32, 128 at L 256:
    fused; L 1025: two kernels; each line names the form), then at every attention
    shape of a batch-128 train step, the longest of them also with the
    two-kernel form forced; returns the worst absolute error, the kernel,
    plain and library time of one step's worth of backward calls, and
    their bound."""
    worst_abs = 0.0
    cases = [(seq, HEAD_DIM) for seq in ATTN_LENGTHS + ATTN_BWD_LONG]
    cases += [(256, d) for d in ATTN_BWD_HEAD_DIMS]
    for seq, d in cases:
        err, *_ = check_attention_bwd(
            f"flash_attn_bwd BH={ATTN_BH} L={seq} d={d}",
            attention_bwd_case(ATTN_BH, seq, d, gen))
        worst_abs = max(worst_abs, err)
    totals, bound = [0.0, 0.0, 0.0], Bound()
    for (c, h, w), n in sorted(
            {s: attn_shapes.count(s) for s in attn_shapes}.items()):
        heads = 4
        bh, seq, d = TRAIN_BATCH * heads, h * w, c // heads
        err, *times = check_attention_bwd(
            f"  train step: flash_attn_bwd BH={bh} L={seq} d={d} x{n}",
            attention_bwd_case(bh, seq, d, gen))
        worst_abs = max(worst_abs, err)
        totals = [total + n * ms for total, ms in zip(totals, times)]
        bound.add(*attn_work(bh, seq, d, backward=True), n)
        if seq == max(h * w for _, h, w in attn_shapes):
            # the form not taken, on the same kind of input: the reading
            # behind `flash_attention.FUSED_MAX_LEN`
            err, *_ = check_attention_bwd(
                f"  train step: flash_attn_bwd BH={bh} L={seq} d={d}, forced",
                attention_bwd_case(bh, seq, d, gen), fused=False)
            worst_abs = max(worst_abs, err)
    return worst_abs, totals, bound


def check_attention_dropout(label, bh, seq, d, gen, timed=False, fused=None):
    """K2 and K3 in their dropout form (p 0.1, one seed) against their plain
    versions on one input: o and lse, then dq, dk, dv from the kernel's o
    and lse (the backward's form as the wrapper picks it, or `fused`
    forces). With `timed`, per call: the dropout forms, their plain
    versions, the kernels at p = 0 on the same input, and
    `F.scaled_dot_product_attention` with dropout 0.1 and its backward
    (another mask: the library's own generator; never called by the port).
    Returns the worst absolute error and the times."""
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device="cuda")
                   for _ in range(4))
    drop = (ATTN_DROPOUT, ATTN_DROPOUT_SEED)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused)
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop)
    torch.cuda.synchronize()
    rel = max_rel(o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    rels = [max_rel(g, r) for g, r in zip(grads, refs)]
    worst = max((o - o_ref).abs().max().item(), lse_err,
                *((g - r).abs().max().item() for g, r in zip(grads, refs)))
    line = (f"{label} BH={bh} L={seq} d={d} p={ATTN_DROPOUT} "
            f"[{attention_fwd_form(seq, d)}; backward "
            f"{attention_bwd_form(seq, d, fused)}]: o max_rel {rel:.3e} lse "
            f"max_abs {lse_err:.3e}; dq/dk/dv max_rel "
            f"{' '.join(f'{r:.3e}' for r in rels)}")
    times = {}
    if timed:
        args = (q, k, v, o, do, lse)
        times = {
            "fwd": median_ms(
                lambda: flash_attention.flash_attention_fwd(q, k, v, *drop)),
            "fwd_p0": median_ms(
                lambda: flash_attention.flash_attention_fwd(q, k, v)),
            "fwd_plain": median_ms(
                lambda: flash_attention.flash_attention_fwd_ref(q, k, v,
                                                                *drop),
                reps=10),
            "fwd_library": median_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], dropout_p=ATTN_DROPOUT)),
            "bwd": median_ms(
                lambda: flash_attention.flash_attention_bwd(*args, *drop)),
            "bwd_p0": median_ms(
                lambda: flash_attention.flash_attention_bwd(*args)),
            "bwd_plain": median_ms(
                lambda: flash_attention.flash_attention_bwd_ref(*args, *drop),
                reps=10)}
        qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*qkv, dropout_p=ATTN_DROPOUT)
        times["bwd_library"] = median_ms(lambda: torch.autograd.grad(
            out, qkv, do[None], retain_graph=True))
        line += ("; ms a call: forward kernel {fwd:.4f} (p = 0 {fwd_p0:.4f}) "
                 "plain {fwd_plain:.4f} scaled_dot_product_attention "
                 "{fwd_library:.4f}; backward kernel {bwd:.4f} (p = 0 "
                 "{bwd_p0:.4f}) plain {bwd_plain:.4f} its backward "
                 "{bwd_library:.4f}").format(**times)
    print(line)
    if not (rel <= TOL_OUT and lse_err <= TOL_LSE and max(rels) <= TOL_BWD):
        raise AssertionError(f"{label} L={seq} d={d}: o {rel}, lse {lse_err}, "
                             f"dq/dk/dv {rels}")
    return worst, times


def phase_attn_dropout(gen):
    """K2's and K3's dropout forms against their plain versions: at the
    DiT's training shape (timed), then in the forms that shape does not
    take (`ATTN_DROPOUT_FORMS`) and with the two-kernel backward forced at
    L 256; then the mask read back through v = I. Returns the worst
    absolute error and the training shape's times a call."""
    bh = TRAIN_BATCH * DIT_HEADS
    worst, times = check_attention_dropout(
        "attention dropout, DiT train step's shape", bh, DIT_LENGTH,
        DIT_HEAD_DIM, gen, timed=True)
    for seq, d in ATTN_DROPOUT_FORMS:
        err, _ = check_attention_dropout("attention dropout", ATTN_BH, seq, d,
                                         gen)
        worst = max(worst, err)
    err, _ = check_attention_dropout("attention dropout, forced", ATTN_BH,
                                     DIT_LENGTH, DIT_HEAD_DIM, gen,
                                     fused=False)
    phase_mask_readback(gen)
    return max(worst, err), times


def phase_mask_readback(gen):
    """At L = d = 64, v = I: o = P o Z exactly, so the zeros of the
    kernel's o must be the dropped keys of `philox_keep_mask`, bit for bit,
    and their share within 0.5 % of p."""
    bh, seq = TRAIN_BATCH * DIT_HEADS, 64
    q, k = (torch.randn(bh, seq, seq, generator=gen, device="cuda")
            for _ in range(2))
    v = torch.eye(seq, device="cuda").expand(bh, -1, -1).contiguous()
    o, _ = flash_attention.flash_attention_fwd(q, k, v, ATTN_DROPOUT,
                                               ATTN_DROPOUT_SEED)
    keep = flash_attention.philox_keep_mask(ATTN_DROPOUT_SEED, bh, seq, seq,
                                            ATTN_DROPOUT, device="cuda")
    torch.cuda.synchronize()
    differ = (o.ne(0) != keep).sum().item()
    share = keep.float().mean().item()
    print(f"attention dropout mask read back through v = I, BH={bh} L={seq} "
          f"({keep.numel()} keys): {differ} keys differ from "
          f"philox_keep_mask; kept share {share:.6f} against "
          f"{1 - ATTN_DROPOUT}")
    if differ or abs(share - (1 - ATTN_DROPOUT)) > 0.005 * (1 - ATTN_DROPOUT):
        raise AssertionError(f"mask read-back: {differ} keys differ, kept "
                             f"share {share}")


def loss_and_grads(model, process, batch):
    """The process's loss of one batch (DDPM's eps-loss unless the config
    names flow matching or EDM) and every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = process.p_losses(model, batch["x0"], batch["t"], batch["noise"],
                            y=batch["y"])
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def image_shape(config):
    return (*resolve_image_size(config["image_size"]), 3)


def phase_train_grads(label, model, config, per_step, gen,
                      batch_size=CHECK_BATCH, batch=None, seed=None,
                      tol=(TOL_LOSS, TOL_GRAD), process=None):
    """The full-width model's loss and every gradient at `batch_size`
    (or on `batch`, an earlier call's) through the kernels against the same
    inside `plain_kernels()`, with exactly one step's launches (`per_step`)
    and none inside; every parameter must get a gradient. Call it with the
    model in eval mode (no dropout), so both runs see one network, or in
    train mode with a `seed` that reseeds the CPU and CUDA generators before
    each run, so both draw the same dropout masks (the attention's seeds
    from the CPU generator, the MLP's masks from the CUDA one). `tol` is
    the (loss, gradient) bar. The loss is `process`'s `p_losses`, by
    default the config's process's (`factory.get_diffusion`: DDPM, flow
    matching or EDM). Returns the batch, the loss and the flattened
    gradient."""
    process = process or factory.get_diffusion(config)
    shape = (batch_size, *image_shape(config))
    batch = batch or {
        "x0": torch.rand(*shape, generator=gen, device="cuda") * 2 - 1,
        "t": torch.randint(0, config["num_timesteps"], (batch_size,),
                           generator=gen, device="cuda"),
        "noise": torch.randn(*shape, generator=gen, device="cuda"),
        "y": torch.randint(0, 11, (batch_size,), generator=gen,
                           device="cuda"),
    }
    batch_size = batch["t"].shape[0]

    def run():
        if seed is not None:
            torch.manual_seed(seed)
        return loss_and_grads(model, process, batch)

    reset_launches()
    loss, grads = run()
    torch.cuda.synchronize()
    launched = read_launches()
    with plain_kernels():
        reset_launches()
        loss_ref, grads_ref = run()
        torch.cuda.synchronize()
        plain_launched = read_launches()
    flat = torch.cat([g.flatten() for g in grads.values()])
    flat_ref = torch.cat([g.flatten() for g in grads_ref.values()])
    loss_rel = max_rel(loss, loss_ref)
    grad_rel = max_rel(flat, flat_ref)
    worst = max(grads, key=lambda n: max_rel(grads[n], grads_ref[n]))
    print(f"{label} loss and gradients B={batch_size}, kernels vs plain: "
          f"loss {loss.item():.6f} max_rel {loss_rel:.3e}, flattened "
          f"gradient max_abs_diff/max_abs {grad_rel:.3e}; worst tensor "
          f"{worst} max_rel {max_rel(grads[worst], grads_ref[worst]):.3e}; "
          f"launches {launched}, inside plain_kernels {plain_launched}")
    expected = expect(**per_step)
    if launched != expected or any(plain_launched.values()):
        raise AssertionError(f"{label} train-step launches {launched} "
                             f"(expected {expected}), plain {plain_launched}")
    no_grad = [n for n, g in grads.items() if not g.any()]
    if not (loss_rel <= tol[0] and grad_rel <= tol[1]
            and torch.isfinite(flat).all() and not no_grad):
        raise AssertionError(f"{label} loss max_rel {loss_rel}, gradient "
                             f"{grad_rel}, zero gradients {no_grad}")
    return batch, loss, flat


def phase_remat_grads(label, model, config, per_step, remat_step, gen,
                      seed=None):
    """The model under `remat: True` with `model`'s weights (and mode) at
    the training batch: its loss and gradients against the plain versions
    (`phase_train_grads`, with a remat step's launches, `remat_step`), and
    against the model without remat (`per_step`) on the same batch, within
    the same bars; with `seed`, in train mode with the same dropout draws."""
    remat_config = dict(config, remat=True)
    remat_model = factory.get_model(remat_config).to("cuda")
    remat_model.load_state_dict(model.state_dict())
    remat_model.train(model.training)
    batch, loss_r, flat_r = phase_train_grads(
        f"{label} remat", remat_model, remat_config, remat_step, gen,
        batch_size=TRAIN_BATCH, seed=seed)
    _, loss, flat = phase_train_grads(f"{label} on the remat run's batch",
                                      model, config, per_step, gen,
                                      batch=batch, seed=seed)
    loss_rel, grad_rel = max_rel(loss_r, loss), max_rel(flat_r, flat)
    print(f"{label} remat vs no remat, B={TRAIN_BATCH}: loss max_rel "
          f"{loss_rel:.3e}, flattened gradient max_abs_diff/max_abs "
          f"{grad_rel:.3e}")
    if not (loss_rel <= TOL_LOSS and grad_rel <= TOL_GRAD):
        raise AssertionError(f"{label} remat vs no remat: loss {loss_rel}, "
                             f"gradient {grad_rel}")


def write_train_config(config, epochs, tmp, **changes):
    """The config at full width with only the run's length, data and output
    places changed: the committed CIFAR-10 fixtures (where the config reads
    CIFAR-10), `epochs` epochs, outputs under `tmp`, no best-model copy, no
    sample grid (unless `changes` say otherwise)."""
    run = dict(config, data_root=str(FIXTURE_DATA), epochs=epochs,
               save_dir=str(Path(tmp) / "checkpoints"),
               sample_dir=str(Path(tmp) / "samples"), save_best=False,
               sample_start_epoch=epochs + 1)
    run.update(changes)
    Path(tmp).mkdir(parents=True, exist_ok=True)
    path = Path(tmp) / f"cifar10_{config['model_type']}_fixtures.py"
    path.write_text(f"config = {run!r}\n")
    return path


def time_train_steps(trainer, images, labels, warmup=TRAIN_WARMUP,
                     timed=TRAIN_TIMED):
    """Median wall time of `timed` CUDA-synchronised trainer steps after
    `warmup`, in images/s."""
    times = []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer.train_step(images, labels)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - start)
    return images.shape[0] / statistics.median(times)


def timed_rates(label, trainer, batch=None, plain_runs=1, kernel_runs=1,
                warmup=TRAIN_WARMUP, timed=TRAIN_TIMED):
    """Train images/s through the trainer's own step with the kernels and
    with the plain versions (kernels, `plain_runs` times plain, then
    kernels again unless `kernel_runs` is 1) on its first batch (or on
    `batch`, (images, labels) on the card), each the median of `timed`
    steps after `warmup`, and the peak device memory of the kernel path's
    steps."""
    if batch is None:
        images, labels = next(iter(trainer.train_loader))
        images = torch.from_numpy(images).to("cuda")
        if labels is not None:  # the VAE's data is unconditional
            labels = torch.from_numpy(labels).to("cuda")
    else:
        images, labels = batch
    rates, peak = {"kernels": [], "plain": []}, 0
    for path in ("kernels", *["plain"] * plain_runs,
                 *["kernels"] * (kernel_runs - 1)):
        if path == "plain":
            with plain_kernels():
                rates[path].append(time_train_steps(trainer, images, labels,
                                                    warmup, timed))
        else:
            torch.cuda.reset_peak_memory_stats()
            rates[path].append(time_train_steps(trainer, images, labels,
                                                warmup, timed))
            peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"{label} train images/s at batch {images.shape[0]} (median of "
          f"{timed} steps after {warmup}), kernel path "
          f"{', '.join(f'{r:.2f}' for r in rates['kernels'])}, plain path "
          f"{', '.join(f'{r:.2f}' for r in rates['plain'])}; peak device "
          f"memory of the kernel path's steps {peak / 2**20:.1f} MiB")
    return rates, peak


def run_train_main(label, config, per_step, tmp, epochs, steps_per_epoch,
                   extra=(), loss_key="train/loss", **changes):
    """`train.main` for `epochs` epochs at full width, with exactly
    `per_step` launches a step (and the (counts, n) pairs of `extra`
    besides), finite losses (logged under `loss_key`) and a checkpoint;
    `changes` go into its config. Returns the trainer and the launches."""
    batch_size = config["batch_size"]
    cfg_path = write_train_config(config, epochs, tmp, **changes)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    trainer = train.main(["--config", str(cfg_path), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_launches()
    steps = trainer.global_step
    metrics = [json.loads(line) for line in (
        trainer.save_dir / f"{config['experiment_name']}.metrics.jsonl"
    ).read_text().splitlines()]
    losses = [m[loss_key] for m in metrics if loss_key in m]
    ckpt = trainer.save_dir / "current_model.pth"
    print(f"train.main {label}: {epochs} epochs, {steps} steps of "
          f"batch {batch_size} in {wall:.3f} s; losses {losses}; launches "
          f"{launches}")
    expected = add_counts((per_step, steps), *extra)
    if not (steps == epochs * steps_per_epoch and launches == expected):
        raise AssertionError(f"{label}: {steps} steps, launches {launches}, "
                             f"expected {expected}")
    if not (len(losses) == epochs and all(map(math.isfinite, losses))
            and ckpt.is_file()):
        raise AssertionError(f"{label}: losses {losses}, {ckpt} written: "
                             f"{ckpt.is_file()}")
    return trainer, launches


def phase_train_main(label, config, per_step, per_forward, samplers, tmp,
                     epochs=TRAIN_EPOCHS, steps_per_epoch=1, plain_runs=1,
                     kernel_runs=1):
    """`train.main` for `epochs` epochs at full width (on the fixtures:
    three epochs of one batch of 128), with exactly `per_step` launches a
    step; then train images/s with the kernels and with the plain versions,
    in turns, and the peak device memory of the kernel path's steps; then
    `sample.main` from the checkpoint it wrote, once for each (method,
    model calls, flags) of `samplers`, with exactly `per_forward` launches
    a model call."""
    trainer, launches = run_train_main(label, config, per_step, tmp, epochs,
                                       steps_per_epoch)
    ckpt = trainer.save_dir / "current_model.pth"
    rates, peak = timed_rates(label, trainer, plain_runs=plain_runs,
                              kernel_runs=kernel_runs)

    for i, (method, calls, flags) in enumerate(samplers):
        out = Path(tmp) / f"sample_{i}_{method}"
        reset_launches()
        result = sample.main([
            "--checkpoint", str(ckpt), "--sampling_method", method, *flags,
            "--num_samples", "8", "--batch_size", "8", "--use_ema",
            "--device", "cuda", "--output_dir", str(out)])
        torch.cuda.synchronize()
        got = read_launches()
        samples = result["samples"]
        print(f"sample.main {label} {method} {' '.join(flags)} from the "
              f"trained checkpoint: 8 images in "
              f"{result['sampling_seconds']:.3f} s ({calls} model calls); "
              f"launches {got}")
        if not (samples.shape == (8, *image_shape(config))
                and np.isfinite(samples).all()
                and (out / "samples.png").is_file()
                and got == scaled(per_forward, calls)):
            raise AssertionError(f"{label} {method}: samples "
                                 f"{samples.shape}, launches {got}")
    return launches, rates, peak


# ------------------------------------------------- samplers and processes
# (method, steps, config changes) of the fast samplers on the UNet: the
# factory's default step counts, and DDIM on a Karras grid at the CLI's 50
FAST_SAMPLERS = [("dpm++", 20, {}), ("dpm++sde", 20, {}), ("unipc", 10, {}),
                 ("ddim", 20, {"timestep_spacing": "karras"})]
TRAJ_STEPS = 10  # the trajectory checks' steps, as `phase_trajectory`'s


def sampler_label(method, changes):
    return method + ("-karras" if changes.get("timestep_spacing") else "")


def phase_sampler_trajectory(label, config, model, method, gen):
    """8 images, CFG 3, TRAJ_STEPS steps of `method` on `config`'s grid from
    one noise through the kernels against the same inside `plain_kernels()`,
    at TOL_TRAJ; the SDE form takes one explicit noise sequence for both
    runs."""
    process = factory.get_diffusion(dict(config,
                                         num_inference_steps=TRAJ_STEPS),
                                    method)
    noise = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    noises = [torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
              for _ in range(len(process.inference_timesteps))]
    labels = torch.arange(1, 9, device="cuda")

    def run():
        return process.sample_with_cfg(
            model, noise.shape, labels, None, cfg_scale=CFG_SCALE,
            init_noise=noise,
            noises=noises if getattr(process, "sde", False) else None)

    out = run()
    with plain_kernels():
        ref = run()
    torch.cuda.synchronize()
    rel = max_rel(out, ref)
    print(f"{label} {TRAJ_STEPS}-step CFG trajectory, 8 images: kernels vs "
          f"plain max_rel {rel:.3e}")
    if not (torch.isfinite(out).all() and rel <= TOL_TRAJ):
        raise AssertionError(f"{label} trajectory max_rel {rel}")


def phase_samplers(config, model, per_forward, gen, smi):
    """The fast samplers on the full-width model of `config`: each one's
    trajectory against the plain versions, then 80 images with CFG 3
    through `sample.main` at its default steps with exact launches
    (`phase_sample_main`). Returns {label: (launches, seconds, calls)}."""
    runs = {}
    for method, steps, changes in FAST_SAMPLERS:
        label = sampler_label(method, changes)
        run_config = dict(config, **changes)
        phase_sampler_trajectory(f"UNet {label}", run_config, model, method,
                                 gen)
        with tempfile.TemporaryDirectory() as tmp:
            launches, seconds = phase_sample_main(
                f"UNet {label}", run_config, model, per_forward, tmp,
                method=method, steps=steps)
        calls = model_calls(run_config, method, steps)
        runs[label] = (launches, seconds, calls)
        print(f"UNet {label}-{steps} ({calls} model calls) CFG {CFG_SCALE} "
              f"fp32: {SAMPLES / seconds:.2f} samples/s on {smi}")
    return runs


# diffusion_type -> the samplers of its checkpoint: (name, steps, config
# changes); the config's num_inference_steps is 50
PROCESS_SAMPLERS = {
    "flow_matching": [("euler", 50, {}), ("heun", 25, {"flow_solver": "heun"})],
    "edm": [("heun", 18, {})],
}


def phase_process(kind, gen, smi, tmp):
    """The full-width UNet config with `diffusion_type: kind` (flow matching
    or EDM): its loss and gradients against the plain versions
    (`phase_train_grads`, the process's own loss), then `train.main` on
    the fixtures with exact K1, K1b, K2, K3 launches a step, train images/s,
    and `sample.main` from the written checkpoint with each of
    PROCESS_SAMPLERS[kind] (a config file with the changes, CFG 3), with
    exactly one UNet forward's launches per model call."""
    config = dict(load_config(CONFIG), diffusion_type=kind)
    torch.manual_seed(0)
    label = f"UNet {kind}"
    phase_train_grads(label, factory.get_model(config).to("cuda").eval(),
                      config, UNET_STEP, gen)
    samplers = []
    for name, steps, changes in PROCESS_SAMPLERS[kind]:
        flags = ["--num_inference_steps", str(steps),
                 "--cfg_scale", str(CFG_SCALE)]
        if changes:
            path = Path(tmp) / f"{kind}_{name}.py"
            path.write_text(f"config = {dict(config, **changes)!r}\n")
            flags += ["--config", str(path)]
        samplers.append(("ddpm", model_calls(dict(config, **changes), "ddpm",
                                             steps), flags))
    launches, rates, peak = phase_train_main(label, config, UNET_STEP,
                                             UNET_FORWARD, samplers, tmp,
                                             plain_runs=1, kernel_runs=1)
    print(f"{label}: {statistics.median(rates['kernels']):.2f} train "
          f"images/s at batch {TRAIN_BATCH} fp32 (plain versions: "
          f"{statistics.median(rates['plain']):.2f}), peak device memory "
          f"{peak / 2**20:.1f} MiB, on {smi}")
    return {"launches": launches, "rates": rates, "peak": peak}


# ------------------------------------- editing and training-free knobs
EDIT_STRENGTH = 0.5  # DDIM-20 img2img and inpainting: 10 steps
# DDPM RePaint from t0 = round(0.035 * 999) = 35: 36 steps, each run twice
REPAINT_STRENGTH, REPAINT_JUMP, REPAINT_RESAMPLE = 0.035, 10, 2
RESTARTS = 2  # in the CLI's default interval (1, 0.3 T)
# the knobs' and the 64x64 DiT's `sample.main` runs and DDIM inversion: 16
# images (40 until the shapes phase came) on a 20-step grid; the exported
# samplers' runs: 16 images (the other sampling runs: 80 images, DDIM-50),
# cut to keep the script inside its time
SHORT_SAMPLES, SHORT_STEPS, EXPORT_SAMPLES = 16, 20, 16
PAG_SCALE = 2.0
DEEPCACHE_INTERVAL = 3
FREEU = (1.1, 1.2, 0.9, 0.2)
# A PAG model call: the forward, then the same weights with every attention
# map the identity, which runs each GroupNorm+SiLU and no attention
UNET_PAG = {"gn": 2 * GN_PER_FORWARD, "attn": ATTN_PER_FORWARD}
DIT_PAG = DIT_FORWARD
# A DeepCache shallow call (configs/cifar10_unet.py: mult (1, 2, 2, 2), two
# res blocks, attention at 16 and 8): at depth 1 down level 0's two res
# blocks (4), up level 3's three (6) and the head (1), all at 32x32, so no
# attention; at depth 2 also down level 1 (4, and 2 attentions at 16x16)
# and up level 2 (6, and 3 attentions)
DEEPCACHE_SHALLOW = {1: {"gn": 11}, 2: {"gn": 21, "attn": 5}}


def bf16_counts(counts):
    """`counts` of the float32 kernels with the same in their bf16 form."""
    return dict(counts, **{f"{key}_bf16": n for key, n in counts.items()})


def ddim_grid(config, steps):
    return np.round(np.linspace(config["num_timesteps"] - 1, 0, steps))


def add_counts(*pairs):
    """The sum of `n` times `counts` over (counts, n) pairs, as `expect`."""
    total = {}
    for counts, n in pairs:
        for key, c in counts.items():
            total[key] = total.get(key, 0) + n * c
    return expect(**total)


def knob_runs(config):
    """Each `sample.main` run of the knobs' phase: (label, sampling method,
    flags, model calls, launches of the run). Model calls from the grids:
    img2img the DDIM-20 grid at or below round(strength (T - 1)); RePaint
    every step from t0 `resample` times; restarts the grid plus `restarts`
    reruns from the first grid point at or below t_max to the last at or
    above t_min; DeepCache one full step each `interval`."""
    grid = ddim_grid(config, SHORT_STEPS)
    t_total = config["num_timesteps"]
    img2img = int((grid <= round(EDIT_STRENGTH * (t_total - 1))).sum())
    repaint = REPAINT_RESAMPLE * (round(REPAINT_STRENGTH * (t_total - 1)) + 1)
    inside = np.nonzero((grid >= 1) & (grid <= max(2, int(0.3 * t_total))))[0]
    restarts = SHORT_STEPS + RESTARTS * int(inside[-1] - inside[0])
    full = len(range(0, SHORT_STEPS, DEEPCACHE_INTERVAL))
    edit = ["--strength", str(EDIT_STRENGTH), "--init_image", "{dir}/init.png"]
    runs = [
        ("img2img", "ddim", edit, img2img, scaled(UNET_FORWARD, img2img)),
        ("inpainting", "ddim", edit + ["--mask", "{dir}/mask.png"], img2img,
         scaled(UNET_FORWARD, img2img)),
        ("RePaint", "ddpm", ["--strength", str(REPAINT_STRENGTH),
                             "--init_image", "{dir}/init.png", "--mask",
                             "{dir}/mask.png", "--repaint_jump",
                             str(REPAINT_JUMP), "--repaint_resample",
                             str(REPAINT_RESAMPLE)],
         repaint, scaled(UNET_FORWARD, repaint)),
        ("restarts", "ddim", ["--restarts", str(RESTARTS)], restarts,
         scaled(UNET_FORWARD, restarts)),
        ("PAG", "ddim", ["--pag_scale", str(PAG_SCALE)], SHORT_STEPS,
         scaled(UNET_PAG, SHORT_STEPS)),
        ("FreeU", "ddim", ["--freeu", ",".join(map(str, FREEU))],
         SHORT_STEPS, scaled(UNET_FORWARD, SHORT_STEPS)),
    ]
    for depth in (1, 2):
        runs.append((f"DeepCache depth {depth}", "ddim",
                     ["--deepcache", str(DEEPCACHE_INTERVAL),
                      "--deepcache_depth", str(depth)], SHORT_STEPS,
                     add_counts((UNET_FORWARD, full),
                                (DEEPCACHE_SHALLOW[depth],
                                 SHORT_STEPS - full))))
    return runs


def editing_inputs(tmp, gen):
    """A 32x32 init image and a mask regenerating its right half, written
    as PNG by the port (`write_png`); returns the image in [0, 1] and the
    mask."""
    image = (torch.rand(32, 32, 3, generator=gen, device="cuda") * 255
             ).round().to(torch.uint8).cpu().numpy()
    mask = np.zeros((32, 32), np.uint8)
    mask[:, 16:] = 255
    write_png(Path(tmp) / "init.png", image)
    write_png(Path(tmp) / "mask.png", mask)
    return image / 255.0, mask


def check_kept_pixels(label, samples, image, mask):
    """With a mask, the kept (black) pixels come back as the init image."""
    kept = np.broadcast_to((mask == 0)[None, :, :, None], samples.shape)
    err = np.abs(samples[kept] - np.broadcast_to(image, samples.shape)[kept])
    print(f"{label}: kept pixels against the init image max_abs "
          f"{err.max():.3e}")
    if not err.max() <= 1e-6:
        raise AssertionError(f"{label}: kept pixels moved by {err.max()}")


def phase_knob_trajectory(label, run, x, checked=True):
    """`run(x)` (8 images, 10 steps or so, from the input `x`) through the
    kernels against the same inside `plain_kernels()`, at TOL_TRAJ; `run`
    reseeds whatever it draws, so both runs take the same noise. Beside it
    the plain run's own sensitivity: how far it moves when `x` changes by
    1e-6 relative, the distance that float32 rounding alone can open along
    this trajectory. A run with `checked` False is printed, not held."""
    out = run(x)
    with plain_kernels():
        ref = run(x)
        moved = run(x * (1 + 1e-6))
    torch.cuda.synchronize()
    rel, sensitivity = max_rel(out, ref), max_rel(moved, ref)
    print(f"{label} trajectory, 8 images: kernels vs plain max_rel "
          f"{rel:.3e}; the plain run moved {sensitivity:.3e} by a 1e-6 "
          f"change of its input" + ("" if checked else " (reported only)"))
    if checked and not (torch.isfinite(out).all() and rel <= TOL_TRAJ):
        raise AssertionError(f"{label} trajectory max_rel {rel}")


def phase_knob_trajectories(model, freeu_model, dit_model, gen):
    """A short trajectory of every knob's path against the plain versions:
    DDIM-10 img2img and inpainting at strength 0.5, DDPM RePaint over 5
    steps run twice, DDIM-10 with two restarts, DDIM-10 inversion, PAG over
    DDIM-10 on the UNet and the DiT, DeepCache over DDIM-10 at depth 1 and
    2, FreeU over DDIM-10; CFG 3 but for the inversion. PAG, FreeU and
    DeepCache, which change the model's output, are held without the x0
    constraint (`clip_sample: False`) and printed with the dynamic
    threshold: there a random-weight trajectory can be chaotic (on an H100
    80GB HBM3, PAG on the UNet ends 1.2e-2 from the plain versions, and the
    plain run itself moves 1.7e-2 when its noise changes by 1e-6;
    tests/test_torch_port_guidance.py finds the same on the CPU), and the
    plain run's sensitivity is printed beside each."""
    shape = (8, 32, 32, 3)
    images = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    noise = torch.randn(shape, generator=gen, device="cuda")
    mask = torch.zeros(1, 32, 32, 1, device="cuda")
    mask[:, :, 16:] = 1.0
    labels = torch.arange(1, 9, device="cuda")
    ddim = DDIM(num_inference_steps=TRAJ_STEPS)
    ddim_free = DDIM(num_inference_steps=TRAJ_STEPS, clip_sample=False)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(1)

    def pag(m):
        def perturbed(x, t, y=None):
            return m(x, t, y, pag_perturb=True)
        return pag_model_fn(m, perturbed, PAG_SCALE)

    def views(depth):
        return (lambda x, t, y: model(x, t, y, deepcache_mode="full",
                                      deepcache_depth=depth),
                lambda x, t, y, c: model(x, t, y, c, deepcache_mode="shallow",
                                         deepcache_depth=depth))

    cfg = dict(y=labels, cfg_scale=CFG_SCALE)
    # label: (run, its input, held at TOL_TRAJ)
    runs = {
        "DDIM-10 img2img": (lambda x: ddim.img2img(
            model, x, seeded(), strength=EDIT_STRENGTH, **cfg), images, True),
        "DDIM-10 inpainting": (lambda x: ddim.img2img(
            model, x, seeded(), strength=EDIT_STRENGTH, mask=mask, **cfg),
            images, True),
        "DDPM RePaint (5 steps x 2)": (lambda x: DDPM().img2img(
            model, x, seeded(), strength=0.004, mask=mask,
            repaint_jump=REPAINT_JUMP, repaint_resample=REPAINT_RESAMPLE,
            **cfg), images, True),
        "DDIM-10 restarts": (lambda x: ddim.sample_restart(
            model, shape, seeded(), restart_interval=(1, 300),
            restarts=RESTARTS, init_noise=x, **cfg), noise, True),
        "DDIM-10 inversion": (lambda x: ddim.invert(model, x, y=labels),
                              images, True),
    }
    # the knobs that change the model's output, each held without the x0
    # constraint and printed with the dynamic threshold
    guided = {"UNet PAG": lambda d, x: d.sample_with_cfg(
                  pag(model), shape, labels, cfg_scale=CFG_SCALE,
                  init_noise=x),
              "DiT PAG": lambda d, x: d.sample_with_cfg(
                  pag(dit_model), shape, labels, cfg_scale=CFG_SCALE,
                  init_noise=x),
              "FreeU": lambda d, x: d.sample_with_cfg(
                  freeu_model, shape, labels, cfg_scale=CFG_SCALE,
                  init_noise=x)}
    for depth in (1, 2):
        guided[f"DeepCache depth {depth}"] = (
            lambda d, x, depth=depth: deepcache_sample(
                d, *views(depth), shape, y=labels, cfg_scale=CFG_SCALE,
                interval=DEEPCACHE_INTERVAL, init_noise=x))
    for label, run in guided.items():
        runs[f"{label} DDIM-10, dynamic threshold"] = (
            lambda x, run=run: run(ddim, x), noise, False)
        runs[f"{label} DDIM-10, no x0 constraint"] = (
            lambda x, run=run: run(ddim_free, x), noise, True)
    for label, (run, x, checked) in runs.items():
        phase_knob_trajectory(label, run, x, checked)


def phase_inversion(model, gen, smi):
    """DDIM inversion of SHORT_SAMPLES images on SHORT_STEPS steps (no CFG,
    their labels), then DDIM sampling from the latent it gives: one UNet
    forward's launches a call, 2 SHORT_STEPS calls at SHORT_SAMPLES rows;
    the round-trip error printed."""
    low = (torch.rand(SHORT_SAMPLES, 8, 8, 3, generator=gen, device="cuda")
           * 2 - 1)
    images = F.interpolate(low.permute(0, 3, 1, 2), size=(32, 32),
                           mode="bilinear").permute(0, 2, 3, 1).contiguous()
    labels = torch.arange(SHORT_SAMPLES, device="cuda") % 10 + 1
    ddim = DDIM(num_inference_steps=SHORT_STEPS)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    latent = ddim.invert(model, images, y=labels)
    back = ddim.sample(model, images.shape, y=labels, init_noise=latent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    expected = scaled(UNET_FORWARD, 2 * SHORT_STEPS)
    err = (back - images).abs()
    print(f"UNet DDIM-{SHORT_STEPS} inversion and back, {SHORT_SAMPLES} images: "
          f"{seconds:.3f} s; latent std {latent.std().item():.4f}, round "
          f"trip max_abs {err.max().item():.4f} mean_abs "
          f"{err.mean().item():.4f} (random weights); launches {launches} "
          f"on {smi}")
    if launches != expected:
        raise AssertionError(f"inversion launches {launches}, expected "
                             f"{expected}")
    if not (torch.isfinite(latent).all() and torch.isfinite(back).all()):
        raise AssertionError("inversion: values not finite")
    return launches


def phase_knobs(config, model, gen, smi):
    """The editing and training-free knobs on the full-width UNet (and PAG
    on the full-width DiT): the trajectories against the plain versions,
    then SHORT_SAMPLES images CFG 3 on SHORT_STEPS steps through
    `sample.main` for each with exact
    launches
    (img2img and inpainting at strength 0.5, RePaint, restarts, PAG, FreeU,
    DeepCache at depth 1 and 2; the kept pixels of each masked run checked),
    DDIM inversion and back, PAG on the DiT, and DeepCache on the bf16 UNet.
    Returns {label: (launches, seconds, calls)}."""
    freeu_config = dict(config, model_params=dict(config["model_params"],
                                                  freeu=FREEU))
    freeu_model = factory.get_model(freeu_config).to("cuda").eval()
    freeu_model.load_state_dict(model.state_dict(), strict=True)
    dit_config = load_config(DIT_CONFIG)
    dit_model = random_model(dit_config, gen)
    phase_knob_trajectories(model, freeu_model, dit_model, gen)
    del freeu_model
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        image, mask = editing_inputs(tmp, gen)
        for label, method, flags, calls, expected in knob_runs(config):
            launches, seconds = phase_sample_main(
                f"UNet {label}", config, model, UNET_FORWARD, tmp,
                flags=[f.format(dir=tmp) for f in flags], method=method,
                steps=SHORT_STEPS, calls=calls, expected=expected,
                samples=SHORT_SAMPLES)
            if "--mask" in flags:
                samples = np.load(Path(tmp) / "samples.npy")
                check_kept_pixels(f"UNet {label}", samples, image, mask)
            runs[f"UNet {label}"] = (launches, seconds, calls)
        runs["UNet DDIM inversion"] = (phase_inversion(model, gen, smi), None,
                                       2 * SHORT_STEPS)
        runs["DiT PAG"] = (*phase_sample_main(
            "DiT PAG", dit_config, dit_model, DIT_FORWARD, tmp,
            flags=["--pag_scale", str(PAG_SCALE)], steps=SHORT_STEPS,
            calls=SHORT_STEPS, expected=scaled(DIT_PAG, SHORT_STEPS),
            samples=SHORT_SAMPLES), SHORT_STEPS)
        full = len(range(0, SHORT_STEPS, DEEPCACHE_INTERVAL))
        runs["UNet bf16 DeepCache depth 1"] = (*phase_sample_main(
            "UNet bf16 DeepCache depth 1", config, model, UNET_FORWARD, tmp,
            flags=["--mixed_precision", "bf16", "--deepcache",
                   str(DEEPCACHE_INTERVAL), "--deepcache_depth", "1"],
            steps=SHORT_STEPS, calls=SHORT_STEPS,
            expected=add_counts((bf16_counts(UNET_FORWARD), full),
                                (bf16_counts(DEEPCACHE_SHALLOW[1]),
                                 SHORT_STEPS - full)),
            samples=SHORT_SAMPLES), SHORT_STEPS)
    del dit_model
    for label, (_, seconds, calls) in runs.items():
        if seconds is not None:
            print(f"{label} ({calls} model calls) CFG {CFG_SCALE}: "
                  f"{SHORT_SAMPLES / seconds:.2f} samples/s at "
                  f"{SHORT_SAMPLES} images, on {smi}")
    return runs


# ------------------------------------------------------------------- DiM
def scan_case(batch, length, gen, d_inner=SCAN_D, n_state=SCAN_N):
    """Scan inputs, at the DiM's width unless told otherwise: x, dt > 0
    (softplus, mostly below 1), A = -exp(N(0, 0.25)) * (1..N) like the
    model's S4D init, B, C, and an output gradient g."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = randn(batch, length, d_inner)
    dt = F.softplus(randn(batch, length, d_inner) - 2)
    A = -torch.exp(randn(d_inner, n_state) * 0.5) * torch.arange(
        1, n_state + 1, device="cuda")
    return (x, dt, A, randn(batch, length, n_state),
            randn(batch, length, n_state), randn(batch, length, d_inner))


def check_outputs(label, outs, refs, tol):
    """The tensors `outs` against each reference of `refs` (name -> tensors;
    None entries skipped), max-rel within `tol`, each error printed;
    returns the worst absolute error."""
    worst = 0.0
    for name, wants in refs.items():
        pairs = [(o, w) for o, w in zip(outs, wants) if w is not None]
        rels = [max_rel(o, w) for o, w in pairs]
        worst = max(worst, *((o - w).abs().max().item() for o, w in pairs))
        print(f"{label} vs {name}: max_rel "
              f"{' '.join(f'{r:.3e}' for r in rels)}")
        if not max(rels) <= tol:
            raise AssertionError(f"{label} vs {name}: max_rel {rels} > {tol}")
    return worst


def check_scan_fwd(batch, length, d_inner, n_state, gen, worst, times=None):
    """The scan forward with states off and on against the plain forward.
    With `times`, each and the plain forward are timed."""
    inputs = scan_case(batch, length, gen, d_inner, n_state)[:5]
    y_ref, bound_ref = scan.selective_scan_fwd_ref(*inputs, True)
    shape = f"B={batch} L={length} D={d_inner} N={n_state}"
    for save in (False, True):
        outs = scan.selective_scan_fwd(*inputs, save)
        torch.cuda.synchronize()
        label = (f"selective_scan_fwd {shape} "
                 f"[states {'on' if save else 'off'}]")
        worst["fwd"] = max(worst["fwd"], check_outputs(
            label, outs, {"plain": (y_ref, bound_ref if save else None)},
            TOL_SCAN_FWD))
        if times is None:
            continue
        ms = median_ms(lambda: scan.selective_scan_fwd(*inputs, save))
        plain = median_ms(lambda: scan.selective_scan_fwd_ref(*inputs, save),
                          reps=10, warmup=2)
        times[("fwd", batch, length, save)] = (ms, plain)
        print(f"  kernel {ms:.4f} ms plain {plain:.4f} ms")


def phase_scan_nostate(gen, worst, times):
    """K7 against its plain version (the plain forward with states, then
    the plain backward) and against K8 from K6's states."""
    for batch, length in SCAN_NOSTATE_CASES:
        *inputs, g = scan_case(batch, length, gen)
        args = (*inputs, g)
        label = (f"selective_scan_bwd_nostate B={batch} L={length} "
                 f"D={SCAN_D} N={SCAN_N} dx/ddt/dA/dB/dC")
        grads = scan.selective_scan_bwd_nostate(*args)
        torch.cuda.synchronize()
        _, bound = scan.selective_scan_fwd(*inputs, True)
        worst["bwd_nostate"] = max(worst["bwd_nostate"], check_outputs(
            label, grads,
            {"plain": scan.selective_scan_bwd_nostate_ref(*args),
             "K8 from K6's states": scan.selective_scan_bwd(*args, bound)},
            TOL_SCAN_BWD))
        ms = median_ms(lambda: scan.selective_scan_bwd_nostate(*args))
        plain = median_ms(lambda: scan.selective_scan_bwd_nostate_ref(*args),
                          reps=5, warmup=1)
        times[("bwd_nostate", batch, length)] = (ms, plain)
        print(f"  kernel {ms:.4f} ms plain {plain:.4f} ms")


def phase_scan_sweep_forms(gen, worst):
    """The reverse sweep in the forms the main paths do not take
    (`SCAN_SWEEP_FORMS`), through each kernel that runs it (K8, K7, K10),
    against the plain backward; each line names the form."""
    lib = _build.library()
    for batch, length, d_inner, n_state in SCAN_SWEEP_FORMS:
        *inputs, g = scan_case(batch, length, gen, d_inner, n_state)
        _, bound = scan.selective_scan_fwd_ref(*inputs, True)
        refs = {"plain": scan.selective_scan_bwd_ref(*inputs, g, bound)}
        t_block = scan.t_block_for(length)
        scratch = lib.selective_scan_bwd_nostate_needs_scratch(
            length, n_state, t_block)
        form = (f"{scan.sweep_form(n_state)}, time "
                f"blocks of {t_block} steps"
                f"{', a ragged last one' if length % t_block else ''}, "
                f"{-(-d_inner // 64)} tiles of 64 channels for D={d_inner}")
        shape = f"B={batch} L={length} D={d_inner} N={n_state}"
        for key, fn, args, note in (
                ("bwd", scan.selective_scan_bwd, (*inputs, g, bound), ""),
                ("bwd_nostate", scan.selective_scan_bwd_nostate,
                 (*inputs, g), ", rebuilt states in "
                 + ("device scratch" if scratch else "shared memory")),
                ("bwd_split", scan.selective_scan_bwd_split,
                 (*inputs, g, bound),
                 f", chunks of {scan.bwd_chunk_blocks(batch, length, d_inner)}"
                 " time blocks")):
            grads = fn(*args)
            torch.cuda.synchronize()
            worst[key] = max(worst[key], check_outputs(
                f"selective_scan_{key} {shape} [sweep: {form}{note}]", grads,
                refs, TOL_SCAN_BWD))


def phase_scan_split(gen, worst, times):
    """K9 and K10 against their plain versions (the same passes in plain
    PyTorch) and against K6 and K8 on the same inputs."""
    for batch, length in SCAN_SPLIT_CASES:
        *inputs, g = scan_case(batch, length, gen)
        shape = (f"B={batch} L={length} D={SCAN_D} N={SCAN_N} [chunks of "
                 f"{scan.fwd_chunk_blocks(batch, length, SCAN_D)} and "
                 f"{scan.bwd_chunk_blocks(batch, length, SCAN_D)} time "
                 "blocks]")
        outs = scan.selective_scan_fwd_split(*inputs)
        torch.cuda.synchronize()
        y_k6, bound = scan.selective_scan_fwd(*inputs, True)
        worst["fwd_split"] = max(worst["fwd_split"], check_outputs(
            f"selective_scan_fwd_split {shape} y/bound", outs,
            {"plain": scan.selective_scan_fwd_split_ref(*inputs),
             "K6": (y_k6, bound)}, TOL_SCAN_FWD))
        ms = median_ms(lambda: scan.selective_scan_fwd_split(*inputs))
        plain = median_ms(lambda: scan.selective_scan_fwd_split_ref(*inputs),
                          reps=5, warmup=1)
        times[("fwd_split", batch, length)] = (ms, plain)
        print(f"  kernel {ms:.4f} ms plain {plain:.4f} ms")

        args = (*inputs, g, bound)
        grads = scan.selective_scan_bwd_split(*args)
        torch.cuda.synchronize()
        worst["bwd_split"] = max(worst["bwd_split"], check_outputs(
            f"selective_scan_bwd_split {shape} dx/ddt/dA/dB/dC", grads,
            {"plain": scan.selective_scan_bwd_split_ref(*args),
             "K8": scan.selective_scan_bwd(*args)}, TOL_SCAN_BWD))
        ms = median_ms(lambda: scan.selective_scan_bwd_split(*args))
        plain = median_ms(lambda: scan.selective_scan_bwd_split_ref(*args),
                          reps=5, warmup=1)
        times[("bwd_split", batch, length)] = (ms, plain)
        print(f"  kernel {ms:.4f} ms plain {plain:.4f} ms")


def routed_step(batch, length):
    """The scan launches of one DiM train step at this shape, as
    `scan.split_forward` and `scan.split_backward` route them."""
    n = SCAN_PER_FORWARD
    step = ({"scan_fwd_split": n} if scan.split_forward(batch, length, SCAN_D)
            else {"scan_fwd": n, "scan_fwd_states": n})
    step["scan_bwd_split" if scan.split_backward(batch, length, SCAN_D)
         else "scan_bwd"] = n
    return step


def phase_scan_sweep(gen, times):
    """Per-call times of the whole-sequence kernels against the time-split
    ones at L = 1024 over the batch (the data behind `scan.split_forward`
    and `scan.split_backward`), each line with what the rules pick, and of
    K7 against K6 + K8 at the CIFAR training shape."""
    length = SCAN_SWEEP_LENGTH
    for batch in SCAN_SWEEP_BATCHES:
        *inputs, g = scan_case(batch, length, gen)
        _, bound = scan.selective_scan_fwd(*inputs, True)
        args = (*inputs, g, bound)
        fns = {"K6": lambda: scan.selective_scan_fwd(*inputs, True),
               "K9": lambda: scan.selective_scan_fwd_split(*inputs),
               "K8": lambda: scan.selective_scan_bwd(*args),
               "K10": lambda: scan.selective_scan_bwd_split(*args)}
        single = {k: median_ms(fn, reps=10) for k, fn in fns.items()}
        device = {k: graph_ms(fn) for k, fn in fns.items()}
        times[("sweep", batch)] = device
        fwd = "K9" if scan.split_forward(batch, length, SCAN_D) else "K6"
        bwd = "K10" if scan.split_backward(batch, length, SCAN_D) else "K8"
        print(f"scan sweep L={length} B={batch} (picked: {fwd} with chunks "
              f"of {scan.fwd_chunk_blocks(batch, length, SCAN_D)} time "
              f"blocks, {bwd} with chunks of "
              f"{scan.bwd_chunk_blocks(batch, length, SCAN_D)}), ms a call "
              "on the card (from a CUDA graph; a single launch with its host "
              "time): "
              + ", ".join(f"{k} {device[k]:.4f} ({single[k]:.4f})"
                          for k in fns))
    pair = times[("sweep", DIM64_BATCH)]
    print(f"64x64 DiM train step's scans (B={DIM64_BATCH} L={length}), ms a "
          f"call on the card: forward K6 {pair['K6']:.4f}, K9 "
          f"{pair['K9']:.4f}; backward K8 {pair['K8']:.4f}, K10 "
          f"{pair['K10']:.4f}; the rules pick "
          f"{routed_step(DIM64_BATCH, length)}")
    phase_scan_chunks(gen, times)
    k7 = times[("bwd_nostate", TRAIN_BATCH, 256)][0]
    k6 = times[("fwd", TRAIN_BATCH, 256, True)][0]
    k5 = times[("fwd", TRAIN_BATCH, 256, False)][0]
    k8 = times[("bwd", TRAIN_BATCH, 256)][0]
    print(f"scan at B={TRAIN_BATCH} L=256: K7 {k7:.4f} ms against K8 "
          f"{k8:.4f} + K6 {k6:.4f} = {k8 + k6:.4f} ms; a remat step's "
          f"2 K5 + K7 {2 * k5 + k7:.4f} ms")
    print_scan_bounds()


def phase_scan_chunks(gen, times):
    """K9 and K10 at L = 1024 with every chunk size of `SCAN_CHUNK_SWEEP`
    in place of the wrappers' own choice: each held against K6 and K8 on
    the same inputs, then timed."""
    length = SCAN_SWEEP_LENGTH
    rules = scan.fwd_chunk_blocks, scan.bwd_chunk_blocks
    for batch in SCAN_CHUNK_BATCHES:
        *inputs, g = scan_case(batch, length, gen)
        y_k6, bound = scan.selective_scan_fwd(*inputs, True)
        args = (*inputs, g, bound)
        grads_k8 = scan.selective_scan_bwd(*args)
        readings = []
        try:
            for chunk in SCAN_CHUNK_SWEEP:
                scan.fwd_chunk_blocks = scan.bwd_chunk_blocks = (
                    lambda *shape, chunk=chunk: chunk)
                label = f"scan chunk of {chunk} B={batch} L={length}"
                check_outputs(f"{label} y/bound",
                              scan.selective_scan_fwd_split(*inputs),
                              {"K6": (y_k6, bound)}, TOL_SCAN_FWD)
                check_outputs(f"{label} dx/ddt/dA/dB/dC",
                              scan.selective_scan_bwd_split(*args),
                              {"K8": grads_k8}, TOL_SCAN_BWD)
                k9 = graph_ms(lambda: scan.selective_scan_fwd_split(*inputs))
                k10 = graph_ms(lambda: scan.selective_scan_bwd_split(*args))
                times[("chunk", batch, chunk)] = {"K9": k9, "K10": k10}
                readings.append(f"{chunk}: K9 {k9:.4f} K10 {k10:.4f}")
        finally:
            scan.fwd_chunk_blocks, scan.bwd_chunk_blocks = rules
        print(f"scan chunk sweep L={length} B={batch} (the wrappers' own "
              f"choice: K9 {rules[0](batch, length, SCAN_D)}, K10 "
              f"{rules[1](batch, length, SCAN_D)}), ms a call on the card "
              f"(from a CUDA graph) by time blocks in a chunk: "
              f"{'; '.join(readings)}")


def print_scan_bounds():
    """The bound of one call of each scan kernel at its main path's shape
    (and K4's at the ragged check shape), with what sets it."""
    for name, kind, batch, length in (
            ("K4", "fwd", CHECK_BATCH, 100), ("K5", "fwd", 2 * SAMPLES, 256),
            ("K5", "fwd", TRAIN_BATCH, 256), ("K5", "fwd", DIM64_BATCH, 1024),
            ("K6", "fwd_states", TRAIN_BATCH, 256),
            ("K6", "fwd_states", DIM64_BATCH, 1024),
            ("K7", "bwd_nostate", TRAIN_BATCH, 256),
            ("K8", "bwd", TRAIN_BATCH, 256), ("K8", "bwd", DIM64_BATCH, 1024),
            ("K9", "fwd_states", DIM64_BATCH, 1024),
            ("K10", "bwd", DIM64_BATCH, 1024)):
        keys = Bound().add(*scan_work(kind, batch, length)).keys()
        walks = {"fwd": 1, "fwd_states": 1, "bwd": 2, "bwd_nostate": 3}[kind]
        if name == "K9":  # chunk 0 and the last walked once, the others twice
            chunks = -(-len(scan._blocks(length))
                       // scan.fwd_chunk_blocks(batch, length, SCAN_D))
            walks = 2 - 2 / chunks
        exp_ms = 1e3 * walks * batch * length * SCAN_D * SCAN_N / PEAK_EXP_PER_S
        print(f"scan bound per call {name} B={batch} L={length}: "
              f"{keys['bound_ms']:.4f} ms ({keys['bound_by']}); its "
              f"exponentials alone, {walks:.3g} a state and step on the "
              f"special-function units: {exp_ms:.4f} ms")


def phase_scan(gen):
    """The scan kernels against their plain versions: the forward (K5 with
    states off, K6 with states on, K4's ragged block at L = 100), the
    backward from states (K8) and without (K7), the time-split forward
    and backward (K9, K10), and the other forms of the reverse sweep.
    Returns the worst absolute errors and the
    kernel and plain ms of one call at each shape."""
    worst = {"fwd": 0.0, "bwd": 0.0, "bwd_nostate": 0.0, "fwd_split": 0.0,
             "bwd_split": 0.0}
    times = {}
    for batch, length in SCAN_FWD_CASES:
        check_scan_fwd(batch, length, SCAN_D, SCAN_N, gen, worst, times)
    for shape in SCAN_FWD_FORMS:
        check_scan_fwd(*shape, gen, worst)
    for batch, length in SCAN_BWD_CASES:
        x, dt, A, B, C, g = scan_case(batch, length, gen)
        _, bound = scan.selective_scan_fwd_ref(x, dt, A, B, C, True)
        args = (x, dt, A, B, C, g, bound)
        grads = scan.selective_scan_bwd(*args)
        refs = scan.selective_scan_bwd_ref(*args)
        torch.cuda.synchronize()
        rels = [max_rel(o, r) for o, r in zip(grads, refs)]
        worst["bwd"] = max(worst["bwd"], *((o - r).abs().max().item()
                                            for o, r in zip(grads, refs)))
        ms = median_ms(lambda: scan.selective_scan_bwd(*args))
        plain = median_ms(lambda: scan.selective_scan_bwd_ref(*args), reps=10,
                          warmup=2)
        times[("bwd", batch, length)] = (ms, plain)
        print(f"selective_scan_bwd B={batch} L={length} D={SCAN_D} "
              f"N={SCAN_N}: dx/ddt/dA/dB/dC max_rel "
              f"{' '.join(f'{r:.3e}' for r in rels)} kernel {ms:.4f} ms "
              f"plain {plain:.4f} ms")
        if not max(rels) <= TOL_SCAN_BWD:
            raise AssertionError(f"selective_scan_bwd B={batch}: max_rel "
                                 f"{rels}")
    phase_scan_nostate(gen, worst, times)
    phase_scan_split(gen, worst, times)
    phase_scan_sweep_forms(gen, worst)
    phase_scan_sweep(gen, times)
    return worst, times


def random_model(config, gen):
    """The full-width DiM or DiT with random weights, in eval mode. Their
    init is adaLN-Zero: every adaLN modulation and the final projection
    start at zero, so the output would be exactly 0 whatever the kernels
    compute, and a comparison with the plain versions would hold nothing.
    Each parameter that starts all zero is drawn N(0, 0.02^2) instead, so
    every block's scan or attention reaches the output and every parameter
    gets a gradient."""
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").eval()
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return model


def phase_model_forward(label, config, per_forward, gen, tol=TOL_UNET):
    """A full-width DiM or DiT (`random_model`): forwards at batch 32 and
    160 through the kernels against the same inside `plain_kernels()`,
    with exactly `per_forward` launches each. Returns the model, its
    parameter count and the launches of one forward."""
    model = random_model(config, gen)
    n_params = sum(p.numel() for p in model.parameters())
    for batch in (CHECK_BATCH, 2 * SAMPLES):
        x = torch.randn(batch, 32, 32, 3, generator=gen, device="cuda")
        t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
        y = torch.randint(0, 11, (batch,), generator=gen, device="cuda")
        reset_launches()
        with torch.no_grad():
            out = model(x, t, y)
            launched = read_launches()
            with plain_kernels():
                ref = model(x, t, y)
        torch.cuda.synchronize()
        rel = max_rel(out, ref)
        print(f"{label} forward B={batch} ({n_params} parameters): kernels "
              f"vs plain max_rel {rel:.3e}; launches {launched}")
        if launched != expect(**per_forward):
            raise AssertionError(f"{label} forward launches {launched}")
        if not (out.shape == (batch, 32, 32, 3) and ref.abs().max() > 0
                and out.dtype == torch.float32
                and torch.isfinite(out).all() and rel <= tol):
            raise AssertionError(f"{label} forward B={batch}: shape "
                                 f"{tuple(out.shape)}, max_rel {rel}, "
                                 f"max |plain| {ref.abs().max().item()}")
    return model, n_params, launched


def phase_dit(gen):
    """The DiT's paths (configs/cifar10_dit.py at full width) and the DiM's
    attention fallback; see the module's docstring. Returns what the
    `kernels` line and the summary read."""
    dropout_err, dropout_times = phase_attn_dropout(gen)
    config = load_config(DIT_CONFIG)
    model, n_params, _ = phase_model_forward("DiT", config, DIT_FORWARD, gen)
    phase_trajectory(model, gen)
    with tempfile.TemporaryDirectory() as tmp:
        sample_launches, seconds, plain_seconds = phase_sample_main(
            "DiT", config, model, DIT_FORWARD, tmp, compare_plain=True)
    model.train()  # dropout on: the attention's in the kernels, the MLP's
    phase_train_grads("DiT", model, config, DIT_STEP, gen,
                      batch_size=TRAIN_BATCH, seed=TRAIN_SEED)
    phase_remat_grads("DiT", model, config, DIT_STEP, DIT_REMAT_STEP, gen,
                      seed=TRAIN_SEED)
    del model
    samplers = [("ddim", 10, ["--num_inference_steps", "10",
                              "--cfg_scale", str(CFG_SCALE)])]
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, rates, peak = phase_train_main(
            "DiT", config, DIT_STEP, DIT_FORWARD, samplers, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        remat_launches, remat_rates, remat_peak = phase_train_main(
            "DiT remat", dict(config, remat=True), DIT_REMAT_STEP,
            DIT_FORWARD, samplers, tmp, plain_runs=0)

    # the DiM with 8-head attention in place of each Mamba mixer (d 48)
    dim_config = load_config(DIM_CONFIG)
    fallback = dict(dim_config, model_params=dict(
        dim_config["model_params"], use_attention_fallback=True))
    fallback_model, _, fallback_launches = phase_model_forward(
        "DiM attention fallback", fallback, DIT_FORWARD, gen)
    fallback_model.train()
    phase_train_grads("DiM attention fallback", fallback_model, fallback,
                      DIT_STEP, gen, batch_size=TRAIN_BATCH, seed=TRAIN_SEED)
    del fallback_model
    return {"params": n_params, "dropout_err": dropout_err,
            "dropout_times": dropout_times, "sample_launches": sample_launches,
            "seconds": seconds, "plain_seconds": plain_seconds,
            "train_launches": train_launches, "rates": rates, "peak": peak,
            "remat_launches": remat_launches, "remat_rates": remat_rates,
            "remat_peak": remat_peak,
            "fallback_launches": fallback_launches["attn"]}


# ------------------------------------------------------------------ bf16
# Mixed precision (`mixed_precision: 'bf16'`): bf16 convs, linears and
# activations on float32 parameters; GroupNorm+SiLU and attention in their
# kernels' bf16 form, the scans in float32 as before.
UNET_FORWARD_BF16 = dict(UNET_FORWARD, gn_bf16=GN_PER_FORWARD,
                         attn_bf16=ATTN_PER_FORWARD)
UNET_STEP_BF16 = dict(UNET_STEP, gn_bf16=GN_PER_FORWARD,
                      gn_bwd_bf16=GN_PER_FORWARD, attn_bf16=ATTN_PER_FORWARD,
                      attn_bwd_bf16=ATTN_PER_FORWARD)
DIT_FORWARD_BF16 = dict(DIT_FORWARD, attn_bf16=ATTN_PER_DIT_FORWARD)
DIT_STEP_BF16 = dict(DIT_STEP, attn_bf16=ATTN_PER_DIT_FORWARD,
                     attn_bwd_bf16=ATTN_PER_DIT_FORWARD)
# A bf16 form and its plain version compute in float32 from the same bf16
# inputs and round once: equal, or one bf16 step apart where the two float32
# values straddle a rounding boundary (two for the attention backward, whose
# dS is a difference of two products). An element far below the largest is
# held to the float32 bar of the largest (TOL_OUT, TOL_BWD) instead: the
# float32 rounding it carries is many bf16 steps of its own.
BF16_STEPS_FWD, BF16_STEPS_BWD = 1, 2
# Full-width bf16 models, kernels against plain: a norm's or an
# attention's output one bf16 step off (2^-8 relative) goes on through the
# bf16 layers after it, and the plain attention's autograd takes delta from
# the float32 o where the kernel takes it from the bf16 o, as JAX does.
# Measured by this script (H100 80GB HBM3, 700 W): forwards 4.2e-3 to
# 1.0e-2, losses 3.7e-6 to 1.6e-5, gradients 3.2e-3 to 4.5e-3.
TOL_BF16_MODEL, TOL_BF16_LOSS, TOL_BF16_GRAD = 3e-2, 1e-4, 2e-2
# K1/K1b beyond the UNet's shapes: C / G = 3 (the generic kernels in both
# types), C / G = 4 (whole float32 vectors, no whole bf16 one), a group of
# 64 x 64 x 16 (shared memory holds it in bf16, not in float32)
GN_BF16_EDGES = [GN_RAGGED, (3, 8, 8, 32), GN_LARGE]
# K2/K3 beyond the main paths' shapes: ragged tiles (L 17, 65 and 100 past
# tiles of 16 and 64), many key tiles fused and with the two-kernel backward
# (L 1025), d 48 (the DiM's attention fallback), d 32, d 24 (padded to the
# mma's depth of 16, 32 columns)
ATTN_BF16_FORMS = [(100, 64), (1024, 64), (1025, 64), (257, 64), (100, 48),
                   (33, 32), (17, 64), (65, 64), (100, 24)]


def bf16_steps(a, b):
    """The number of bf16 values between a and b, elementwise."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def bf16_check(label, got, want, steps, tol):
    """`got` within `steps` bf16 steps of `want` (both bf16) wherever it is
    not within tol * max|want|; returns (the most steps seen there, the max
    absolute error)."""
    if not got.dtype == want.dtype == torch.bfloat16:
        raise AssertionError(f"{label}: dtypes {got.dtype}, {want.dtype}")
    diff = (got.float() - want.float()).abs()
    near = diff <= tol * want.float().abs().max()
    worst = bf16_steps(got, want).masked_fill(near, 0).max().item()
    if worst > steps:
        raise AssertionError(f"{label}: {worst} bf16 steps from the plain "
                             f"version (bar {steps}, or {tol} of the "
                             "largest value)")
    return worst, diff.max().item()


def bf16_bar(steps, tol):
    return f"bar {steps} bf16 step{'s' if steps > 1 else ''} or {tol:g} of max"


def check_gn_bf16(label, b, h, w, c, gen):
    """K1's and K1b's bf16 forms against their plain versions at one shape,
    one line naming the forms. Returns the worst absolute errors (forward,
    backward) and the inputs (x, scale, bias, g, stats, plain stats)."""
    x, scale, bias, g = gn_case(b, h, w, c, gen)
    x, g = x.bfloat16(), g.bfloat16()
    y, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
    stats_ref = fused_norm.group_norm_silu_stats_ref(x, 8)
    grads = fused_norm.group_norm_silu_bwd(x, scale, bias, g, stats, 8)
    refs = fused_norm.group_norm_silu_bwd_ref(x, scale, bias, g, stats_ref, 8)
    torch.cuda.synchronize()
    label = f"{label} B={b} {h}x{w}x{c}"
    steps, err = bf16_check(label, y, fused_norm.group_norm_silu_ref(
        x, scale, bias, 8), BF16_STEPS_FWD, TOL_OUT)
    steps_bwd, err_bwd = bf16_check(label + " dx", grads[0], refs[0],
                                    BF16_STEPS_FWD, TOL_OUT)
    rels = [max_rel(stats, stats_ref),
            *(max_rel(a, r) for a, r in zip(grads[1:], refs[1:]))]
    if not max(rels) <= TOL_OUT:
        raise AssertionError(f"{label}: stats, dscale, dbias max_rel "
                             f"{rels} > {TOL_OUT}")
    print(f"{label} [{fused_norm.kernel_form(x.shape, 8, False, x.dtype)}"
          f"; backward: {fused_norm.kernel_form(x.shape, 8, True, x.dtype)}"
          f"]: y {steps} bf16 steps, dx {steps_bwd} "
          f"({bf16_bar(BF16_STEPS_FWD, TOL_OUT)}); stats, dscale, dbias "
          f"max_rel {' '.join(f'{r:.3e}' for r in rels)} (bar {TOL_OUT:g})")
    errs = (max(err, (stats - stats_ref).abs().max().item()), err_bwd)
    return errs, (x, scale, bias, g, stats, stats_ref)


def phase_bf16_gn(gn_shapes, gen):
    """K1's and K1b's bf16 forms against their plain versions at every
    GroupNorm+SiLU shape of a UNet forward at the sampling batch (K1) and of
    a train step (K1b), timed and summed over one forward's or step's calls,
    then at `GN_BF16_EDGES`; each line names the form. Returns the worst
    absolute errors (forward, backward), the sums and the bounds."""
    worst = [0.0, 0.0]
    totals = {"fwd": 0.0, "fwd_plain": 0.0, "bwd": 0.0, "bwd_plain": 0.0}
    bounds = {"fwd": Bound(), "bwd": Bound()}
    counts = sorted({s: gn_shapes.count(s) for s in gn_shapes}.items())
    cases = [(2 * SAMPLES, h, w, c, n, "fwd") for (c, h, w), n in counts]
    cases += [(TRAIN_BATCH, h, w, c, n, "bwd") for (c, h, w), n in counts]
    cases += [(*shape, 0, "both") for shape in GN_BF16_EDGES]
    for b, h, w, c, n, which in cases:
        errs, (x, scale, bias, g, stats, stats_ref) = check_gn_bf16(
            "gn_silu bf16", b, h, w, c, gen)
        worst = [max(a, e) for a, e in zip(worst, errs)]
        if which == "fwd":
            ms = median_ms(
                lambda: fused_norm.group_norm_silu_fwd(x, scale, bias, 8))
            plain = median_ms(
                lambda: fused_norm.group_norm_silu_ref(x, scale, bias, 8))
            totals["fwd"] += n * ms
            totals["fwd_plain"] += n * plain
            bounds["fwd"].add(*gn_work(b, h, w, c, elem=2), n)
            print(f"  x{n} a forward: kernel {ms:.4f} ms plain {plain:.4f} ms")
        elif which == "bwd":
            ms = median_ms(lambda: fused_norm.group_norm_silu_bwd(
                x, scale, bias, g, stats, 8))
            plain = median_ms(lambda: fused_norm.group_norm_silu_bwd_ref(
                x, scale, bias, g, stats_ref, 8), reps=10)
            totals["bwd"] += n * ms
            totals["bwd_plain"] += n * plain
            bounds["bwd"].add(*gn_bwd_work(b, h, w, c, elem=2), n)
            print(f"  x{n} a train step: backward kernel {ms:.4f} ms plain "
                  f"{plain:.4f} ms")
    print(f"GroupNorm+SiLU bf16: a UNet sampling forward at batch "
          f"{2 * SAMPLES} {totals['fwd']:.3f} ms (plain {totals['fwd_plain']:.3f}"
          f", bound {bounds['fwd'].ms:.3f} ms, {bounds['fwd'].keys()['bound_by']}"
          f"); its backward a train step at batch {TRAIN_BATCH} "
          f"{totals['bwd']:.3f} ms (plain {totals['bwd_plain']:.3f}, bound "
          f"{bounds['bwd'].ms:.3f} ms, {bounds['bwd'].keys()['bound_by']})")
    return worst, totals, bounds


def bf16_qkv(bh, seq, d, gen, n=4):
    return [torch.randn(bh, seq, d, generator=gen, device="cuda").bfloat16()
            for _ in range(n)]


def check_attention_bf16(label, bh, seq, d, gen, drop=(0.0, None),
                         fused=None, timed=False):
    """K2 and K3 in their bf16 form (with dropout when `drop` has p > 0;
    K3 in the form `fused` forces, or the wrapper's) against their plain
    versions on one input; with `timed`, per call: each kernel, its plain
    version and `F.scaled_dot_product_attention` on the same bf16 inputs
    and its backward (with its own dropout mask; never called by the port).
    The library call gets them as (1, BH, L, d): on 3-D tensors PyTorch
    takes its unfused math path, on 4-D ones its flash kernel. Returns the
    worst absolute error and the times."""
    q, k, v, do = bf16_qkv(bh, seq, d, gen)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                fused=fused)
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop)
    torch.cuda.synchronize()
    label = (f"{label} BH={bh} L={seq} d={d} p={drop[0]} "
             f"[{attention_fwd_form(seq, d, torch.bfloat16)}; backward "
             f"{attention_bwd_form(seq, d, fused, torch.bfloat16)}]")
    steps, err = bf16_check(label + " o", o, o_ref, BF16_STEPS_FWD, TOL_OUT)
    lse_err = (lse - lse_ref).abs().max().item()
    if not (lse.dtype == torch.float32 and lse_err <= TOL_LSE):
        raise AssertionError(f"{label}: lse {lse.dtype} max_abs {lse_err}")
    checked = [bf16_check(f"{label} {name}", a, r, BF16_STEPS_BWD, TOL_BWD)
               for name, a, r in zip(("dq", "dk", "dv"), grads, refs)]
    line = (f"{label}: o {steps} bf16 steps "
            f"({bf16_bar(BF16_STEPS_FWD, TOL_OUT)}), lse max_abs "
            f"{lse_err:.3e} (bar {TOL_LSE:g}); dq/dk/dv "
            f"{' '.join(str(c[0]) for c in checked)} bf16 steps "
            f"({bf16_bar(BF16_STEPS_BWD, TOL_BWD)})")
    times = {}
    if timed:
        args = (q, k, v, o, do, lse)
        times = {
            "fwd": median_ms(
                lambda: flash_attention.flash_attention_fwd(q, k, v, *drop)),
            "fwd_plain": median_ms(
                lambda: flash_attention.flash_attention_fwd_ref(q, k, v,
                                                                *drop),
                reps=10),
            "fwd_library": median_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], dropout_p=drop[0])),
            "bwd": median_ms(lambda: flash_attention.flash_attention_bwd(
                *args, *drop, fused=fused)),
            "bwd_plain": median_ms(
                lambda: flash_attention.flash_attention_bwd_ref(*args, *drop),
                reps=10)}
        qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*qkv, dropout_p=drop[0])
        times["bwd_library"] = median_ms(
            lambda: torch.autograd.grad(out, qkv, do[None],
                                        retain_graph=True))
        line += ("; ms a call: forward kernel {fwd:.4f} plain {fwd_plain:.4f} "
                 "scaled_dot_product_attention {fwd_library:.4f}; backward "
                 "kernel {bwd:.4f} plain {bwd_plain:.4f} its backward "
                 "{bwd_library:.4f}").format(**times)
    print(line)
    return max(err, lse_err, *(c[1] for c in checked)), times


def phase_bf16_attn(attn_shapes, gen):
    """K2's and K3's bf16 forms against their plain versions: at every
    attention shape of a UNet forward at the sampling batch (K2) and of a
    train step (K3, the longest also with the two-kernel form forced),
    timed beside the library call on bf16 inputs and summed over a forward's
    or step's calls; at the DiT's sampling shape (p = 0) and train-step
    shape (p 0.1, the dropout forms; also forced), summed over its 12
    calls; then in `ATTN_BF16_FORMS` with and without dropout. Returns the
    worst absolute error, the sums and the bounds (each a pair: the work at
    the float32 CUDA-core rate the forms compute at, and at the bf16 tensor
    cores' rate, the bound of the inputs' type)."""
    worst = 0.0
    keys = ("fwd", "fwd_plain", "fwd_library", "bwd", "bwd_plain",
            "bwd_library")
    sums = {what: dict.fromkeys(keys, 0.0)
            for what in ("unet_fwd", "unet_bwd", "dit", "dit_dropout")}
    bounds = {what: (Bound(), Bound(PEAK_BF16_TC_OPS_PER_S))
              for what in sums}
    counts = sorted({s: attn_shapes.count(s) for s in attn_shapes}.items())
    longest = max(h * w for (_, h, w), _ in counts)
    for (c, h, w), n in counts:
        for what, batch in (("unet_fwd", 2 * SAMPLES),
                            ("unet_bwd", TRAIN_BATCH)):
            bh, seq, d = batch * 4, h * w, c // 4
            err, times = check_attention_bf16(
                f"  {what}: attention bf16 x{n}", bh, seq, d, gen, timed=True)
            worst = max(worst, err)
            for key in keys:
                sums[what][key] += n * times[key]
            for bound in bounds[what]:
                bound.add(*attn_work(bh, seq, d, what == "unet_bwd", elem=2),
                          n)
            if what == "unet_bwd" and seq == longest:
                err, _ = check_attention_bf16(
                    f"  {what}: attention bf16, forced", bh, seq, d, gen,
                    fused=False)
                worst = max(worst, err)
    dit_shapes = (("dit", 2 * SAMPLES, (0.0, None)),
                  ("dit_dropout", TRAIN_BATCH,
                   (ATTN_DROPOUT, ATTN_DROPOUT_SEED)))
    for what, batch, drop in dit_shapes:
        bh = batch * DIT_HEADS
        err, times = check_attention_bf16(
            f"  {what}: attention bf16 x{ATTN_PER_DIT_FORWARD}", bh,
            DIT_LENGTH, DIT_HEAD_DIM, gen, drop=drop, timed=True)
        worst = max(worst, err)
        for key in keys:
            sums[what][key] += ATTN_PER_DIT_FORWARD * times[key]
        for bound in bounds[what]:  # the forward's; the backward's below
            bound.add(*attn_work(bh, DIT_LENGTH, DIT_HEAD_DIM, elem=2),
                      ATTN_PER_DIT_FORWARD)
    bounds["dit_dropout_bwd"] = (Bound(), Bound(PEAK_BF16_TC_OPS_PER_S))
    for bound in bounds["dit_dropout_bwd"]:
        bound.add(*attn_work(TRAIN_BATCH * DIT_HEADS, DIT_LENGTH,
                             DIT_HEAD_DIM, True, elem=2),
                  ATTN_PER_DIT_FORWARD)
    err, _ = check_attention_bf16(
        "  dit_dropout: attention bf16, forced", TRAIN_BATCH * DIT_HEADS,
        DIT_LENGTH, DIT_HEAD_DIM, gen, drop=(ATTN_DROPOUT, ATTN_DROPOUT_SEED),
        fused=False)
    worst = max(worst, err)
    for seq, d in ATTN_BF16_FORMS:
        for drop in ((0.0, None), (ATTN_DROPOUT, ATTN_DROPOUT_SEED)):
            err, _ = check_attention_bf16("attention bf16", ATTN_BH, seq, d,
                                          gen, drop=drop)
            worst = max(worst, err)
    for what, label in (("unet_fwd", "a UNet sampling forward"),
                        ("unet_bwd", "a UNet train step"),
                        ("dit", "a DiT sampling forward"),
                        ("dit_dropout", "a DiT train step, p 0.1")):
        t = sums[what]
        print(f"attention bf16, {label}: forward kernel {t['fwd']:.3f} ms "
              f"plain {t['fwd_plain']:.3f} scaled_dot_product_attention "
              f"{t['fwd_library']:.3f}; backward kernel {t['bwd']:.3f} plain "
              f"{t['bwd_plain']:.3f} library {t['bwd_library']:.3f}; bound "
              f"{bounds[what][1].ms:.3f} ms (bf16 tensor cores), "
              f"{bounds[what][0].ms:.3f} ms at the float32 CUDA-core rate")
    return worst, sums, bounds


def time_train_rates(trainer, runs=1, warmup=TRAIN_WARMUP, timed=TRAIN_TIMED):
    """Train images/s through the trainer's own step on its first batch,
    `runs` times (each the median of `timed` steps after `warmup`), and the
    peak device memory of those steps."""
    images, labels = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).to("cuda")
    labels = torch.from_numpy(labels).to("cuda")
    rates, peak = [], 0
    for _ in range(runs):
        torch.cuda.reset_peak_memory_stats()
        rates.append(time_train_steps(trainer, images, labels, warmup,
                                      timed))
        peak = max(peak, torch.cuda.max_memory_allocated())
    return rates, peak


def phase_bf16_model(label, config, per_forward, per_step, gen,
                     train_seed=None, fast_sampler=None):
    """The full-width model under `mixed_precision: 'bf16'` (float32
    parameters, the kernels' bf16 forms, float32 eps): forwards at batch 32
    and 160 against the same inside `plain_kernels()`; 80 images DDIM-50
    CFG 3 through `sample.main --mixed_precision bf16` from a float32
    config's checkpoint of its weights; the loss and gradients against the
    plain versions (in train mode with dropout when `train_seed`, at batch
    128); three epochs of `train.main` from the config with
    `mixed_precision: 'bf16'`, train images/s and peak memory. Exact
    launches everywhere (`per_forward`, `per_step`). `fast_sampler`, a
    (method, steps) pair, adds the same `sample.main` run under that
    sampler."""
    config16 = dict(config, mixed_precision="bf16")
    name = f"{label} bf16"
    model, n_params, _ = phase_model_forward(name, config16, per_forward, gen,
                                             tol=TOL_BF16_MODEL)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError(f"{name}: parameters not all float32")
    with tempfile.TemporaryDirectory() as tmp:
        sample_launches, seconds = phase_sample_main(
            name, config, model, per_forward, tmp,
            flags=("--mixed_precision", "bf16"))
    fast = None
    if fast_sampler is not None:
        method, steps = fast_sampler
        with tempfile.TemporaryDirectory() as tmp:
            fast = phase_sample_main(f"{name} {method}", config, model,
                                     per_forward, tmp, method=method,
                                     steps=steps,
                                     flags=("--mixed_precision", "bf16"))
    if train_seed is not None:
        model.train()
    phase_train_grads(name, model, config16, per_step, gen,
                      batch_size=TRAIN_BATCH if train_seed else CHECK_BATCH,
                      seed=train_seed,
                      tol=(TOL_BF16_LOSS, TOL_BF16_GRAD))
    del model
    with tempfile.TemporaryDirectory() as tmp:
        trainer, train_launches = run_train_main(name, config16, per_step,
                                                 tmp, TRAIN_EPOCHS, 1)
        rates, peak = time_train_rates(trainer)
    print(f"{name} train images/s at batch {config['batch_size']}: "
          f"{', '.join(f'{r:.2f}' for r in rates)}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    return {"params": n_params, "sample_launches": sample_launches,
            "seconds": seconds, "train_launches": train_launches,
            "rates": rates, "peak": peak, "fast": fast}


DIT_BF16_FAST_SAMPLER = ("dpm++", 20)


def phase_bf16(gn_shapes, attn_shapes, gen):
    """The bf16 forms of K1, K1b, K2 and K3 against their plain versions,
    then the UNet, the DiM and the DiT in bf16 (`phase_bf16_model`)."""
    gn_err, gn_totals, gn_bounds = phase_bf16_gn(gn_shapes, gen)
    attn_err, attn_sums, attn_bounds = phase_bf16_attn(attn_shapes, gen)
    models = {
        "UNet": phase_bf16_model("UNet", load_config(CONFIG),
                                 UNET_FORWARD_BF16, UNET_STEP_BF16, gen),
        "DiM": phase_bf16_model("DiM", load_config(DIM_CONFIG), DIM_FORWARD,
                                DIM_STEP, gen),
        "DiT": phase_bf16_model("DiT", load_config(DIT_CONFIG),
                                DIT_FORWARD_BF16, DIT_STEP_BF16, gen,
                                train_seed=TRAIN_SEED,
                                fast_sampler=DIT_BF16_FAST_SAMPLER),
    }
    return {"gn_err": gn_err, "gn_totals": gn_totals,
            "gn_bounds": gn_bounds, "attn_err": attn_err,
            "attn_sums": attn_sums, "attn_bounds": attn_bounds,
            "models": models}


# ------------------------------------------------------ metrics and evaluate
TOL_METRIC_NET = 2e-4  # the metric networks on the card against the CPU
INCEPTION_RATE_BATCH = 50
# Newton-Schulz against scipy's sqrtm at 512 features (InceptionV3's pool
# has 2048: scipy takes 11-22 s there on the host, cut to keep the script
# inside its time)
SQRTM_DIM = 512
# `evaluate.main` on the fp32 UNet: DDIM-20, CFG 3 in one batch of 2 x 50
# rows, against the fixtures' 50-image test split
EVAL_SAMPLES, EVAL_BATCH, EVAL_STEPS = 50, 50, 20
# and on the bf16 DiT: DDIM-20, one batch of 50
EVAL_DIT_SAMPLES, EVAL_DIT_STEPS = 50, 20


def phase_metric_networks(gen):
    """The metric networks on the card against the same networks (the same
    weights) on the CPU: InceptionV3 pool features and logits for 8 images
    at 32x32 and 2 at 299x299, LPIPS distances for 8 pairs at 32x32, each
    within TOL_METRIC_NET; then the rate of feature extraction at batch 50
    and tr sqrtm of a 2048x2048 covariance product by Newton-Schulz on the
    card against scipy's sqrtm on the host. Returns the figures."""
    rng = np.random.default_rng(0)
    cpu_inc = metrics.InceptionFeatures(device="cpu")
    card_inc = metrics.InceptionFeatures(device="cuda")
    card_inc.model.load_state_dict(cpu_inc.model.state_dict())
    worst = 0.0
    for shape in ((8, 32, 32, 3), (2, 299, 299, 3)):
        images = rng.random(shape, dtype=np.float32)
        for name, ours, ref in zip(("features", "logits"), card_inc(images),
                                   cpu_inc(images)):
            err = max_rel(ours.cpu(), ref)
            worst = max(worst, err)
            print(f"InceptionV3 {name} at {shape} on the card against the "
                  f"CPU: max-rel {err:.3e} (bar {TOL_METRIC_NET:g})")
            if not (ours.dtype == torch.float32 and err <= TOL_METRIC_NET):
                raise AssertionError(f"InceptionV3 {name} at {shape}: "
                                     f"{ours.dtype}, max-rel {err:.3e}")
    cpu_lpips = lpips_score.LPIPSScore(device="cpu")
    card_lpips = lpips_score.LPIPSScore(device="cuda")
    card_lpips.model.load_state_dict(cpu_lpips.model.state_dict())
    x1, x2 = (rng.random((8, 32, 32, 3), dtype=np.float32) for _ in range(2))
    err = max_rel(card_lpips.distance(x1, x2).cpu(),
                  cpu_lpips.distance(x1, x2))
    worst = max(worst, err)
    print(f"LPIPS distances of 8 pairs at 32x32 on the card against the "
          f"CPU: max-rel {err:.3e} (bar {TOL_METRIC_NET:g})")
    if err > TOL_METRIC_NET:
        raise AssertionError(f"LPIPS max-rel {err:.3e}")

    batch = torch.rand(INCEPTION_RATE_BATCH, 32, 32, 3, generator=gen,
                       device="cuda")
    ms = median_ms(lambda: card_inc(batch), reps=5, warmup=2)
    rate = INCEPTION_RATE_BATCH / ms * 1e3
    print(f"InceptionV3 feature extraction at batch {INCEPTION_RATE_BATCH} "
          f"(32x32, resized to 299): {ms:.3f} ms a batch (median of 5), "
          f"{rate:.1f} images/s")

    feats = [rng.standard_normal((n, SQRTM_DIM)) for n in (4096, 3000)]
    prod = np.cov(feats[0], rowvar=False) @ np.cov(feats[1], rowvar=False)
    start = time.perf_counter()
    ref = float(np.trace(linalg.sqrtm(prod).real))
    scipy_s = time.perf_counter() - start
    trace = metrics.FIDScore.trace_sqrtm_newton_schulz(prod, device="cuda")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics.FIDScore.trace_sqrtm_newton_schulz(prod, device="cuda")
        times.append(time.perf_counter() - start)
    ns_s = statistics.median(times)
    print(f"tr sqrtm at {SQRTM_DIM}x{SQRTM_DIM}: scipy on the host {ref:.6f} "
          f"in {scipy_s:.3f} s; Newton-Schulz (30 iterations, float32) on "
          f"the card {trace:.6f} in {ns_s * 1e3:.2f} ms (median of 3), "
          f"relative difference {abs(trace - ref) / abs(ref):.3e}")
    return {"err": worst, "rate": rate, "scipy_s": scipy_s, "ns_s": ns_s}


class MetricDtypes:
    """Records, while active, the dtype of a parameter and of the outputs
    of every InceptionV3 and LPIPS call, from the classes' own methods."""

    def __enter__(self):
        self.seen = []
        self.saved = (metrics.InceptionFeatures.__call__,
                      lpips_score.LPIPSScore.distance)
        inception_call, distance = self.saved
        seen = self.seen

        def record_inception(inc, images):
            out = inception_call(inc, images)
            seen.append(("InceptionV3", next(inc.model.parameters()).dtype,
                         *(t.dtype for t in out)))
            return out

        def record_lpips(lp, x1, x2):
            out = distance(lp, x1, x2)
            seen.append(("LPIPS", next(lp.model.parameters()).dtype,
                         out.dtype))
            return out

        metrics.InceptionFeatures.__call__ = record_inception
        lpips_score.LPIPSScore.distance = record_lpips
        return self

    def __exit__(self, *exc):
        (metrics.InceptionFeatures.__call__,
         lpips_score.LPIPSScore.distance) = self.saved


def trace_sqrtm_eigh(sigma1, sigma2):
    """tr sqrtm(S1 S2) of two covariances (symmetric, positive semidefinite)
    from two float64 eigendecompositions on the card: with S1 = U L U^T and
    B = U L^(1/2), S1 S2 has the eigenvalues of B^T S2 B, so the trace is the
    sum of their square roots. It holds at any rank (50 or 100 samples of
    2048 features), where Newton-Schulz diverges."""
    s1, s2 = (torch.as_tensor(np.atleast_2d(s), dtype=torch.float64,
                              device="cuda") for s in (sigma1, sigma2))
    lam, u = torch.linalg.eigh(s1)
    b = u * lam.clamp_min(0.0).sqrt()
    return torch.linalg.eigvalsh(b.T @ s2 @ b).clamp_min(0.0).sqrt().sum(
        ).item()


class CardFrechet:
    """While active, FID's tr sqrtm is `trace_sqrtm_eigh` on the card in
    place of scipy's 2048x2048 sqrtm on the host (11-22 s an `evaluate`
    call on the GPU machine), to keep the script inside its time; with
    `host`, scipy's value stays the result and the card's is recorded
    beside it (`seen`), so the script's first `evaluate` run computes FID as
    the port's `FIDScore.calculate_frechet_distance` does and holds the two
    together."""

    def __init__(self, host: bool):
        self.host, self.seen = host, []

    def __enter__(self):
        self.saved = metrics.FIDScore.calculate_frechet_distance
        scipy_fid, seen, host = self.saved, self.seen, self.host

        def frechet(mu1, sigma1, mu2, sigma2, eps=1e-6):
            diff = np.atleast_1d(mu1) - np.atleast_1d(mu2)
            card = (diff.dot(diff) + np.trace(np.atleast_2d(sigma1))
                    + np.trace(np.atleast_2d(sigma2))
                    - 2 * trace_sqrtm_eigh(sigma1, sigma2))
            if not host:
                return card
            fid = scipy_fid(mu1, sigma1, mu2, sigma2, eps)
            seen.append((fid, card))
            return fid
        metrics.FIDScore.calculate_frechet_distance = staticmethod(frechet)
        return self

    def __exit__(self, *exc):
        metrics.FIDScore.calculate_frechet_distance = self.saved


# the evaluate runs so far: the first computes FID as `evaluate` does (and
# the card's value beside it), the later ones under `CardFrechet`
EVALUATE_RUNS = []
# the largest relative difference the first run allows between FID with
# scipy's sqrtm and with `trace_sqrtm_eigh` (2.8e-7 measured on the H100)
FRECHET_BAR = 1e-5


def run_evaluate(label, model, config, flags, expected, tmp):
    """`evaluate.main` from a checkpoint of `model` (its weights also as the
    EMA weights) and `config` on the fixtures, with `flags`, exactly
    `expected` launches, every metric finite, the metric networks float32
    (FID's tr sqrtm on the card after the script's first run,
    `CardFrechet`, and beside scipy's in that run). Returns the launches,
    the report and the stage seconds."""
    ckpt = Path(tmp) / f"{label.replace(' ', '_')}.pth"
    state = model.state_dict()
    checkpoint.save_checkpoint(ckpt, state,
                               dict(config, data_root=str(FIXTURE_DATA)),
                               ema_model_state_dict=state)
    out = Path(tmp) / f"{label.replace(' ', '_')}_metrics.json"
    argv = ["--checkpoint", str(ckpt), "--device", "cuda", "--use_ema",
            "--sampling_method", "ddim", "--cfg_scale", str(CFG_SCALE),
            "--swd", "--seed", "0", "--output", str(out),
            "--save_images_dir", str(Path(tmp) / "eval"), *flags]
    seconds = {}
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    frechet = CardFrechet(host=not EVALUATE_RUNS)
    EVALUATE_RUNS.append(label)
    with MetricDtypes() as dtypes, frechet:
        report = evaluate.main(argv, seconds=seconds)
    for fid, card in frechet.seen:
        rel = abs(card - fid) / abs(fid)
        print(f"evaluate.main {label}: FID with scipy's host sqrtm "
              f"{fid:.6f}, with the card's eigendecompositions {card:.6f}, "
              f"relative difference {rel:.3e} (bar {FRECHET_BAR:g})")
        if not rel <= FRECHET_BAR:
            raise AssertionError(
                f"evaluate {label}: the card's FID {card} is {rel:.3e} from "
                f"scipy's {fid}, over the bar {FRECHET_BAR:g}")
    if frechet.host and not frechet.seen:
        raise AssertionError(f"evaluate {label}: FID was not computed, so "
                             "the card's tr sqrtm was not held to scipy's")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_launches()
    print(f"evaluate.main {label} ({' '.join(flags)}; FID's tr sqrtm "
          f"{'on the card' if len(EVALUATE_RUNS) > 1 else 'scipy, host'}): "
          f"whole call {wall:.3f} s; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f"; launches {launches}")
    print(f"evaluate.main {label} report: {json.dumps(report)}")
    if launches != expected:
        raise AssertionError(f"evaluate {label} kernel launches {launches}, "
                             f"expected {expected}")
    values = [v for k, v in report.items()
              if k != "uncalibrated_relative_only"]
    if not (values and all(map(math.isfinite, values))
            and "swd_avg" in report
            and json.loads(out.read_text()) == report):
        raise AssertionError(f"evaluate {label} report {report}")
    kinds = {entry[0] for entry in dtypes.seen}
    if kinds != {"InceptionV3", "LPIPS"} or any(
            dtype != torch.float32 for entry in dtypes.seen
            for dtype in entry[1:]):
        raise AssertionError(f"evaluate {label}: metric network dtypes "
                             f"{sorted(set(dtypes.seen))}")
    print(f"evaluate.main {label}: metric networks ran "
          f"{sorted(set(dtypes.seen))}")
    return launches, report, seconds


def phase_evaluate(config, gen, smi):
    """The metric networks on the card (`phase_metric_networks`), then
    `evaluate.main` on a full-width fp32 UNet checkpoint (DDIM-20, CFG 3,
    50 samples in one batch, SWD, FID with scipy's sqrtm; one forward's
    launches a model call: 900 GroupNorm+SiLU and 220 attention launches)
    and on the bf16
    DiT (DDIM-20, 50 samples: 240 bf16 attention launches, no
    GroupNorm+SiLU), each against the fixtures' 50-image test split."""
    networks = phase_metric_networks(gen)
    torch.manual_seed(0)
    unet = factory.get_model(config).to("cuda").eval()
    calls = EVAL_SAMPLES // EVAL_BATCH * EVAL_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        unet_launches, unet_report, unet_seconds = run_evaluate(
            "UNet", unet, config,
            ["--num_inference_steps", str(EVAL_STEPS), "--num_samples",
             str(EVAL_SAMPLES), "--batch_size", str(EVAL_BATCH)],
            scaled(UNET_FORWARD, calls), tmp)
    del unet
    rate = EVAL_SAMPLES / unet_seconds["generation"]
    print(f"evaluate UNet generation: {EVAL_SAMPLES} samples DDIM-"
          f"{EVAL_STEPS} CFG {CFG_SCALE} in {unet_seconds['generation']:.3f} "
          f"s ({rate:.2f} samples/s) on {smi}")
    dit_config = load_config(DIT_CONFIG)
    dit = random_model(dit_config, gen)
    with tempfile.TemporaryDirectory() as tmp:
        dit_launches, dit_report, dit_seconds = run_evaluate(
            "DiT bf16", dit, dit_config,
            ["--mixed_precision", "bf16", "--num_inference_steps",
             str(EVAL_DIT_STEPS), "--num_samples", str(EVAL_DIT_SAMPLES),
             "--batch_size", str(EVAL_DIT_SAMPLES)],
            scaled(bf16_counts(DIT_FORWARD), EVAL_DIT_STEPS), tmp)
    del dit
    return {"networks": networks, "unet_launches": unet_launches,
            "unet_seconds": unet_seconds, "unet_report": unet_report,
            "dit_launches": dit_launches, "dit_seconds": dit_seconds,
            "dit_report": dit_report}


# ------------------------------------------------------------------ serving
SERVE_SLOTS = 16  # `--batch_size`: the batched mode's batch, the engine's pool
SERVE_SEED = 11
SERVE_STAGGER_TICKS = 5  # the second solo request joins this many steps in
# the JAX bench leg's traffic (`bench.py` `_leg_serving`): single-image CFG
# requests from client threads, each waiting for its reply (a closed loop)
# the JAX bench leg sends 64 requests from 8 clients; 16 from 8 keep its
# shape (8 waiting clients, single images) in a quarter of the steps (cut
# from 32 to keep the script inside its time)
SERVE_REQUESTS, SERVE_CLIENTS = 8, 8
TOL_SERVE_BATCHED = 1e-6  # in [0, 1]: the same trajectory, bit-equal expected
TOL_SERVE_SLOT = 1e-5  # model space: one row of a pool, bit-equal expected


def http_request(address, method, path, body=None):
    conn = http.client.HTTPConnection(*address, timeout=600)
    conn.request(method, path, body=json.dumps(body) if body else None)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def serve_reference(model, config, noise, labels):
    """DDIM-50 CFG 3 of `model` from `noise` on labels `labels` (+1
    shifted), a fresh sampler from `config`: (images in model space, seconds
    with the card synchronised)."""
    ddim = factory.get_diffusion(dict(config, num_inference_steps=STEPS),
                                 "ddim")
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = ddim.sample_with_cfg(model, noise.shape,
                               torch.as_tensor(labels, device="cuda"),
                               cfg_scale=CFG_SCALE, init_noise=noise)
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def phase_serve_batched(ckpt, config, model, smi):
    """`serve`'s batched mode over real HTTP: a ThreadingHTTPServer on
    127.0.0.1, port 0, with the port's handler, `--batch_size 16`, DDIM-50,
    CFG 3. /healthz, then one npy request (its images against
    `sample_with_cfg` on the same seeded draw at batch 16) and one png
    request (decoded by `read_png`), each with exactly 50 forwards'
    launches. Returns the launches of one request and its seconds."""
    service = serve.SamplerService(
        str(ckpt), sampling_method="ddim", num_inference_steps=STEPS,
        batch_size=SERVE_SLOTS, device="cuda")
    print(f"serve batched: warm-up {service.warmup():.3f} s")
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0),
                                      serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever)
    thread.start()
    try:
        address = httpd.server_address
        status, _, data = http_request(address, "GET", "/healthz")
        health = json.loads(data)
        if status != 200 or health["max_batch"] != SERVE_SLOTS:
            raise AssertionError(f"serve /healthz: {status} {health}")
        labels = [i % 10 for i in range(SERVE_SLOTS)]
        runs = {}
        for fmt in ("npy", "png"):
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            status, ctype, data = http_request(
                address, "POST", "/generate",
                {"num_samples": SERVE_SLOTS, "labels": labels,
                 "seed": SERVE_SEED, "cfg_scale": CFG_SCALE, "format": fmt})
            seconds = time.perf_counter() - start
            launches = read_launches()
            if status != 200:
                raise AssertionError(f"serve batched {fmt}: {status} {data}")
            if launches != scaled(UNET_FORWARD, STEPS):
                raise AssertionError(f"serve batched {fmt} launches "
                                     f"{launches}")
            runs[fmt] = (data, launches, seconds)
            print(f"serve batched {fmt}: {SERVE_SLOTS} images DDIM-{STEPS} "
                  f"CFG {CFG_SCALE} in {seconds:.3f} s over HTTP on {smi}; "
                  f"launches {launches}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    images = np.load(io.BytesIO(runs["npy"][0]))
    generator = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    noise = torch.randn((SERVE_SLOTS, 32, 32, 3), generator=generator,
                        device="cuda")
    ref, _ = serve_reference(model, config, noise,
                             np.asarray(labels) + 1)
    ref = np.clip((ref.cpu().numpy() + 1) / 2, 0, 1)
    err = float(np.abs(images - ref).max())
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "grid.png").write_bytes(runs["png"][0])
        grid = read_png(Path(tmp) / "grid.png")
    side = 4 * 32 + 5 * 2  # 4 x 4 images, padding 2
    print(f"serve batched npy against sample_with_cfg at batch "
          f"{SERVE_SLOTS} on the request's draw: max_abs {err:.3e} (bar "
          f"{TOL_SERVE_BATCHED:g}); png grid {grid.shape}")
    if not (images.shape == (SERVE_SLOTS, 32, 32, 3)
            and err <= TOL_SERVE_BATCHED and grid.shape == (side, side, 3)):
        raise AssertionError(f"serve batched: images {images.shape}, "
                             f"max_abs {err}, grid {grid.shape}")
    del service
    return runs["npy"][1], runs["npy"][2]


def pool_reference(model, config, requests):
    """The pool-shaped DDIM-50 CFG 3 trajectory with each request's noise
    and labels in its slots (the other rows zero noise, null label): each
    slot's row is what the engine owes that request."""
    noise = torch.zeros((SERVE_SLOTS, 32, 32, 3), device="cuda")
    labels = np.zeros(SERVE_SLOTS, np.int64)
    for slots, x, y in requests:
        noise[slots] = x
        labels[slots] = y
    return serve_reference(model, config, noise, labels)


def serve_traffic(engine, label, smi):
    """The bench leg's traffic: SERVE_REQUESTS single-image CFG 3 requests
    from SERVE_CLIENTS threads, labels (client + i) % 10 + 1, exactly one
    forward's launches a step. Returns the launches and the figures."""
    latencies, lock = [], threading.Lock()
    per_client = SERVE_REQUESTS // SERVE_CLIENTS

    def client(wid):
        rng = np.random.RandomState(1000 + wid)
        for i in range(per_client):
            x = rng.randn(1, 32, 32, 3).astype(np.float32)
            y = np.asarray([(wid + i) % 10 + 1])
            start = time.perf_counter()
            out = engine.submit(x, y, cfg_scale=CFG_SCALE, timeout=600)
            seconds = time.perf_counter() - start
            if not (out.shape == (1, 32, 32, 3) and np.isfinite(out).all()):
                raise AssertionError(f"{label}: a request returned "
                                     f"{out.shape}")
            with lock:
                latencies.append(seconds)

    ticks = engine.ticks
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(w,))
               for w in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    launches = read_launches()
    steps = engine.ticks - ticks
    if len(latencies) != SERVE_REQUESTS:
        raise AssertionError(f"{label}: {len(latencies)} of "
                             f"{SERVE_REQUESTS} requests answered")
    latencies.sort()
    figures = {"p50_ms": 1e3 * latencies[len(latencies) // 2],
               "p99_ms": 1e3 * latencies[min(len(latencies) - 1,
                                             int(len(latencies) * 0.99))],
               "images_per_s": SERVE_REQUESTS / wall, "wall_s": wall,
               "steps": steps, "ms_per_step": 1e3 * wall / steps}
    print(f"{label}: {SERVE_REQUESTS} single-image requests from "
          f"{SERVE_CLIENTS} clients, {SERVE_SLOTS} slots, DDIM-{STEPS} CFG "
          f"{CFG_SCALE}: p50 {figures['p50_ms']:.1f} ms, p99 "
          f"{figures['p99_ms']:.1f} ms ({SERVE_REQUESTS} samples), "
          f"{figures['images_per_s']:.2f} images/s, {steps} steps in "
          f"{wall:.3f} s ({figures['ms_per_step']:.2f} ms a step); launches "
          f"{launches}; on {smi}")
    return launches, figures


def phase_serve_continuous(ckpt, config, model, precision, smi, gen):
    """`serve --continuous` (16 slots, DDIM-50, CFG 3, one step a tick) in
    `precision`: 16 images in one submit against `sample_with_cfg` at batch
    16 on the same noise; two single-image requests admitted
    SERVE_STAGGER_TICKS steps apart, each against its row of a pool-shaped
    `sample_with_cfg`; then `serve_traffic`, beside the whole-trajectory
    comparator's time (16 images in one batch). Every step exactly one
    forward's launches (in the bf16 forms under bf16)."""
    bf16 = precision == "bf16"
    label = f"serve continuous {precision}"
    per_forward = UNET_FORWARD_BF16 if bf16 else UNET_FORWARD
    service = serve.SamplerService(
        str(ckpt), sampling_method="ddim", num_inference_steps=STEPS,
        batch_size=SERVE_SLOTS, continuous=True, steps_per_tick=1,
        mixed_precision=precision, device="cuda")
    engine = service.engine
    if bf16:
        model = factory.get_model(dict(config, mixed_precision="bf16")).to(
            "cuda").eval()
        model.load_state_dict(service.model.state_dict())
    try:
        print(f"{label}: warm-up {service.warmup():.3f} s")
        # 16 images in one submit, against sample_with_cfg at batch 16
        noise = torch.randn((SERVE_SLOTS, 32, 32, 3), generator=gen,
                            device="cuda")
        labels = np.arange(SERVE_SLOTS) % 10 + 1
        ticks = engine.ticks
        torch.cuda.synchronize()
        reset_launches()
        out = engine.submit(noise, labels, cfg_scale=CFG_SCALE, timeout=600)
        launches = read_launches()
        steps = engine.ticks - ticks
        ref, batch_seconds = serve_reference(model, config, noise, labels)
        ref = ref.cpu().numpy()
        # bf16: one bf16 step at the largest value (the pool stays float32)
        tol = (torch.finfo(torch.bfloat16).eps * float(np.abs(ref).max())
               if bf16 else TOL_SERVE_SLOT)
        err = float(np.abs(out - ref).max())
        print(f"{label}: {SERVE_SLOTS} images in one submit against "
              f"sample_with_cfg at batch {SERVE_SLOTS}: max_abs {err:.3e} "
              f"(bar {tol:.3e}); launches {launches}")
        if not (steps == STEPS and launches == scaled(per_forward, STEPS)
                and err <= tol):
            raise AssertionError(f"{label} full pool: {steps} steps, "
                                 f"launches {launches}, max_abs {err}")
        # two single-image requests, the second SERVE_STAGGER_TICKS steps in
        with engine._lock:  # slots are taken from the end of the free list
            slot_a, slot_b = engine._free[-1], engine._free[-2]
        xa, xb = (torch.randn((1, 32, 32, 3), generator=gen, device="cuda")
                  for _ in range(2))
        results = {}

        def submit(name, x, y):
            start = time.perf_counter()
            results[name] = engine.submit(x, np.asarray([y]),
                                          cfg_scale=CFG_SCALE, timeout=600)
            results[name + "_s"] = time.perf_counter() - start

        start_ticks = engine.ticks
        first = threading.Thread(target=submit, args=("a", xa, 3))
        first.start()
        while (engine.ticks < start_ticks + SERVE_STAGGER_TICKS
               and first.is_alive()):
            time.sleep(0.001)
        joined = engine.ticks - start_ticks
        submit("b", xb, 8)
        first.join()
        ref, _ = pool_reference(model, config, [([slot_a], xa, 3),
                                                ([slot_b], xb, 8)])
        ref = ref.cpu().numpy()
        errs = [float(np.abs(results[n] - ref[[s]]).max())
                for n, s in (("a", slot_a), ("b", slot_b))]
        print(f"{label}: solo request in an idle pool {results['a_s']:.3f} "
              f"s, the second joined {joined} steps later "
              f"({results['b_s']:.3f} s); each against its row of a "
              f"pool-shaped sample_with_cfg: "
              f"max_abs {errs[0]:.3e}, {errs[1]:.3e} (bar {tol:.3e}); on "
              f"{smi}")
        if not (joined >= SERVE_STAGGER_TICKS and max(errs) <= tol):
            raise AssertionError(f"{label} staggered: joined after {joined}"
                                 f" steps, max_abs {errs}")
        launches, figures = serve_traffic(engine, label, smi)
    finally:
        service.close()
    if launches != scaled(per_forward, figures["steps"]):
        raise AssertionError(f"{label} traffic launches {launches}, expected "
                             f"{scaled(per_forward, figures['steps'])}")
    figures["batch_ms"] = 1e3 * batch_seconds
    figures["solo_s"] = results["a_s"]
    print(f"{label}: whole-trajectory comparator, {SERVE_SLOTS} images in "
          f"one sample_with_cfg batch: {figures['batch_ms']:.1f} ms; on {smi}")
    return launches, figures


def phase_serve(ckpt, config, model, gen, smi):
    """The serving daemon on the fp32 UNet checkpoint `ckpt` of `model`:
    batched mode over HTTP, continuous mode in fp32 and in bf16."""
    batched_launches, batched_seconds = phase_serve_batched(ckpt, config,
                                                            model, smi)
    continuous = {precision: phase_serve_continuous(ckpt, config, model,
                                                    precision, smi, gen)
                  for precision in ("none", "bf16")}
    return {"batched_launches": batched_launches,
            "batched_seconds": batched_seconds,
            "continuous_launches": continuous["none"][0],
            "continuous": continuous["none"][1],
            "continuous_bf16_launches": continuous["bf16"][0],
            "continuous_bf16": continuous["bf16"][1]}


# ------------------------------------------------------- latent diffusion
VAE_CONFIG = ROOT / "configs" / "cifar10_vae.py"
LATENT_CONFIG = ROOT / "configs" / "cifar10_latent_unet.py"
VAE_PARAMETERS = 2_385_227  # `eval_shape` of the JAX VAE at this config
# Launches of one VAE encode and of one decode (each five VAEResBlocks of two
# GroupNorm+SiLU and the output norm; one attention block at 16x16, 4 heads
# of 32), of a VAE train step (a forward through both, its backward), of one
# latent UNet forward (17 ResBlocks of two and the output norm; attention
# at 8x8 and 4x4) and of a latent train step (the frozen encoder under no
# gradient, then the UNet's forward and backward)
VAE_CODER = {"gn": 11, "attn": 1}
VAE_STEP = {"gn": 22, "attn": 2, "gn_bwd": 22, "attn_bwd": 2}
LATENT_FORWARD = {"gn": 35, "attn": 11}
LATENT_STEP = {"gn": 35 + 11, "attn": 11 + 1, "gn_bwd": 35, "attn_bwd": 11}
LATENT_EVAL_STEPS, LATENT_EVAL_SAMPLES = 20, 50
# The 80 decoded images of DDIM-50 through the kernels against the same
# run on the plain versions, in [0, 1]: 50 steps of float32 rounding
# differences of about 1e-6 relative a forward, through an unclamped latent
# trajectory and the decoder
TOL_LATENT_SAMPLES = 1e-3
LATENT_CLIENTS, LATENT_REQUESTS = 8, 16  # single-image requests, continuous


def coder_shapes(model, run):
    """The (C, H, W) that each GroupNorm+SiLU and each attention block of
    `model` sees in `run()`, recorded by forward pre-hooks."""
    gn, attn = [], []
    hooks = [m.register_forward_pre_hook(
                 lambda mod, args, acc=acc: acc.append(
                     tuple(args[0].shape[1:])))
             for acc, kind in ((gn, unet_mod.FusedGroupNormSiLU),
                               (attn, unet_mod.AttentionBlock))
             for m in model.modules() if isinstance(m, kind)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return gn, attn


def phase_latent_kernels(vae_gn, vae_attn, gen):
    """K1, K1b, K2 and K3 at the shapes this slice adds, float32 and bf16,
    against their plain versions: every GroupNorm+SiLU shape of the VAE at
    its training batch (C 64 at 32x32, eight channels a group; the
    decoder's 128 -> 64 transition) and its attention, 4 heads of d 32 at
    L 256. Returns the worst absolute errors."""
    worst = dict.fromkeys(("gn", "gn_bwd", "attn", "attn_bwd", "gn_bf16",
                           "gn_bwd_bf16", "attn_bf16"), 0.0)
    for c, h, w in sorted(set(vae_gn)):
        (fwd, bwd), _ = check_gn("latent: VAE gn_silu", TRAIN_BATCH, h, w,
                                     c, gen, timed=(c, h, w) == (64, 32, 32))
        worst["gn"], worst["gn_bwd"] = (max(worst["gn"], fwd),
                                        max(worst["gn_bwd"], bwd))
        (fwd, bwd), _ = check_gn_bf16("latent: VAE gn_silu bf16",
                                      TRAIN_BATCH, h, w, c, gen)
        worst["gn_bf16"] = max(worst["gn_bf16"], fwd)
        worst["gn_bwd_bf16"] = max(worst["gn_bwd_bf16"], bwd)
    (c, h, w), = set(vae_attn)
    bh, seq, d = TRAIN_BATCH * 4, h * w, c // 4
    worst["attn"] = check_attention_fwd("latent: VAE flash_attn_fwd", bh, seq,
                                        d, gen, timed=True)[0]
    worst["attn_bwd"] = check_attention_bwd(
        f"latent: VAE flash_attn_bwd BH={bh} L={seq} d={d}",
        attention_bwd_case(bh, seq, d, gen))[0]
    worst["attn_bf16"] = check_attention_bf16(
        "latent: VAE attention bf16", bh, seq, d, gen, timed=True)[0]
    return worst


def checked_sample(label, argv, expected, hw=(32, 32)):
    """`sample.main(argv)` with exactly `expected` launches and finite
    images of size `hw`; returns the result and the launches."""
    torch.cuda.synchronize()
    reset_launches()
    result = sample.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    samples = result["samples"]
    print(f"sample.main {label}: {len(samples)} images in "
          f"{result['sampling_seconds']:.3f} s "
          f"({len(samples) / result['sampling_seconds']:.2f} samples/s); "
          f"launches {launches}")
    if not (samples.shape[1:] == (*hw, 3) and np.isfinite(samples).all()
            and launches == expected):
        raise AssertionError(f"{label}: samples {samples.shape}, launches "
                             f"{launches}, expected {expected}")
    return result, launches


def phase_latent_sample(ckpt, config, tmp, gen, smi):
    """From the latent checkpoint through `sample.main`: 80 images DDIM-50
    with CFG at the config's scale (50 forwards and one decode), against
    the same call inside `plain_kernels()`; img2img at strength 0.5 (the
    init image encoded to its posterior mode, 25 forwards, one decode);
    `--mask` refused. Returns the launches and the seconds."""
    scale = config["cfg_scale"]
    argv = ["--checkpoint", str(ckpt), "--sampling_method", "ddim",
            "--num_inference_steps", str(STEPS), "--cfg_scale", str(scale),
            "--num_samples", str(SAMPLES), "--batch_size", str(SAMPLES),
            "--seed", "0", "--use_ema", "--device", "cuda",
            "--output_dir", str(Path(tmp) / "latent_samples")]
    result, launches = checked_sample(
        f"latent DDIM-{STEPS} CFG {scale}, decode included", argv,
        add_counts((LATENT_FORWARD, STEPS), (VAE_CODER, 1)))
    with plain_kernels():
        plain, _ = checked_sample(f"latent DDIM-{STEPS} CFG {scale} inside "
                                 "plain_kernels()", argv, expect())
    err = float(np.abs(result["samples"] - plain["samples"]).max())
    print(f"latent DDIM-{STEPS} CFG {scale}, {SAMPLES} decoded images: "
          f"kernels vs plain max_abs {err:.3e} in [0, 1] (bar "
          f"{TOL_LATENT_SAMPLES:g}); {SAMPLES / result['sampling_seconds']:.2f}"
          f" samples/s (plain {SAMPLES / plain['sampling_seconds']:.2f}) on "
          f"{smi}")
    if not err <= TOL_LATENT_SAMPLES:
        raise AssertionError(f"latent samples kernels vs plain: {err}")
    editing_inputs(tmp, gen)
    edit = ["--init_image", str(Path(tmp) / "init.png"), "--strength",
            str(EDIT_STRENGTH)]
    _, img2img = checked_sample(
        f"latent img2img strength {EDIT_STRENGTH}", argv + edit,
        add_counts((VAE_CODER, 2), (LATENT_FORWARD, int(STEPS * EDIT_STRENGTH))))
    try:
        sample.main(argv + edit + ["--mask", str(Path(tmp) / "mask.png")])
    except SystemExit as e:
        if "--mask is not supported with latent-diffusion" not in str(e):
            raise
        print(f"latent --mask refused: {e}")
    else:
        raise AssertionError("latent --mask was not refused")
    return {"sample": launches, "img2img": img2img,
            "seconds": result["sampling_seconds"],
            "plain_seconds": plain["sampling_seconds"]}


def phase_latent_serve(ckpt, smi):
    """`serve` on the latent checkpoint (16 rows or slots, DDIM-50, CFG 3):
    batched over HTTP, /healthz in pixels, a 16-image request against
    `sample_with_cfg` plus `decode` of the same seeded draw; `--continuous`
    over HTTP, a 16-image request against the same on its own draw, then
    LATENT_REQUESTS single-image requests from LATENT_CLIENTS threads, each
    decoded on its handler's thread while the engine steps. Exact launches
    (a forward a step, a decode a request). Returns the launches of each."""
    out = {}
    labels = [i % 10 for i in range(SERVE_SLOTS)]
    body = {"num_samples": SERVE_SLOTS, "labels": labels, "seed": SERVE_SEED,
            "cfg_scale": CFG_SCALE, "format": "npy"}
    for mode in ("batched", "continuous"):
        service = serve.SamplerService(
            str(ckpt), sampling_method="ddim", num_inference_steps=STEPS,
            batch_size=SERVE_SLOTS, continuous=mode == "continuous",
            device="cuda")
        print(f"latent serve {mode}: warm-up {service.warmup():.3f} s")
        httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0),
                                          serve.make_handler(service))
        thread = threading.Thread(target=httpd.serve_forever)
        thread.start()
        try:
            address = httpd.server_address
            status, _, data = http_request(address, "GET", "/healthz")
            if status != 200 or json.loads(data)["image_size"] != [32, 32]:
                raise AssertionError(f"latent serve /healthz: {status} {data}")
            ticks = service.engine.ticks if service.engine else 0
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            status, _, data = http_request(address, "POST", "/generate", body)
            seconds = time.perf_counter() - start
            launches = read_launches()
            steps = (service.engine.ticks - ticks if service.engine
                     else STEPS)
            if status != 200:
                raise AssertionError(f"latent serve {mode}: {status} {data}")
            images = np.load(io.BytesIO(data))
            shape = (SERVE_SLOTS, *service.image_hw, service.channels)
            with torch.no_grad():
                noise = service.initial_noise(shape, SERVE_SEED)
                ref = service.codec.decode(service.diffusion.sample_with_cfg(
                    service.model, shape,
                    torch.as_tensor(np.asarray(labels) + 1, device="cuda"),
                    cfg_scale=CFG_SCALE, init_noise=noise))
            ref = np.clip((ref.cpu().numpy() + 1) / 2, 0, 1)
            err = float(np.abs(images - ref).max())
            tol = TOL_SERVE_BATCHED if mode == "batched" else TOL_SERVE_SLOT
            print(f"latent serve {mode}: {SERVE_SLOTS} images DDIM-{STEPS} CFG "
                  f"{CFG_SCALE} in {seconds:.3f} s over HTTP; against "
                  f"sample_with_cfg + decode of the same draw: max_abs "
                  f"{err:.3e} (bar {tol:g}); launches {launches} on {smi}")
            expected = add_counts((LATENT_FORWARD, steps), (VAE_CODER, 1))
            if not (images.shape == (SERVE_SLOTS, 32, 32, 3) and err <= tol
                    and steps == STEPS and launches == expected):
                raise AssertionError(f"latent serve {mode}: {images.shape}, "
                                     f"max_abs {err}, {steps} steps, "
                                     f"launches {launches}")
            out[mode] = launches
            if mode == "continuous":
                out["traffic"] = latent_traffic(service, address, smi)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()
            service.close()
    return out


def latent_traffic(service, address, smi):
    """LATENT_REQUESTS single-image requests over HTTP from LATENT_CLIENTS
    threads to the continuous server: every answer 200 and finite, a
    forward's launches each engine step and a decode's each request."""
    latencies, errors, lock = [], [], threading.Lock()

    def client(wid):
        for i in range(LATENT_REQUESTS // LATENT_CLIENTS):
            start = time.perf_counter()
            status, _, data = http_request(
                address, "POST", "/generate",
                {"num_samples": 1, "labels": [(wid + i) % 10],
                 "seed": 100 * wid + i, "format": "npy"})
            seconds = time.perf_counter() - start
            with lock:
                if status != 200:
                    errors.append((status, data))
                    continue
                image = np.load(io.BytesIO(data))
                if not (image.shape == (1, 32, 32, 3)
                        and np.isfinite(image).all()):
                    errors.append(image.shape)
                latencies.append(seconds)

    ticks = service.engine.ticks
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(w,))
               for w in range(LATENT_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    launches = read_launches()
    steps = service.engine.ticks - ticks
    expected = add_counts((LATENT_FORWARD, steps),
                          (VAE_CODER, LATENT_REQUESTS))
    latencies.sort()
    print(f"latent serve continuous: {LATENT_REQUESTS} single-image requests "
          f"from {LATENT_CLIENTS} clients over HTTP in {wall:.3f} s "
          f"({LATENT_REQUESTS / wall:.2f} images/s, p50 "
          f"{1e3 * latencies[len(latencies) // 2]:.1f} ms), {steps} steps; "
          f"launches {launches} on {smi}")
    if errors or len(latencies) != LATENT_REQUESTS or launches != expected:
        raise AssertionError(f"latent traffic: errors {errors}, launches "
                             f"{launches}, expected {expected}")
    return launches


def phase_latent(gen, smi):
    """The two-stage pipeline of configs/cifar10_vae.py and
    configs/cifar10_latent_unet.py at full width on the fixtures: a VAE
    forward and the kernels at the VAE's shapes against the plain versions;
    `train` of the VAE (TRAIN_EPOCHS one-batch epochs at 128, its
    reconstruction grid at the last); `compute_latent_scale` on its
    checkpoint; `train` of the latent UNet from a copy of its config naming
    that checkpoint and scale; `sample`, `evaluate` and `serve` from the
    latent checkpoint. Exact launches throughout. Returns the figures."""
    start = time.perf_counter()
    vae_config = dict(load_config(VAE_CONFIG), image_size=(32, 32))
    torch.manual_seed(0)
    vae = factory.get_model(vae_config).to("cuda").eval()
    n_vae = sum(p.numel() for p in vae.parameters())
    x = torch.rand(CHECK_BATCH, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    noise = torch.randn(CHECK_BATCH, 16, 16, 4, generator=gen, device="cuda")
    vae_gn, vae_attn = coder_shapes(vae, lambda: vae(x, noise))
    calls = {"gn": len(vae_gn), "attn": len(vae_attn)}
    with torch.no_grad():
        out = vae(x, noise)
        with plain_kernels():
            ref = vae(x, noise)
    torch.cuda.synchronize()
    rels = [max_rel(a, b) for a, b in zip(out, ref)]
    print(f"latent: VAE ({n_vae} parameters) forward B={CHECK_BATCH}, "
          f"{calls} calls an encode and a decode: reconstruction, mean, "
          f"logvar kernels vs plain max_rel {' '.join(f'{r:.3e}' for r in rels)}")
    if not (n_vae == VAE_PARAMETERS and max(rels) <= TOL_UNET
            and calls == {k: 2 * n for k, n in VAE_CODER.items()}):
        raise AssertionError(f"VAE: {n_vae} parameters, calls {calls}, "
                             f"max_rel {rels}")
    del vae, out, ref
    worst = phase_latent_kernels(vae_gn, vae_attn, gen)

    with tempfile.TemporaryDirectory() as tmp:
        for stage in ("vae", "latent"):
            (Path(tmp) / stage).mkdir()
        vae_trainer, vae_launches = run_train_main(
            "VAE", vae_config, VAE_STEP, Path(tmp) / "vae", TRAIN_EPOCHS, 1,
            extra=((VAE_CODER, 2),), sample_start_epoch=TRAIN_EPOCHS,
            sample_interval=TRAIN_EPOCHS)
        grid = vae_trainer.sample_dir / f"vae_epoch_{TRAIN_EPOCHS:04d}.png"
        if not grid.is_file():
            raise AssertionError(f"VAE: {grid} was not written")
        vae_rates, vae_peak = timed_rates("VAE", vae_trainer)
        vae_ckpt = vae_trainer.save_dir / "current_model.pth"
        del vae_trainer

        latent_config = dict(load_config(LATENT_CONFIG), image_size=(32, 32),
                             vae_checkpoint=str(vae_ckpt),
                             data_root=str(FIXTURE_DATA))
        cfg_path = Path(tmp) / "latent_scale_config.py"
        cfg_path.write_text(f"config = {latent_config!r}\n")
        torch.cuda.synchronize()
        reset_launches()
        scale = compute_latent_scale.main(["--config", str(cfg_path),
                                           "--batches", "1", "--device",
                                           "cuda"])
        launches = read_launches()
        print(f"compute_latent_scale on the VAE's checkpoint: {scale}; "
              f"launches {launches}")
        if not (math.isfinite(scale["latent_scale_factor"])
                and scale["latent_scale_factor"] > 0
                and launches == scaled(VAE_CODER, 1)):
            raise AssertionError(f"latent scale {scale}, launches {launches}")
        latent_config["latent_scale_factor"] = scale["latent_scale_factor"]

        latent_trainer, latent_launches = run_train_main(
            "latent UNet", latent_config, LATENT_STEP, Path(tmp) / "latent",
            TRAIN_EPOCHS, 1)
        n_latent = sum(p.numel() for p in latent_trainer.model.parameters())
        print(f"latent UNet: {n_latent} parameters on "
              f"{latent_trainer.image_size} x {latent_trainer.in_channels} "
              "latents")
        latent_rates, latent_peak = timed_rates("latent UNet", latent_trainer)
        ckpt = latent_trainer.save_dir / "current_model.pth"
        model = latent_trainer.model.eval()
        del latent_trainer

        sampled = phase_latent_sample(ckpt, latent_config, tmp, gen, smi)
        evaluated, _, eval_seconds = run_evaluate(
            "latent UNet", model, latent_config,
            ["--num_inference_steps", str(LATENT_EVAL_STEPS),
             "--num_samples", str(LATENT_EVAL_SAMPLES), "--batch_size",
             str(LATENT_EVAL_SAMPLES)],
            add_counts((LATENT_FORWARD, LATENT_EVAL_STEPS), (VAE_CODER, 1)),
            tmp)
        del model
        served = phase_latent_serve(ckpt, smi)
    seconds = time.perf_counter() - start
    rate = statistics.median
    print(f"latent: VAE ({n_vae} parameters) {rate(vae_rates['kernels']):.2f} "
          f"train images/s at batch {TRAIN_BATCH} (plain versions "
          f"{rate(vae_rates['plain']):.2f}), peak {vae_peak / 2**20:.1f} MiB; "
          f"latent UNet ({n_latent} parameters) "
          f"{rate(latent_rates['kernels']):.2f} train images/s (plain "
          f"{rate(latent_rates['plain']):.2f}), peak "
          f"{latent_peak / 2**20:.1f} MiB; DDIM-{STEPS} CFG "
          f"{latent_config['cfg_scale']} {SAMPLES / sampled['seconds']:.2f} "
          f"samples/s decoded (plain "
          f"{SAMPLES / sampled['plain_seconds']:.2f}); evaluate stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in eval_seconds.items())
          + f"; phase {seconds:.1f} s; on {smi}")
    return {"worst": worst, "launches": {
        "latent_vae_train": vae_launches, "latent_train": latent_launches,
        "latent_sample": sampled["sample"],
        "latent_img2img": sampled["img2img"], "latent_evaluate": evaluated,
        "latent_serve": served["batched"],
        "latent_serve_continuous": add_counts((served["continuous"], 1),
                                              (served["traffic"], 1))}}


CLASSIFIER_CONFIG = ROOT / "configs" / "cifar10_classifier.py"
SR_CONFIG = ROOT / "configs" / "celeba64_sr_unet.py"
# Launches of one classifier forward (six ResidualBlocks of two
# GroupNorm+SiLU and the output norm; an attention block after each of the
# two blocks at 8x8, 4 heads of 32 at L 64) and of its train step
CLASSIFIER_FORWARD = {"gn": 13, "attn": 2}
CLASSIFIER_STEP = dict(CLASSIFIER_FORWARD, gn_bwd=13, attn_bwd=2)
# The config's batch, for the gradients and the rates; `train.main` on the
# fixtures takes one batch of 128 an epoch (200 images make no batch of 256)
CLASSIFIER_BATCH = 256
GUIDANCE_SCALE = 2.0
# One guided model call: the UNet on the fused CFG batch of 2B rows, then
# the classifier's forward and its backward to x on the first B rows
GUIDED_CALL = dict(UNET_FORWARD, gn=GN_PER_FORWARD + 13,
                   attn=ATTN_PER_FORWARD + 2, gn_bwd=13, attn_bwd=2)
GUIDED_CHECK_STEPS = 10  # the 16-image runs: scale 0 against unguided
# The SR stage's batches tried, largest first (the config's 256), and the
# images of its `sample` and cascade runs
SR_BATCHES = (256, 128, 64)
SR_SAMPLES, SR_STEPS = 16, 10


def classifier_loss_and_grads(model, batch):
    """The cross-entropy of one batch of noisy images and every
    parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(batch["x_t"], batch["t"]), batch["y"])
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def phase_classifier(gen, smi, tmp):
    """configs/cifar10_classifier.py at full width: K1, K1b, K2 and K3 at
    every shape of its forward at its batch of 256 and at the 80 rows of
    guided sampling (`shape_kernels`); the loss and every gradient of one
    step at 256 through the kernels against `plain_kernels()` (13 K1 + 2 K2
    + 13 K1b + 2 K3, none inside); three
    one-batch epochs of `train` on the fixtures; train images/s at 256 with
    the kernels and the plain versions, and the peak memory. Returns the
    checkpoint, the launches and the figures."""
    config = dict(load_config(CLASSIFIER_CONFIG), image_size=(32, 32))
    tmp = Path(tmp) / "classifier"
    tmp.mkdir()
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    b = CLASSIFIER_BATCH
    batch = {"x_t": torch.randn(b, 32, 32, 3, generator=gen, device="cuda"),
             "t": torch.randint(0, 1000, (b,), generator=gen, device="cuda"),
             "y": torch.randint(0, 10, (b,), generator=gen, device="cuda")}
    gn_shapes, attn_shapes = coder_shapes(
        model, lambda: model(batch["x_t"][:2], batch["t"][:2]))
    calls = {"gn": len(gn_shapes), "attn": len(attn_shapes)}
    if calls != CLASSIFIER_FORWARD:
        raise AssertionError(f"classifier forward calls {calls}")
    # the training batch, and the guided sampling's 80 rows
    worst = {}
    for label, rows in (("classifier", b), ("guided classifier", SAMPLES)):
        got, _ = shape_kernels(label, gn_shapes, attn_shapes, rows, gen)
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in got.items()}
    reset_launches()
    loss, grads = classifier_loss_and_grads(model, batch)
    torch.cuda.synchronize()
    launched = read_launches()
    with plain_kernels():
        reset_launches()
        loss_ref, grads_ref = classifier_loss_and_grads(model, batch)
        torch.cuda.synchronize()
        plain_launched = read_launches()
    flat = torch.cat([g.flatten() for g in grads.values()])
    flat_ref = torch.cat([g.flatten() for g in grads_ref.values()])
    loss_rel, grad_rel = max_rel(loss, loss_ref), max_rel(flat, flat_ref)
    no_grad = [n for n, g in grads.items() if not g.any()]
    print(f"classifier ({n_params} parameters) loss and gradients B={b}, "
          f"kernels vs plain: cross-entropy {loss.item():.6f} max_rel "
          f"{loss_rel:.3e}, flattened gradient max_abs_diff/max_abs "
          f"{grad_rel:.3e}; launches {launched}, inside plain_kernels "
          f"{plain_launched}")
    if not (launched == expect(**CLASSIFIER_STEP)
            and not any(plain_launched.values()) and loss_rel <= TOL_LOSS
            and grad_rel <= TOL_GRAD and not no_grad):
        raise AssertionError(f"classifier step: launches {launched}, plain "
                             f"{plain_launched}, loss {loss_rel}, gradient "
                             f"{grad_rel}, zero gradients {no_grad}")
    del model, grads, grads_ref
    trainer, launches = run_train_main(
        "classifier", dict(config, batch_size=TRAIN_BATCH), CLASSIFIER_STEP,
        tmp, TRAIN_EPOCHS, 1)
    pairs = []  # the fixtures give one batch of 128 an epoch: two epochs'
    for epoch in range(b // TRAIN_BATCH):
        trainer.train_loader.set_epoch(TRAIN_EPOCHS + 1 + epoch)
        pairs.append(next(iter(trainer.train_loader)))
    images = torch.from_numpy(np.concatenate([p[0] for p in pairs])).cuda()
    labels = torch.from_numpy(np.concatenate([p[1] for p in pairs])).cuda()
    rates, peak = timed_rates("classifier", trainer, (images, labels))
    return {"ckpt": trainer.save_dir / "current_model.pth",
            "launches": launches, "rates": rates, "peak": peak,
            "params": n_params, "worst": worst}


def phase_guided(unet_ckpt, classifier_ckpt, tmp, gen, smi):
    """Classifier guidance from the trained UNet's checkpoint and the
    classifier's (one schedule): a guided DDIM-10 CFG trajectory of 8 images
    against `plain_kernels()` (without the x0 clamp; with it printed), then
    through `sample.main` 80 images DDIM-50 CFG 3 unguided and with
    `--classifier_checkpoint --classifier_scale 2` (a guided call: the
    UNet's forward on 2B rows, the classifier's forward and backward on B,
    K1b and K3 inside the sampler's no_grad), and 16 images DDIM-10 at
    scale 0 equal to the unguided run bit for bit. Returns the launches and
    the seconds."""
    payload = checkpoint.load_checkpoint(unet_ckpt)
    config = dict(payload["config"], num_inference_steps=TRAJ_STEPS)
    unet = factory.load_model_for_inference(payload, config, True, "cuda")
    cls_payload = checkpoint.load_checkpoint(classifier_ckpt)
    classifier = factory.load_model_for_inference(
        cls_payload, cls_payload["config"], True, "cuda").requires_grad_(False)
    targets = torch.arange(8, device="cuda") % 10
    x = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    for clip in (False, True):
        ddim = factory.get_diffusion(dict(config, clip_sample=clip), "ddim")

        def run(init, ddim=ddim):
            fn = classifier_guided_model_fn(unet, classifier, targets,
                                            GUIDANCE_SCALE, ddim.schedule)
            return ddim.sample_with_cfg(fn, init.shape, targets + 1,
                                        cfg_scale=CFG_SCALE, init_noise=init)
        phase_knob_trajectory(
            f"classifier guidance scale {GUIDANCE_SCALE} DDIM-{TRAJ_STEPS} "
            f"CFG {CFG_SCALE}, x0 clamp {'on' if clip else 'off'}", run, x,
            checked=not clip)
    del unet, classifier
    argv = ["--checkpoint", str(unet_ckpt), "--sampling_method", "ddim",
            "--cfg_scale", str(CFG_SCALE), "--seed", "0", "--use_ema",
            "--device", "cuda", "--output_dir", str(Path(tmp) / "guided")]
    guide = ["--classifier_checkpoint", str(classifier_ckpt),
             "--classifier_scale", str(GUIDANCE_SCALE)]
    full = ["--num_inference_steps", str(STEPS), "--num_samples",
            str(SAMPLES), "--batch_size", str(SAMPLES)]
    plain_run, _ = checked_sample(f"unguided DDIM-{STEPS} CFG {CFG_SCALE}",
                                 argv + full, scaled(UNET_FORWARD, STEPS))
    guided, launches = checked_sample(
        f"classifier-guided scale {GUIDANCE_SCALE} DDIM-{STEPS} CFG "
        f"{CFG_SCALE}", argv + full + guide, scaled(GUIDED_CALL, STEPS))
    short = ["--num_inference_steps", str(GUIDED_CHECK_STEPS),
             "--num_samples", "16", "--batch_size", "16"]
    unguided, _ = checked_sample("unguided, 16 images", argv + short,
                                scaled(UNET_FORWARD, GUIDED_CHECK_STEPS))
    zero, _ = checked_sample(
        "classifier scale 0, 16 images",
        argv + short + guide[:2] + ["--classifier_scale", "0"],
        scaled(GUIDED_CALL, GUIDED_CHECK_STEPS))
    if not np.array_equal(zero["samples"], unguided["samples"]):
        raise AssertionError("--classifier_scale 0 differs from the "
                             "unguided run")
    moved = float(np.abs(guided["samples"] - plain_run["samples"]).max())
    print(f"classifier guidance: scale 0 equals the unguided run bit for "
          f"bit; scale {GUIDANCE_SCALE} moved the 80 samples by max_abs "
          f"{moved:.3e} in [0, 1]; DDIM-{STEPS} CFG {CFG_SCALE} "
          f"{SAMPLES / guided['sampling_seconds']:.2f} samples/s guided, "
          f"{SAMPLES / plain_run['sampling_seconds']:.2f} unguided; on {smi}")
    if not moved > 0:
        raise AssertionError("the guidance did not move the samples")
    return {"launches": launches, "seconds": guided["sampling_seconds"],
            "unguided_seconds": plain_run["sampling_seconds"]}


class Conditioned(torch.nn.Module):
    """An SR model on [x ; cond], as `utils.sr.wrap_model_fn` calls it,
    with the model's parameters as its own."""

    def __init__(self, model, cond):
        super().__init__()
        self.model, self.cond = model, cond

    def forward(self, x, t, y=None):
        return sr.wrap_model_fn(self.model, self.cond)(x, t, y)


def sr_batch(model, config, gen):
    """The largest of SR_BATCHES whose train step (forward and backward at
    64x64) fits on the card."""
    process = factory.get_diffusion(config)
    model.train()
    for batch in SR_BATCHES:
        try:
            x = torch.rand(batch, 64, 64, 3, generator=gen, device="cuda")
            cond = sr.make_condition(sr.SRSpec(2), (64, 64), hr_images=x)
            loss = process.p_losses(Conditioned(model, cond), x,
                                    torch.zeros(batch, dtype=torch.int64,
                                                device="cuda"),
                                    torch.randn_like(x))
            loss.backward()
            torch.cuda.synchronize()
            print(f"SR: a train step at batch {batch} fits")
            return batch
        except torch.cuda.OutOfMemoryError:
            print(f"SR: a train step at batch {batch} does not fit")
        finally:
            model.zero_grad(set_to_none=True)
            loss = x = cond = None
            torch.cuda.empty_cache()
    raise AssertionError(f"SR: no batch of {SR_BATCHES} fits")


def shape_kernels(label, gn_shapes, attn_shapes, batch, gen):
    """K1 and K1b at every GroupNorm+SiLU (C, H, W) of `gn_shapes` at
    `batch` (timed, with its bound, where the kernels take their generic
    form, a group beyond shared memory), and K2, K3 at each attention
    (C, H, W) of `attn_shapes` (4 heads of C / 4), timed beside
    `F.scaled_dot_product_attention` with their bounds. Returns the worst
    absolute errors and the times."""
    worst = dict.fromkeys(("gn", "gn_bwd", "attn", "attn_bwd"), 0.0)
    times = {}
    for c, h, w in sorted(set(gn_shapes)):
        form = fused_norm.kernel_form((batch, h, w, c), 8)
        timed = "generic" in form
        (fwd, bwd), t = check_gn(f"{label} gn_silu", batch, h, w, c, gen,
                                 timed=timed)
        worst["gn"], worst["gn_bwd"] = (max(worst["gn"], fwd),
                                        max(worst["gn_bwd"], bwd))
        if timed:
            bound = Bound().add(*gn_work(batch, h, w, c))
            bound_bwd = Bound().add(*gn_bwd_work(batch, h, w, c))
            times[("gn", c, h, w)] = dict(t, bound=bound.ms,
                                          bound_bwd=bound_bwd.ms)
            print(f"  bound of B={batch} {h}x{w}x{c}: forward {bound.ms:.4f}"
                  f" ms ({bound.keys()['bound_by']}), backward "
                  f"{bound_bwd.ms:.4f} ms")
    for c, h, w in sorted(set(attn_shapes)):
        bh, seq, d = batch * 4, h * w, c // 4
        err, t = check_attention_fwd(f"{label} flash_attn_fwd", bh, seq, d,
                                     gen, timed=True)
        worst["attn"] = max(worst["attn"], err)
        err_b, ms, plain, library = check_attention_bwd(
            f"{label} flash_attn_bwd BH={bh} L={seq} d={d}",
            attention_bwd_case(bh, seq, d, gen))
        worst["attn_bwd"] = max(worst["attn_bwd"], err_b)
        bound = Bound().add(*attn_work(bh, seq, d))
        bound_bwd = Bound().add(*attn_work(bh, seq, d, backward=True))
        times[("attn", seq, d)] = dict(t, bwd=ms, bwd_plain=plain,
                                       bwd_library=library, bound=bound.ms,
                                       bound_bwd=bound_bwd.ms)
        print(f"  bound of BH={bh} L={seq} d={d}: forward {bound.ms:.4f} ms "
              f"({bound.keys()['bound_by']}), backward {bound_bwd.ms:.4f} ms "
              f"({bound_bwd.keys()['bound_by']})")
    return worst, times


def phase_sr(unet_ckpt, tmp, gen, smi):
    """configs/celeba64_sr_unet.py at full width on the `synthetic` dataset
    at 64x64 (6 channels in: x_t and the upsampled 32x32 condition): the
    largest batch of SR_BATCHES whose step fits; the kernels at every shape
    of that step (`shape_kernels`); the loss and gradients at the check
    batch against `plain_kernels()`; one epoch of `train` (45 K1 + 11 K2 +
    45 K1b + 11 K3 a step), train images/s and peak memory; `sample
    --sr_source` on a PNG written here; the two-stage cascade
    (`tools/cascade.py`) from the trained 32x32 UNet to 64x64. Returns the
    launches and the figures."""
    config = dict(load_config(SR_CONFIG), dataset="synthetic",
                  image_size=(64, 64))
    tmp = Path(tmp) / "sr"
    tmp.mkdir()
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    batch = sr_batch(model, config, gen)
    model.eval()
    probe = torch.zeros(2, 64, 64, 6, device="cuda")
    gn_shapes, attn_shapes = coder_shapes(
        model, lambda: model(probe, torch.zeros(2, dtype=torch.int64,
                                                device="cuda")))
    calls = {"gn": len(gn_shapes), "attn": len(attn_shapes)}
    print(f"SR UNet ({n_params} parameters): {calls} calls a forward; "
          f"GroupNorm+SiLU shapes {sorted(set(gn_shapes))}, attention "
          f"{sorted(set(attn_shapes))}")
    if calls != UNET_FORWARD:
        raise AssertionError(f"SR forward calls {calls}")
    worst, times = shape_kernels("SR", gn_shapes, attn_shapes, batch, gen)
    x0 = torch.rand(CHECK_BATCH, 64, 64, 3, generator=gen,
                    device="cuda") * 2 - 1
    cond = sr.make_condition(sr.SRSpec(2, 0.1), (64, 64), hr_images=x0,
                             generator=gen)
    phase_train_grads(
        "SR UNet", Conditioned(model, cond), config, UNET_STEP, gen,
        batch={"x0": x0,
               "t": torch.randint(0, 1000, (CHECK_BATCH,), generator=gen,
                                  device="cuda"),
               "noise": torch.randn(x0.shape, generator=gen, device="cuda"),
               "y": None})
    del model, cond
    trainer, train_launches = run_train_main(
        "SR UNet", dict(config, batch_size=batch), UNET_STEP, tmp, 1,
        SYNTHETIC_IMAGES // batch)
    # the kernel path only: the plain versions' timed run was cut to keep the
    # script inside its time
    rates, peak = timed_rates("SR UNet", trainer, plain_runs=0,
                              kernel_runs=1)
    ckpt = trainer.save_dir / "current_model.pth"
    del trainer

    png = Path(tmp) / "lr.png"
    write_png(png, (torch.rand(32, 32, 3, generator=gen, device="cuda")
                    * 255).byte().cpu().numpy())
    _, sample_launches = checked_sample(
        f"SR --sr_source DDIM-{SR_STEPS}",
        ["--checkpoint", str(ckpt), "--sr_source", str(png),
         "--sampling_method", "ddim", "--num_inference_steps", str(SR_STEPS),
         "--num_samples", str(SR_SAMPLES), "--batch_size", str(SR_SAMPLES),
         "--use_ema", "--device", "cuda", "--output_dir",
         str(Path(tmp) / "sr_samples")],
        scaled(UNET_FORWARD, SR_STEPS), hw=(64, 64))

    out = Path(tmp) / "cascade"
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    stages = cascade.main([
        "--base_checkpoint", str(unet_ckpt), "--sr_checkpoint", str(ckpt),
        "--num_samples", str(SR_SAMPLES), "--batch_size", str(SR_SAMPLES),
        "--cfg_scale", str(CFG_SCALE), "--num_inference_steps",
        str(SR_STEPS), "--sr_num_inference_steps", str(SR_STEPS),
        "--use_ema", "--device", "cuda", "--output_dir", str(out)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    cascade_launches = read_launches()
    shapes = [s.shape for s in stages]
    print(f"cascade 32x32 UNet -> 64x64 SR stage: {SR_SAMPLES} images, "
          f"DDIM-{SR_STEPS} each (CFG {CFG_SCALE} at the base) in "
          f"{seconds:.3f} s; shapes {shapes}; launches {cascade_launches}")
    if not (shapes == [(SR_SAMPLES, 32, 32, 3), (SR_SAMPLES, 64, 64, 3)]
            and all(np.isfinite(s).all() for s in stages)
            and cascade_launches == scaled(UNET_FORWARD, 2 * SR_STEPS)
            and all((out / f"cascade_stage{k}.png").is_file()
                    for k in (0, 1))):
        raise AssertionError(f"cascade: shapes {shapes}, launches "
                             f"{cascade_launches}")
    return {"worst": worst, "times": times, "batch": batch, "rates": rates,
            "peak": peak, "params": n_params,
            "launches": {"sr_train": train_launches,
                         "sr_sample": sample_launches,
                         "cascade": cascade_launches}}


# ---------------------------------- Mixture-of-Experts, token merging, int8
MOE_CONFIG = ROOT / "configs" / "cifar10_dit_moe.py"
# the dense DiT's parameters and, in each of the 12 blocks, a router and 8
# experts in place of the MLP: 8,274,056 more a block
MOE_PARAMS = 32_573_964 + 12 * 8_274_056
MOE_AUX_WEIGHT = 0.01  # the config's moe_aux_weight
TOME_RATIO = 0.5
# ToMe at 0.5 and 0.3 merges the DiT's 256 tokens to 128 and 179; the
# sampling batch's 160 rows of 6 heads
TOME_LENGTHS = (128, 179)
TOME_BH = 2 * SAMPLES * DIT_HEADS
# a forward with merging: each of the 12 attentions in the key-bias form
# (an MLP merged by `tome_mlp` adds no attention); a train step's in the
# dropout form too, and its backward
TOME_FORWARD = dict(DIT_FORWARD, attn_bias=ATTN_PER_DIT_FORWARD)
TOME_FORWARD_BF16 = dict(TOME_FORWARD, attn_bf16=ATTN_PER_DIT_FORWARD)
TOME_STEP = dict(DIT_STEP, attn_bias=ATTN_PER_DIT_FORWARD,
                 attn_bwd_bias=ATTN_PER_DIT_FORWARD)
TOME_STEP_BF16 = dict(TOME_STEP, attn_bf16=ATTN_PER_DIT_FORWARD,
                      attn_bwd_bf16=ATTN_PER_DIT_FORWARD)
# int8: the qkv and out projections and the MLP's two products of 12 blocks
INT8_PER_FORWARD = 4 * 12
INT8_FORWARD = dict(DIT_FORWARD, int8=INT8_PER_FORWARD)
INT8_FORWARD_BF16 = dict(DIT_FORWARD_BF16, int8=INT8_PER_FORWARD)


@contextlib.contextmanager
def recorded_choices(model, replay=None):
    """Record the discrete choices of the forwards of `model` run inside:
    each MoE block's experts and each token-merging plan, in call order;
    with `replay` (an earlier record), impose them instead. Two runs of one
    network that differ at float rounding (the kernels against their plain
    versions) can otherwise route a near-tie token to another expert or
    merge it elsewhere, a difference of the order of the token itself; held
    to one set of choices they compare at the float bars."""
    record = {"experts": [], "plans": []}
    build_plan = tome_ops.build_plan

    def plan(metric, spec):
        chosen = (replay["plans"][len(record["plans"])] if replay is not None
                  else build_plan(metric, spec))
        record["plans"].append(chosen)
        return chosen

    mlps = [m for m in model.modules() if isinstance(m, MoeMlp)]
    for mlp in mlps:
        def route(x, expert=None, _mlp=mlp):
            if replay is not None:
                expert = replay["experts"][len(record["experts"])]
            out = MoeMlp.route(_mlp, x, expert)
            record["experts"].append(out[1])
            return out
        mlp.route = route
    tome_ops.build_plan = plan
    try:
        yield record
    finally:
        tome_ops.build_plan = build_plan
        for mlp in mlps:
            del mlp.route


def choices_apart(a, b):
    """(experts chosen apart, of all (token, slot)s; tokens placed apart by
    the merge plans, of all tokens) between two records."""
    experts = sum(int((x != y).sum()) for x, y in zip(a["experts"],
                                                       b["experts"]))
    tokens = sum(int((x["gather"] != y["gather"]).sum())
                 for x, y in zip(a["plans"], b["plans"]))
    return ((experts, sum(x.numel() for x in a["experts"])),
            (tokens, sum(x["gather"].numel() for x in a["plans"])))


def phase_choice_forward(label, model, per_forward, gen, tol,
                         batch=2 * SAMPLES):
    """A forward of a full-width MoE or token-merging DiT at the sampling
    batch through the kernels, with exactly `per_forward` launches, against
    the same inside `plain_kernels()` on the kernel run's routing and plans
    (`recorded_choices`); how many choices the plain run makes apart when
    left free is printed. Returns the max-rel."""
    x = torch.randn(batch, 32, 32, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    y = torch.randint(0, 11, (batch,), generator=gen, device="cuda")
    reset_launches()
    with torch.no_grad():
        with recorded_choices(model) as choices:
            out = model(x, t, y)
        launched = read_launches()
        with plain_kernels():
            with recorded_choices(model) as free:
                model(x, t, y)
            with recorded_choices(model, choices):
                ref = model(x, t, y)
    torch.cuda.synchronize()
    rel = max_rel(out, ref)
    (experts, slots), (tokens, placed) = choices_apart(choices, free)
    print(f"{label} forward B={batch}: kernels vs plain on the kernel run's "
          f"choices max_rel {rel:.3e} (bar {tol:g}); left free, the plain "
          f"run chose {experts} of {slots} experts and placed {tokens} of "
          f"{placed} merged tokens apart; launches {launched}")
    if launched != expect(**per_forward):
        raise AssertionError(f"{label} forward launches {launched}")
    if not (out.shape == (batch, 32, 32, 3) and torch.isfinite(out).all()
            and ref.abs().max() > 0 and rel <= tol):
        raise AssertionError(f"{label} forward: max_rel {rel}")
    return rel


def phase_moe_grads(label, model, config, per_step, gen, tol):
    """A MoE DiT's train-step loss (DDPM's eps-loss plus MOE_AUX_WEIGHT
    times the blocks' mean load-balance loss, as the trainer forms it) and
    every gradient at batch 128 in train mode (dropout 0.1, the same draws
    in both runs) through the kernels against the same inside
    `plain_kernels()` on the kernel run's routing; exactly `per_step`
    launches, none inside; every parameter gets a gradient."""
    process = factory.get_diffusion(config)
    shape = (TRAIN_BATCH, 32, 32, 3)
    batch = {"x0": torch.rand(*shape, generator=gen, device="cuda") * 2 - 1,
             "t": torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                                device="cuda"),
             "noise": torch.randn(*shape, generator=gen, device="cuda"),
             "y": torch.randint(0, 11, (TRAIN_BATCH,), generator=gen,
                                device="cuda")}

    def run(replay=None):
        torch.manual_seed(TRAIN_SEED)
        model.zero_grad(set_to_none=True)
        aux = []
        with recorded_choices(model, replay) as choices:
            loss = process.p_losses(
                lambda x, t, y: model(x, t, y, moe_losses=aux), batch["x0"],
                batch["t"], batch["noise"], y=batch["y"])
        loss = loss + MOE_AUX_WEIGHT * aux[0]
        loss.backward()
        return (loss.detach(), aux[0].detach(), choices,
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()})

    reset_launches()
    loss, aux, choices, grads = run()
    torch.cuda.synchronize()
    launched = read_launches()
    with plain_kernels():
        reset_launches()
        loss_ref, aux_ref, _, grads_ref = run(choices)
        torch.cuda.synchronize()
        plain_launched = read_launches()
    flat = torch.cat([g.flatten() for g in grads.values()])
    flat_ref = torch.cat([g.flatten() for g in grads_ref.values()])
    loss_rel, grad_rel = max_rel(loss, loss_ref), max_rel(flat, flat_ref)
    print(f"{label} train step B={TRAIN_BATCH}, p {ATTN_DROPOUT}: loss "
          f"{loss.item():.6f} (load balance {aux.item():.6f} x "
          f"{MOE_AUX_WEIGHT}) kernels vs plain max_rel {loss_rel:.3e} (bar "
          f"{tol[0]:g}), flattened gradient {grad_rel:.3e} (bar {tol[1]:g}); "
          f"launches {launched}, inside plain_kernels {plain_launched}")
    if launched != expect(**per_step) or any(plain_launched.values()):
        raise AssertionError(f"{label} train-step launches {launched}")
    no_grad = [n for n, g in grads.items() if not g.any()]
    if not (loss_rel <= tol[0] and grad_rel <= tol[1] and not no_grad
            and torch.isfinite(flat).all()
            and max_rel(aux, aux_ref) <= tol[0]):
        raise AssertionError(f"{label} loss {loss_rel}, gradient {grad_rel}, "
                             f"zero gradients {no_grad}")


def phase_serve_moe(ckpt, config, model, gen, smi):
    """`serve --continuous` on the MoE DiT's checkpoint (16 slots, DDIM-50,
    CFG 3): 16 images in one submit against `sample_with_cfg` at batch 16
    on the same noise, one forward's launches a step."""
    service = serve.SamplerService(
        str(ckpt), sampling_method="ddim", num_inference_steps=STEPS,
        batch_size=SERVE_SLOTS, continuous=True, steps_per_tick=1,
        device="cuda")
    try:
        print(f"serve continuous DiT-MoE: warm-up {service.warmup():.3f} s")
        noise = torch.randn((SERVE_SLOTS, 32, 32, 3), generator=gen,
                            device="cuda")
        labels = np.arange(SERVE_SLOTS) % 10 + 1
        ticks = service.engine.ticks
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        out = service.engine.submit(noise, labels, cfg_scale=CFG_SCALE,
                                    timeout=600)
        seconds = time.perf_counter() - start
        launches = read_launches()
        steps = service.engine.ticks - ticks
    finally:
        service.close()
    ref, _ = serve_reference(model, config, noise, labels)
    err = float(np.abs(out - ref.cpu().numpy()).max())
    print(f"serve continuous DiT-MoE: {SERVE_SLOTS} images in one submit in "
          f"{seconds:.3f} s ({SERVE_SLOTS / seconds:.2f} images/s), against "
          f"sample_with_cfg at batch {SERVE_SLOTS}: max_abs {err:.3e} (bar "
          f"{TOL_SERVE_SLOT:g}); launches {launches}; on {smi}")
    if not (steps == STEPS and launches == scaled(DIT_FORWARD, STEPS)
            and err <= TOL_SERVE_SLOT):
        raise AssertionError(f"serve continuous DiT-MoE: {steps} steps, "
                             f"launches {launches}, max_abs {err}")
    return {"launches": launches, "seconds": seconds}


def phase_moe(gen, smi):
    """The MoE DiT (configs/cifar10_dit_moe.py at full width: hidden 384,
    depth 12, 6 heads, 8 experts, top 2, capacity 1.25): forwards and a
    train step against the plain versions in float32 and bf16, one
    epoch of `train.main` at batch 128 in each with train images/s and
    peak memory, DDIM-50 CFG 3 on 80 images through `sample.main` in each,
    and a 16-image `serve --continuous` request."""
    config = load_config(MOE_CONFIG)
    model = random_model(config, gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"DiT-MoE: {n_params} parameters")
    if n_params != MOE_PARAMS:
        raise AssertionError(f"DiT-MoE: {n_params} parameters, expected "
                             f"{MOE_PARAMS}")
    phase_choice_forward("DiT-MoE", model, DIT_FORWARD, gen, TOL_UNET)
    model.train()
    phase_moe_grads("DiT-MoE", model, config, DIT_STEP, gen,
                    (TOL_LOSS, TOL_GRAD))
    config16 = dict(config, mixed_precision="bf16")
    model16 = factory.get_model(config16).to("cuda").eval()
    model16.load_state_dict(model.state_dict())
    phase_choice_forward("DiT-MoE bf16", model16, DIT_FORWARD_BF16, gen,
                         TOL_BF16_MODEL)
    model16.train()
    phase_moe_grads("DiT-MoE bf16", model16, config16, DIT_STEP_BF16, gen,
                    (TOL_BF16_LOSS, TOL_BF16_GRAD))
    del model16
    model.eval()
    out = {"params": n_params, "seconds": {}, "launches": {}, "rates": {},
           "peak": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for precision, per_forward, flags in (
                ("fp32", DIT_FORWARD, ()),
                ("bf16", DIT_FORWARD_BF16, ("--mixed_precision", "bf16"))):
            launches, seconds = phase_sample_main(
                f"DiT-MoE {precision}", config, model, per_forward, tmp,
                flags=flags)
            out["seconds"][precision] = seconds
            out["launches"][f"sample_{precision}"] = launches
        out["serve"] = phase_serve_moe(Path(tmp) / "dit_random.pth", config,
                                       model, gen, smi)
    del model
    for precision, cfg, per_step in (("fp32", config, DIT_STEP),
                                     ("bf16", config16, DIT_STEP_BF16)):
        with tempfile.TemporaryDirectory() as tmp:
            # one epoch each (cut from three to keep the script inside its
            # time: a 131.9 M-parameter checkpoint is written every epoch)
            trainer, launches = run_train_main(
                f"DiT-MoE {precision}", cfg, per_step, tmp, 1, 1)
            rates, peak = time_train_rates(trainer, runs=1)
            del trainer
        out["launches"][f"train_{precision}"] = launches
        out["rates"][precision], out["peak"][precision] = rates, peak
        print(f"DiT-MoE {precision} train images/s at batch {TRAIN_BATCH}: "
              f"{', '.join(f'{r:.2f}' for r in rates)}; peak device memory "
              f"{peak / 2**20:.1f} MiB; on {smi}")
    return out


def check_attention_bias(label, bh, seq, d, dtype, gen, drop=(0.0, None),
                         timed=False):
    """K2 and K3 in their key-bias forms (float32 or bf16; with dropout
    when `drop` has p > 0) against their plain versions on one input, the
    bias log of merged sizes 1 .. 8 shared by each item's DIT_HEADS heads;
    with `timed`, per call: each kernel, its plain version, and
    `F.scaled_dot_product_attention` with the bias as an additive mask on
    (1, BH, L, d) and its backward (never called by the port). Returns the
    worst absolute error and the times."""
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device="cuda").to(
        dtype) for _ in range(4))
    sizes = torch.randint(1, 9, (bh // DIT_HEADS, seq), generator=gen,
                          device="cuda")
    bias = torch.log(sizes.float())
    o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop, bias=bias)
    o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v, *drop,
                                                             bias=bias)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, *drop,
                                                bias=bias)
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop,
                                                   bias=bias)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    label = (f"{label} BH={bh} L={seq} d={d} p={drop[0]} "
             f"[{attention_fwd_form(seq, d, dtype)}; backward "
             f"{attention_bwd_form(seq, d, None, dtype)}]")
    lse_err = (lse - lse_ref).abs().max().item()
    if bf16:
        steps, err = bf16_check(label + " o", o, o_ref, BF16_STEPS_FWD,
                                TOL_OUT)
        checked = [bf16_check(f"{label} {n}", a, r, BF16_STEPS_BWD, TOL_BWD)
                   for n, a, r in zip(("dq", "dk", "dv"), grads, refs)]
        line = (f"{label}: o {steps} bf16 steps, lse max_abs {lse_err:.3e}; "
                f"dq/dk/dv {' '.join(str(c[0]) for c in checked)} bf16 steps")
        worst = max(err, lse_err, *(c[1] for c in checked))
        ok = lse_err <= TOL_LSE
    else:
        rel = max_rel(o, o_ref)
        rels = [max_rel(g, r) for g, r in zip(grads, refs)]
        line = (f"{label}: o max_rel {rel:.3e} lse max_abs {lse_err:.3e}; "
                f"dq/dk/dv max_rel {' '.join(f'{r:.3e}' for r in rels)}")
        worst = max((o - o_ref).abs().max().item(), lse_err,
                    *((g - r).abs().max().item() for g, r in zip(grads, refs)))
        ok = rel <= TOL_OUT and lse_err <= TOL_LSE and max(rels) <= TOL_BWD
    if not ok:
        raise AssertionError(line)
    times = {}
    if timed:
        args = (q, k, v, o, do, lse)
        mask = bias.repeat_interleave(DIT_HEADS, dim=0)[None, :, None, :].to(
            dtype)
        times = {
            "fwd": median_ms(lambda: flash_attention.flash_attention_fwd(
                q, k, v, *drop, bias=bias)),
            "fwd_plain": median_ms(
                lambda: flash_attention.flash_attention_fwd_ref(
                    q, k, v, *drop, bias=bias), reps=10),
            "fwd_library": median_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=mask)),
            "bwd": median_ms(lambda: flash_attention.flash_attention_bwd(
                *args, *drop, bias=bias)),
            "bwd_plain": median_ms(
                lambda: flash_attention.flash_attention_bwd_ref(
                    *args, *drop, bias=bias), reps=10)}
        qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*qkv, attn_mask=mask)
        times["bwd_library"] = median_ms(
            lambda: torch.autograd.grad(out, qkv, do[None],
                                        retain_graph=True))
        line += ("; ms a call: forward kernel {fwd:.4f} plain {fwd_plain:.4f} "
                 "scaled_dot_product_attention(attn_mask) {fwd_library:.4f}; "
                 "backward kernel {bwd:.4f} plain {bwd_plain:.4f} its "
                 "backward {bwd_library:.4f}").format(**times)
    print(line)
    return worst, times


def bias_bounds(bh, seq, d, dtype):
    """The bound of the key-bias forms' forward and backward at one shape:
    the attention's work (`attn_work`) and the bias read, at the float32
    CUDA-core rate, or in bf16 at the tensor cores' rate."""
    elem = 2 if dtype == torch.bfloat16 else 4
    rate = (PEAK_BF16_TC_OPS_PER_S if dtype == torch.bfloat16
            else PEAK_FP32_OPS_PER_S)
    bias_bytes = 4 * (bh // DIT_HEADS) * seq
    bounds = {}
    for backward in (False, True):
        n_bytes, n_ops = attn_work(bh, seq, d, backward, elem=elem)
        bounds["bwd" if backward else "fwd"] = Bound(rate).add(
            n_bytes + bias_bytes, n_ops)
    return bounds


def phase_bias_kernels(gen):
    """The key-bias forms of K2 and K3, float32 and bf16, against their
    plain versions at the sampling batch's BH 960 and ToMe's merged lengths
    (128 at ratio 0.5, 179 at 0.3, a ragged last tile), d 64, timed beside
    the library call; with dropout at the train step's BH 768. Returns the
    worst error, the times and the bounds by (dtype, L)."""
    worst, times, bounds = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        worst[name] = 0.0
        for seq in TOME_LENGTHS:
            err, t = check_attention_bias(
                f"attention key bias {name}", TOME_BH, seq, DIT_HEAD_DIM,
                dtype, gen, timed=True)
            worst[name] = max(worst[name], err)
            times[(name, seq)] = t
            bounds[(name, seq)] = bias_bounds(TOME_BH, seq, DIT_HEAD_DIM,
                                              dtype)
            err, _ = check_attention_bias(
                f"attention key bias {name}", TRAIN_BATCH * DIT_HEADS, seq,
                DIT_HEAD_DIM, dtype, gen,
                drop=(ATTN_DROPOUT, ATTN_DROPOUT_SEED))
            worst[name] = max(worst[name], err)
    return worst, times, bounds


def phase_tome(gen, smi):
    """Token merging on the DiT (configs/cifar10_dit.py at full width, the
    same random weights as `phase_int8`'s): the key-bias kernels
    (`phase_bias_kernels`); forwards at ratio 0.5 with and without
    `tome_mlp` against the plain versions on the kernel run's plans, in
    float32 and bf16; DDIM-50 CFG 3 on 80 images through `sample.main
    --tome_ratio 0.5` with and without `--tome_mlp`, in float32 and bf16,
    12 K2 in the key-bias form a forward; three epochs of `train.main` with
    merging (the bias forms of K2 and K3 with dropout) in each. Returns the
    model and what the summary and the `kernels` line read."""
    worst, times, bounds = phase_bias_kernels(gen)
    config = load_config(DIT_CONFIG)
    model = random_model(config, gen)
    out = {"worst": worst, "times": times, "bounds": bounds, "seconds": {},
           "launches": {}}
    for mlp in (False, True):
        for precision, per_forward, tol in (
                ("fp32", TOME_FORWARD, TOL_UNET),
                ("bf16", TOME_FORWARD_BF16, TOL_BF16_MODEL)):
            cfg = dict(config, mixed_precision=(
                "bf16" if precision == "bf16" else "none"),
                model_params=dict(config["model_params"],
                                  tome_ratio=TOME_RATIO, tome_mlp=mlp))
            merged = factory.get_model(cfg).to("cuda").eval()
            merged.load_state_dict(model.state_dict())
            phase_choice_forward(
                f"DiT ToMe {TOME_RATIO}{' + MLP' if mlp else ''} {precision}",
                merged, per_forward, gen, tol)
            del merged
    with tempfile.TemporaryDirectory() as tmp:
        for mlp in (False, True):
            for precision, per_forward, flags in (
                    ("fp32", TOME_FORWARD, ()),
                    ("bf16", TOME_FORWARD_BF16,
                     ("--mixed_precision", "bf16"))):
                key = f"{'mlp_' if mlp else ''}{precision}"
                launches, seconds = phase_sample_main(
                    f"DiT ToMe {TOME_RATIO}{' + MLP' if mlp else ''} "
                    f"{precision}", config, model, per_forward, tmp,
                    flags=(*flags, "--tome_ratio", str(TOME_RATIO),
                           *(("--tome_mlp",) if mlp else ())))
                out["seconds"][key] = seconds
                out["launches"][f"sample_{key}"] = launches
    for precision, per_step in (("fp32", TOME_STEP), ("bf16", TOME_STEP_BF16)):
        cfg = dict(config, mixed_precision=(
            "bf16" if precision == "bf16" else "none"),
            model_params=dict(config["model_params"], tome_ratio=TOME_RATIO))
        with tempfile.TemporaryDirectory() as tmp:
            _, launches = run_train_main(f"DiT ToMe {TOME_RATIO} {precision}",
                                         cfg, per_step, tmp, TRAIN_EPOCHS, 1)
        out["launches"][f"train_{precision}"] = launches
    return model, out


def phase_int8(model, gen, smi):
    """int8 (w8a8) inference on the DiT's random weights `model`: a forward
    at the sampling batch with exactly 48 int8 products beside the float
    one (the distance between them printed), then DDIM-50 CFG 3 on 80
    images through `sample.main --quantize int8`, float32 and bf16, with
    48 int8 products a forward."""
    config = load_config(DIT_CONFIG)
    q_model = factory.get_model(dict(config, model_params=dict(
        config["model_params"], quant="int8"))).to("cuda").eval()
    q_model.load_state_dict(model.state_dict())
    x = torch.randn(2 * SAMPLES, 32, 32, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (2 * SAMPLES,), generator=gen, device="cuda")
    y = torch.randint(0, 11, (2 * SAMPLES,), generator=gen, device="cuda")
    reset_launches()
    with torch.no_grad():
        got = q_model(x, t, y)
        launched = read_launches()
        ref = model(x, t, y)
    torch.cuda.synchronize()
    distance = max_rel(got, ref)
    print(f"DiT int8 forward B={2 * SAMPLES}: max|int8 - float| / max|float| "
          f"{distance:.3e}; launches {launched}")
    if not (launched == expect(**INT8_FORWARD) and torch.isfinite(got).all()
            and 0 < distance < 0.1):
        raise AssertionError(f"DiT int8 forward: launches {launched}, "
                             f"distance {distance}")
    del q_model
    out = {"distance": distance, "seconds": {}, "launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for precision, per_forward, flags in (
                ("fp32", INT8_FORWARD, ()),
                ("bf16", INT8_FORWARD_BF16, ("--mixed_precision", "bf16"))):
            launches, seconds = phase_sample_main(
                f"DiT int8 {precision}", config, model, per_forward, tmp,
                flags=(*flags, "--quantize", "int8"))
            out["seconds"][precision] = seconds
            out["launches"][precision] = launches
    return out


# ------------------------------------------------------- few-step trainers
# Consistency training: two UNet forwards (the student's, and the target's
# without a gradient) and one backward a step; consistency distillation
# (guided: one teacher call on the [cond; uncond] batch) and progressive
# distillation (two teacher forwards): three forwards and one backward
CT_STEP = dict(UNET_STEP, gn=2 * GN_PER_FORWARD, attn=2 * ATTN_PER_FORWARD)
DISTILL_STEP = dict(UNET_STEP, gn=3 * GN_PER_FORWARD,
                    attn=3 * ATTN_PER_FORWARD)
CT_GRIDS = [10, 20]  # `ct_grid_schedule`: 3 epochs, 1 on 10 points, 2 on 20
CM_STEPS = 2  # the consistency checkpoints' embedded step count
PD_STEPS = 4  # the progressive student's count (its teacher's grid: 8)
REFLOW_PAIRS, REFLOW_BATCH, REFLOW_TEACHER_STEPS = 128, 64, 10
TOL_FEWSTEP_SAMPLES = 1e-4  # consistency-2 images in [0, 1], kernels vs plain


class ConsistencyObjective:
    """Consistency training's loss in the `p_losses` form that
    `phase_train_grads` calls: the batch's t % (grid pairs) picks a pair of
    the CT_GRIDS[0]-point grid, the target is a frozen copy of the model
    made here (the student's start, as the trainer's)."""

    def __init__(self, config, model):
        self.schedule = factory.get_diffusion(
            dict(config, diffusion_type="ddpm")).schedule_on("cuda")
        self.grid = [g.to("cuda") for g in cm_lib.cd_grids(
            config["num_timesteps"], CT_GRIDS[0])]
        self.target = copy.deepcopy(model).eval().requires_grad_(False)

    def p_losses(self, model, x0, t, noise, y=None):
        idx = t % len(self.grid[0])

        def pair(m):
            return dbase.wrap_model_as_eps_x0(self.schedule, m, "eps")
        return cm_lib.consistency_training_loss(
            self.schedule, pair(model), pair(self.target), x0, noise,
            self.grid[0][idx], self.grid[1][idx], y, sigma_data=0.5,
            timestep_scaling=10.0)


def fewstep_sample(label, ckpt, flags, calls, tmp, compare_plain=False):
    """`sample.main` of 80 images from `ckpt` with `flags` (CFG 3 unless
    they say otherwise), exactly one UNet forward's launches for each of
    `calls` model calls, finite; with `compare_plain`, the same call inside
    `plain_kernels()` within TOL_FEWSTEP_SAMPLES. Returns the launches and
    the sampling seconds."""
    argv = ["--checkpoint", str(ckpt), "--cfg_scale", str(CFG_SCALE),
            "--num_samples", str(SAMPLES), "--batch_size", str(SAMPLES),
            "--seed", "0", "--use_ema", "--device", "cuda", "--output_dir",
            str(Path(tmp) / label.replace(" ", "_")), *flags]
    result, launches = checked_sample(label, argv,
                                      scaled(UNET_FORWARD, calls))
    if compare_plain:
        with plain_kernels():
            reset_launches()
            plain = sample.main(argv)
            torch.cuda.synchronize()
            plain_launched = read_launches()
        err = float(np.abs(result["samples"] - plain["samples"]).max())
        print(f"sample.main {label}, kernels vs plain: max_abs {err:.3e} "
              f"(bar {TOL_FEWSTEP_SAMPLES:g}); plain sampling "
              f"{plain['sampling_seconds']:.3f} s")
        if err > TOL_FEWSTEP_SAMPLES or any(plain_launched.values()):
            raise AssertionError(f"{label}: max_abs {err}, plain launches "
                                 f"{plain_launched}")
    return launches, result["sampling_seconds"]


def fewstep_serve(ckpt, smi):
    """A consistency checkpoint behind `serve`'s batched mode over HTTP
    (`--batch_size 16`, CFG 3): one npy request with exactly its 2 model
    calls' launches, against the service's own `sample_with_cfg` on the
    request's seeded draw; then `--continuous`, which refuses it."""
    service = serve.SamplerService(str(ckpt), batch_size=SERVE_SLOTS,
                                   use_ema=True, device="cuda")
    if not isinstance(service.diffusion, ConsistencyModel):
        raise AssertionError(f"serve built {type(service.diffusion)}")
    print(f"serve consistency-{CM_STEPS}: warm-up {service.warmup():.3f} s")
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0),
                                      serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever)
    thread.start()
    labels = [i % 10 for i in range(SERVE_SLOTS)]
    try:
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        status, _, data = http_request(
            httpd.server_address, "POST", "/generate",
            {"num_samples": SERVE_SLOTS, "labels": labels,
             "seed": SERVE_SEED, "cfg_scale": CFG_SCALE, "format": "npy"})
        seconds = time.perf_counter() - start
        launches = read_launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    if status != 200 or launches != scaled(UNET_FORWARD, CM_STEPS):
        raise AssertionError(f"serve consistency: {status}, launches "
                             f"{launches}")
    images = np.load(io.BytesIO(data))
    with torch.no_grad():
        ref = service.diffusion.sample_with_cfg(
            service.model, (SERVE_SLOTS, 32, 32, 3),
            torch.as_tensor(np.asarray(labels) + 1, device="cuda"),
            torch.Generator(device="cuda").manual_seed(SERVE_SEED),
            cfg_scale=CFG_SCALE)
    err = float(np.abs(images - np.clip((ref.cpu().numpy() + 1) / 2, 0, 1))
                .max())
    print(f"serve consistency-{CM_STEPS} batched: {SERVE_SLOTS} images CFG "
          f"{CFG_SCALE} in {seconds:.3f} s over HTTP on {smi}; against "
          f"sample_with_cfg on the request's draw max_abs {err:.3e}; "
          f"launches {launches}")
    if err > TOL_SERVE_BATCHED:
        raise AssertionError(f"serve consistency max_abs {err}")
    del service
    try:
        serve.SamplerService(str(ckpt), sampling_method="ddim",
                             continuous=True, device="cuda")
    except ValueError as e:
        if "requires a VP" not in str(e):
            raise
        print(f"serve --continuous refuses the consistency checkpoint: {e}")
    else:
        raise AssertionError("serve --continuous took a consistency "
                             "checkpoint")
    return launches, seconds


def run_tool(label, tool, config, tmp, per_step, epochs, **changes):
    """A few-step tool's `main` (`tools/distill.py`) on a config file
    written from `config` (`write_train_config`: the fixtures, `epochs`
    epochs of one batch of 128), with exactly `per_step` launches a step.
    Returns the trainer and the launches."""
    path = write_train_config(config, epochs, tmp, **changes)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    trainer = tool.main(["--config", str(path), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_launches()
    print(f"{label}: {trainer.global_step} steps of batch "
          f"{config['batch_size']} in {wall:.3f} s; launches {launches}")
    if launches != scaled(per_step, trainer.global_step) or (
            trainer.global_step != epochs):
        raise AssertionError(f"{label}: {trainer.global_step} steps, "
                             f"launches {launches}")
    return trainer, launches


def phase_reflow(flow_ckpt, tmp, smi):
    """`tools/reflow.py` on the flow-matching UNet `phase_process` trained:
    REFLOW_PAIRS pairs from its Euler sampler at REFLOW_TEACHER_STEPS steps
    with CFG 3 (2 batches of 64: 20 calls of one UNet forward at 128 rows,
    counted at `synthesize_pairs`), then one round of 2 epochs (4 steps);
    then 1-step Euler `sample` of `reflow_round1.pth`."""
    counted = {}
    synthesize = ReflowTrainer.synthesize_pairs

    def counting(self, *args, **kwargs):
        torch.cuda.synchronize()
        before = read_launches()
        out = synthesize(self, *args, **kwargs)
        torch.cuda.synchronize()
        counted.update({k: v - before[k] for k, v in read_launches().items()})
        return out

    path = Path(tmp) / "reflow.json"
    path.write_text(json.dumps({
        "teacher_checkpoint": str(flow_ckpt), "reflow_pairs": REFLOW_PAIRS,
        "pair_batch_size": REFLOW_BATCH,
        "teacher_sample_steps": REFLOW_TEACHER_STEPS,
        "reflow_cfg_scale": CFG_SCALE, "reflow_rounds": 1, "epochs": 2,
        "optimizer": "adamw", "learning_rate": 1e-4,
        "save_dir": str(Path(tmp) / "reflow"), "seed": 0}))
    ReflowTrainer.synthesize_pairs = counting
    try:
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        trainer = reflow_tool.main(["--config", str(path), "--device",
                                    "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        total = read_launches()
    finally:
        ReflowTrainer.synthesize_pairs = synthesize
    pair_calls = REFLOW_PAIRS // REFLOW_BATCH * REFLOW_TEACHER_STEPS
    train_launches = {k: v - counted[k] for k, v in total.items()}
    print(f"reflow: {REFLOW_PAIRS} pairs ({pair_calls} teacher calls at "
          f"{2 * REFLOW_BATCH} rows) and {trainer.global_step} steps in "
          f"{wall:.3f} s; pair launches {counted}, train launches "
          f"{train_launches}")
    if counted != scaled(UNET_FORWARD, pair_calls) or (
            train_launches != scaled(UNET_STEP, trainer.global_step)
            or trainer.global_step != 2 * REFLOW_PAIRS // REFLOW_BATCH):
        raise AssertionError(f"reflow launches: pairs {counted}, train "
                             f"{train_launches}")
    sample_launches, seconds = fewstep_sample(
        "reflow Euler-1", trainer.save_dir / "reflow_round1.pth",
        ["--num_inference_steps", "1"], 1, tmp)
    return {"pairs": counted, "train": train_launches,
            "sample": sample_launches, "seconds": seconds}


def phase_optimizers(config, smi):
    """6 DDPM steps (the median of 5 after 1) of the full-width UNet at
    batch 128 with AdamW, Adafactor and Lion (the same init), each step
    exactly one step's launches, a finite loss, peak memory and the
    optimizer state's bytes."""
    out = {}
    for name in ("adamw", "adafactor", "lion"):
        run = dict(config, optimizer=name, data_root=str(FIXTURE_DATA))
        with tempfile.TemporaryDirectory() as tmp:
            run.update(save_dir=str(Path(tmp) / "checkpoints"),
                       sample_dir=str(Path(tmp) / "samples"))
            torch.manual_seed(0)
            loader = factory.get_dataloader(
                run, factory.get_dataset(run, train=True), train=True)
            trainer = DiffusionTrainer(
                factory.get_model(run), factory.get_diffusion(run), loader,
                run, "cuda")
            rates, peak = time_train_rates(trainer, runs=1)
            images, labels = next(iter(loader))
            reset_launches()
            loss = trainer.train_step(torch.from_numpy(images).to("cuda"),
                                      torch.from_numpy(labels).to("cuda"))
            torch.cuda.synchronize()
            launches = read_launches()
            state = trainer.optimizer.state_dict()["state"]
            state_bytes = sum(t.numel() * t.element_size()
                              for s in state.values() for t in s.values()
                              if torch.is_tensor(t))
        print(f"DDPM UNet with {name}: {rates[0]:.2f} train images/s at "
              f"batch {TRAIN_BATCH} fp32, peak device memory "
              f"{peak / 2**20:.1f} MiB, optimizer state "
              f"{state_bytes / 2**20:.1f} MiB, loss {loss.item():.5f}; "
              f"launches a step {launches}; on {smi}")
        if not (math.isfinite(loss.item()) and launches == expect(
                **UNET_STEP)):
            raise AssertionError(f"{name}: loss {loss}, launches {launches}")
        out[name] = {"rate": rates[0], "peak": peak,
                     "state_bytes": state_bytes}
        del trainer
    return out


def phase_fewstep(unet_ckpt, flow_ckpt, gen, smi, ddim_seconds):
    """The few-step trainers at the full width of configs/cifar10_unet.py
    on the fixtures: consistency training (the loss and gradients against
    `plain_kernels()`, `train` with two grid stages, train images/s in fp32
    and bf16, then of its checkpoint `sample` with 2-step CFG 3 against
    the plain versions, `evaluate` of 50 samples, a 16-image `serve`
    request and `--continuous`'s refusal); consistency and progressive
    distillation of `unet_ckpt` through `tools/distill.py` and a sample of
    each; reflow of `flow_ckpt` (`phase_reflow`); Adafactor and Lion beside
    AdamW (`phase_optimizers`). Returns the launches by path and the
    figures."""
    config = load_config(CONFIG)
    ct_config = dict(config, diffusion_type="consistency",
                     ct_grid_schedule=CT_GRIDS, consistency_sample_steps=CM_STEPS,
                     save_current_interval=TRAIN_EPOCHS)
    launches, figures = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for precision in ("fp32", "bf16"):
            run = (ct_config if precision == "fp32" else
                   dict(ct_config, mixed_precision="bf16"))
            per_step = CT_STEP if precision == "fp32" else bf16_counts(
                CT_STEP)
            torch.manual_seed(0)
            model = factory.get_model(run).to("cuda").eval()
            phase_train_grads(
                f"UNet consistency training {precision}", model, run,
                per_step, gen, process=ConsistencyObjective(run, model),
                tol=((TOL_LOSS, TOL_GRAD) if precision == "fp32"
                     else (TOL_BF16_LOSS, TOL_BF16_GRAD)))
            del model
            trainer, launches[f"ct_train_{precision}"] = run_train_main(
                f"UNet consistency training {precision}", run, per_step,
                Path(tmp) / precision, TRAIN_EPOCHS, 1, loss_key="ct/loss")
            if trainer.grid_for_epoch() != [CT_GRIDS[0]] + [CT_GRIDS[1]] * 2:
                raise AssertionError(f"CT grids {trainer.grid_for_epoch()}")
            rates, peak = time_train_rates(trainer, runs=1)
            figures[f"ct_{precision}"] = {"rate": rates[0], "peak": peak}
            print(f"UNet consistency training {precision}: {rates[0]:.2f} "
                  f"train images/s at batch {TRAIN_BATCH}, peak device "
                  f"memory {peak / 2**20:.1f} MiB, on {smi}")
            if precision == "fp32":
                ct_ckpt = trainer.save_dir / "consistency_model.pth"
                ct_model, ct_cfg = trainer.ema_model, trainer.out_config()
            del trainer
        launches["ct_sample_fp32"], seconds = fewstep_sample(
            f"consistency-{CM_STEPS} CFG {CFG_SCALE}", ct_ckpt, [], CM_STEPS,
            tmp, compare_plain=True)
        figures["ct_sample_seconds"] = seconds
        print(f"consistency-{CM_STEPS} CFG {CFG_SCALE}: "
              f"{SAMPLES / seconds:.2f} samples/s fp32 ({CM_STEPS} model "
              f"calls), {ddim_seconds / seconds:.2f}x DDIM-{STEPS}'s "
              f"{SAMPLES / ddim_seconds:.2f}, on {smi}")
        launches["ct_evaluate_fp32"], _, eval_seconds = run_evaluate(
            "UNet consistency", ct_model, ct_cfg,
            ["--num_samples", str(EVAL_DIT_SAMPLES), "--batch_size",
             str(EVAL_DIT_SAMPLES)], scaled(UNET_FORWARD, CM_STEPS), tmp)
        figures["ct_evaluate_seconds"] = eval_seconds
        launches["ct_serve_fp32"], figures["ct_serve_seconds"] = (
            fewstep_serve(ct_ckpt, smi))
        del ct_model

        distill = dict(config, teacher_checkpoint=str(unet_ckpt))
        cd, launches["cd_train_fp32"] = run_tool(
            "consistency distillation (tools/distill.py)", distill_tool,
            distill, Path(tmp) / "cd", DISTILL_STEP, TRAIN_EPOCHS,
            distill_method="consistency", distill_cfg_scale=CFG_SCALE,
            consistency_sample_steps=CM_STEPS)
        figures["cd_rate"] = time_train_rates(cd, runs=1)[0][0]
        cd_ckpt = cd.save_dir / "consistency_model.pth"
        del cd
        launches["cd_sample_fp32"], _ = fewstep_sample(
            f"CD consistency-{CM_STEPS}", cd_ckpt, ["--cfg_scale", "1"],
            CM_STEPS, tmp)
        pd, launches["pd_train_fp32"] = run_tool(
            "progressive distillation (tools/distill.py)", distill_tool,
            distill, Path(tmp) / "pd", DISTILL_STEP, 2,
            distill_method="progressive", distill_steps=PD_STEPS)
        figures["pd_rate"] = time_train_rates(pd, runs=1)[0][0]
        del pd
        launches["pd_sample_fp32"], _ = fewstep_sample(
            f"PD DDIM-{PD_STEPS}",
            Path(tmp) / "pd" / "checkpoints" /
            f"distilled_{PD_STEPS:04d}step.pth",
            ["--sampling_method", "ddim", "--num_inference_steps",
             str(PD_STEPS)], PD_STEPS, tmp)
        reflow = phase_reflow(flow_ckpt, tmp, smi)
    launches.update({"reflow_pairs_fp32": reflow["pairs"],
                     "reflow_train_fp32": reflow["train"],
                     "reflow_sample_fp32": reflow["sample"]})
    figures["reflow_sample_seconds"] = reflow["seconds"]
    figures["optimizers"] = phase_optimizers(config, smi)
    return {"launches": launches, "figures": figures}


# ------------------------------------------ the operators and the export
# Every kernel launcher is a `torch.library` operator (`ops/_library.py`);
# `serving.py` exports a whole sampling trajectory with `torch.export`
EXPORT_DIT_FORWARD = DIT_FORWARD_BF16


def opcheck_args(name, gen):
    """Inputs of one call of the operator `name` on the card: the shapes of
    the UNet's attention at 16x16 and a GroupNorm+SiLU of its first level,
    and a DiM scan at L 100 (a ragged last block)."""
    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    if name.startswith("gn_silu"):
        x, scale, bias = randn(4, 32, 32, 128), randn(128), randn(128)
        if name == "gn_silu_fwd":
            return (x, scale, bias, 8)
        _, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 8)
        return (x, scale, bias, randn(4, 32, 32, 128), stats, 8)
    if name.startswith("flash_attn"):
        # the dropout form at a sharded rank's head grid (E7) and a
        # sequence-parallel rank's rows 128 .. of 256 keys (E6)
        q, do = (randn(64, 128, 64) for _ in range(2))
        k, v = (randn(64, 256, 64) for _ in range(2))
        drop = (ATTN_DROPOUT, ATTN_DROPOUT_SEED)
        grid = [4, 8, 16, 4]
        if name == "flash_attn_fwd":
            return (q, k, v, *drop, None, grid, 128)
        o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop,
                                                     head_grid=grid, row0=128)
        return (q, k, v, o, do, lse, *drop, None, None, grid, 128)
    batch, length, d_inner, n_state = 2, 100, 256, 16
    x = randn(batch, length, d_inner)
    dt = F.softplus(randn(batch, length, d_inner) - 2)
    A = -torch.exp(randn(d_inner, n_state) * 0.5)
    B, C = randn(batch, length, n_state), randn(batch, length, n_state)
    if name in ("selective_scan_fwd", "selective_scan_fwd_states",
                "selective_scan_fwd_split"):
        return (x, dt, A, B, C)
    h = randn(batch, d_inner, n_state)
    if name in ("selective_scan_fwd_state", "selective_scan_end_state"):
        return (x, dt, A, B, C, h)
    g = randn(batch, length, d_inner)
    if name == "selective_scan_bwd_nostate":
        return (x, dt, A, B, C, g)
    if name == "selective_scan_bwd_state":
        _, bound, _ = scan.selective_scan_fwd_state(x, dt, A, B, C, h)
        return (x, dt, A, B, C, g, bound, randn(batch, d_inner, n_state))
    _, bound = scan.selective_scan_fwd(x, dt, A, B, C, True)
    return (x, dt, A, B, C, g, bound)


def phase_opcheck(gen):
    """`torch.library.opcheck` on every `dmc::` operator with CUDA tensors:
    its schema, its fake implementation against the CUDA one (shapes,
    dtypes, strides), its registration, and a trace through AOT autograd
    with dynamic shapes. Its launches count nowhere: every path resets the
    counts before it runs."""
    start = time.perf_counter()
    for name, op in _library.OPS.items():
        result = torch.library.opcheck(op, opcheck_args(name, gen))
        torch.cuda.synchronize()
        if set(result.values()) != {"SUCCESS"}:
            raise AssertionError(f"opcheck {name}: {result}")
    print(f"opcheck on CUDA tensors: {len(_library.OPS)} operators "
          f"({', '.join(_library.OPS)}), every test SUCCESS in "
          f"{time.perf_counter() - start:.1f} s")


def scan_extra_calls():
    """How many more times than its length the installed torch's scan
    operator calls its step: torch 2.11's runs the first step once more
    before its loop, to learn the outputs' shapes (2.13's does not)."""
    from torch._higher_order_ops.scan import scan_op
    calls = []

    def step(x, t):
        calls.append(t)
        return [x + t]
    scan_op(step, [torch.zeros(())], [torch.ones(4)], ())
    return len(calls) - 4


def export_case(label, model, config, per_call, extra, gen, smi):
    """`serving.export_sampler` of `model` at `config` (DDIM-50, CFG 3, 80
    images), the blob loaded back and run from one x_T beside the live
    `sample_with_cfg` (and the codec's decode under latent diffusion) from
    the same x_T, each with exactly `per_call` launches a model call plus
    `extra` ((counts, n) pairs), the program's run `scan_extra_calls()`
    model calls more; the images held bit for bit, or within
    TOL_SERVE_BATCHED (images in [0, 1]) where a sum's order differs.
    Returns the launches of the program's run and the figures."""
    params = dict(model.named_parameters())
    config = dict(config, num_inference_steps=STEPS)
    seconds = {}
    blob = serving.export_sampler(model, params, config,
                                  batch_size=EXPORT_SAMPLES,
                                  cfg_scale=CFG_SCALE, device="cuda",
                                  seconds=seconds)
    start = time.perf_counter()
    program, meta = serving.load_exported(blob)
    module = program.module()
    seconds["load"] = time.perf_counter() - start
    shape = tuple(meta["shape"])
    x_T = torch.randn(shape, generator=gen, device="cuda")
    labels = torch.randint(1, 11, (EXPORT_SAMPLES,), generator=gen,
                           device="cuda")
    ddim = factory.get_diffusion(config, "ddim")
    codec = LatentCodec.from_config(config, device="cuda")
    expected = add_counts((per_call, STEPS), *extra)
    scan_extra = scan_extra_calls()
    expected_program = add_counts((per_call, STEPS + scan_extra), *extra)

    def timed(fn):
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, read_launches()

    def live():
        out = ddim.sample_with_cfg(model, shape, labels, cfg_scale=CFG_SCALE,
                                   init_noise=x_T)
        if codec is not None:
            out = codec.decode(out)
        return torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
    with torch.no_grad():  # cuDNN and cuBLAS warm at the call's 2 B rows
        model(torch.cat([x_T, x_T]),
              torch.zeros(2 * EXPORT_SAMPLES, dtype=torch.int64,
                          device="cuda"),
              torch.cat([labels, torch.zeros_like(labels)]))
    want, live_s, live_launches = timed(live)
    got, run_s, launches = timed(lambda: module(params, x_T, labels, None))
    err = (got - want).abs().max().item()
    print(f"export {label}: DDIM-{STEPS} CFG {CFG_SCALE}, {EXPORT_SAMPLES} images "
          f"{tuple(got.shape)}: export {seconds['export']:.2f} s, save "
          f"{seconds['save']:.2f} s, load {seconds['load']:.2f} s, blob "
          f"{len(blob) / 2**20:.2f} MiB; the program {EXPORT_SAMPLES / run_s:.2f} "
          f"samples/s ({run_s:.3f} s), the live sampler "
          f"{EXPORT_SAMPLES / live_s:.2f} samples/s ({live_s:.3f} s); max |program "
          f"- live| {err:.3e} ({'bit-equal' if err == 0 else 'not bit-equal'}"
          f", bar {TOL_SERVE_BATCHED:g}); launches {launches} ({STEPS} + "
          f"{scan_extra} model calls: the scan's own on torch "
          f"{torch.__version__}), live {live_launches}; on {smi}")
    if not (launches == expected_program and live_launches == expected
            and err <= TOL_SERVE_BATCHED and torch.isfinite(got).all()
            and got.shape == (EXPORT_SAMPLES, *image_shape(config))):
        raise AssertionError(f"export {label}: launches {launches} "
                             f"(expected {expected_program}), live "
                             f"{live_launches} (expected {expected}), "
                             f"max |program - live| {err}")
    return launches, dict(seconds, blob_mib=len(blob) / 2**20,
                          rate=EXPORT_SAMPLES / run_s,
                          live_rate=EXPORT_SAMPLES / live_s,
                          bit_equal=err == 0, calls=STEPS + scan_extra)


def phase_export(gen, smi):
    """`serving.export_sampler` on the card: the full-width fp32 UNet
    (configs/cifar10_unet.py; 2250 K1 + 550 K2), the DiT in bf16
    (configs/cifar10_dit.py, `mixed_precision: 'bf16'`; 600 bf16 K2) and
    the latent UNet with its decode (configs/cifar10_latent_unet.py on a
    VAE checkpoint of random weights written here; 1761 K1 + 551 K2), each
    DDIM-50 CFG 3 for EXPORT_SAMPLES images (`export_case`). Returns the
    launches and figures by path."""
    phase_opcheck(gen)
    launches, figures = {}, {}
    config = load_config(CONFIG)
    model = random_model(config, gen)
    launches["export_unet"], figures["UNet fp32"] = export_case(
        "UNet fp32", model, config, UNET_FORWARD, (), gen, smi)
    del model
    config = dict(load_config(DIT_CONFIG), mixed_precision="bf16")
    model = random_model(config, gen)
    launches["export_dit_bf16"], figures["DiT bf16"] = export_case(
        "DiT bf16", model, config, EXPORT_DIT_FORWARD, (), gen, smi)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        vae_config = load_config(VAE_CONFIG)
        torch.manual_seed(0)
        vae = factory.get_model(vae_config)
        vae_ckpt = Path(tmp) / "vae_random.pth"
        checkpoint.save_checkpoint(vae_ckpt, vae.state_dict(), vae_config)
        del vae
        config = dict(load_config(LATENT_CONFIG), vae_checkpoint=str(vae_ckpt),
                      latent_scale_factor=0.5)
        model = random_model(config, gen)
        launches["export_latent"], figures["latent UNet"] = export_case(
            "latent UNet + decode", model, config, LATENT_FORWARD,
            ((VAE_CODER, 1),), gen, smi)
        del model
    return launches, figures


# ------------------------------------------------------------ the 64x64 DiT
DIT64_SIZE, DIT64_LENGTH = 64, 1024
DIT64_BATCHES = (128, 64, 32, 16)  # the largest whose train step fits
DIT64_CHECK_BATCH = 4  # the plain dropout mask is BH L^2 values
TOL_DIT64_LOSS, TOL_DIT64_GRAD = TOL_LOSS, TOL_GRAD


def dit64_config(precision="none"):
    size = (DIT64_SIZE, DIT64_SIZE)
    config = load_config(DIT_CONFIG)
    return dict(config, image_size=size, dataset="synthetic",
                mixed_precision=precision,
                model_params=dict(config["model_params"], img_size=size))


def dit64_step_fits(config, batch, gen):
    """Whether one train step of the 64x64 DiT (forward, backward, AdamW)
    at `batch` fits on the card."""
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    process = factory.get_diffusion(config)
    try:
        x0 = torch.rand(batch, DIT64_SIZE, DIT64_SIZE, 3, generator=gen,
                        device="cuda") * 2 - 1
        t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
        y = torch.randint(0, 11, (batch,), generator=gen, device="cuda")
        process.p_losses(model, x0, t, torch.randn_like(x0), y=y).backward()
        opt.step()
        torch.cuda.synchronize()
        return True
    except torch.cuda.OutOfMemoryError:
        return False


def dit64_batch(config, gen):
    """The largest of DIT64_BATCHES whose train step fits on the card,
    tried from the largest down."""
    for batch in DIT64_BATCHES:
        fits = dit64_step_fits(config, batch, gen)
        torch.cuda.empty_cache()
        if fits:
            return batch
        print(f"DiT 64x64 {config['mixed_precision']}: a train step at "
              f"batch {batch} does not fit")
    raise AssertionError("DiT 64x64: no train step fits")


def phase_k3_sweep(batch, gen, smi):
    """K3's two forms at the 64x64 DiT's train step (BH = batch x 6, L 1024,
    d 64) in float32 and bf16, at p 0 and 0.1: the fused form (its dq
    shares in a (BH, L/64, L, 64) float32 scratch) against the two-kernel
    form, which recomputes the scores for dq; each beside K2, the library's
    forward and backward (`F.scaled_dot_product_attention` on (1, BH, L,
    d), its own dropout mask) and the bound. Both forms held against each
    other; at BH 12 each against the plain version. The reading behind
    `flash_attention.FUSED_MAX_LEN`. Returns the times by (dtype, p)."""
    seq, d = DIT64_LENGTH, DIT_HEAD_DIM
    for fused in (True, False):
        check_attention_dropout("attention dropout, 64x64 DiT", 12, seq, d,
                                gen, fused=fused)
    bh = batch * DIT_HEADS
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        for p in (0.0, ATTN_DROPOUT):
            drop = (p, ATTN_DROPOUT_SEED if p else None)
            o, lse = flash_attention.flash_attention_fwd(q, k, v, *drop)
            bwd = {fused: flash_attention.flash_attention_bwd(
                q, k, v, o, do, lse, *drop, fused=fused)
                for fused in (True, False)}
            torch.cuda.synchronize()
            apart = max(max_rel(a.float(), b.float())
                        for a, b in zip(bwd[True], bwd[False]))
            del bwd
            t = {
                "fwd": median_ms(lambda: flash_attention.flash_attention_fwd(
                    q, k, v, *drop), reps=10, warmup=2),
                "fused": median_ms(lambda: flash_attention.flash_attention_bwd(
                    q, k, v, o, do, lse, *drop, fused=True), reps=10,
                    warmup=2),
                "two_kernel": median_ms(
                    lambda: flash_attention.flash_attention_bwd(
                        q, k, v, o, do, lse, *drop, fused=False), reps=10,
                    warmup=2),
                "fwd_library": median_ms(
                    lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], dropout_p=p), reps=10,
                    warmup=2)}
            out = F.scaled_dot_product_attention(*qkv, dropout_p=p)
            t["bwd_library"] = median_ms(lambda: torch.autograd.grad(
                out, qkv, do[None], retain_graph=True), reps=10, warmup=2)
            del out
            rate = PEAK_BF16_TC_OPS_PER_S if bf16 else PEAK_FP32_OPS_PER_S
            elem = 2 if bf16 else 4
            t["fwd_bound"] = Bound(rate).add(*attn_work(bh, seq, d,
                                                        elem=elem)).ms
            t["bwd_bound"] = Bound(rate).add(*attn_work(bh, seq, d, True,
                                                        elem=elem)).ms
            tile = flash_attention.bwd_tile(seq, d, dtype)
            scratch = bh * -(-seq // tile) * seq * d * 4
            name = "bf16" if bf16 else "fp32"
            times[(name, p)] = t
            print(f"K3 form sweep, 64x64 DiT step BH={bh} L={seq} d={d} "
                  f"{name} p={p}: fused {t['fused']:.4f} ms (scratch "
                  f"{scratch / 2**30:.2f} GiB), two kernels "
                  f"{t['two_kernel']:.4f} ms, apart max_rel {apart:.3e}; "
                  f"the library's backward {t['bwd_library']:.4f} ms; K2 "
                  f"{t['fwd']:.4f} ms, the library's forward "
                  f"{t['fwd_library']:.4f} ms; bounds forward "
                  f"{t['fwd_bound']:.4f} ms, backward {t['bwd_bound']:.4f} "
                  f"ms; the wrapper takes "
                  f"{attention_bwd_form(seq, d, dtype=dtype)}; on {smi}")
            if not apart <= (2 * 2**-8 if bf16 else TOL_BWD):
                raise AssertionError(f"K3 forms apart {apart} at {name} "
                                     f"p={p}")
        del q, k, v, do, qkv, o, lse
        torch.cuda.empty_cache()
    return times


def phase_dit64(gen, smi):
    """The DiT on 64x64 images (configs/cifar10_dit.py with image_size and
    img_size (64, 64) on the `synthetic` dataset: L 1024, 6 heads of 64, 12
    blocks): for fp32 and bf16, the largest of DIT64_BATCHES whose step
    fits; the loss and gradients at batch DIT64_CHECK_BATCH in train mode
    (dropout 0.1) against `plain_kernels()` with 12 K2 + 12 K3 in the
    dropout form; one epoch of `train` at that batch, train images/s and
    peak memory; K3's form sweep and the library at the fp32 training
    shape; 40 images DDIM-20 CFG 3 through `sample` (12 K2 a forward) in
    fp32 and bf16. Returns the launches and figures."""
    out = {"launches": {}, "rates": {}, "peak": {}, "batch": {},
           "seconds": {}}
    for precision, step, forward, tol in (
            ("none", DIT_STEP, DIT_FORWARD, (TOL_DIT64_LOSS, TOL_DIT64_GRAD)),
            ("bf16", DIT_STEP_BF16, DIT_FORWARD_BF16,
             (TOL_BF16_LOSS, TOL_BF16_GRAD))):
        name = "fp32" if precision == "none" else precision
        label = f"DiT 64x64 {name}"
        config = dit64_config(precision)
        batch = dit64_batch(config, gen)
        out["batch"][name] = batch
        model = random_model(config, gen).train()
        phase_train_grads(label, model, config, step, gen,
                          batch_size=DIT64_CHECK_BATCH, seed=TRAIN_SEED,
                          tol=tol)
        del model
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            trainer, out["launches"][f"dit64_train_{name}"] = run_train_main(
                label, dict(config, batch_size=batch), step, tmp, 1,
                SYNTHETIC_IMAGES // batch)
            rates, peak = time_train_rates(trainer, runs=1)
            del trainer
        torch.cuda.empty_cache()
        out["rates"][name], out["peak"][name] = rates[0], peak
        print(f"{label} train images/s at batch {batch}, the largest of "
              f"{DIT64_BATCHES} that fits: {rates[0]:.2f}; peak device "
              f"memory {peak / 2**20:.1f} MiB; on {smi}")
        if name == "fp32":
            out["sweep"] = phase_k3_sweep(batch, gen, smi)
        model = random_model(dit64_config(), gen)
        flags = () if name == "fp32" else ("--mixed_precision", "bf16")
        with tempfile.TemporaryDirectory() as tmp:
            out["launches"][f"dit64_sample_{name}"], out["seconds"][name] = (
                phase_sample_main(label, dit64_config(), model, forward, tmp,
                                  flags=flags, steps=SHORT_STEPS,
                                  samples=SHORT_SAMPLES))
        del model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ parallel
# Item 15's first slice (`parallel/`): DDP at world 1 under NCCL in this
# process, then the tensor-parallel, data-parallel and FSDP layouts in a gloo
# world of two processes on the one card (NCCL refuses two ranks on one
# device; gloo carries CUDA tensors through host memory, so those legs run
# a small global batch and time nothing). FSDP runs at world 2 under gloo:
# gloo took `reduce_scatter_tensor` and `all_gather_into_tensor` on CUDA
# tensors and FSDP2's hooks on the H100.
DDP_STEPS = 3
PARALLEL_BATCH = 32  # the world-2 legs' global batch (`batch_size`): 16
# rows a DP rank
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT = 480
# a rank's step at sequence parallel 2 (`parallel/sequence_parallel.py`,
# `dim_sequence_parallel.py`): the DiT's attention in E6's dropout form (its
# queries against every key), the DiM's two stated scans a block (E4: the end
# state from zero, then y from h_in) and their two stated backwards
SP_DEGREE = 2
DIT_SP_STEP = dict(DIT_STEP, attn_cross=ATTN_PER_DIT_FORWARD,
                   attn_bwd_cross=ATTN_PER_DIT_FORWARD)
DIM_SP_STEP = {"scan_fwd_state": 2 * SCAN_PER_FORWARD,
               "scan_bwd_state": 2 * SCAN_PER_FORWARD}
# E7 at a tensor-parallel rank of the DiT at its training batch: heads 3..5
# of 6 (rank 1 of 2), every row of 128
E7_BATCH, E7_GRID = TRAIN_BATCH, (DIT_HEADS // 2, DIT_HEADS, 0, DIT_HEADS // 2)
# after a leg's checked first step, step 2 on the same batch, timed: the
# steady step that a first step's allocations and first draws hide (steps
# 2 and 3 until the shapes phase came)
LEG_STEADY_STEPS = 1


def parallel_trainer(config, state, device="cuda"):
    """`DiffusionTrainer` on `config` with the weights `state` (the full
    model's, before any split), no tracker, no loader."""
    model = factory.get_model(config)
    model.load_state_dict(state)
    return DiffusionTrainer(model, factory.get_diffusion(config), [None],
                            config, device, tracker=NullTracker())


def record_full_grads(trainer):
    """Make `trainer`'s optimizer record the full gradients (gathered to the
    single-device names, before the clip) at its update, flattened in the
    model's parameter order; returns the list it fills."""
    plan, store = trainer.plan, []
    before = plan.average_replicated_grads

    def hook():
        before()
        store.append(torch.cat([g.flatten() for g in
                                plan.full_gradients(trainer.model).values()]))
    plan.average_replicated_grads = hook
    return store


def timed_step(trainer, batch):
    """(loss, seconds) of one synchronised train step on `batch`."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss = trainer.train_step(batch["x0"], batch["labels"], batch["t"],
                              batch["noise"], batch["drop"])
    torch.cuda.synchronize()
    return loss, time.perf_counter() - start


def time_calls(obj, name, store):
    """Wrap the method `name` of `obj`: each call's synchronised seconds
    are appended to `store`."""
    inner = getattr(obj, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - start)
        return out
    setattr(obj, name, timed)


def parallel_leg_step(leg):
    """One train step of `leg` (its config, weights and global batch, files
    under the parent's directory) on this rank's layout, dropout on with
    the generators seeded at TRAIN_SEED: the loss (mean over 'data') and
    the full gradients held against the one-process step's (`leg["ref"]`,
    on rank 0), this rank's launches, peak device memory and sharded
    share; then LEG_STEADY_STEPS more steps, timed. A leg's own keys:
    `replay_routing`, the one-process step's experts imposed on this
    rank's rows in the checked step (a MoE leg); `time_replay`, the
    pipeline's draw replay timed in every step, and one step more with
    every dropout at 0 (a PP leg)."""
    config = load_config(Path(leg["config"]))
    trainer = parallel_trainer(config, torch.load(leg["state"]))
    grads = record_full_grads(trainer)
    lay = trainer.plan.layout
    batch = {k: lay.rows(v.to("cuda")) for k, v in torch.load(
        leg["batch"]).items()}
    torch.manual_seed(TRAIN_SEED)
    # the legs before this one in the process leave nothing behind (the
    # recording hook holds its trainer in a cycle): the peak is this leg's
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    replays = []
    if leg.get("time_replay"):
        time_calls(trainer.train_model, "replay", replays)
    with contextlib.ExitStack() as stack:
        if leg.get("replay_routing"):
            ref = torch.load(leg["ref"])
            stack.enter_context(recorded_choices(trainer.model, {
                "experts": [lay.rows(e.to("cuda")) for e in ref["experts"]],
                "plans": []}))
        reset_launches()
        loss, seconds = timed_step(trainer, batch)
    out = {"launches": read_launches(),
           "peak": torch.cuda.max_memory_allocated(), "base": base,
           "loss": float(lay.mean_over_data(loss)),
           "sharded": sharded_fraction(trainer.model),
           "layout": (lay.dp, lay.tp), "seconds": seconds}
    out["steady"] = [timed_step(trainer, batch)[1]
                     for _ in range(LEG_STEADY_STEPS)]
    if leg.get("time_replay"):
        # no draws to replay, K2/K3 in their plain form
        for m in trainer.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
            elif hasattr(m, "replayed_seed"):
                m.dropout = 0.0
        out["step_p0"] = timed_step(trainer, batch)[1]
        out["replay_seconds"] = replays
    if dist.get_rank() == 0:
        ref = torch.load(leg["ref"])
        out["loss_rel"] = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
        out["grad_rel"] = max_rel(grads[0], ref["grads"])
    del trainer, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def parallel_rank(legs):
    """(In each rank of the gloo world.) Every leg in turn."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [parallel_leg_step(leg) for leg in legs]


def phase_ddp(gen, smi, tmp):
    """The fp32 UNet through `DiffusionTrainer` under DDP at world 1 (NCCL,
    this process): DDP_STEPS steps from the same weights on the same draws
    as the trainer without a process group, parameters and losses within
    1e-6, one train step's launches a step; then train images/s of both."""
    config = load_config(CONFIG)
    config = dict(config, save_dir=str(Path(tmp) / "ddp"),
                  sample_dir=str(Path(tmp) / "ddp_samples"))
    torch.manual_seed(0)
    state = factory.get_model(config).state_dict()
    shape = (TRAIN_BATCH, *image_shape(config))
    draws = [{"x0": torch.rand(*shape, generator=gen, device="cuda") * 2 - 1,
              "labels": torch.randint(0, 10, (TRAIN_BATCH,), generator=gen,
                                      device="cuda"),
              "t": torch.randint(0, config["num_timesteps"], (TRAIN_BATCH,),
                                 generator=gen, device="cuda"),
              "noise": torch.randn(*shape, generator=gen, device="cuda"),
              "drop": torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
              < 0.2} for _ in range(DDP_STEPS)]

    def steps(trainer):
        """The losses, the parameters after the steps and the launches of
        all the steps, each step's read just after it."""
        losses, launched = [], expect()
        for d in draws:
            torch.manual_seed(TRAIN_SEED)
            reset_launches()
            loss = trainer.train_step(d["x0"], d["labels"], d["t"],
                                      d["noise"], d["drop"])
            torch.cuda.synchronize()
            counts = read_launches()
            if counts != expect(**UNET_STEP):
                raise AssertionError(f"DDP leg launches {counts}, "
                                     f"expected {expect(**UNET_STEP)}")
            launched = {k: n + counts[k] for k, n in launched.items()}
            losses.append(loss.item())
        return losses, torch.cat([p.detach().flatten() for p in
                                  trainer.model.parameters()]), launched

    plain = parallel_trainer(config, state)
    plain_losses, plain_params, _ = steps(plain)
    images, labels = draws[0]["x0"], draws[0]["labels"]
    plain_rate = time_train_steps(plain, images, labels)
    del plain
    init_process_group(torch.device("cuda", 0), rank=0, world_size=1,
                       store=dist.FileStore(str(Path(tmp) / "ddp_store"), 1),
                       backend="nccl")
    try:
        ddp = parallel_trainer(config, state)
        if type(ddp.train_model).__name__ != "DistributedDataParallel":
            raise AssertionError(f"world 1 trained through "
                                 f"{type(ddp.train_model).__name__}")
        ddp_losses, ddp_params, ddp_launches = steps(ddp)
        ddp_rate = time_train_steps(ddp, images, labels)
        del ddp
    finally:
        dist.destroy_process_group()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ddp_losses,
                                                       plain_losses))
    param_rel = max_rel(ddp_params, plain_params)
    print(f"parallel DDP (world 1, NCCL) UNet B={TRAIN_BATCH}, {DDP_STEPS} "
          f"steps vs no process group: losses {ddp_losses} vs "
          f"{plain_losses}, max_rel {loss_rel:.3e}; parameters max_rel "
          f"{param_rel:.3e}; launches of the {DDP_STEPS} DDP steps "
          f"{ddp_launches}")
    print(f"parallel DDP train images/s at batch {TRAIN_BATCH}: "
          f"{ddp_rate:.2f} through DDP, {plain_rate:.2f} without; DDP step "
          f"overhead {1e3 * TRAIN_BATCH * (1 / ddp_rate - 1 / plain_rate):.3f}"
          f" ms on {smi}")
    if not (loss_rel <= 1e-6 and param_rel <= 1e-6):
        raise AssertionError(f"DDP world 1: losses {loss_rel}, parameters "
                             f"{param_rel}")
    return {"ddp_rate": ddp_rate, "plain_rate": plain_rate,
            "loss_rel": loss_rel, "param_rel": param_rel,
            "launches": ddp_launches}


def phase_e7(gen):
    """E7 on the card: every dropout form of K2 and K3 (float32 and bf16,
    with and without the key bias, fused and two-kernel backward) at a
    tensor-parallel rank's head grid, against the plain versions at the
    same grid; and the kernel's mask read back (v = I) against the rank's
    slice of the single-device `philox_keep_mask` (at L 64). Returns the
    worst error of each form (relative in float32, absolute in bf16)."""
    bh, seq, d = E7_BATCH * E7_GRID[0], DIT_LENGTH, DIT_HEAD_DIM
    drop, worst = (ATTN_DROPOUT, ATTN_DROPOUT_SEED), {}
    for dtype in (torch.float32, torch.bfloat16):
        for bias in (False, True):
            for fused in (True, False):
                q, k, v, do = (torch.randn(bh, seq, d, generator=gen,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                key_bias = (torch.rand(E7_BATCH, seq, generator=gen,
                                       device="cuda").add(0.5).log()
                            if bias else None)
                reset_launches()
                o, lse = flash_attention.flash_attention_fwd(
                    q, k, v, *drop, key_bias, head_grid=E7_GRID)
                grads = flash_attention.flash_attention_bwd(
                    q, k, v, o, do, lse, *drop, fused=fused, bias=key_bias,
                    head_grid=E7_GRID)
                torch.cuda.synchronize()
                counts = read_launches()
                if (counts["attn_dropout"], counts["attn_bwd_dropout"]) != (
                        1, 1):
                    raise AssertionError(f"E7 launches {counts}")
                o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(
                    q, k, v, *drop, key_bias, E7_GRID)
                # the backward's plain version from the kernel's o and lse
                # (as `check_attention_bf16`)
                refs = flash_attention.flash_attention_bwd_ref(
                    q, k, v, o, do, lse, *drop, key_bias, E7_GRID)
                label = (f"E7 {str(dtype).split('.')[-1]} "
                         f"{'bias' if bias else 'no bias'} "
                         f"{'fused' if fused else 'two-kernel'}")
                lse_err = (lse - lse_ref).abs().max().item()
                if dtype == torch.bfloat16:
                    errs = [bf16_check(label, o, o_ref, BF16_STEPS_FWD,
                                       TOL_OUT)[1]]
                    errs += [bf16_check(label, g, r, BF16_STEPS_BWD,
                                        TOL_BWD)[1]
                             for g, r in zip(grads, refs)]
                    ok = lse_err <= TOL_LSE
                else:
                    errs = [max_rel(o, o_ref)] + [max_rel(g, r) for g, r in
                                                  zip(grads, refs)]
                    ok = (errs[0] <= TOL_OUT and lse_err <= TOL_LSE
                          and max(errs[1:]) <= TOL_BWD)
                print(f"  {label}: BH={bh} L={seq} d={d} grid {E7_GRID}, "
                      f"o {errs[0]:.3e}, lse {lse_err:.3e}, dq/dk/dv "
                      f"{', '.join(f'{e:.3e}' for e in errs[1:])}")
                if not ok:
                    raise AssertionError(f"{label}: {errs}, lse {lse_err}")
                worst[label] = max(errs)
    full_bh = E7_BATCH * DIT_HEADS
    index = torch.tensor([b * DIT_HEADS + E7_GRID[3] + h
                          for b in range(E7_BATCH)
                          for h in range(E7_GRID[0])], device="cuda")
    seq = 64  # v = I: head_dim = L, within the kernels' 128
    for dtype in (torch.float32, torch.bfloat16):
        qk = [torch.randn(bh, seq, seq, generator=gen, device="cuda").to(
            dtype) for _ in range(2)]
        eye = torch.eye(seq, device="cuda", dtype=dtype).expand(
            bh, -1, -1).contiguous()
        o, _ = flash_attention.flash_attention_fwd(*qk, eye, *drop,
                                                   head_grid=E7_GRID)
        full = flash_attention.philox_keep_mask(
            ATTN_DROPOUT_SEED, full_bh, seq, seq, ATTN_DROPOUT,
            device="cuda")
        if not torch.equal(o != 0, full[index]):
            raise AssertionError(f"E7 {dtype}: the kernel's mask at the "
                                 "rank's grid is not its slice of the "
                                 "single-device mask")
    print(f"E7: the mask of a tensor-parallel rank (heads {E7_GRID[3]}.."
          f"{E7_GRID[3] + E7_GRID[0] - 1} of {DIT_HEADS}, BH {bh}, L {seq}) "
          "read back from K2 in float32 and bf16 equals its slice of the "
          "single-device mask")
    return worst


def parallel_reference(label, config, state, batch):
    """The one-process step of a world-2 leg: loss and full gradients."""
    trainer = parallel_trainer(config, state)
    grads = record_full_grads(trainer)
    torch.manual_seed(TRAIN_SEED)
    reset_launches()
    loss = trainer.train_step(*(batch[k].to("cuda") for k in (
        "x0", "labels", "t", "noise", "drop")))
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "grads": grads[0],
           "launches": read_launches(),
           "peak": torch.cuda.max_memory_allocated()}
    del trainer
    torch.cuda.empty_cache()
    print(f"parallel {label} one-process reference: loss {out['loss']:.6f}, "
          f"launches {out['launches']}")
    return out


def phase_parallel(gen, smi, more_legs=None):
    """Item 15 on the card: DDP at world 1 (`phase_ddp`), E7 (`phase_e7`),
    then a gloo world of two processes on the card: the DiT (dropout 0.1)
    at TP 2, at DP 2, at FSDP 2, at SP 2 and at PP 2, the DiM at TP 2, DP
    2, SP 2 and PP 2, and the legs `more_legs(gen, tmp)` returns with
    their references (`chip_smoke_pipeline.parallel_legs`: the MoE DiT at
    EP 2 and DP 2),
    each rank's loss and gathered gradients against the one-process step on
    the same global batch (TOL_LOSS, TOL_GRAD), each rank with one step's
    launches (the DiT's attention in the dropout form, at its rank's head
    grid or, at SP 2, its rows against every key (E6); the DiM's scans on
    its 384 channels, K6 and K8, or at SP 2 the stated scans (E4)), and the
    peak memory a rank under FSDP beside DDP's (`phase_sequence_parallel`
    reads the SP legs beside DP 2's, `phase_pipeline_expert` the PP and EP
    legs)."""
    # the ranks compute float32 without TF32 (`parallel_rank`): so must the
    # references here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        figures["ddp"] = phase_ddp(gen, smi, tmp)
        figures["e7"] = phase_e7(gen)
        legs, refs = [], {}
        for name, path, step, sp_step in (
                ("DiT", DIT_CONFIG, DIT_STEP, DIT_SP_STEP),
                ("DiM", DIM_CONFIG, DIM_STEP, DIM_SP_STEP)):
            config = load_config(path)
            state = random_model(config, gen).cpu().state_dict()
            shape = (PARALLEL_BATCH, *image_shape(config))
            batch = {
                "x0": torch.rand(*shape, generator=gen, device="cuda") * 2 - 1,
                "labels": torch.randint(0, 10, (PARALLEL_BATCH,),
                                        generator=gen, device="cuda"),
                "t": torch.randint(0, config["num_timesteps"],
                                   (PARALLEL_BATCH,), generator=gen,
                                   device="cuda"),
                "noise": torch.randn(*shape, generator=gen, device="cuda"),
                "drop": torch.rand(PARALLEL_BATCH, generator=gen,
                                   device="cuda") < 0.2}
            files = {}
            for key, obj in (("state", state), ("batch", {
                    k: v.cpu() for k, v in batch.items()})):
                files[key] = str(Path(tmp) / f"{name}_{key}.pt")
                torch.save(obj, files[key])
            base = dict(config, save_dir=str(Path(tmp) / f"{name}_ckpt"),
                        sample_dir=str(Path(tmp) / f"{name}_samples"),
                        batch_size=PARALLEL_BATCH)
            refs[name] = parallel_reference(name, base, state, batch)
            files["ref"] = str(Path(tmp) / f"{name}_ref.pt")
            torch.save(refs[name], files["ref"])
            sp = (f"SP {SP_DEGREE}", {"sequence_parallel": SP_DEGREE},
                  sp_step)
            pp = ("PP 2", {"pipeline_parallel": 2}, step, True)
            layouts = ([("TP 2", {"tensor_parallel": 2}, step),
                        ("DP 2", {}, step), ("FSDP 2", {"fsdp": True}, step),
                        sp, pp] if name == "DiT" else
                       [("TP 2", {"tensor_parallel": 2}, step),
                        ("DP 2", {}, step), sp, pp])
            for layout, changes, per_step, *piped in layouts:
                cfg_path = Path(tmp) / f"{name}_{layout.replace(' ', '')}.py"
                cfg_path.write_text(f"config = {dict(base, **changes)!r}\n")
                legs.append(dict(name=name, layout=layout, step=per_step,
                                 config=str(cfg_path), time_replay=bool(piped),
                                 **files))
        if more_legs is not None:
            more, more_refs = more_legs(gen, tmp)
            legs += more
            refs.update(more_refs)
        launched = time.perf_counter()
        ranks = launch(PARALLEL_WORLD, "chip_smoke.parallel_rank", legs,
                       device="cuda", backend="gloo",
                       timeout=PARALLEL_TIMEOUT)
        world_seconds = time.perf_counter() - launched
    peaks, launched_by_leg, by_leg = {}, {}, {}
    for i, leg in enumerate(legs):
        ref = refs[leg["name"]]
        first = ranks[0][i]
        loss_rel, grad_rel = first["loss_rel"], first["grad_rel"]
        per_rank = [r[i]["launches"] for r in ranks]
        peaks[(leg["name"], leg["layout"])] = [r[i]["peak"] for r in ranks]
        launched_by_leg[f"{leg['name']} {leg['layout']}"] = per_rank[0]
        label = f"parallel {leg['name']} {leg['layout']} (gloo, 2 ranks)"
        print(f"{label}: layout (dp, tp) {first['layout']}, loss "
              f"{first['loss']:.6f} vs {ref['loss']:.6f} max_rel "
              f"{loss_rel:.3e}, gathered gradient max_abs_diff/max_abs "
              f"{grad_rel:.3e}; sharded share {first['sharded']:.3f}; "
              f"launches a rank {per_rank}; peak a rank "
              f"{[round(r[i]['peak'] / 2**20, 1) for r in ranks]} MiB (at "
              f"the step's start {[round(r[i]['base'] / 2**20, 1) for r in ranks]}"
              f" MiB); step {first['seconds']:.3f} s, steady steps "
              f"{[round(t, 4) for t in first['steady']]} s")
        if any(c != expect(**leg["step"]) for c in per_rank):
            raise AssertionError(f"{label}: launches {per_rank}, expected "
                                 f"{expect(**leg['step'])} a rank")
        if not (loss_rel <= TOL_LOSS and grad_rel <= TOL_GRAD):
            raise AssertionError(f"{label}: loss {loss_rel}, gradients "
                                 f"{grad_rel}")
        by_leg[(leg["name"], leg["layout"])] = {
            "launches": per_rank[0], "peak": max(r[i]["peak"] for r in ranks),
            "base": max(r[i]["base"] for r in ranks),
            "seconds": max(r[i]["seconds"] for r in ranks),
            "steady": max(statistics.mean(r[i]["steady"]) for r in ranks),
            "err": max(loss_rel, grad_rel),
            **{k: first[k] for k in ("replay_seconds", "step_p0")
               if k in first}}
    fsdp, ddp = peaks[("DiT", "FSDP 2")], peaks[("DiT", "DP 2")]
    print(f"parallel DiT peak device memory a rank at global batch "
          f"{PARALLEL_BATCH}: FSDP 2 {max(fsdp) / 2**20:.1f} MiB, DDP "
          f"{max(ddp) / 2**20:.1f} MiB ({max(fsdp) / max(ddp):.3f}x) on "
          f"{smi}; the gloo world took {world_seconds:.1f} s")
    figures.update(peaks=peaks, world_seconds=world_seconds,
                   launches=launched_by_leg, legs=by_leg)
    return figures


def main():
    smi = device_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # what the later phases take from the earlier ones: the trained UNet
    keep = tempfile.TemporaryDirectory()
    unet_ckpt = Path(keep.name) / "unet_trained.pth"
    flow_ckpt = Path(keep.name) / "flow_trained.pth"

    with clock("phase_build"):
        phase_build()
    with clock("phase_gn"):
        gn_err, gn_bwd_err = phase_gn(gen)
    with clock("phase_attn"):
        attn_err = phase_attn(gen)
    config = load_config(CONFIG)
    with clock("phase_unet, phase_trajectory, phase_main_shapes"):
        model, gn_shapes, attn_shapes = phase_unet(config, gen)
        phase_trajectory(model, gen)
        totals, main_err, bounds = phase_main_shapes(gn_shapes, attn_shapes,
                                                     2 * SAMPLES, gen)
    with tempfile.TemporaryDirectory() as tmp:
        with clock("phase_sample_main UNet"):
            launches, seconds = phase_sample_main("UNet", config, model,
                                                  UNET_FORWARD, tmp)
        with clock("phase_serve"):
            served = phase_serve(Path(tmp) / "unet_random.pth", config,
                                 model, gen, smi)
    with clock("phase_samplers"):
        fast = phase_samplers(config, model, UNET_FORWARD, gen, smi)
    with clock("phase_knobs"):
        knobs = phase_knobs(config, model, gen, smi)
    # the SASS that `phase_build` began to read
    with clock("phase_tensor_cores (the wait)"):
        phase_tensor_cores()
    del model
    with clock("phase_gn_train_step, phase_attn_bwd, UNet train grads"):
        gn_step_err, gn_step, gn_bwd_bound = phase_gn_train_step(gn_shapes,
                                                                 gen)
        bwd_err, bwd_totals, bwd_bound = phase_attn_bwd(attn_shapes, gen)
        torch.manual_seed(0)
        phase_train_grads("UNet",
                          factory.get_model(config).to("cuda").eval(),
                          config, UNET_STEP, gen)
    with tempfile.TemporaryDirectory() as tmp, clock("phase_train_main UNet"):
        # DDIM-10, and DDPM over all the timesteps of a config that has
        # DDPM_CUT of them (the checkpoint's 1000 took 25 s, cut to keep
        # the script inside its time)
        ddpm_config = Path(tmp) / "unet_ddpm_cut.py"
        ddpm_config.write_text(
            f"config = {dict(config, num_timesteps=DDPM_CUT)!r}\n")
        samplers = [("ddim", 10, ["--num_inference_steps", "10"]),
                    ("ddpm", DDPM_CUT, ["--config", str(ddpm_config)])]
        train_launches, rates, unet_peak = phase_train_main(
            "UNet", config, UNET_STEP, UNET_FORWARD, samplers, tmp)
        shutil.copy(Path(tmp) / "checkpoints" / "current_model.pth",
                    unet_ckpt)
    processes = {}
    for kind in PROCESS_SAMPLERS:
        with tempfile.TemporaryDirectory() as tmp, \
                clock(f"phase_process {kind}"):
            processes[kind] = phase_process(kind, gen, smi, tmp)
            if kind == "flow_matching":  # reflow's teacher
                shutil.copy(Path(tmp) / "checkpoints" / "current_model.pth",
                            flow_ckpt)

    dim_config = load_config(DIM_CONFIG)
    with clock("phase_scan"):
        scan_err, scan_times = phase_scan(gen)
    with clock("DiM forwards, trajectory, sample.main"):
        dim_model, dim_params, _ = phase_model_forward("DiM", dim_config,
                                                       DIM_FORWARD, gen)
        phase_trajectory(dim_model, gen)
        with tempfile.TemporaryDirectory() as tmp:
            dim_launches, dim_seconds = phase_sample_main(
                "DiM", dim_config, dim_model, DIM_FORWARD, tmp)
        del dim_model
    with clock("DiM train grads and remat grads"):
        dim_model = random_model(dim_config, gen)
        phase_train_grads("DiM", dim_model, dim_config, DIM_STEP, gen)
        phase_remat_grads("DiM", dim_model, dim_config, DIM_STEP,
                          DIM_REMAT_STEP, gen)
        del dim_model
    samplers = [("ddim", 10, ["--num_inference_steps", "10",
                              "--cfg_scale", str(CFG_SCALE)])]
    with tempfile.TemporaryDirectory() as tmp, clock("phase_train_main DiM"):
        dim_train_launches, dim_rates, dim_peak = phase_train_main(
            "DiM", dim_config, DIM_STEP, DIM_FORWARD, samplers, tmp)
    with tempfile.TemporaryDirectory() as tmp, \
            clock("phase_train_main DiM remat"):
        remat_launches, remat_rates, remat_peak = phase_train_main(
            "DiM remat", dict(dim_config, remat=True), DIM_REMAT_STEP,
            DIM_FORWARD, samplers, tmp, plain_runs=0, kernel_runs=1)

    # the same DiM on 64x64 images, on the `synthetic` dataset (one epoch)
    for batch, step in ((DIM64_BATCH, DIM64_STEP),
                        (DIM64_SMALL_BATCH, DIM64_SMALL_STEP)):
        if routed_step(batch, DIM64_LENGTH) != step:
            raise AssertionError(
                f"64x64 at batch {batch}: {step} is not what the scan's rules "
                f"route: {routed_step(batch, DIM64_LENGTH)}")
    size = (DIM64_SIZE, DIM64_SIZE)
    dim64_config = dict(
        dim_config, image_size=size, dataset="synthetic",
        batch_size=DIM64_BATCH,
        model_params=dict(dim_config["model_params"], img_size=size))
    with clock("DiM 64x64"):
        phase_train_grads("DiM 64x64", random_model(dim64_config, gen),
                          dim64_config, DIM64_STEP, gen,
                          batch_size=DIM64_BATCH)
        with tempfile.TemporaryDirectory() as tmp:
            dim64_launches, dim64_rates, dim64_peak = phase_train_main(
                "DiM 64x64", dim64_config, DIM64_STEP, DIM_FORWARD, samplers,
                tmp, epochs=1, steps_per_epoch=SYNTHETIC_IMAGES // DIM64_BATCH,
                plain_runs=0, kernel_runs=1)
        with tempfile.TemporaryDirectory() as tmp:
            _, dim64_small_launches = run_train_main(
                "DiM 64x64 batch 8",
                dict(dim64_config, batch_size=DIM64_SMALL_BATCH),
                DIM64_SMALL_STEP, tmp, 1,
                SYNTHETIC_IMAGES // DIM64_SMALL_BATCH)

    with clock("phase_dit"):
        dit = phase_dit(gen)
    with clock("phase_bf16"):
        bf16 = phase_bf16(gn_shapes, attn_shapes, gen)
    with clock("phase_evaluate"):
        evaluated = phase_evaluate(config, gen, smi)
    with clock("phase_latent"):
        latent = phase_latent(gen, smi)
    with clock("phase_classifier and phase_guided"):
        classified = phase_classifier(gen, smi, keep.name)
        guided = phase_guided(unet_ckpt, classified["ckpt"], keep.name, gen,
                              smi)
    with clock("phase_sr"):
        super_res = phase_sr(unet_ckpt, keep.name, gen, smi)
    with clock("phase_fewstep"):
        fewstep = phase_fewstep(unet_ckpt, flow_ckpt, gen, smi, seconds)
    with clock("phase_moe"):
        moe = phase_moe(gen, smi)
    with clock("phase_tome"):
        dit_random, merged = phase_tome(gen, smi)
    with clock("phase_int8"):
        int8 = phase_int8(dit_random, gen, smi)
    del dit_random
    with clock("phase_export"):
        exported, export_figures = phase_export(gen, smi)
    with clock("phase_dit64"):
        dit64 = phase_dit64(gen, smi)
    # beside this script; they import this script's helpers as `chip_smoke`
    import chip_smoke_data
    import chip_smoke_pipeline
    import chip_smoke_sequence
    import chip_smoke_serve
    import chip_smoke_shapes

    with clock("phase_shapes"):
        shapes = chip_smoke_shapes.phase_shapes(gen, smi)

    with clock("phase_parallel"):
        parallel = phase_parallel(gen, smi, chip_smoke_pipeline.parallel_legs)
    with clock("phase_sequence_parallel"):
        sequence = chip_smoke_sequence.phase_sequence_parallel(
            gen, smi, parallel["legs"])
    with clock("phase_pipeline_expert"):
        chip_smoke_pipeline.phase_pipeline_expert(gen, smi, parallel)
    with clock("phase_data_parallel"):
        data = chip_smoke_data.phase_data_parallel(smi, unet_ckpt, flow_ckpt)
    with clock("phase_serve_data_parallel"):
        served_dp = chip_smoke_serve.phase_serve_data_parallel(smi, unet_ckpt)
    keep.cleanup()

    print(f"{SAMPLES / seconds:.2f} samples/s DDIM-{STEPS} CFG {CFG_SCALE} "
          f"fp32 on {smi}")
    print(f"{statistics.median(rates['kernels']):.2f} train images/s at batch "
          f"{TRAIN_BATCH} fp32 (plain versions: "
          f"{statistics.median(rates['plain']):.2f}) on {smi}")
    for label, (_, sec, calls) in fast.items():
        print(f"UNet {label} ({calls} model calls): {SAMPLES / sec:.2f} "
              f"samples/s CFG {CFG_SCALE} fp32 on {smi}")
    # each knob's images a second a model call against DDIM-50's of its
    # model and precision (SAMPLES images) at SHORT_SAMPLES images
    yardsticks = {"DiT PAG": ("DiT", dit["seconds"]),
                  "UNet bf16 DeepCache depth 1": (
                      "UNet bf16", bf16["models"]["UNet"]["seconds"])}
    for label, (_, sec, calls) in knobs.items():
        if sec is not None:
            model_name, ddim_sec = yardsticks.get(label, ("UNet", seconds))
            ratio = (SHORT_SAMPLES * calls / sec) / (SAMPLES * STEPS
                                                     / ddim_sec)
            print(f"{label} ({calls} model calls, {SHORT_SAMPLES} images): "
                  f"{SHORT_SAMPLES / sec:.2f} samples/s CFG {CFG_SCALE} "
                  f"({ratio:.3f}x the {model_name} DDIM-{STEPS}'s model "
                  f"calls a second at {SAMPLES} images) on {smi}")
    for kind, run in processes.items():
        print(f"UNet {kind}: {statistics.median(run['rates']['kernels']):.2f} "
              f"train images/s at batch {TRAIN_BATCH} fp32 (plain versions: "
              f"{statistics.median(run['rates']['plain']):.2f}) on {smi}")
    print(f"DiM ({dim_params} parameters): {SAMPLES / dim_seconds:.2f} "
          f"samples/s DDIM-{STEPS} CFG {CFG_SCALE} fp32; "
          f"{statistics.median(dim_rates['kernels']):.2f} train images/s at "
          f"batch {TRAIN_BATCH} (plain versions: "
          f"{statistics.median(dim_rates['plain']):.2f}) on {smi}")
    print(f"DiM remat: {statistics.median(remat_rates['kernels']):.2f} train "
          f"images/s at batch {TRAIN_BATCH}, peak device "
          f"memory {remat_peak / 2**20:.1f} MiB against "
          f"{dim_peak / 2**20:.1f} MiB without remat, on {smi}")
    print(f"DiM 64x64: {statistics.median(dim64_rates['kernels']):.2f} train "
          f"images/s at batch {DIM64_BATCH}, peak device memory "
          f"{dim64_peak / 2**20:.1f} MiB, on {smi}")
    print(f"DiT ({dit['params']} parameters): {SAMPLES / dit['seconds']:.2f} "
          f"samples/s DDIM-{STEPS} CFG {CFG_SCALE} fp32 (plain versions: "
          f"{SAMPLES / dit['plain_seconds']:.2f}); "
          f"{statistics.median(dit['rates']['kernels']):.2f} train images/s "
          f"at batch {TRAIN_BATCH}, dropout 0.1 (plain versions: "
          f"{statistics.median(dit['rates']['plain']):.2f}), peak device "
          f"memory {dit['peak'] / 2**20:.1f} MiB; remat "
          f"{statistics.median(dit['remat_rates']['kernels']):.2f}, "
          f"peak {dit['remat_peak'] / 2**20:.1f} MiB; on {smi}")
    fp32_figures = {
        "UNet": (seconds, rates["kernels"], unet_peak),
        "DiM": (dim_seconds, dim_rates["kernels"], dim_peak),
        "DiT": (dit["seconds"], dit["rates"]["kernels"], dit["peak"])}
    dit_fast_launches, dit_fast_seconds = bf16["models"]["DiT"]["fast"]
    print(f"DiT bf16 {DIT_BF16_FAST_SAMPLER[0]}-{DIT_BF16_FAST_SAMPLER[1]}: "
          f"{SAMPLES / dit_fast_seconds:.2f} samples/s CFG {CFG_SCALE}, "
          f"{dit_fast_launches['attn_bf16']} bf16 attention launches, on "
          f"{smi}")
    for label, run in bf16["models"].items():
        seconds32, rates32, peak32 = fp32_figures[label]
        print(f"{label} bf16 ({run['params']} float32 parameters): "
              f"{SAMPLES / run['seconds']:.2f} samples/s DDIM-{STEPS} CFG "
              f"{CFG_SCALE} (fp32 {SAMPLES / seconds32:.2f}); "
              f"{statistics.median(run['rates']):.2f} train images/s at "
              f"batch {TRAIN_BATCH} (fp32 {statistics.median(rates32):.2f}), "
              f"peak device memory {run['peak'] / 2**20:.1f} MiB (fp32 "
              f"{peak32 / 2**20:.1f} MiB); on {smi}")
    for precision, key in (("fp32", "continuous"), ("bf16",
                                                     "continuous_bf16")):
        fig = served[key]
        print(f"serve --continuous {precision}, {SERVE_SLOTS} slots, "
              f"DDIM-{STEPS} CFG {CFG_SCALE}, {SERVE_REQUESTS} requests from "
              f"{SERVE_CLIENTS} clients: p50 {fig['p50_ms']:.1f} ms, p99 "
              f"{fig['p99_ms']:.1f} ms, {fig['images_per_s']:.2f} images/s, "
              f"{fig['ms_per_step']:.2f} ms a step, solo request "
              f"{fig['solo_s']:.3f} s, 16 images in one batch "
              f"{fig['batch_ms']:.1f} ms; on {smi}")
    print(f"serve batched: {SERVE_SLOTS} images DDIM-{STEPS} CFG {CFG_SCALE} "
          f"in {served['batched_seconds']:.3f} s over HTTP; on {smi}")
    print(f"classifier ({classified['params']} parameters): "
          f"{statistics.median(classified['rates']['kernels']):.2f} train "
          f"images/s at batch {CLASSIFIER_BATCH} (plain versions: "
          f"{statistics.median(classified['rates']['plain']):.2f}), peak "
          f"device memory {classified['peak'] / 2**20:.1f} MiB; classifier-"
          f"guided DDIM-{STEPS} CFG {CFG_SCALE} scale {GUIDANCE_SCALE}: "
          f"{SAMPLES / guided['seconds']:.2f} samples/s (unguided "
          f"{SAMPLES / guided['unguided_seconds']:.2f}); on {smi}")
    print(f"SR UNet 64x64 ({super_res['params']} parameters): "
          f"{statistics.median(super_res['rates']['kernels']):.2f} train "
          f"images/s at batch {super_res['batch']}, the largest of "
          f"{SR_BATCHES} that fits, peak device memory "
          f"{super_res['peak'] / 2**20:.1f} MiB; on {smi}")
    for key, t in super_res["times"].items():
        print(f"SR {key}: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in t.items()) + f"; on {smi}")
    dit32, dit16 = dit["seconds"], bf16["models"]["DiT"]["seconds"]
    for precision in ("fp32", "bf16"):
        dense = dit32 if precision == "fp32" else dit16
        sec = moe["seconds"][precision]
        print(f"DiT-MoE ({moe['params']} parameters) {precision}: "
              f"{SAMPLES / sec:.2f} samples/s DDIM-{STEPS} CFG {CFG_SCALE} "
              f"(dense DiT {SAMPLES / dense:.2f}, {dense / sec:.3f}x); "
              f"{statistics.median(moe['rates'][precision]):.2f} train "
              f"images/s at batch {TRAIN_BATCH}, peak device memory "
              f"{moe['peak'][precision] / 2**20:.1f} MiB; on {smi}")
        for key, what in ((precision, "attention"),
                          (f"mlp_{precision}", "attention + MLP")):
            sec = merged["seconds"][key]
            print(f"DiT ToMe {TOME_RATIO} ({what}) {precision}: "
                  f"{SAMPLES / sec:.2f} samples/s DDIM-{STEPS} CFG "
                  f"{CFG_SCALE} (unmerged DiT {SAMPLES / dense:.2f}, "
                  f"{dense / sec:.3f}x); on {smi}")
        sec = int8["seconds"][precision]
        print(f"DiT int8 {precision}: {SAMPLES / sec:.2f} samples/s "
              f"DDIM-{STEPS} CFG {CFG_SCALE} (float DiT "
              f"{SAMPLES / dense:.2f}, {dense / sec:.3f}x); on {smi}")
    for label, fig in export_figures.items():
        print(f"export {label} DDIM-{STEPS} CFG {CFG_SCALE}, {EXPORT_SAMPLES} "
              "images: "
              f"export {fig['export']:.2f} s, save {fig['save']:.2f} s, load "
              f"{fig['load']:.2f} s, blob {fig['blob_mib']:.2f} MiB; the "
              f"program {fig['rate']:.2f} samples/s, the live sampler "
              f"{fig['live_rate']:.2f}; bit-equal {fig['bit_equal']}; on "
              f"{smi}")
    for name in ("fp32", "bf16"):
        print(f"DiT 64x64 {name}: {dit64['rates'][name]:.2f} train images/s "
              f"at batch {dit64['batch'][name]}, peak device memory "
              f"{dit64['peak'][name] / 2**20:.1f} MiB; "
              f"{SHORT_SAMPLES / dit64['seconds'][name]:.2f} samples/s "
              f"({SHORT_SAMPLES} images) DDIM-{SHORT_STEPS} "
              f"CFG {CFG_SCALE}; on {smi}")
    print(f"serve --continuous DiT-MoE, {SERVE_SLOTS} images in one submit: "
          f"{moe['serve']['seconds']:.3f} s; DiT int8 output's distance from "
          f"the float DiT's {int8['distance']:.3e}; on {smi}")
    nets = evaluated["networks"]
    print(f"metric networks on the card against the CPU: max-rel "
          f"{nets['err']:.3e}; InceptionV3 {nets['rate']:.1f} images/s at "
          f"batch {INCEPTION_RATE_BATCH}; tr sqrtm {SQRTM_DIM}: scipy "
          f"{nets['scipy_s']:.3f} s on the host, Newton-Schulz "
          f"{nets['ns_s'] * 1e3:.2f} ms on the card; on {smi}")
    for label, key in (("UNet fp32", "unet"), ("DiT bf16", "dit")):
        print(f"evaluate {label} stage seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in evaluated[f"{key}_seconds"].items())
            + f"; on {smi}")
    few = fewstep["figures"]
    ddpm_rate = statistics.median(rates["kernels"])
    for label, key in (("consistency training fp32", "ct_fp32"),
                       ("consistency training bf16", "ct_bf16")):
        print(f"UNet {label}: {few[key]['rate']:.2f} train images/s at batch "
              f"{TRAIN_BATCH} ({few[key]['rate'] / ddpm_rate:.3f}x the fp32 "
              f"DDPM step's {ddpm_rate:.2f}), peak device memory "
              f"{few[key]['peak'] / 2**20:.1f} MiB; on {smi}")
    for label, key in (("consistency distillation CFG 3", "cd_rate"),
                       ("progressive distillation", "pd_rate")):
        print(f"UNet {label}: {few[key]:.2f} train images/s at batch "
              f"{TRAIN_BATCH} fp32 ({few[key] / ddpm_rate:.3f}x DDPM's); on "
              f"{smi}")
    for label, key, calls in (
            (f"consistency-{CM_STEPS} CFG {CFG_SCALE}", "ct_sample_seconds",
             CM_STEPS),
            (f"reflow Euler-1 CFG {CFG_SCALE}", "reflow_sample_seconds", 1)):
        sec = few[key]
        print(f"UNet {label} ({calls} model calls): {SAMPLES / sec:.2f} "
              f"samples/s fp32 ({seconds / sec:.2f}x DDIM-{STEPS}'s "
              f"{SAMPLES / seconds:.2f}); on {smi}")
    print(f"serve consistency-{CM_STEPS}: {SERVE_SLOTS} images CFG "
          f"{CFG_SCALE} in {few['ct_serve_seconds']:.3f} s over HTTP; "
          f"evaluate of {EVAL_DIT_SAMPLES} stage seconds " + ", ".join(
              f"{k} {v:.3f}" for k, v in few["ct_evaluate_seconds"].items())
          + f"; on {smi}")
    for opt_name, fig in few["optimizers"].items():
        print(f"DDPM UNet {opt_name}: {fig['rate']:.2f} train images/s at batch "
              f"{TRAIN_BATCH} fp32, peak device memory "
              f"{fig['peak'] / 2**20:.1f} MiB, optimizer state "
              f"{fig['state_bytes'] / 2**20:.1f} MiB; on {smi}")
    fwd_ms, fwd_plain = scan_times[("fwd", 2 * SAMPLES, 256, False)]
    bwd_ms, bwd_plain = scan_times[("bwd", TRAIN_BATCH, 256)]
    k7_ms, k7_plain = scan_times[("bwd_nostate", TRAIN_BATCH, 256)]
    k9_ms, k9_plain = scan_times[("fwd_split", DIM64_BATCH, 1024)]
    k10_ms, k10_plain = scan_times[("bwd_split", DIM64_SMALL_BATCH, 1024)]

    def per_model_call(kind, batch, length):
        """The bound of the 12 scans of one model call."""
        return Bound().add(*scan_work(kind, batch, length),
                           SCAN_PER_FORWARD).keys()
    # the dropout forms, ms of one DiT train step's 12 calls at BH 768, L 256,
    # d 64 against the p = 0 forms' bound (Philox's integer operations are
    # not counted as operations)
    drop_ms = {key: ATTN_PER_DIT_FORWARD * ms
               for key, ms in dit["dropout_times"].items()}
    drop_bound = {
        backward: Bound().add(*attn_work(TRAIN_BATCH * DIT_HEADS, DIT_LENGTH,
                                         DIT_HEAD_DIM, backward),
                              ATTN_PER_DIT_FORWARD).ms
        for backward in (False, True)}
    def path_launches(key, train_only=False):
        """A UNet kernel's launches on the later slices' paths: the fast
        samplers' and the editing and training-free knobs' `sample.main`
        runs (also DDIM inversion and back, PAG on the DiT and DeepCache on
        the bf16 UNet, whose `_bf16` counts the bf16 rows carry), and flow
        matching's and EDM's `train.main`."""
        out = {} if train_only else {
            f"sample_{label}": run[0][key] for label, run in fast.items()}
        if not train_only:
            out.update({f"sample_{label.replace(' ', '_')}": run[0][key]
                        for label, run in knobs.items()})
        out.update({f"train_{kind}": run["launches"][key]
                    for kind, run in processes.items()})
        return out
    def serve_launches(key):
        """A forward kernel's launches in `serve`: one batched request over
        HTTP, the continuous engine's traffic in fp32 and in bf16 (`*_bf16`
        keys count only the bf16 run, the others both)."""
        runs = {"serve": served["batched_launches"],
                "serve_continuous": served["continuous_launches"],
                "serve_continuous_bf16": served["continuous_bf16_launches"]}
        return {path: run[key] for path, run in runs.items()
                if run[key] or not key.endswith("_bf16")}
    def later_launches(key):
        """A float32 kernel's launches on the classifier's and SR3's paths:
        the classifier's `train.main`, guided `sample.main` (K1b and K3
        inside the sampler), the SR stage's `train.main`, `sample
        --sr_source` and the cascade."""
        runs = {"classifier_train": classified["launches"],
                "guided_sample": guided["launches"],
                **super_res["launches"]}
        return {path: run[key] for path, run in runs.items() if run[key]}
    def fewstep_launches(key):
        """A UNet kernel's launches on the few-step paths: consistency
        training's `train.main` (fp32 and bf16), `sample`, `evaluate` and
        `serve` of its checkpoint, the two distillations' and reflow's
        tools (reflow's pair synthesis counted apart) and a sample of each
        result; a float32 row lists the fp32 runs, a bf16 row the runs of
        its form."""
        return {path: run[key]
                for path, run in fewstep["launches"].items()
                if run[key] and (key.endswith("_bf16")
                                 or path.endswith("_fp32"))}
    def latent_launches(key):
        """A float32 kernel's launches on the latent slice's paths: both
        stages' `train.main`, `sample.main` (DDIM-50 CFG and img2img, decode
        included), `evaluate.main` and `serve` (batched, and continuous with
        its traffic)."""
        return {path: run[key] for path, run in latent["launches"].items()
                if run[key]}
    def parallel_launches(key):
        """A kernel's launches on the parallel paths: a rank's (rank 0's)
        in one step of each gloo leg (the DiT at TP 2, DP 2, FSDP 2, SP 2
        and PP 2, the DiM at TP 2, DP 2, SP 2 and PP 2, the MoE DiT at EP 2
        and DP 2), and the UNet's DDP_STEPS
        steps under DDP, each as its run read them."""
        out = {f"parallel_{leg.lower().replace(' ', '_')}": counts[key]
               for leg, counts in parallel["launches"].items()
               if counts[key]}
        if parallel["ddp"]["launches"][key]:
            out["parallel_unet_ddp"] = parallel["ddp"]["launches"][key]
        return out
    pallas = "diffusion_models_collection_tpu/ops/selective_scan_pallas.py"
    csrc = "diffusion_models_collection_tpu_torch/csrc/"
    kernels = [
        {"name": "gn_silu_fwd", "route": "cuda",
         "source": csrc + "gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:46",
         "launches": launches["gn"],
         "launches_by_path": {"sample": launches["gn"],
                              "train": train_launches["gn"],
                              **path_launches("gn"),
                              "evaluate": evaluated["unet_launches"]["gn"],
                              **serve_launches("gn"),
                              **latent_launches("gn"),
                              **later_launches("gn"),
                              **fewstep_launches("gn"),
                              **parallel_launches("gn")},
         "max_abs_err": max(gn_err, main_err["gn"], latent["worst"]["gn"],
                            super_res["worst"]["gn"],
                            classified["worst"]["gn"]),
         "ms": totals["gn"][0], "plain_ms": totals["gn"][1],
         **bounds["gn"].keys(), "library_ms": None},
        # K1b, ms per train step: 45 calls at batch 128. It has no TPU kernel
        # before it: the JAX package's backward, named here, recomputes the
        # plain forward under autodiff
        {"name": "gn_silu_bwd", "route": "cuda",
         "source": csrc + "gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:125",
         "launches": train_launches["gn_bwd"],
         "launches_by_path": {"train": train_launches["gn_bwd"],
                              **path_launches("gn_bwd", train_only=True),
                              **latent_launches("gn_bwd"),
                              **later_launches("gn_bwd"),
                              **fewstep_launches("gn_bwd"),
                              **parallel_launches("gn_bwd")},
         "max_abs_err": max(gn_bwd_err, gn_step_err,
                            latent["worst"]["gn_bwd"],
                            super_res["worst"]["gn_bwd"],
                            classified["worst"]["gn_bwd"]),
         "ms": gn_step["bwd"], "plain_ms": gn_step["bwd_plain"],
         "recompute_ms": gn_step["recompute"],
         **gn_bwd_bound.keys(), "library_ms": None},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": csrc + "flash_attn.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:65",
         "launches": launches["attn"],
         "launches_by_path": {"sample": launches["attn"],
                              "train": train_launches["attn"],
                              "dit_sample": dit["sample_launches"]["attn"],
                              "dit_train": dit["train_launches"]["attn"],
                              "dit_train_remat":
                                  dit["remat_launches"]["attn"],
                              "dim_fallback": dit["fallback_launches"],
                              **path_launches("attn"),
                              "evaluate": evaluated["unet_launches"]["attn"],
                              **serve_launches("attn"),
                              **latent_launches("attn"),
                              **later_launches("attn"),
                              **fewstep_launches("attn"),
                              **parallel_launches("attn")},
         "dropout_launches": dit["train_launches"]["attn_dropout"],
         "head_grid_max_err": max(parallel["e7"].values()),
         "max_abs_err": max(attn_err, main_err["attn"], dit["dropout_err"],
                            latent["worst"]["attn"],
                            super_res["worst"]["attn"],
                            classified["worst"]["attn"]),
         "ms": totals["attn"][0], "plain_ms": totals["attn"][1],
         **bounds["attn"].keys(), "library_ms": totals["attn"][2],
         "dropout_ms": drop_ms["fwd"], "dropout_p0_ms": drop_ms["fwd_p0"],
         "dropout_plain_ms": drop_ms["fwd_plain"],
         "dropout_bound_ms": drop_bound[False],
         "dropout_library_ms": drop_ms["fwd_library"]},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": csrc + "flash_attn_bwd.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:126",
         "launches": train_launches["attn_bwd"],
         "launches_by_path": {"train": train_launches["attn_bwd"],
                              **path_launches("attn_bwd", train_only=True),
                              "dit_train": dit["train_launches"]["attn_bwd"],
                              "dit_train_remat":
                                  dit["remat_launches"]["attn_bwd"],
                              **latent_launches("attn_bwd"),
                              **later_launches("attn_bwd"),
                              **fewstep_launches("attn_bwd"),
                              **parallel_launches("attn_bwd")},
         "dropout_launches": dit["train_launches"]["attn_bwd_dropout"],
         "head_grid_max_err": max(parallel["e7"].values()),
         "max_abs_err": max(bwd_err, dit["dropout_err"],
                            latent["worst"]["attn_bwd"],
                            super_res["worst"]["attn_bwd"],
                            classified["worst"]["attn_bwd"]),
         "ms": bwd_totals[0], "plain_ms": bwd_totals[1],
         **bwd_bound.keys(), "library_ms": bwd_totals[2],
         "dropout_ms": drop_ms["bwd"], "dropout_p0_ms": drop_ms["bwd_p0"],
         "dropout_plain_ms": drop_ms["bwd_plain"],
         "dropout_bound_ms": drop_bound[True],
         "dropout_library_ms": drop_ms["bwd_library"]},
        # K5 (states off), K6 (states on) and K4 (the ragged last block);
        # ms per sampling forward: 12 calls at batch 160
        {"name": "selective_scan_fwd", "route": "cuda",
         "source": csrc + "selective_scan_fwd.cu",
         "replaces": pallas + ":93",
         "also_replaces": [pallas + ":295", pallas + ":55"],
         "launches": dim_launches["scan_fwd"],
         "launches_by_path": {"sample": dim_launches["scan_fwd"],
                              "train": dim_train_launches["scan_fwd"],
                              "train_remat": remat_launches["scan_fwd"],
                              **parallel_launches("scan_fwd")},
         "max_abs_err": scan_err["fwd"],
         "ms": SCAN_PER_FORWARD * fwd_ms,
         "plain_ms": SCAN_PER_FORWARD * fwd_plain,
         **per_model_call("fwd", 2 * SAMPLES, 256), "library_ms": None},
        # K8; ms per train step: 12 calls at batch 128
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": csrc + "selective_scan_bwd.cu",
         "replaces": pallas + ":511",
         "launches": dim_train_launches["scan_bwd"],
         "launches_by_path": {"train": dim_train_launches["scan_bwd"],
                              "train_64x64": dim64_launches["scan_bwd"],
                              **parallel_launches("scan_bwd")},
         "max_abs_err": scan_err["bwd"],
         "ms": SCAN_PER_FORWARD * bwd_ms,
         "plain_ms": SCAN_PER_FORWARD * bwd_plain,
         **per_model_call("bwd", TRAIN_BATCH, 256), "library_ms": None},
        # K7; ms per remat train step: 12 calls at batch 128
        {"name": "selective_scan_bwd_nostate", "route": "cuda",
         "source": csrc + "selective_scan_bwd.cu",
         "replaces": pallas + ":233",
         "launches": remat_launches["scan_bwd_nostate"],
         "launches_by_path": {
             "train_remat": remat_launches["scan_bwd_nostate"]},
         "max_abs_err": scan_err["bwd_nostate"],
         "ms": SCAN_PER_FORWARD * k7_ms,
         "plain_ms": SCAN_PER_FORWARD * k7_plain,
         **per_model_call("bwd_nostate", TRAIN_BATCH, 256),
         "library_ms": None},
        # K9, ms per 64x64 train step: 12 calls at batch 16, L 1024
        {"name": "selective_scan_fwd_split", "route": "cuda",
         "source": csrc + "selective_scan_split.cu",
         "replaces": pallas + ":371",
         "launches": dim64_launches["scan_fwd_split"],
         "launches_by_path": {
             "train_64x64": dim64_launches["scan_fwd_split"],
             "train_64x64_batch_8": dim64_small_launches["scan_fwd_split"]},
         "max_abs_err": scan_err["fwd_split"],
         "ms": SCAN_PER_FORWARD * k9_ms,
         "plain_ms": SCAN_PER_FORWARD * k9_plain,
         **per_model_call("fwd_states", DIM64_BATCH, 1024),
         "library_ms": None},
        # K10, ms per 64x64 train step at batch 8, the path that runs it
        {"name": "selective_scan_bwd_split", "route": "cuda",
         "source": csrc + "selective_scan_split.cu",
         "replaces": pallas + ":411",
         "launches": dim64_small_launches["scan_bwd_split"],
         "launches_by_path": {
             "train_64x64": dim64_launches["scan_bwd_split"],
             "train_64x64_batch_8": dim64_small_launches["scan_bwd_split"]},
         "max_abs_err": scan_err["bwd_split"],
         "ms": SCAN_PER_FORWARD * k10_ms,
         "plain_ms": SCAN_PER_FORWARD * k10_plain,
         **per_model_call("bwd", DIM64_SMALL_BATCH, 1024),
         "library_ms": None},
    ]
    # the bf16 forms (one source each with the float32 form): K1 per UNet
    # sampling forward at batch 160, K1b per train step at batch 128, K2 per
    # UNet sampling forward and K3 per UNet train step, with the DiT's rows
    # (12 calls: sampling at p = 0, a train step at p 0.1) beside them
    unet16 = bf16["models"]["UNet"]
    dit16 = bf16["models"]["DiT"]
    gn_t, gn_b = bf16["gn_totals"], bf16["gn_bounds"]
    at, ab = bf16["attn_sums"], bf16["attn_bounds"]
    kernels += [
        {"name": "gn_silu_fwd_bf16", "route": "cuda",
         "source": csrc + "gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:46",
         "launches": unet16["sample_launches"]["gn_bf16"],
         "launches_by_path": {
             "sample_bf16": unet16["sample_launches"]["gn_bf16"],
             "sample_bf16_deepcache": knobs["UNet bf16 DeepCache depth 1"][
                 0]["gn_bf16"],
             "train_bf16": unet16["train_launches"]["gn_bf16"],
             **serve_launches("gn_bf16"), **fewstep_launches("gn_bf16")},
         "max_abs_err": max(bf16["gn_err"][0], latent["worst"]["gn_bf16"]),
         "ms": gn_t["fwd"], "plain_ms": gn_t["fwd_plain"],
         **gn_b["fwd"].keys(), "library_ms": None},
        {"name": "gn_silu_bwd_bf16", "route": "cuda",
         "source": csrc + "gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:125",
         "launches": unet16["train_launches"]["gn_bwd_bf16"],
         "launches_by_path": {
             "train_bf16": unet16["train_launches"]["gn_bwd_bf16"],
             **fewstep_launches("gn_bwd_bf16")},
         "max_abs_err": max(bf16["gn_err"][1],
                            latent["worst"]["gn_bwd_bf16"]),
         "ms": gn_t["bwd"], "plain_ms": gn_t["bwd_plain"],
         **gn_b["bwd"].keys(), "library_ms": None},
        {"name": "flash_attn_fwd_bf16", "route": "cuda",
         "source": csrc + "flash_attn.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:65",
         "launches": unet16["sample_launches"]["attn_bf16"],
         "launches_by_path": {
             "sample_bf16": unet16["sample_launches"]["attn_bf16"],
             "sample_bf16_deepcache": knobs["UNet bf16 DeepCache depth 1"][
                 0]["attn_bf16"],
             "train_bf16": unet16["train_launches"]["attn_bf16"],
             "dit_sample_bf16": dit16["sample_launches"]["attn_bf16"],
             "dit_sample_bf16_dpmpp": dit_fast_launches["attn_bf16"],
             "dit_train_bf16": dit16["train_launches"]["attn_bf16"],
             "evaluate_dit_bf16": evaluated["dit_launches"]["attn_bf16"],
             **serve_launches("attn_bf16"), **fewstep_launches("attn_bf16")},
         "max_abs_err": max(bf16["attn_err"], latent["worst"]["attn_bf16"]),
         "ms": at["unet_fwd"]["fwd"], "plain_ms": at["unet_fwd"]["fwd_plain"],
         **ab["unet_fwd"][1].keys(),
         "cuda_core_bound_ms": ab["unet_fwd"][0].ms,
         "library_ms": at["unet_fwd"]["fwd_library"],
         "dit_ms": at["dit"]["fwd"], "dit_plain_ms": at["dit"]["fwd_plain"],
         "dit_bound_ms": ab["dit"][1].ms,
         "dit_cuda_core_bound_ms": ab["dit"][0].ms,
         "dit_library_ms": at["dit"]["fwd_library"],
         "dropout_ms": at["dit_dropout"]["fwd"],
         "dropout_plain_ms": at["dit_dropout"]["fwd_plain"],
         "dropout_bound_ms": ab["dit_dropout"][1].ms,
         "dropout_cuda_core_bound_ms": ab["dit_dropout"][0].ms,
         "dropout_library_ms": at["dit_dropout"]["fwd_library"]},
        {"name": "flash_attn_bwd_bf16", "route": "cuda",
         "source": csrc + "flash_attn_bwd.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:126",
         "launches": unet16["train_launches"]["attn_bwd_bf16"],
         "launches_by_path": {
             "train_bf16": unet16["train_launches"]["attn_bwd_bf16"],
             "dit_train_bf16": dit16["train_launches"]["attn_bwd_bf16"],
             **fewstep_launches("attn_bwd_bf16")},
         "max_abs_err": max(bf16["attn_err"], latent["worst"]["attn_bf16"]),
         "ms": at["unet_bwd"]["bwd"], "plain_ms": at["unet_bwd"]["bwd_plain"],
         **ab["unet_bwd"][1].keys(),
         "cuda_core_bound_ms": ab["unet_bwd"][0].ms,
         "library_ms": at["unet_bwd"]["bwd_library"],
         "dropout_ms": at["dit_dropout"]["bwd"],
         "dropout_plain_ms": at["dit_dropout"]["bwd_plain"],
         "dropout_bound_ms": ab["dit_dropout_bwd"][1].ms,
         "dropout_cuda_core_bound_ms": ab["dit_dropout_bwd"][0].ms,
         "dropout_library_ms": at["dit_dropout"]["bwd_library"]},
    ]
    # the key-bias forms (ToMe's proportional attention), ms a call at the
    # sampling batch's BH 960 and L' 128 (ratio 0.5), with L' 179 beside
    def bias_row(name, source, fwd, precision):
        key = "fwd" if fwd else "bwd"
        t = merged["times"][(precision, TOME_LENGTHS[0])]
        t179 = merged["times"][(precision, TOME_LENGTHS[1])]
        bound = merged["bounds"][(precision, TOME_LENGTHS[0])][key]
        count = "attn_bias" if fwd else "attn_bwd_bias"
        runs = {f"tome_{path}": run[count]
                for path, run in merged["launches"].items()
                if precision in path and run[count]}
        return {
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": "diffusion_models_collection_tpu/ops/"
                        + ("flash_attention.py:65" if fwd
                           else "flash_attention.py:126"),
            "launches": runs[f"tome_{'sample' if fwd else 'train'}_"
                             f"{precision}"],
            "launches_by_path": runs,
            "max_abs_err": merged["worst"][precision],
            "ms": t[key], "plain_ms": t[f"{key}_plain"], **bound.keys(),
            "library_ms": t[f"{key}_library"],
            "l179": {"ms": t179[key], "plain_ms": t179[f"{key}_plain"],
                     "bound_ms": merged["bounds"][
                         (precision, TOME_LENGTHS[1])][key].ms,
                     "library_ms": t179[f"{key}_library"]}}
    kernels += [bias_row("flash_attn_fwd_bias", "flash_attn.cu", True,
                         "fp32"),
                bias_row("flash_attn_bwd_bias", "flash_attn_bwd.cu", False,
                         "fp32"),
                bias_row("flash_attn_fwd_bias_bf16", "flash_attn.cu", True,
                         "bf16"),
                bias_row("flash_attn_bwd_bias_bf16", "flash_attn_bwd.cu",
                         False, "bf16")]
    # the MoE DiT's and the int8 DiT's K2 and K3 launches (their rows above
    # time the forms at the dense DiT's shapes, which these paths share)
    for row in kernels:
        if row["name"] in ("flash_attn_fwd", "flash_attn_bwd",
                           "flash_attn_fwd_bf16", "flash_attn_bwd_bf16"):
            key = ("attn" if row["name"].startswith("flash_attn_fwd")
                   else "attn_bwd")
            bf16_row = row["name"].endswith("_bf16")
            for path, run in moe["launches"].items():
                if bf16_row == path.endswith("bf16"):
                    row["launches_by_path"][f"moe_{path}"] = run[key]
            if key == "attn":
                for precision, run in int8["launches"].items():
                    if bf16_row == (precision == "bf16"):
                        row["launches_by_path"][
                            f"int8_sample_{precision}"] = run[key]
    # the export's and the 64x64 DiT's launches, and K2's and K3's readings
    # at the 64x64 DiT's train step (BH = batch x 6, L 1024, d 64; K3 in
    # both forms, `FUSED_MAX_LEN` set from them)
    dit64_launches = {**exported, **dit64["launches"]}
    for row in kernels:
        bf16_row = row["name"].endswith("_bf16")
        if row["name"] not in ("gn_silu_fwd", "flash_attn_fwd",
                               "flash_attn_bwd", "gn_silu_fwd_bf16",
                               "flash_attn_fwd_bf16", "flash_attn_bwd_bf16"):
            continue
        key = {"gn": "gn", "flash_attn_fwd": "attn",
               "flash_attn_bwd": "attn_bwd"}[
            "gn" if row["name"].startswith("gn") else
            row["name"].replace("_bf16", "")]
        key += "_bf16" if bf16_row else ""
        for path, run in dit64_launches.items():
            # a float32 row counts the float32 form's launches alone
            n = (run[key] if bf16_row
                 else run[key] - run[key + "_bf16"])
            if n:
                row["launches_by_path"][path] = n
        if row["name"].startswith("flash_attn"):
            fwd = row["name"].startswith("flash_attn_fwd")
            for p in (0.0, ATTN_DROPOUT):
                t = dit64["sweep"][("bf16" if bf16_row else "fp32", p)]
                row[f"l1024_p{p:g}"] = (
                    {"ms": t["fwd"], "bound_ms": t["fwd_bound"],
                     "library_ms": t["fwd_library"]} if fwd else
                    {"ms": (t["fused"] if flash_attention.bwd_fused(
                        DIT64_LENGTH) else t["two_kernel"]),
                     "fused_ms": t["fused"], "two_kernel_ms": t["two_kernel"],
                     "bound_ms": t["bwd_bound"],
                     "library_ms": t["bwd_library"]})
    kernels += chip_smoke_sequence.kernel_rows(sequence)
    kernels += chip_smoke_shapes.kernel_rows(shapes)
    # the float32 UNet kernels' launches a rank (rank 0's) on the
    # data-parallel paths outside train
    for row in kernels:
        key = {"gn_silu_fwd": "gn", "gn_silu_bwd": "gn_bwd",
               "flash_attn_fwd": "attn",
               "flash_attn_bwd": "attn_bwd"}.get(row["name"])
        for path, run in data["launches"].items():
            if key is not None and run[key]:
                row["launches_by_path"][f"data_parallel_{path}"] = run[key]
        # a rank's launches for one request of the batched daemon at world 2
        if key is not None and served_dp["launches"][key]:
            row["launches_by_path"]["serve_data_parallel_request"] = (
                served_dp["launches"][key])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
