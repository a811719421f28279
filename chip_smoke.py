"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. It builds the port's kernels from
`diffusion_models_collection_tpu_torch/csrc/`, holds each against its plain
PyTorch version at the shapes of the CIFAR-10 UNet (configs/cifar10_unet.py)
and of the CIFAR-10 DiM (configs/cifar10_dim.py), and drives the main paths
of both models through the port's entry points. The UNet's:

* sampling: the forward kernels at batch 32 and at the sampling run's own
  batch of 160 rows (80 images, cond + uncond), full-width UNet forwards at
  both batches and a short sampling run against the plain versions, then 80
  images with DDIM-50 and classifier-free guidance (scale 3) through
  `diffusion_models_collection_tpu_torch.sample` from a randomly
  initialised checkpoint;
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
  wrote with DDIM-10 and DDPM.

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

Each path is run with every launch count set to 0 just before it and read
just after, and checks that every GroupNorm+SiLU, attention and scan call
(forward and backward) of its run went through a kernel, and that the other
model's kernels did not run. Every failure raises; there is no fallback. The
last line of standard output is one JSON object with "ok": true; the line
before it lists each kernel with its launches, error, times, the least time
the card could take for the same calls (`bound_ms`, from the shapes) and,
where one PyTorch call computes the same function, that call's time
(`library_ms`; the port never calls it).

Float32 throughout, TF32 off. Kernel times are medians of CUDA-event
timings after warm-up; samples/s is the generation loop of one
`sample.main` call; train images/s is the median of CUDA-synchronised
steps; all on the card named in the output.
"""

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from diffusion_models_collection_tpu_torch import (  # noqa: E402
    factory,
    sample,
    train,
)
from diffusion_models_collection_tpu_torch.diffusion import DDIM, DDPM  # noqa: E402
from diffusion_models_collection_tpu_torch.models import unet as unet_mod  # noqa: E402
from diffusion_models_collection_tpu_torch.ops import (  # noqa: E402
    _build,
    flash_attention,
    fused_norm,
)
from diffusion_models_collection_tpu_torch.ops import (  # noqa: E402
    selective_scan as scan,
)
from diffusion_models_collection_tpu_torch.ops.plain import plain_kernels  # noqa: E402
from diffusion_models_collection_tpu_torch.utils import checkpoint  # noqa: E402
from diffusion_models_collection_tpu_torch.utils.helpers import (  # noqa: E402
    load_config,
    resolve_image_size,
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
# beyond `flash_attention.FUSED_MAX_LEN`: the two-kernel form
ATTN_BWD_LONG = (1024, 257)
TRAIN_BATCH, TRAIN_EPOCHS = 128, 3
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# Loss of one full-width forward, and the flattened gradient as max-abs
# difference over max-abs: a backward chains 60 conv backwards and the GN
# recomputes through 45 norms.
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
FIXTURE_DATA = ROOT / "tests" / "fixtures" / "data"

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
                 "scan_bwd_split": "BWD_SPLIT_LAUNCHES"}
# Published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores. A kernel's bound is the larger of its bytes over the one and
# its operations over the other.
PEAK_BYTES_PER_S, PEAK_FP32_OPS_PER_S = 3.35e12, 67e12
# The special-function units evaluate 16 exponentials a clock and SM where
# the FMA pipes do 128 multiply-adds (256 operations): a sixteenth of the
# float32 peak. Not part of `bound_ms`, which counts an exponential as one
# operation; printed beside it for the scans.
PEAK_EXP_PER_S = PEAK_FP32_OPS_PER_S / 16


def max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


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
    written once) and operations / 67 TFLOP/s (float32 outside the tensor
    cores; an exponential counted as one operation), summed over the calls."""

    def __init__(self):
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, n_bytes, n_ops, calls=1):
        bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
        ops_ms = 1e3 * n_ops / PEAK_FP32_OPS_PER_S
        self.ms += calls * max(bytes_ms, ops_ms)
        self.bytes_ms += calls * bytes_ms
        self.ops_ms += calls * ops_ms
        return self

    def keys(self):
        return {"bound_ms": self.ms,
                "bound_by": ("bytes" if self.bytes_ms >= self.ops_ms
                             else "operations")}


def gn_work(b, h, w, c):
    """GroupNorm+SiLU: x in, y out, scale and bias; per element the mean
    and variance sums (3), normalise and affine (4), SiLU (4)."""
    n = b * h * w * c
    return 4 * (2 * n + 2 * c), 11 * n


def gn_bwd_work(b, h, w, c):
    """GroupNorm+SiLU backward: x and g in, dx out, scale, bias and the
    per-image dscale, dbias rows; per element the pre-activation (4), the
    SiLU's derivative (8), the four sums (7) and dx (5)."""
    n = b * h * w * c
    return 4 * (3 * n + 2 * c + 2 * b * c), 24 * n


def attn_work(bh, seq, d, backward=False):
    """Attention forward: q, k, v in, o and lse out; QK^T and PV (2 L^2 d
    multiply-adds) and the softmax (5 an entry). Backward: q, k, v, o, dO,
    lse in, dq, dk, dv out; five such products and the softmax's."""
    n = bh * seq * d
    if backward:
        return 4 * (8 * n + bh * seq), bh * seq * seq * (10 * d + 8)
    return 4 * (4 * n + bh * seq), bh * seq * seq * (4 * d + 5)


def scan_work(kind, batch, length, d_inner=768, n_state=16):
    """The scan's bytes and operations. Forward ("fwd", with "fwd_states"
    also `bound` out): x, dt in, y out, B, C, A in; per state and step the
    decay (2, the exponential as one), the update (3) and the output (2).
    Backward from states ("bwd"; "bwd_nostate" reads no `bound` and walks
    forward once more): x, dt, g in, dx, ddt out, B, C in, dB, dC out, A in,
    dA out; per state and step one recompute of h (5) and the adjoint with
    its five gradients (16)."""
    rows = batch * length
    states = rows * d_inner * n_state
    small = 4 * (2 * rows * n_state + d_inner * n_state)
    bound = 4 * batch * len(scan._blocks(length)) * n_state * d_inner
    if kind in ("fwd", "fwd_states"):
        return (4 * 3 * rows * d_inner + small
                + (bound if kind == "fwd_states" else 0)), 7 * states
    n_bytes = 4 * 5 * rows * d_inner + 2 * small
    if kind == "bwd":
        return n_bytes + bound, 21 * states
    return n_bytes, 26 * states


def reset_launches():
    fused_norm.LAUNCHES = 0
    fused_norm.BWD_LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = 0
    for counter in SCAN_COUNTERS.values():
        setattr(scan, counter, 0)


def read_launches():
    return {"gn": fused_norm.LAUNCHES, "gn_bwd": fused_norm.BWD_LAUNCHES,
            "attn": flash_attention.LAUNCHES,
            "attn_bwd": flash_attention.BWD_LAUNCHES,
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


def phase_build():
    start = time.perf_counter()
    _build.library()
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


def attention_fwd_form(seq, d):
    """The form of K2 that the wrapper takes for this shape, in words."""
    tile = flash_attention.fwd_tile(seq, d)
    width = flash_attention.padded_head_dim(d)
    dmax = 32 if width <= 32 else 64 if width <= 64 else 128
    return (f"tiles of {tile} rows, {-(-seq // tile)} key tile"
            f"{'s' if seq > tile else ''}, d padded to {dmax}")


def phase_attn(gen):
    """K2 against its plain version at BH 128, d 64 and L 256, 64, 16, 100
    (timed), then in the forms the UNet does not take; each line names the
    form. Returns the worst absolute error."""
    worst_abs = 0.0
    cases = [(seq, HEAD_DIM, True) for seq in ATTN_LENGTHS]
    cases += [(seq, d, False) for seq, d in ATTN_FWD_FORMS]
    for seq, d, timed in cases:
        q, k, v = (torch.randn(ATTN_BH, seq, d, generator=gen,
                               device="cuda") for _ in range(3))
        o, lse = flash_attention.flash_attention_fwd(q, k, v)
        o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        rel = max_rel(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        worst_abs = max(worst_abs, (o - o_ref).abs().max().item(), lse_err)
        line = (f"flash_attn_fwd BH={ATTN_BH} L={seq} d={d} "
                f"[{attention_fwd_form(seq, d)}]: o max_rel {rel:.3e} lse "
                f"max_abs {lse_err:.3e}")
        if timed:
            ms = median_ms(lambda: flash_attention.flash_attention_fwd(q, k, v))
            plain = median_ms(
                lambda: flash_attention.flash_attention_fwd_ref(q, k, v))
            line += f" kernel {ms:.4f} ms plain {plain:.4f} ms"
        print(line)
        if not (rel <= TOL_OUT and lse_err <= TOL_LSE):
            raise AssertionError(f"flash_attn_fwd L={seq} d={d}: o {rel}, "
                                 f"lse {lse_err}")
    return worst_abs


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
        library = median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
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


def phase_sample_main(label, config, model, per_forward, tmp):
    """80 images, DDIM-50, CFG 3 through `sample.main` from a checkpoint of
    `model`'s weights, with exactly 50 forwards' worth of kernel launches
    (`per_forward`, a `read_launches()` subset)."""
    ckpt = Path(tmp) / f"{config['model_type']}_random.pth"
    checkpoint.save_checkpoint(ckpt, model.state_dict(), config)
    argv = ["--checkpoint", str(ckpt), "--sampling_method", "ddim",
            "--cfg_scale", str(CFG_SCALE), "--num_samples", str(SAMPLES),
            "--batch_size", str(SAMPLES), "--seed", "0", "--device", "cuda",
            "--output_dir", tmp, "--output_name", "samples.png",
            "--num_inference_steps", str(STEPS)]
    # the caller ran the model at this batch, so cuDNN, cuBLAS and the
    # kernel library are warm
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    result = sample.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_launches()
    samples = result["samples"]
    if not (samples.shape == (SAMPLES, 32, 32, 3)
            and np.isfinite(samples).all()):
        raise AssertionError(f"{label} samples: shape {samples.shape}, "
                             f"finite {np.isfinite(samples).all()}")
    for name in ("samples.png", "samples.npy"):
        if not (Path(tmp) / name).is_file():
            raise AssertionError(f"{label}: {name} was not written")
    expected = scaled(per_forward, STEPS)
    if launches != expected:
        raise AssertionError(f"{label} kernel launches {launches}, expected "
                             f"{expected}")
    print(f"sample.main {label}: {SAMPLES} images, DDIM-{STEPS}, CFG "
          f"{CFG_SCALE}: sampling {result['sampling_seconds']:.3f} s "
          f"({SAMPLES / result['sampling_seconds']:.2f} samples/s), whole "
          f"call {wall:.3f} s; launches {launches}")
    return launches, result["sampling_seconds"]


def attention_bwd_case(bh, seq, d, gen):
    """Inputs of one backward: q, k, v, the forward's o and lse, dO."""
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = flash_attention.flash_attention_fwd_ref(q, k, v)
    return q, k, v, o, do, lse


def attention_bwd_form(seq, d, fused=None):
    """The form of K3 that the wrapper takes for this shape, in words."""
    tile = flash_attention.bwd_tile(seq, d)
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
    qkv = [t.detach().requires_grad_() for t in args[:3]]
    out = F.scaled_dot_product_attention(*qkv)
    library = median_ms(
        lambda: torch.autograd.grad(out, qkv, args[4], retain_graph=True))
    print(f"{label}: dq/dk/dv max_rel {rels[0]:.3e} {rels[1]:.3e} "
          f"{rels[2]:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms "
          f"scaled_dot_product_attention's backward {library:.4f} ms")
    if not max(rels) <= TOL_BWD:
        raise AssertionError(f"{label}: max_rel {rels} > {TOL_BWD}")
    return worst_abs, ms, plain, library


def phase_attn_bwd(attn_shapes, gen):
    """K3 against `flash_attention_bwd_ref` at BH 128 in every form it has
    (L 256, 64, 16, 100 at d 64 and d 32, 128 at L 256: fused; L 1024 and
    257: two kernels; each line names the form), then at every attention
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


def loss_and_grads(model, ddpm, batch):
    """The DDPM eps-loss of one batch and every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = ddpm.p_losses(model, batch["x0"], batch["t"], batch["noise"],
                         y=batch["y"])
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def image_shape(config):
    return (*resolve_image_size(config["image_size"]), 3)


def phase_train_grads(label, model, config, per_step, gen,
                      batch_size=CHECK_BATCH, batch=None):
    """The full-width model's loss and every gradient at `batch_size`
    (or on `batch`, an earlier call's) through the kernels against the same
    inside `plain_kernels()`, with exactly one step's launches (`per_step`)
    and none inside; every parameter must get a gradient. Call it with the
    model in eval mode (no dropout), so both runs see one network. Returns
    the batch, the loss and the flattened gradient."""
    ddpm = DDPM(num_timesteps=config["num_timesteps"])
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
    reset_launches()
    loss, grads = loss_and_grads(model, ddpm, batch)
    torch.cuda.synchronize()
    launched = read_launches()
    with plain_kernels():
        reset_launches()
        loss_ref, grads_ref = loss_and_grads(model, ddpm, batch)
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
    if not (loss_rel <= TOL_LOSS and grad_rel <= TOL_GRAD
            and torch.isfinite(flat).all() and not no_grad):
        raise AssertionError(f"{label} loss max_rel {loss_rel}, gradient "
                             f"{grad_rel}, zero gradients {no_grad}")
    return batch, loss, flat


def phase_remat_grads(model, config, gen):
    """The CIFAR DiM under `remat: True` with `model`'s weights at the
    training batch: its loss and gradients against the plain versions
    (`phase_train_grads`, with a remat step's launches), and against the
    model without remat on the same batch, within the same bars."""
    remat_config = dict(config, remat=True)
    remat_model = factory.get_model(remat_config).to("cuda").eval()
    remat_model.load_state_dict(model.state_dict())
    batch, loss_r, flat_r = phase_train_grads(
        "DiM remat", remat_model, remat_config, DIM_REMAT_STEP, gen,
        batch_size=TRAIN_BATCH)
    _, loss, flat = phase_train_grads("DiM on the remat run's batch", model,
                                      config, DIM_STEP, gen, batch=batch)
    loss_rel, grad_rel = max_rel(loss_r, loss), max_rel(flat_r, flat)
    print(f"DiM remat vs no remat, B={TRAIN_BATCH}: loss max_rel "
          f"{loss_rel:.3e}, flattened gradient max_abs_diff/max_abs "
          f"{grad_rel:.3e}")
    if not (loss_rel <= TOL_LOSS and grad_rel <= TOL_GRAD):
        raise AssertionError(f"DiM remat vs no remat: loss {loss_rel}, "
                             f"gradient {grad_rel}")


def write_train_config(config, epochs, tmp):
    """The config at full width with only the run's length, data and output
    places changed: the committed CIFAR-10 fixtures (where the config reads
    CIFAR-10), `epochs` epochs, outputs under `tmp`, no best-model copy, no
    sample grid."""
    run = dict(config, data_root=str(FIXTURE_DATA), epochs=epochs,
               save_dir=str(Path(tmp) / "checkpoints"),
               sample_dir=str(Path(tmp) / "samples"), save_best=False,
               sample_start_epoch=epochs + 1)
    path = Path(tmp) / f"cifar10_{config['model_type']}_fixtures.py"
    path.write_text(f"config = {run!r}\n")
    return path


def time_train_steps(trainer, images, labels):
    """Median wall time of TRAIN_TIMED CUDA-synchronised trainer steps
    after TRAIN_WARMUP, in images/s."""
    times = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer.train_step(images, labels)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - start)
    return images.shape[0] / statistics.median(times)


def run_train_main(label, config, per_step, tmp, epochs, steps_per_epoch):
    """`train.main` for `epochs` epochs at full width, with exactly
    `per_step` launches a step, finite losses and a checkpoint. Returns the
    trainer and the launches."""
    batch_size = config["batch_size"]
    cfg_path = write_train_config(config, epochs, tmp)
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
    losses = [m["train/loss"] for m in metrics if "train/loss" in m]
    ckpt = trainer.save_dir / "current_model.pth"
    print(f"train.main {label}: {epochs} epochs, {steps} steps of "
          f"batch {batch_size} in {wall:.3f} s; losses {losses}; launches "
          f"{launches}")
    expected = scaled(per_step, steps)
    if not (steps == epochs * steps_per_epoch and launches == expected):
        raise AssertionError(f"{label}: {steps} steps, launches {launches}, "
                             f"expected {expected}")
    if not (len(losses) == epochs and all(map(math.isfinite, losses))
            and ckpt.is_file()):
        raise AssertionError(f"{label}: losses {losses}, {ckpt} written: "
                             f"{ckpt.is_file()}")
    return trainer, launches


def phase_train_main(label, config, per_step, per_forward, samplers, tmp,
                     epochs=TRAIN_EPOCHS, steps_per_epoch=1):
    """`train.main` for `epochs` epochs at full width (on the fixtures:
    three epochs of one batch of 128), with exactly `per_step` launches a
    step; then train images/s with the kernels and with the plain versions,
    in turns, and the peak device memory of the kernel path's steps; then
    `sample.main` from the checkpoint it wrote, once for each (method,
    model calls, flags) of `samplers`, with exactly `per_forward` launches
    a model call."""
    batch_size = config["batch_size"]
    trainer, launches = run_train_main(label, config, per_step, tmp, epochs,
                                       steps_per_epoch)
    ckpt = trainer.save_dir / "current_model.pth"
    images, labels = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).to("cuda")
    labels = torch.from_numpy(labels).to("cuda")
    rates = {"kernels": [], "plain": []}
    peak = 0
    for path in ("kernels", "plain", "plain", "kernels"):
        if path == "plain":
            with plain_kernels():
                rates[path].append(time_train_steps(trainer, images, labels))
        else:
            torch.cuda.reset_peak_memory_stats()
            rates[path].append(time_train_steps(trainer, images, labels))
            peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"{label} train images/s at batch {batch_size} (median of "
          f"{TRAIN_TIMED} steps after {TRAIN_WARMUP}), kernel path "
          f"{', '.join(f'{r:.2f}' for r in rates['kernels'])}, plain path "
          f"{', '.join(f'{r:.2f}' for r in rates['plain'])}; peak device "
          f"memory of the kernel path's steps {peak / 2**20:.1f} MiB")

    for method, calls, flags in samplers:
        out = Path(tmp) / method
        reset_launches()
        result = sample.main([
            "--checkpoint", str(ckpt), "--sampling_method", method, *flags,
            "--num_samples", "8", "--batch_size", "8", "--use_ema",
            "--device", "cuda", "--output_dir", str(out)])
        torch.cuda.synchronize()
        got = read_launches()
        samples = result["samples"]
        print(f"sample.main {label} {method} from the trained checkpoint: 8 "
              f"images in {result['sampling_seconds']:.3f} s; launches {got}")
        if not (samples.shape == (8, *image_shape(config))
                and np.isfinite(samples).all()
                and (out / "samples.png").is_file()
                and got == scaled(per_forward, calls)):
            raise AssertionError(f"{label} {method}: samples "
                                 f"{samples.shape}, launches {got}")
    return launches, rates, peak


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
        form = (f"{'four' if n_state <= 16 else 'eight'} states a lane, time "
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


def random_dim(config, gen):
    """The full-width DiM with random weights, in eval mode. Its init is
    adaLN-Zero: every adaLN modulation and the final projection start at
    zero, so the output would be exactly 0 whatever the scans compute, and
    a comparison with the plain versions would hold nothing. Each parameter
    that starts all zero is drawn N(0, 0.02^2) instead, so every block's
    scan reaches the output and every parameter gets a gradient."""
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").eval()
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return model


def phase_dim(config, gen):
    """Full-width DiM forwards at batch 32 and 160 through the scan kernel
    against the same inside `plain_kernels()`, with exactly 12 forward
    launches (states off) each."""
    model = random_dim(config, gen)
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
        print(f"DiM forward B={batch} ({n_params} parameters): kernels vs "
              f"plain max_rel {rel:.3e}; launches {launched}")
        if launched != expect(**DIM_FORWARD):
            raise AssertionError(f"DiM forward launches {launched}")
        if not (out.shape == (batch, 32, 32, 3) and ref.abs().max() > 0
                and torch.isfinite(out).all() and rel <= TOL_UNET):
            raise AssertionError(f"DiM forward B={batch}: shape "
                                 f"{tuple(out.shape)}, max_rel {rel}, "
                                 f"max |plain| {ref.abs().max().item()}")
    return model, n_params


def main():
    smi = device_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase_build()
    gn_err, gn_bwd_err = phase_gn(gen)
    attn_err = phase_attn(gen)
    config = load_config(CONFIG)
    model, gn_shapes, attn_shapes = phase_unet(config, gen)
    phase_trajectory(model, gen)
    totals, main_err, bounds = phase_main_shapes(gn_shapes, attn_shapes,
                                                 2 * SAMPLES, gen)
    with tempfile.TemporaryDirectory() as tmp:
        launches, seconds = phase_sample_main("UNet", config, model,
                                              UNET_FORWARD, tmp)
    del model
    gn_step_err, gn_step, gn_bwd_bound = phase_gn_train_step(gn_shapes, gen)
    bwd_err, bwd_totals, bwd_bound = phase_attn_bwd(attn_shapes, gen)
    torch.manual_seed(0)
    phase_train_grads("UNet", factory.get_model(config).to("cuda").eval(),
                      config, UNET_STEP, gen)
    # DDIM-10, and DDPM over all of the config's timesteps
    samplers = [("ddim", 10, ["--num_inference_steps", "10"]),
                ("ddpm", config["num_timesteps"], [])]
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, rates, _ = phase_train_main(
            "UNet", config, UNET_STEP, UNET_FORWARD, samplers, tmp)

    dim_config = load_config(DIM_CONFIG)
    scan_err, scan_times = phase_scan(gen)
    dim_model, dim_params = phase_dim(dim_config, gen)
    phase_trajectory(dim_model, gen)
    with tempfile.TemporaryDirectory() as tmp:
        dim_launches, dim_seconds = phase_sample_main(
            "DiM", dim_config, dim_model, DIM_FORWARD, tmp)
    del dim_model
    dim_model = random_dim(dim_config, gen)
    phase_train_grads("DiM", dim_model, dim_config, DIM_STEP, gen)
    phase_remat_grads(dim_model, dim_config, gen)
    del dim_model
    samplers = [("ddim", 10, ["--num_inference_steps", "10",
                              "--cfg_scale", str(CFG_SCALE)])]
    with tempfile.TemporaryDirectory() as tmp:
        dim_train_launches, dim_rates, dim_peak = phase_train_main(
            "DiM", dim_config, DIM_STEP, DIM_FORWARD, samplers, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        remat_launches, remat_rates, remat_peak = phase_train_main(
            "DiM remat", dict(dim_config, remat=True), DIM_REMAT_STEP,
            DIM_FORWARD, samplers, tmp)

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
    phase_train_grads("DiM 64x64", random_dim(dim64_config, gen),
                      dim64_config, DIM64_STEP, gen, batch_size=DIM64_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        dim64_launches, dim64_rates, dim64_peak = phase_train_main(
            "DiM 64x64", dim64_config, DIM64_STEP, DIM_FORWARD, samplers, tmp,
            epochs=1, steps_per_epoch=SYNTHETIC_IMAGES // DIM64_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        _, dim64_small_launches = run_train_main(
            "DiM 64x64 batch 8",
            dict(dim64_config, batch_size=DIM64_SMALL_BATCH),
            DIM64_SMALL_STEP, tmp, 1, SYNTHETIC_IMAGES // DIM64_SMALL_BATCH)

    print(f"{SAMPLES / seconds:.2f} samples/s DDIM-{STEPS} CFG {CFG_SCALE} "
          f"fp32 on {smi}")
    print(f"{statistics.median(rates['kernels']):.2f} train images/s at batch "
          f"{TRAIN_BATCH} fp32 (plain versions: "
          f"{statistics.median(rates['plain']):.2f}) on {smi}")
    print(f"DiM ({dim_params} parameters): {SAMPLES / dim_seconds:.2f} "
          f"samples/s DDIM-{STEPS} CFG {CFG_SCALE} fp32; "
          f"{statistics.median(dim_rates['kernels']):.2f} train images/s at "
          f"batch {TRAIN_BATCH} (plain versions: "
          f"{statistics.median(dim_rates['plain']):.2f}) on {smi}")
    print(f"DiM remat: {statistics.median(remat_rates['kernels']):.2f} train "
          f"images/s at batch {TRAIN_BATCH} (plain versions: "
          f"{statistics.median(remat_rates['plain']):.2f}), peak device "
          f"memory {remat_peak / 2**20:.1f} MiB against "
          f"{dim_peak / 2**20:.1f} MiB without remat, on {smi}")
    print(f"DiM 64x64: {statistics.median(dim64_rates['kernels']):.2f} train "
          f"images/s at batch {DIM64_BATCH} (plain versions: "
          f"{statistics.median(dim64_rates['plain']):.2f}), peak device "
          f"memory {dim64_peak / 2**20:.1f} MiB, on {smi}")
    fwd_ms, fwd_plain = scan_times[("fwd", 2 * SAMPLES, 256, False)]
    bwd_ms, bwd_plain = scan_times[("bwd", TRAIN_BATCH, 256)]
    k7_ms, k7_plain = scan_times[("bwd_nostate", TRAIN_BATCH, 256)]
    k9_ms, k9_plain = scan_times[("fwd_split", DIM64_BATCH, 1024)]
    k10_ms, k10_plain = scan_times[("bwd_split", DIM64_SMALL_BATCH, 1024)]

    def per_model_call(kind, batch, length):
        """The bound of the 12 scans of one model call."""
        return Bound().add(*scan_work(kind, batch, length),
                           SCAN_PER_FORWARD).keys()
    pallas = "diffusion_models_collection_tpu/ops/selective_scan_pallas.py"
    csrc = "diffusion_models_collection_tpu_torch/csrc/"
    kernels = [
        {"name": "gn_silu_fwd", "route": "cuda",
         "source": csrc + "gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:46",
         "launches": launches["gn"],
         "launches_by_path": {"sample": launches["gn"],
                              "train": train_launches["gn"]},
         "max_abs_err": max(gn_err, main_err["gn"]),
         "ms": totals["gn"][0], "plain_ms": totals["gn"][1],
         **bounds["gn"].keys(), "library_ms": None},
        # K1b, ms per train step: 45 calls at batch 128. It has no TPU kernel
        # before it: the JAX package's backward, named here, recomputes the
        # plain forward under autodiff
        {"name": "gn_silu_bwd", "route": "cuda",
         "source": csrc + "gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:125",
         "launches": train_launches["gn_bwd"],
         "launches_by_path": {"train": train_launches["gn_bwd"]},
         "max_abs_err": max(gn_bwd_err, gn_step_err),
         "ms": gn_step["bwd"], "plain_ms": gn_step["bwd_plain"],
         "recompute_ms": gn_step["recompute"],
         **gn_bwd_bound.keys(), "library_ms": None},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": csrc + "flash_attn.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:65",
         "launches": launches["attn"],
         "launches_by_path": {"sample": launches["attn"],
                              "train": train_launches["attn"]},
         "max_abs_err": max(attn_err, main_err["attn"]),
         "ms": totals["attn"][0], "plain_ms": totals["attn"][1],
         **bounds["attn"].keys(), "library_ms": totals["attn"][2]},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": csrc + "flash_attn_bwd.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:126",
         "launches": train_launches["attn_bwd"],
         "launches_by_path": {"train": train_launches["attn_bwd"]},
         "max_abs_err": bwd_err,
         "ms": bwd_totals[0], "plain_ms": bwd_totals[1],
         **bwd_bound.keys(), "library_ms": bwd_totals[2]},
        # K5 (states off), K6 (states on) and K4 (the ragged last block);
        # ms per sampling forward: 12 calls at batch 160
        {"name": "selective_scan_fwd", "route": "cuda",
         "source": csrc + "selective_scan_fwd.cu",
         "replaces": pallas + ":93",
         "also_replaces": [pallas + ":295", pallas + ":55"],
         "launches": dim_launches["scan_fwd"],
         "launches_by_path": {"sample": dim_launches["scan_fwd"],
                              "train": dim_train_launches["scan_fwd"],
                              "train_remat": remat_launches["scan_fwd"]},
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
                              "train_64x64": dim64_launches["scan_bwd"]},
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
