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
* training: the attention backward kernel at every shape of a batch-128
  train step, the full-width UNet's loss and gradients against the plain
  versions, then three epochs of `diffusion_models_collection_tpu_torch.
  train` on the committed CIFAR-10 fixtures (200 images, one batch of 128
  an epoch), train images/s through the trainer's own step with the
  kernels and with the plain versions, and `sample` from the checkpoint it
  wrote with DDIM-10 and DDPM.

The DiM's, at full width (hidden 384, depth 12, patch 2, state 16: the scan
runs at L = 256, D = 768, N = 16 in each of the 12 blocks):

* the selective-scan kernels against their plain versions: the forward at
  batch 32 and 160 (the sampling batch), states off and on, and at L = 48
  and 100 (a ragged last block); the backward at batch 32 and 128 (the
  training batch);
* sampling: full-width forwards at batch 32 and 160 and a DDIM-10 CFG
  trajectory against the plain versions, then 80 images with DDIM-50 and
  CFG 3 through `sample` from a checkpoint of those random weights (the
  adaLN-Zero parameters drawn small but not zero, so the scans reach the
  output);
* training: the full-width loss and gradients against the plain versions,
  every parameter's gradient non-zero, then three epochs of `train` on the
  fixtures at batch 128, train images/s with the kernels and with the
  plain versions, and `sample` DDIM-10 from the checkpoint it wrote.

Each path is run with every launch count set to 0 just before it and read
just after, and checks that every GroupNorm+SiLU, attention and scan call
(forward and backward) of its run went through a kernel, and that the other
model's kernels did not run. Every failure raises; there is no fallback. The
last line of standard output is one JSON object with "ok": true; the line
before it lists each kernel with its launches, error and times.

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
from diffusion_models_collection_tpu_torch.utils.helpers import load_config  # noqa: E402

CONFIG = ROOT / "configs" / "cifar10_unet.py"
GN_SHAPES = [(32, 32, 128), (32, 32, 256), (32, 32, 384), (16, 16, 128),
             (16, 16, 256), (16, 16, 384), (16, 16, 512), (8, 8, 256),
             (8, 8, 512), (4, 4, 256), (4, 4, 512)]
GN_RAGGED = (3, 5, 7, 24)  # B, H, W, C: C % 8 == 0, H*W odd
ATTN_LENGTHS = (256, 64, 16, 100)
ATTN_BH, HEAD_DIM = 128, 64
CHECK_BATCH = 32
SAMPLES, STEPS, CFG_SCALE = 80, 50, 3.0
GN_PER_FORWARD, ATTN_PER_FORWARD = 45, 11
# Kernel launches of one UNet forward and of one train step
UNET_FORWARD = {"gn": GN_PER_FORWARD, "attn": ATTN_PER_FORWARD}
UNET_STEP = dict(UNET_FORWARD, attn_bwd=ATTN_PER_FORWARD)
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
SCAN_D, SCAN_N = 768, 16  # d_inner = 2 * hidden, state size
# (batch, L): the check, sampling and training batches at the model's L, the
# two other time blocks (L = 48: T = 16; L = 100: a ragged last block)
SCAN_FWD_CASES = [(CHECK_BATCH, 256), (2 * SAMPLES, 256), (128, 256),
                  (CHECK_BATCH, 48), (CHECK_BATCH, 100)]
SCAN_BWD_CASES = [(CHECK_BATCH, 256), (TRAIN_BATCH, 256)]
# The scan forward keeps the recurrence in float32 like its plain version,
# in another order of rounding: 2e-5 as the other forwards. Its backward
# runs an adjoint over L steps and sums dB, dC over D: 1e-4 as K3.
TOL_SCAN_FWD, TOL_SCAN_BWD = 2e-5, 1e-4


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


def reset_launches():
    fused_norm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = 0
    scan.FWD_LAUNCHES = 0
    scan.FWD_STATES_LAUNCHES = 0
    scan.BWD_LAUNCHES = 0


def read_launches():
    return {"gn": fused_norm.LAUNCHES, "attn": flash_attention.LAUNCHES,
            "attn_bwd": flash_attention.BWD_LAUNCHES,
            "scan_fwd": scan.FWD_LAUNCHES,
            "scan_fwd_states": scan.FWD_STATES_LAUNCHES,
            "scan_bwd": scan.BWD_LAUNCHES}


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


def phase_gn(gen):
    worst_abs = 0.0
    cases = [(CHECK_BATCH, *s) for s in GN_SHAPES] + [GN_RAGGED]
    for b, h, w, c in cases:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        y = fused_norm.group_norm_silu_fwd(x, scale, bias, 8)
        ref = fused_norm.group_norm_silu_ref(x, scale, bias, 8)
        torch.cuda.synchronize()
        rel = max_rel(y, ref)
        worst_abs = max(worst_abs, (y - ref).abs().max().item())
        ms = median_ms(lambda: fused_norm.group_norm_silu_fwd(x, scale, bias, 8))
        plain = median_ms(
            lambda: fused_norm.group_norm_silu_ref(x, scale, bias, 8))
        print(f"gn_silu_fwd B={b} {h}x{w}x{c}: max_rel {rel:.3e} "
              f"kernel {ms:.4f} ms plain {plain:.4f} ms")
        if not rel <= TOL_OUT:
            raise AssertionError(f"gn_silu_fwd {b}x{h}x{w}x{c}: max_rel "
                                 f"{rel} > {TOL_OUT}")
    return worst_abs


def phase_attn(gen):
    worst_abs = 0.0
    for seq in ATTN_LENGTHS:
        q, k, v = (torch.randn(ATTN_BH, seq, HEAD_DIM, generator=gen,
                               device="cuda") for _ in range(3))
        o, lse = flash_attention.flash_attention_fwd(q, k, v)
        o_ref, lse_ref = flash_attention.flash_attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        rel = max_rel(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        worst_abs = max(worst_abs, (o - o_ref).abs().max().item(), lse_err)
        ms = median_ms(lambda: flash_attention.flash_attention_fwd(q, k, v))
        plain = median_ms(
            lambda: flash_attention.flash_attention_fwd_ref(q, k, v))
        print(f"flash_attn_fwd BH={ATTN_BH} L={seq} d={HEAD_DIM}: o max_rel "
              f"{rel:.3e} lse max_abs {lse_err:.3e} kernel {ms:.4f} ms "
              f"plain {plain:.4f} ms")
        if not (rel <= TOL_OUT and lse_err <= TOL_LSE):
            raise AssertionError(f"flash_attn_fwd L={seq}: o {rel}, lse "
                                 f"{lse_err}")
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
    above; returns the kernel and plain time of one forward's worth of
    calls, summed over those shapes, and the worst absolute errors."""
    totals = {"gn": [0.0, 0.0], "attn": [0.0, 0.0]}
    worst_abs = {"gn": 0.0, "attn": 0.0}
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
        totals["attn"][0] += n * ms
        totals["attn"][1] += n * plain
        print(f"  main path: flash_attn_fwd BH={bh} L={seq} d={d} x{n}: o "
              f"max_rel {rel:.3e} lse max_abs {lse_err:.3e} kernel {ms:.4f} "
              f"ms plain {plain:.4f} ms")
        if not (rel <= TOL_OUT and lse_err <= TOL_LSE):
            raise AssertionError(f"flash_attn_fwd BH={bh} L={seq}: o {rel}, "
                                 f"lse {lse_err}")
    return totals, worst_abs


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


def check_attention_bwd(label, args):
    """K3 against its plain version on one input; returns the worst
    absolute error and the kernel and plain times."""
    grads = flash_attention.flash_attention_bwd(*args)
    refs = flash_attention.flash_attention_bwd_ref(*args)
    torch.cuda.synchronize()
    rels = [max_rel(g, r) for g, r in zip(grads, refs)]
    worst_abs = max((g - r).abs().max().item() for g, r in zip(grads, refs))
    ms = median_ms(lambda: flash_attention.flash_attention_bwd(*args))
    plain = median_ms(lambda: flash_attention.flash_attention_bwd_ref(*args))
    print(f"{label}: dq/dk/dv max_rel {rels[0]:.3e} {rels[1]:.3e} "
          f"{rels[2]:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms")
    if not max(rels) <= TOL_BWD:
        raise AssertionError(f"{label}: max_rel {rels} > {TOL_BWD}")
    return worst_abs, ms, plain


def phase_attn_bwd(attn_shapes, gen):
    """K3 against `flash_attention_bwd_ref` at BH 128 (L 256, 64, 16, 100
    at d 64; d 32 and 128 at L 256), then at every attention shape of a
    batch-128 train step; returns the worst absolute error and the kernel
    and plain time of one step's worth of backward calls."""
    worst_abs = 0.0
    cases = [(seq, HEAD_DIM) for seq in ATTN_LENGTHS]
    cases += [(256, d) for d in ATTN_BWD_HEAD_DIMS]
    for seq, d in cases:
        err, _, _ = check_attention_bwd(
            f"flash_attn_bwd BH={ATTN_BH} L={seq} d={d}",
            attention_bwd_case(ATTN_BH, seq, d, gen))
        worst_abs = max(worst_abs, err)
    totals = [0.0, 0.0]
    for (c, h, w), n in sorted(
            {s: attn_shapes.count(s) for s in attn_shapes}.items()):
        heads = 4
        bh, seq, d = TRAIN_BATCH * heads, h * w, c // heads
        err, ms, plain = check_attention_bwd(
            f"  train step: flash_attn_bwd BH={bh} L={seq} d={d} x{n}",
            attention_bwd_case(bh, seq, d, gen))
        worst_abs = max(worst_abs, err)
        totals[0] += n * ms
        totals[1] += n * plain
    return worst_abs, totals


def loss_and_grads(model, ddpm, batch):
    """The DDPM eps-loss of one batch and every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = ddpm.p_losses(model, batch["x0"], batch["t"], batch["noise"],
                         y=batch["y"])
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def phase_train_grads(label, model, config, per_step, gen):
    """The full-width model's loss and every gradient at batch 32 through
    the kernels against the same inside `plain_kernels()`, with exactly
    one step's launches (`per_step`) and none inside; every parameter must
    get a gradient. Call it with the model in eval mode (no dropout), so
    both runs see one network."""
    ddpm = DDPM(num_timesteps=config["num_timesteps"])
    batch = {
        "x0": torch.rand(CHECK_BATCH, 32, 32, 3, generator=gen,
                         device="cuda") * 2 - 1,
        "t": torch.randint(0, config["num_timesteps"], (CHECK_BATCH,),
                           generator=gen, device="cuda"),
        "noise": torch.randn(CHECK_BATCH, 32, 32, 3, generator=gen,
                             device="cuda"),
        "y": torch.randint(0, 11, (CHECK_BATCH,), generator=gen,
                           device="cuda"),
    }
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
    print(f"{label} loss and gradients B={CHECK_BATCH}, kernels vs plain: "
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


def write_train_config(config, tmp):
    """The config at full width with only the run's length, data and output
    places changed: the committed CIFAR-10 fixtures, three epochs, outputs
    under `tmp`, no best-model copy, no sample grid."""
    run = dict(config, data_root=str(FIXTURE_DATA), epochs=TRAIN_EPOCHS,
               save_dir=str(Path(tmp) / "checkpoints"),
               sample_dir=str(Path(tmp) / "samples"), save_best=False,
               sample_start_epoch=TRAIN_EPOCHS + 1)
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


def phase_train_main(label, config, per_step, per_forward, samplers, tmp):
    """`train.main` for three epochs on the fixtures at full width, with
    exactly `per_step` launches a step; then train images/s with the
    kernels and with the plain versions, in turns; then `sample.main` from
    the checkpoint it wrote, once for each (method, model calls, flags) of
    `samplers`, with exactly `per_forward` launches a model call."""
    cfg_path = write_train_config(config, tmp)
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
    print(f"train.main {label}: {TRAIN_EPOCHS} epochs, {steps} steps of "
          f"batch {TRAIN_BATCH} in {wall:.3f} s; losses {losses}; launches "
          f"{launches}")
    expected = scaled(per_step, steps)
    if not (steps == TRAIN_EPOCHS and launches == expected):
        raise AssertionError(f"{label}: {steps} steps, launches {launches}, "
                             f"expected {expected}")
    if not (len(losses) == TRAIN_EPOCHS and all(map(math.isfinite, losses))
            and ckpt.is_file()):
        raise AssertionError(f"{label}: losses {losses}, {ckpt} written: "
                             f"{ckpt.is_file()}")

    images, labels = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).to("cuda")
    labels = torch.from_numpy(labels).to("cuda")
    rates = {"kernels": [], "plain": []}
    for path in ("kernels", "plain", "plain", "kernels"):
        if path == "plain":
            with plain_kernels():
                rates[path].append(time_train_steps(trainer, images, labels))
        else:
            rates[path].append(time_train_steps(trainer, images, labels))
    print(f"{label} train images/s at batch {TRAIN_BATCH} (median of "
          f"{TRAIN_TIMED} steps after {TRAIN_WARMUP}), kernel path "
          f"{', '.join(f'{r:.2f}' for r in rates['kernels'])}, plain path "
          f"{', '.join(f'{r:.2f}' for r in rates['plain'])}")

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
        if not (samples.shape == (8, 32, 32, 3) and np.isfinite(samples).all()
                and (out / "samples.png").is_file()
                and got == scaled(per_forward, calls)):
            raise AssertionError(f"{label} {method}: samples "
                                 f"{samples.shape}, launches {got}")
    return launches, rates


# ------------------------------------------------------------------- DiM
def scan_case(batch, length, gen):
    """Scan inputs at the DiM's width: x, dt > 0 (softplus, mostly below
    1), A = -exp(N(0, 0.25)) * (1..N) like the model's S4D init, B, C, and
    an output gradient g."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = randn(batch, length, SCAN_D)
    dt = torch.nn.functional.softplus(randn(batch, length, SCAN_D) - 2)
    A = -torch.exp(randn(SCAN_D, SCAN_N) * 0.5) * torch.arange(
        1, SCAN_N + 1, device="cuda")
    return (x, dt, A, randn(batch, length, SCAN_N),
            randn(batch, length, SCAN_N), randn(batch, length, SCAN_D))


def phase_scan(gen):
    """The scan kernels against their plain versions: the forward (K5 with
    states off, K6 with states on, K4's ragged block at L = 100) and the
    backward (K8). Returns the worst absolute errors and the kernel and
    plain ms of one call at each shape."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for batch, length in SCAN_FWD_CASES:
        x, dt, A, B, C, _ = scan_case(batch, length, gen)
        for save in (False, True):
            y, bound = scan.selective_scan_fwd(x, dt, A, B, C, save)
            y_ref, bound_ref = scan.selective_scan_fwd_ref(x, dt, A, B, C,
                                                           save)
            torch.cuda.synchronize()
            rels = [max_rel(y, y_ref)]
            errs = [(y - y_ref).abs().max().item()]
            if save:
                rels.append(max_rel(bound, bound_ref))
                errs.append((bound - bound_ref).abs().max().item())
            worst["fwd"] = max(worst["fwd"], *errs)
            ms = median_ms(
                lambda: scan.selective_scan_fwd(x, dt, A, B, C, save))
            plain = median_ms(
                lambda: scan.selective_scan_fwd_ref(x, dt, A, B, C, save),
                reps=10, warmup=2)
            times[("fwd", batch, length, save)] = (ms, plain)
            print(f"selective_scan_fwd B={batch} L={length} D={SCAN_D} "
                  f"N={SCAN_N} states {'on' if save else 'off'}: max_rel "
                  f"{' '.join(f'{r:.3e}' for r in rels)} kernel {ms:.4f} ms "
                  f"plain {plain:.4f} ms")
            if not max(rels) <= TOL_SCAN_FWD:
                raise AssertionError(f"selective_scan_fwd B={batch} "
                                     f"L={length}: max_rel {rels}")
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
    gn_err = phase_gn(gen)
    attn_err = phase_attn(gen)
    config = load_config(CONFIG)
    model, gn_shapes, attn_shapes = phase_unet(config, gen)
    phase_trajectory(model, gen)
    totals, main_err = phase_main_shapes(gn_shapes, attn_shapes, 2 * SAMPLES,
                                         gen)
    with tempfile.TemporaryDirectory() as tmp:
        launches, seconds = phase_sample_main("UNet", config, model,
                                              UNET_FORWARD, tmp)
    del model
    bwd_err, bwd_totals = phase_attn_bwd(attn_shapes, gen)
    torch.manual_seed(0)
    phase_train_grads("UNet", factory.get_model(config).to("cuda").eval(),
                      config, UNET_STEP, gen)
    # DDIM-10, and DDPM over all of the config's timesteps
    samplers = [("ddim", 10, ["--num_inference_steps", "10"]),
                ("ddpm", config["num_timesteps"], [])]
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, rates = phase_train_main(
            "UNet", config, UNET_STEP, UNET_FORWARD, samplers, tmp)

    dim_config = load_config(DIM_CONFIG)
    scan_err, scan_times = phase_scan(gen)
    dim_model, dim_params = phase_dim(dim_config, gen)
    phase_trajectory(dim_model, gen)
    with tempfile.TemporaryDirectory() as tmp:
        dim_launches, dim_seconds = phase_sample_main(
            "DiM", dim_config, dim_model, DIM_FORWARD, tmp)
    del dim_model
    phase_train_grads("DiM", random_dim(dim_config, gen), dim_config,
                      DIM_STEP, gen)
    samplers = [("ddim", 10, ["--num_inference_steps", "10",
                              "--cfg_scale", str(CFG_SCALE)])]
    with tempfile.TemporaryDirectory() as tmp:
        dim_train_launches, dim_rates = phase_train_main(
            "DiM", dim_config, DIM_STEP, DIM_FORWARD, samplers, tmp)

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
    fwd_ms, fwd_plain = scan_times[("fwd", 2 * SAMPLES, 256, False)]
    bwd_ms, bwd_plain = scan_times[("bwd", TRAIN_BATCH, 256)]
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
         "ms": totals["gn"][0], "plain_ms": totals["gn"][1]},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": csrc + "flash_attn.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:65",
         "launches": launches["attn"],
         "launches_by_path": {"sample": launches["attn"],
                              "train": train_launches["attn"]},
         "max_abs_err": max(attn_err, main_err["attn"]),
         "ms": totals["attn"][0], "plain_ms": totals["attn"][1]},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": csrc + "flash_attn_bwd.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:126",
         "launches": train_launches["attn_bwd"],
         "launches_by_path": {"train": train_launches["attn_bwd"]},
         "max_abs_err": bwd_err,
         "ms": bwd_totals[0], "plain_ms": bwd_totals[1]},
        # K5 (states off), K6 (states on) and K4 (the ragged last block);
        # ms per sampling forward: 12 calls at batch 160
        {"name": "selective_scan_fwd", "route": "cuda",
         "source": csrc + "selective_scan_fwd.cu",
         "replaces": pallas + ":93",
         "also_replaces": [pallas + ":295", pallas + ":55"],
         "launches": dim_launches["scan_fwd"],
         "launches_by_path": {"sample": dim_launches["scan_fwd"],
                              "train": dim_train_launches["scan_fwd"]},
         "max_abs_err": scan_err["fwd"],
         "ms": SCAN_PER_FORWARD * fwd_ms,
         "plain_ms": SCAN_PER_FORWARD * fwd_plain},
        # K8; ms per train step: 12 calls at batch 128
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": csrc + "selective_scan_bwd.cu",
         "replaces": pallas + ":511",
         "launches": dim_train_launches["scan_bwd"],
         "launches_by_path": {"train": dim_train_launches["scan_bwd"]},
         "max_abs_err": scan_err["bwd"],
         "ms": SCAN_PER_FORWARD * bwd_ms,
         "plain_ms": SCAN_PER_FORWARD * bwd_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
