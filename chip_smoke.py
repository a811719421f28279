"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. It builds the port's kernels from
`diffusion_models_collection_tpu_torch/csrc/`, holds each against its plain
PyTorch version at the shapes of the CIFAR-10 UNet (configs/cifar10_unet.py),
at batch 32 and at the sampling run's own batch of 160 rows (80 images,
cond + uncond), checks full-width UNet forwards at both batches and a short
sampling run against the plain versions, then samples 80 images with DDIM-50 and classifier-free
guidance (scale 3) through `diffusion_models_collection_tpu_torch.sample`,
the port's entry point, from a randomly initialised checkpoint, and checks
that every GroupNorm+SiLU and attention call of that run went through a
kernel. Every failure raises; there is no fallback. The last line of
standard output is one JSON object with "ok": true; the line before it
lists each kernel with its launches, error and times.

Float32 throughout, TF32 off. Kernel times are medians of CUDA-event
timings after warm-up; samples/s is the generation loop of one
`sample.main` call; all on the card named in the output.
"""

import json
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

from diffusion_models_collection_tpu_torch import factory, sample  # noqa: E402
from diffusion_models_collection_tpu_torch.diffusion import DDIM  # noqa: E402
from diffusion_models_collection_tpu_torch.models import unet as unet_mod  # noqa: E402
from diffusion_models_collection_tpu_torch.ops import (  # noqa: E402
    _build,
    flash_attention,
    fused_norm,
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
# Max-rel is max|kernel - plain| / max|plain|. The kernel and the plain
# version sum in other orders; float32 rounding puts both near 1e-7
# relative, so 2e-5 leaves room and still catches a wrong index.
TOL_OUT = 2e-5
TOL_LSE = 1e-5  # absolute, on values of about log(L) + max score
# A full forward chains 45 norms and 11 attentions through 60 convs.
TOL_UNET = 1e-4
TOL_TRAJ = 5e-4  # 10 DDIM steps with CFG and dynamic thresholding


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
        y = fused_norm.group_norm_silu(x, scale, bias, 8)
        ref = fused_norm.group_norm_silu_ref(x, scale, bias, 8)
        torch.cuda.synchronize()
        rel = max_rel(y, ref)
        worst_abs = max(worst_abs, (y - ref).abs().max().item())
        ms = median_ms(lambda: fused_norm.group_norm_silu(x, scale, bias, 8))
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
        out = fused_norm.group_norm_silu(x, scale, bias, 8)
        ref = fused_norm.group_norm_silu_ref(x, scale, bias, 8)
        torch.cuda.synchronize()
        rel = max_rel(out, ref)
        worst_abs["gn"] = max(worst_abs["gn"], (out - ref).abs().max().item())
        ms = median_ms(lambda: fused_norm.group_norm_silu(x, scale, bias, 8))
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


def phase_main_path(config, model, tmp):
    ckpt = Path(tmp) / "cifar10_unet_random.pth"
    checkpoint.save_checkpoint(ckpt, model.state_dict(), config)
    argv = ["--checkpoint", str(ckpt), "--sampling_method", "ddim",
            "--cfg_scale", str(CFG_SCALE), "--num_samples", str(SAMPLES),
            "--batch_size", str(SAMPLES), "--seed", "0", "--device", "cuda",
            "--output_dir", tmp, "--output_name", "samples.png",
            "--num_inference_steps", str(STEPS)]
    # phase_unet ran the model at this batch, so cuDNN and the kernel
    # library are warm
    torch.cuda.synchronize()
    fused_norm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    start = time.perf_counter()
    result = sample.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"gn": fused_norm.LAUNCHES, "attn": flash_attention.LAUNCHES}
    samples = result["samples"]
    if not (samples.shape == (SAMPLES, 32, 32, 3)
            and np.isfinite(samples).all()):
        raise AssertionError(f"samples: shape {samples.shape}, finite "
                             f"{np.isfinite(samples).all()}")
    for name in ("samples.png", "samples.npy"):
        if not (Path(tmp) / name).is_file():
            raise AssertionError(f"{name} was not written")
    if launches != {"gn": STEPS * GN_PER_FORWARD,
                    "attn": STEPS * ATTN_PER_FORWARD}:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{STEPS * GN_PER_FORWARD} and "
                             f"{STEPS * ATTN_PER_FORWARD}")
    print(f"sample.main: {SAMPLES} images, DDIM-{STEPS}, CFG {CFG_SCALE}: "
          f"sampling {result['sampling_seconds']:.3f} s "
          f"({SAMPLES / result['sampling_seconds']:.2f} samples/s), whole "
          f"call {wall:.3f} s; launches gn_silu_fwd {launches['gn']} "
          f"flash_attn_fwd {launches['attn']}")
    return launches, result["sampling_seconds"]


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
        launches, seconds = phase_main_path(config, model, tmp)

    print(f"{SAMPLES / seconds:.2f} samples/s DDIM-{STEPS} CFG {CFG_SCALE} "
          f"fp32 on {smi}")
    kernels = [
        {"name": "gn_silu_fwd", "route": "cuda",
         "source": "diffusion_models_collection_tpu_torch/csrc/gn_silu.cu",
         "replaces": "diffusion_models_collection_tpu/ops/fused_norm.py:46",
         "launches": launches["gn"],
         "max_abs_err": max(gn_err, main_err["gn"]),
         "ms": totals["gn"][0], "plain_ms": totals["gn"][1]},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "diffusion_models_collection_tpu_torch/csrc/flash_attn.cu",
         "replaces": "diffusion_models_collection_tpu/ops/flash_attention.py:65",
         "launches": launches["attn"],
         "max_abs_err": max(attn_err, main_err["attn"]),
         "ms": totals["attn"][0], "plain_ms": totals["attn"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
