"""Time what the kernels' `torch.library` dispatch costs the host-bound bf16
paths of one or more trees of the PyTorch port, on one NVIDIA GPU.

    python tools/profile_torch_dispatch.py [ROOT ...] [--rounds 10]

From the root of a checkout, on a machine with one CUDA card and nvcc. Each
ROOT (default: this checkout) is a directory that holds a
`diffusion_models_collection_tpu_torch/` package. Every round runs each
ROOT in a process of its own, in the given order in even rounds and the
reverse in odd ones (parent, change, change, parent, ...), so a tree whose
wrappers launch through the operators of `ops/_library.py` and an unpacked
parent whose wrappers launch directly are compared on one card in one call.
A process takes, with random weights and TF32 off:

* the bf16 UNet (configs/cifar10_unet.py, `mixed_precision: 'bf16'`): 80
  images DDIM-50 with CFG 3 through the process's `sample_with_cfg`,
  samples/s, after a 2-step warm-up;
* the bf16 DiT (configs/cifar10_dit.py): train images/s at batch 128
  (train mode, dropout 0.1: the loss, its backward and an AdamW step), the
  median of 10 steps after 3;
* where the tree has the operators, the host's microseconds a call of
  GroupNorm+SiLU's forward on a (2, 8, 8, 64) float32 tensor, whose kernel
  takes a few microseconds, so the host's own time is what a run of calls
  shows: through the operator (`torch.ops.dmc.gn_silu_fwd`), through its
  launcher called directly, and through the same launcher wrapped by the
  `torch.library.custom_op` decorator, the median over 5 runs of 2000
  calls.

Where the tree has the operators, the UNet and DiT readings are a pair:
one through the operators and one through their launchers called directly
(the module's `_FWD` and `_BWD` pointed at `_fwd_cuda`, `_bwd_cuda` for the
run, what the parent's wrappers did), operators first in even rounds and
last in odd ones; a tree without them takes one reading. So `--rounds`
rounds give each tree `--rounds` readings of each path.

Prints one line a reading, then for each reading's kind, tree and path the
median and quartiles over the rounds and the ratios of the medians (direct
against the operators; each tree against the first), each line with the
card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()


def rate_ms(fn, calls=2000, runs=5):
    """Host microseconds a call: `calls` calls of `fn` in a row, then one
    synchronize, the median over `runs` runs."""
    import torch
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) / calls * 1e6)
    return statistics.median(times[1:])


OPERATORS = "through the operators"
DIRECT = "through the launchers called directly"


def paired(measure, flip: bool):
    """`measure()` by path: where the tree's wrappers launch through the
    operators, once through them and once through the launchers called
    directly (in that order, or the reverse with `flip`); else once, under
    the path "". """
    from diffusion_models_collection_tpu_torch.ops import (
        flash_attention, fused_norm)
    if not hasattr(fused_norm, "_fwd_cuda"):
        return {"": measure()}
    ops = {module: (module._FWD, module._BWD)
           for module in (fused_norm, flash_attention)}
    out = {}
    for path in ((DIRECT, OPERATORS) if flip else (OPERATORS, DIRECT)):
        for module, (fwd, bwd) in ops.items():
            module._FWD, module._BWD = ((module._fwd_cuda, module._bwd_cuda)
                                        if path == DIRECT else (fwd, bwd))
        try:
            out[path] = measure()
        finally:
            for module, (fwd, bwd) in ops.items():
                module._FWD, module._BWD = fwd, bwd
    return out


def report(root, kind, path, value, unit, smi):
    """One reading: a line to read, and one the parent process gathers."""
    print(f"{root}: {kind}{' ' + path if path else ''}: {value:.2f} {unit}; "
          f"on {smi}", flush=True)
    print("READING " + json.dumps({"root": str(root), "kind": kind,
                                   "path": path, "value": value,
                                   "unit": unit}), flush=True)


def run_tree(root: Path, smi: str, flip: bool):
    import torch
    sys.path.insert(0, str(root))
    from diffusion_models_collection_tpu_torch import factory
    from diffusion_models_collection_tpu_torch.ops import _build, fused_norm
    from diffusion_models_collection_tpu_torch.utils.helpers import (
        load_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    config = dict(load_config(root / "configs" / "cifar10_unet.py"),
                  mixed_precision="bf16")
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").eval()
    shape = (80, 32, 32, 3)
    labels = torch.randint(1, 11, (80,), generator=gen, device="cuda")
    x_T = torch.randn(shape, generator=gen, device="cuda")

    def sample(steps):
        ddim = factory.get_diffusion(dict(config, num_inference_steps=steps),
                                     "ddim")
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            ddim.sample_with_cfg(model, shape, labels, cfg_scale=3.0,
                                 init_noise=x_T)
        torch.cuda.synchronize()
        return 80 / (time.perf_counter() - start)
    sample(2)
    for path, rate in paired(lambda: sample(50), flip).items():
        report(root, "bf16 UNet DDIM-50 CFG 3, 80 images", path, rate,
               "samples/s", smi)
    del model

    config = dict(load_config(root / "configs" / "cifar10_dit.py"),
                  mixed_precision="bf16")
    torch.manual_seed(0)
    model = factory.get_model(config).to("cuda").train()
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    process = factory.get_diffusion(config)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    batch = 128
    x0 = torch.rand(batch, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    y = torch.randint(0, 11, (batch,), generator=gen, device="cuda")

    def train_rate():
        times = []
        for i in range(13):
            torch.cuda.synchronize()
            start = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            process.p_losses(model, x0, t, noise, y=y).backward()
            opt.step()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(time.perf_counter() - start)
        return batch / statistics.median(times)
    for path, rate in paired(train_rate, flip).items():
        report(root, f"bf16 DiT train step at batch {batch}", path, rate,
               "images/s", smi)
    del model, opt

    if not hasattr(fused_norm, "_fwd_cuda"):
        return
    from diffusion_models_collection_tpu_torch.ops import _library
    x = torch.randn(2, 8, 8, 64, generator=gen, device="cuda")
    scale = torch.ones(64, device="cuda")
    bias = torch.zeros(64, device="cuda")

    @torch.library.custom_op("dmc_probe::gn_silu_fwd", mutates_args=())
    def decorated(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  num_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
        return fused_norm._fwd_cuda(x, scale, bias, num_groups)

    op = _library.OPS["gn_silu_fwd"]
    readings = {
        "the library operator": lambda: op(x, scale, bias, 8),
        "the launcher called directly": lambda: fused_norm._fwd_cuda(
            x, scale, bias, 8),
        "the custom_op decorator": lambda: decorated(x, scale, bias, 8)}
    with torch.no_grad():
        for label in (reversed(readings) if flip else readings):
            report(root, "GroupNorm+SiLU forward (2, 8, 8, 64), host time",
                   f"through {label}", rate_ms(readings[label]),
                   "us a call", smi)


def summarise(readings, roots, smi):
    """For each kind, tree and path: the median and quartiles of its
    readings; then the ratio of the medians, direct against the operators
    in a tree and each tree's against the first's on the same path (a
    parent's "" against the operators)."""
    groups = {}
    for r in readings:
        groups.setdefault((r["kind"], r["root"], r["path"]), []).append(r)
    medians = {}
    for (kind, root, path), rs in groups.items():
        values = sorted(r["value"] for r in rs)
        q1, q2, q3 = (statistics.quantiles(values, n=4) if len(values) > 1
                      else values * 3)
        medians[kind, root, path] = q2
        print(f"summary: {root}: {kind}{' ' + path if path else ''}: "
              f"median {q2:.2f}, quartiles {q1:.2f}-{q3:.2f} {rs[0]['unit']} "
              f"over {len(values)} rounds; on {smi}", flush=True)
    for (kind, root, path), median in medians.items():
        if path == DIRECT and (kind, root, OPERATORS) in medians:
            print(f"summary: {root}: {kind}: direct/operators "
                  f"{median / medians[kind, root, OPERATORS]:.4f}; on {smi}",
                  flush=True)
        first = str(roots[0])
        if root != first and path in (OPERATORS, ""):
            base = (medians.get((kind, first, ""))
                    or medians.get((kind, first, OPERATORS)))
            if base:
                print(f"summary: {root} against {first}: {kind}: "
                      f"{median / base:.4f}; on {smi}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*", default=[str(HERE.parent.parent)])
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--tree", help=argparse.SUPPRESS)
    parser.add_argument("--smi", help=argparse.SUPPRESS)
    parser.add_argument("--flip", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tree:
        run_tree(Path(args.tree).resolve(), args.smi, args.flip)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_dispatch.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    roots = [str(Path(r).resolve()) for r in args.roots]
    readings = []
    for round_ in range(args.rounds):
        flip = round_ % 2 == 1
        for root in (reversed(roots) if flip else roots):
            run = subprocess.run(
                [sys.executable, str(HERE), "--tree", root, "--smi", smi,
                 *(["--flip"] if flip else [])],
                capture_output=True, text=True)
            sys.stderr.write(run.stderr[-4000:] if run.returncode else "")
            for line in run.stdout.splitlines():
                if line.startswith("READING "):
                    readings.append(json.loads(line[len("READING "):]))
                else:
                    print(f"round {round_}: {line}", flush=True)
            if run.returncode:
                print(f"{root}: exit {run.returncode} in round {round_}",
                      flush=True)
                return 1
    summarise(readings, roots, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
