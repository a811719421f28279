"""Check and time the attention forward and backward, the scan backward,
the scan forward and the GroupNorm+SiLU kernels of one or more trees of the
PyTorch port, on one NVIDIA GPU.

    python tools/profile_torch_kernels.py
        [--only attention|attn_fwd|scan|scan_fwd|gn] [ROOT ...]

From the root of a checkout, on a machine with one CUDA card and nvcc. Each
ROOT (default: this checkout) is a directory that holds a
`diffusion_models_collection_tpu_torch/` package; each is built and run in a
process of its own, one after the other, so two versions of a kernel (an
unpacked parent commit beside the working tree) are compared on one card in
one call. Name a ROOT twice to see how far two runs of one tree differ.

`--only attn_fwd`: K2 (`flash_attention_fwd`) against its plain version
(2e-5 on o over the largest value, 1e-5 absolute on lse) at the CIFAR-10
UNet's forward shapes at the sampling batch of 160 (BH 640, d 64; L 256,
64 and 16, five, five and one call a forward) and at the lengths and head
dimensions of the backward's cases below, and `F.scaled_dot_product_attention`
(float32, TF32 off) timed beside it at the UNet's shapes; then the sum over
one forward's 11 calls, single launches and launches in a row.
For every shape below, K3 (`flash_attention_bwd`, in each form the tree's
wrapper offers) and K8, K7, K10 (`selective_scan_bwd`, `_bwd_nostate`,
`_bwd_split`) are held against their plain versions (bar 1e-4 on the
largest error over the largest value of each gradient), launched twice and
compared bit for bit, and timed: the median of 20 launches between CUDA
events after 3. At the UNet train step's main attention shape the backward
of `F.scaled_dot_product_attention` (float32, TF32 off) is timed beside K3.
The scan forward (`selective_scan_fwd`: K5 with states off, K6 with states
on, K4's ragged last block) is held against the plain forward at 2e-5, and
GroupNorm+SiLU (K1 `group_norm_silu_fwd`; where the tree has it, its backward
kernel `group_norm_silu_bwd`, "K1b") against the plain forward and against
autograd through the plain forward, which is also timed as the backward that
a tree without the kernel runs, at every shape of the CIFAR-10 UNet at batch
160 (forward) and 128 (backward), at 2e-5.
Prints the card's name and power limit, the registers and spills of each
of those kernels from the build's ptxas report, and one line a case; exits
with 1 if a case missed its bar or differed between its two launches.
"""

import argparse
import inspect
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
BAR = 1e-4
# (BH, L, d): the UNet train step's shapes at batch 128, then short, ragged
# and long sequences (few heads and many) and the other head dimensions
ATTENTION_CASES = [(512, 256, 64), (512, 64, 64), (128, 16, 64), (128, 100, 64),
                   (128, 256, 32), (128, 256, 128), (8, 257, 64), (16, 1024, 64),
                   (256, 512, 64), (128, 1024, 64), (8, 33, 32), (8, 16, 128)]
# (batch, L, D, N): the DiM train step and the 64x64 DiM's, then ragged
# lengths, D no multiple of a tile, N below 16 and above
SCAN_CASES = [(128, 256, 768, 16), (16, 1024, 768, 16), (4, 37, 200, 8),
              (4, 100, 768, 16), (2, 1000, 200, 32), (3, 1024, 768, 32),
              (2, 256, 200, 5)]
# (batch, L, D, N) of the forward: the DiM's sampling and training batches,
# the 64x64 DiM's sampling and training forward, K4's ragged block, then the
# other batches at L 1024 (K6 against K9), D no multiple of 4 or of a tile,
# N below 16 and above
SCAN_FWD_CASES = [(160, 256, 768, 16), (128, 256, 768, 16),
                  (16, 1024, 768, 16), (32, 100, 768, 16)]
SCAN_FWD_CASES += [(batch, 1024, 768, 16) for batch in (1, 2, 4, 8, 32, 64,
                                                        128)]
SCAN_FWD_CASES += [(4, 37, 130, 8), (2, 1000, 200, 32), (3, 1024, 768, 32),
                   (2, 256, 201, 5)]
BAR_FWD = 2e-5
# (H, W, C) of every GroupNorm+SiLU of the CIFAR-10 UNet, 8 groups; then
# (B, H, W, C) of a ragged shape (rows of 3 floats) and of a group too large
# for shared memory (64 x 64 x 16 floats): the generic kernels; rows of 2
# floats; rows of 32 vectors
GN_SHAPES = [(32, 32, 128), (32, 32, 256), (32, 32, 384), (16, 16, 128),
             (16, 16, 256), (16, 16, 384), (16, 16, 512), (8, 8, 256),
             (8, 8, 512), (4, 4, 256), (4, 4, 512)]
GN_ODD = [(3, 5, 7, 24), (4, 64, 64, 128), (2, 2, 3, 16), (5, 3, 3, 1024)]
GN_FWD_BATCH, GN_BWD_BATCH, GN_GROUPS = 160, 128, 8
# (BH, L, d, calls a forward) of the UNet's attention at the sampling batch
# of 160 rows (80 images, cond + uncond; 4 heads)
ATTN_FWD_UNET = [(640, 256, 64, 5), (640, 64, 64, 5), (640, 16, 64, 1)]
BAR_LSE = 1e-5


def median_ms(fn, reps=20, warmup=3):
    import torch
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
    return statistics.median(times)


def burst_ms(fn, calls=20):
    """Per call, `calls` launches between one pair of events: the host
    prepares the next launch while the card runs the last, so this is the
    larger of the kernel's time and the wrapper's host time, where
    `median_ms`, whose every launch starts on an idle card, is their sum."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(fn, calls=20, reps=5):
    """Per call, the card's own time: `calls` launches captured in a CUDA
    graph and replayed between one pair of events (the median of `reps`
    replays), so no launch waits on the host. `fn` has run before (any
    one-time set-up, such as a kernel's shared-memory opt-in, is done)."""
    import torch
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


def max_rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check(label, fn, refs, bar=BAR):
    """One line for `fn` against `refs`; True when it holds its bar and two
    launches agree bit for bit."""
    import torch
    outs = fn()
    again = fn()
    torch.cuda.synchronize()
    rels = [max_rel(o, r) for o, r in zip(outs, refs)]
    same = all(torch.equal(a, b) for a, b in zip(outs, again))
    ok = max(rels) <= bar and same
    print(f"{label}: rel {' '.join(f'{r:.1e}' for r in rels)} bit-equal {same} "
          f"{median_ms(fn):.4f} ms ({burst_ms(fn):.4f} in a row, "
          f"{graph_ms(fn):.4f} from a CUDA graph)"
          f"{'' if ok else ' FAIL'}", flush=True)
    return ok


def print_ptxas(log):
    name = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
            if not any(k in name for k in ("flash_", "scan_bwd", "split_",
                                           "scan_fwd", "gn_silu")):
                name = None
        elif name and ("registers" in line or "spill" in line):
            print(f"  {name[-60:]} | {line.strip()}")


def run_attn_fwd(root, attention, randn):
    """K2 at the UNet's forward shapes, with the library call beside it,
    then at the backward's cases; the sum over one UNet forward."""
    import torch
    import torch.nn.functional as F
    ok = True
    totals = {"single": 0.0, "row": 0.0, "graph": 0.0, "library": 0.0}
    cases = [(bh, length, d, n) for bh, length, d, n in ATTN_FWD_UNET]
    cases += [(bh, length, d, 0) for bh, length, d in ATTENTION_CASES]
    for bh, length, d, calls in cases:
        q, k, v = (randn(bh, length, d) for _ in range(3))
        o_ref, lse_ref = attention.flash_attention_fwd_ref(q, k, v)
        o, lse = attention.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        lse_err = (lse - lse_ref).abs().max().item()
        tile = (f" tile {attention.fwd_tile(length, d)}"
                if hasattr(attention, "fwd_tile") else "")
        label = f"K2 BH={bh} L={length} d={d}{tile}"
        fn = lambda: attention.flash_attention_fwd(q, k, v)  # noqa: E731
        held = check(label, lambda: fn()[:1], (o_ref,), BAR_FWD)
        print(f"   lse max_abs {lse_err:.1e}", flush=True)
        ok &= held and lse_err <= BAR_LSE
        if calls and hasattr(attention, "fwd_tile"):
            # each tile height the kernel has for this d, forced: the
            # readings behind `fwd_tile`
            rule = attention.fwd_tile
            try:
                for forced in (32, 128) if d <= 64 else (64,):
                    attention.fwd_tile = lambda *shape, t=forced: t
                    ok &= check(f"   forced tile {forced}", lambda: fn()[:1],
                                (o_ref,), BAR_FWD)
            finally:
                attention.fwd_tile = rule
        if calls:
            single, row = median_ms(fn), burst_ms(fn)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
            library = median_ms(sdpa)
            print(f"   x{calls} a UNet forward; scaled_dot_product_attention "
                  f"{library:.4f} ms ({burst_ms(sdpa):.4f} in a row)",
                  flush=True)
            totals["single"] += calls * single
            totals["row"] += calls * row
            totals["graph"] += calls * graph_ms(fn)
            totals["library"] += calls * library
    print(f"{root}: K2 over one UNet forward's 11 calls at batch 160: "
          f"{totals['single']:.4f} ms single launches, {totals['row']:.4f} ms "
          f"in a row, {totals['graph']:.4f} ms from a CUDA graph; "
          f"scaled_dot_product_attention {totals['library']:.4f} ms",
          flush=True)
    return ok


def run_scan_fwd(scan, randn):
    """K5, K6 and K4, with K9 at the same shapes beside them."""
    import torch
    import torch.nn.functional as F
    ok = True
    for batch, length, d_inner, n_state in SCAN_FWD_CASES:
        x = randn(batch, length, d_inner)
        dt = F.softplus(randn(batch, length, d_inner) - 2)
        A = -torch.exp(randn(d_inner, n_state) * 0.5) * torch.arange(
            1, n_state + 1, device="cuda")
        inputs = (x, dt, A, randn(batch, length, n_state),
                  randn(batch, length, n_state))
        refs = scan.selective_scan_fwd_ref(*inputs, True)
        shape = f"B={batch} L={length} D={d_inner} N={n_state}"
        ok &= check(f"K5 {shape}",
                    lambda: scan.selective_scan_fwd(*inputs, False)[:1],
                    refs[:1], BAR_FWD)
        ok &= check(f"K6 {shape}",
                    lambda: scan.selective_scan_fwd(*inputs, True), refs,
                    BAR_FWD)
        ok &= check(f"K9 {shape}",
                    lambda: scan.selective_scan_fwd_split(*inputs), refs,
                    BAR_FWD)
    return ok


def run_gn(root, randn):
    """K1 and, where the tree has it, K1b; the recompute backward beside."""
    import torch
    from diffusion_models_collection_tpu_torch.ops import fused_norm as gn
    ok = True
    has_bwd = hasattr(gn, "group_norm_silu_bwd")
    cases = ([(GN_FWD_BATCH, *s) for s in GN_SHAPES] + GN_ODD)
    totals = {"K1": 0.0, "K1b": 0.0, "recompute": 0.0}
    for b, h, w, c in cases:
        main = (h, w, c) in GN_SHAPES
        scale = 1 + 0.1 * randn(c)
        bias = 0.1 * randn(c)
        x = randn(b, h, w, c) * 2 + 0.5
        ref = gn.group_norm_silu_ref(x, scale, bias, GN_GROUPS)
        shape = f"B={b} {h}x{w}x{c}"
        ok &= check(f"K1 {shape}",
                    lambda: (gn.group_norm_silu_fwd(x, scale, bias,
                                                    GN_GROUPS),), (ref,),
                    BAR_FWD)
        if main:
            totals["K1"] += median_ms(
                lambda: gn.group_norm_silu_fwd(x, scale, bias, GN_GROUPS))
            b = GN_BWD_BATCH
            x = x[:b].contiguous()
        g = randn(b, h, w, c)
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        out = gn.group_norm_silu_ref(*leaves, GN_GROUPS)

        def recompute():
            return torch.autograd.grad(out, leaves, g, retain_graph=True)

        refs = recompute()
        ms = median_ms(recompute, reps=10)
        print(f"   recompute backward B={b} {h}x{w}x{c}: {ms:.4f} ms")
        if main:
            totals["recompute"] += ms
        if has_bwd:
            _, stats = gn.group_norm_silu_fwd_stats(x, scale, bias, GN_GROUPS)
            ok &= check(f"K1b B={b} {h}x{w}x{c}",
                        lambda: gn.group_norm_silu_bwd(x, scale, bias, g,
                                                       stats, GN_GROUPS), refs,
                        BAR_FWD)
            if main:
                totals["K1b"] += median_ms(
                    lambda: gn.group_norm_silu_bwd(x, scale, bias, g, stats,
                                                   GN_GROUPS))
    print(f"{root}: sum over the UNet's 11 shapes, one call each: K1 at batch "
          f"{GN_FWD_BATCH} {totals['K1']:.4f} ms; at batch {GN_BWD_BATCH} K1b "
          f"{totals['K1b']:.4f} ms, the recompute backward "
          f"{totals['recompute']:.4f} ms")
    return ok


def run_tree(root, only):
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(root))
    from diffusion_models_collection_tpu_torch.ops import (
        _build, flash_attention as attention, selective_scan as scan)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    _build.library()
    print(f"{root}: built in {_build.build_info['seconds']:.1f} s")
    print_ptxas(_build.build_info["log"])
    ok = True

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    forms = (None,)
    if "fused" in inspect.signature(attention.flash_attention_bwd).parameters:
        forms = (None, True, False)
    for bh, length, d in (ATTENTION_CASES if only in (None, "attention")
                          else []):
        q, k, v, do = (randn(bh, length, d) for _ in range(4))
        o, lse = attention.flash_attention_fwd_ref(q, k, v)
        args = (q, k, v, o, do, lse)
        refs = attention.flash_attention_bwd_ref(*args)
        for fused in forms:
            kwargs = {} if fused is None else {"fused": fused}
            ok &= check(f"K3 BH={bh} L={length} d={d} fused={fused}",
                        lambda: attention.flash_attention_bwd(*args, **kwargs),
                        refs)
        if (bh, length, d) == ATTENTION_CASES[0]:
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*qkv)
            ms = median_ms(lambda: torch.autograd.grad(out, qkv, do,
                                                       retain_graph=True))
            print(f"   scaled_dot_product_attention backward {ms:.4f} ms")

    if only in (None, "attn_fwd"):
        ok &= run_attn_fwd(root, attention, randn)
    if only in (None, "scan_fwd"):
        ok &= run_scan_fwd(scan, randn)
    if only in (None, "gn"):
        ok &= run_gn(root, randn)

    for batch, length, d_inner, n_state in (SCAN_CASES if only in (None, "scan")
                                            else []):
        x = randn(batch, length, d_inner)
        dt = F.softplus(randn(batch, length, d_inner) - 2)
        A = -torch.exp(randn(d_inner, n_state) * 0.5) * torch.arange(
            1, n_state + 1, device="cuda")
        inputs = (x, dt, A, randn(batch, length, n_state),
                  randn(batch, length, n_state), randn(batch, length, d_inner))
        _, bound = scan.selective_scan_fwd(*inputs[:5], True)
        refs = scan.selective_scan_bwd_ref(*inputs, bound)
        shape = f"B={batch} L={length} D={d_inner} N={n_state}"
        for name, fn, args in (
                ("K8", scan.selective_scan_bwd, (*inputs, bound)),
                ("K7", scan.selective_scan_bwd_nostate, inputs),
                ("K10", scan.selective_scan_bwd_split, (*inputs, bound))):
            ok &= check(f"{name} {shape}", lambda: fn(*args), refs)
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*", default=[str(HERE.parent.parent)])
    parser.add_argument("--only",
                        choices=["attention", "attn_fwd", "scan", "scan_fwd",
                                 "gn"])
    parser.add_argument("--tree", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tree:
        return 0 if run_tree(Path(args.tree).resolve(), args.only) else 1
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_kernels.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    failed = 0
    for root in args.roots:
        cmd = [sys.executable, str(HERE), "--tree", root]
        if args.only:
            cmd += ["--only", args.only]
        failed |= subprocess.run(cmd).returncode
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
