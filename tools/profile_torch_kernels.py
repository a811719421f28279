"""Check and time the attention forward and backward, the scan backward,
the scan forward and the GroupNorm+SiLU kernels of one or more trees of the
PyTorch port, on one NVIDIA GPU.

    python tools/profile_torch_kernels.py
        [--only attention|attn_fwd|attn_dropout|scan|scan_fwd|gn|bf16|wide]
        [ROOT ...]

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
`--only attn_dropout`: K2 and K3 in their dropout form (p 0.1, one seed)
against their plain versions at the CIFAR-10 DiT's train step (BH 768, L
256, d 64; 12 calls a step) and at the DiM's attention fallback (BH 1024, d
48), each timed beside the same call at p = 0 and beside
`F.scaled_dot_product_attention` with dropout 0.1 and its backward (float32,
TF32 off; the library's own mask); then the sums over a DiT train step's 12
calls. Single launches, launches in a row and from a CUDA graph. A tree
without the dropout forms is skipped.
`--only bf16`: the bf16 forms of K1, K1b, K2 and K3 (bf16 in and out,
float32 arithmetic) against their plain versions (bar 8e-3 over the
largest value: one bf16 step of it) at the UNet's GroupNorm+SiLU shapes
(batch 160 forward, 128 backward), its attention shapes (the forward at
batch 160, the backward at 128) and the DiT's (sampling, BH 960; a train
step, BH 768 at p 0.1), each timed beside the float32 form and
`F.scaled_dot_product_attention` on the same bf16 inputs as (1, BH, L, d),
which takes PyTorch's flash kernel (and on the float32 ones, its
memory-efficient kernel), and K2's and K3's bf16 forms with each tile height
they offer forced (the data behind `fwd_tile` and `bwd_tile` in bf16); then
the sums over one forward's or step's calls. A tree without the bf16 forms
is skipped.
`--only wide`: K2 and K3 past head_dim 128 (the wide forms) against their
plain versions (float32: 2e-5 on o and 1e-4 on each gradient over the
largest value; bf16: one bf16 step of the largest value) at the CIFAR-10
DiT's shapes at two heads of 192 (its train step, BH 256 at p 0.1, and
sampling, BH 64 at p 0), at d 256 (BH 256, p 0.1) and at L 1024 (BH 192,
d 192, p 0.1), L 256 elsewhere, float32 and bf16; each timed (a single
launch, 20 in a row, 20 replayed from a CUDA graph) beside
`F.scaled_dot_product_attention` and its backward on the same inputs as (1,
BH, L, d) with the same p (its own mask; TF32 off; its backward with
dropout is not captured in a graph, whose capture fails) and the call's bound:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over 67 TFLOP/s (float32) or the tensor
cores' 989 (bf16).
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
            # (1, BH, L, d): on 3-D tensors PyTorch takes its math path
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], k[None], v[None])
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


# (BH, L, d, calls a train step): the DiT's attention at batch 128 (6 heads
# of 64), then the DiM's attention fallback (8 heads of 48)
ATTN_DROPOUT_CASES = [(768, 256, 64, 12), (1024, 256, 48, 0)]
ATTN_DROPOUT, ATTN_DROPOUT_SEED = 0.1, 0x0123_4567_89AB_CDEF


def run_attn_dropout(root, attention, randn):
    """K2 and K3 in the dropout form against their plain versions, timed
    beside the p = 0 forms and the library call with dropout."""
    import torch
    import torch.nn.functional as F
    if not hasattr(attention, "philox_keep_mask"):
        print(f"{root}: no dropout forms; skipped", flush=True)
        return True
    ok = True
    drop = (ATTN_DROPOUT, ATTN_DROPOUT_SEED)
    totals = {}
    for bh, length, d, calls in ATTN_DROPOUT_CASES:
        q, k, v, do = (randn(bh, length, d) for _ in range(4))
        o_ref, lse_ref = attention.flash_attention_fwd_ref(q, k, v, *drop)
        o, lse = attention.flash_attention_fwd(q, k, v, *drop)
        torch.cuda.synchronize()
        lse_err = (lse - lse_ref).abs().max().item()
        args = (q, k, v, o, do, lse)
        refs = attention.flash_attention_bwd_ref(*args, *drop)
        shape = f"BH={bh} L={length} d={d}"
        times = {}
        for name, fn, want, bar in (
                ("K2 dropout", lambda: attention.flash_attention_fwd(
                    q, k, v, *drop)[:1], (o_ref,), BAR_FWD),
                ("K2 p=0", lambda: attention.flash_attention_fwd(
                    q, k, v)[:1], None, None),
                ("K3 dropout", lambda: attention.flash_attention_bwd(
                    *args, *drop), refs, BAR),
                ("K3 p=0", lambda: attention.flash_attention_bwd(*args),
                 None, None)):
            if want is not None:
                ok &= check(f"{name} {shape}", fn, want, bar)
            times[name] = (median_ms(fn), burst_ms(fn), graph_ms(fn))
        print(f"   lse max_abs {lse_err:.1e}", flush=True)
        ok &= lse_err <= BAR_LSE
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[None], k[None], v[None], dropout_p=ATTN_DROPOUT)
        qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*qkv, dropout_p=ATTN_DROPOUT)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, qkv, do[None], retain_graph=True)
        times["library"] = (median_ms(sdpa), burst_ms(sdpa), None)
        times["library backward"] = (median_ms(sdpa_bwd), burst_ms(sdpa_bwd),
                                     None)
        print(f"   {shape}, ms a call (single launch, in a row, from a CUDA "
              "graph): " + "; ".join(
                  f"{name} {' '.join(f'{t:.4f}' for t in ts if t is not None)}"
                  for name, ts in times.items()), flush=True)
        for name, ts in times.items():
            totals[name] = [calls * t if t is not None else None for t in ts]
        if calls:
            print(f"{root}: over a DiT train step's {calls} calls, ms "
                  "(single launches, in a row, from a CUDA graph): " + "; ".join(
                      f"{name} {' '.join(f'{t:.4f}' for t in ts if t is not None)}"
                      for name, ts in totals.items()), flush=True)
    return ok


BAR_BF16 = 8e-3  # one bf16 step (2^-7 at most) of the largest value
# (BH, L, d, calls) of the UNet train step's attention at batch 128
ATTN_BWD_UNET = [(512, 256, 64, 5), (512, 64, 64, 5), (512, 16, 64, 1)]
# (BH, L, d, calls, dropout) of the DiT: sampling at batch 160, a train step
ATTN_DIT = [(960, 256, 64, 12, 0.0), (768, 256, 64, 12, ATTN_DROPOUT)]


def sweep_bf16_tiles(attention, rule, length, d, fn, refs):
    """`fn` (K2 or K3 in bf16) with each tile height that the tree's bf16
    form offers at this length and head_dim forced in place of `rule`
    (`fwd_tile` or `bwd_tile`): the readings behind the bf16 rules. A tree
    whose rules take no dtype has no such forms and is skipped."""
    import torch
    tiles = {"fwd_tile": (16, 64, 128), "bwd_tile": (16, 64)}[rule]
    chosen = getattr(attention, rule)
    if "dtype" not in inspect.signature(chosen).parameters:
        return True
    ok = True
    try:
        for forced in tiles:
            # (bf16 sums the fused backward's dq shares in a cluster of at
            # most 8 key tiles)
            if (d > 64 and forced != 64) or (
                    rule == "bwd_tile" and -(-length // forced) > 8):
                continue
            setattr(attention, rule, lambda *shape, t=forced: t)
            label = (f"   forced {rule} {forced} (the rule: "
                     f"{chosen(length, d, torch.bfloat16)})")
            ok &= check(label, fn, refs, BAR_BF16)
    finally:
        setattr(attention, rule, chosen)
    return ok


def run_bf16(root, attention, randn):
    """The bf16 forms of K1, K1b, K2 and K3 beside their float32 forms and
    the library call on the same bf16 inputs, with the sums over a UNet
    forward or train step and a DiT's 12 calls."""
    import torch
    import torch.nn.functional as F
    from diffusion_models_collection_tpu_torch.ops import fused_norm as gn
    if not hasattr(gn, "BF16_LAUNCHES"):
        print(f"{root}: no bf16 forms; skipped", flush=True)
        return True
    ok = True
    totals = {}

    def add(key, calls, fn, graph=True):
        # autograd's backward cannot be captured in a CUDA graph: 0 there
        ts = (median_ms(fn), burst_ms(fn), graph_ms(fn) if graph else 0.0)
        totals[key] = [a + calls * t for a, t in
                       zip(totals.get(key, (0.0, 0.0, 0.0)), ts)]
        return ts

    for h, w, c in GN_SHAPES:
        scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
        x = randn(GN_FWD_BATCH, h, w, c) * 2 + 0.5
        x16 = x.bfloat16()
        ref = gn.group_norm_silu_ref(x16, scale, bias, GN_GROUPS)
        shape = f"{h}x{w}x{c}"
        fn = lambda: (gn.group_norm_silu_fwd(  # noqa: E731
            x16, scale, bias, GN_GROUPS),)
        ok &= check(f"K1 bf16 B={GN_FWD_BATCH} {shape}", fn, (ref,),
                    BAR_BF16)
        add("K1 bf16", 1, fn)
        add("K1 fp32", 1, lambda: gn.group_norm_silu_fwd(x, scale, bias,
                                                          GN_GROUPS))
        x, x16 = x[:GN_BWD_BATCH].contiguous(), x16[:GN_BWD_BATCH].contiguous()
        g = randn(GN_BWD_BATCH, h, w, c)
        g16 = g.bfloat16()
        _, stats = gn.group_norm_silu_fwd_stats(x16, scale, bias, GN_GROUPS)
        refs = gn.group_norm_silu_bwd_ref(x16, scale, bias, g16, stats,
                                          GN_GROUPS)
        fn = lambda: gn.group_norm_silu_bwd(  # noqa: E731
            x16, scale, bias, g16, stats, GN_GROUPS)
        ok &= check(f"K1b bf16 B={GN_BWD_BATCH} {shape}", fn, refs, BAR_BF16)
        add("K1b bf16", 1, fn)
        _, stats32 = gn.group_norm_silu_fwd_stats(x, scale, bias, GN_GROUPS)
        add("K1b fp32", 1, lambda: gn.group_norm_silu_bwd(
            x, scale, bias, g, stats32, GN_GROUPS))
    for bh, length, d, calls, p, which in (
            [(*c, 0.0, "UNet forward") for c in ATTN_FWD_UNET]
            + [(*c, 0.0, "UNet step") for c in ATTN_BWD_UNET]
            + [(bh, length, d, calls, p, f"DiT p={p}")
               for bh, length, d, calls, p in ATTN_DIT]):
        q, k, v, do = (randn(bh, length, d) for _ in range(4))
        q16, k16, v16, do16 = (t.bfloat16() for t in (q, k, v, do))
        drop = (p, ATTN_DROPOUT_SEED) if p else ()
        o_ref, lse_ref = attention.flash_attention_fwd_ref(q16, k16, v16,
                                                           *drop)
        o16, lse16 = attention.flash_attention_fwd(q16, k16, v16, *drop)
        o, lse = attention.flash_attention_fwd(q, k, v, *drop)
        shape = f"BH={bh} L={length} d={d} p={p}"
        if which != "UNet step":
            fn = lambda: attention.flash_attention_fwd(  # noqa: E731
                q16, k16, v16, *drop)[:1]
            ok &= check(f"K2 bf16 {shape}", fn, (o_ref,), BAR_BF16)
            add(f"K2 bf16, {which}", calls, fn)
            ok &= sweep_bf16_tiles(attention, "fwd_tile", length, d, fn,
                                   (o_ref,))
            add(f"K2 fp32, {which}", calls,
                lambda: attention.flash_attention_fwd(q, k, v, *drop))
            # (1, BH, L, d): PyTorch's flash kernel (3-D takes its math
            # path); the float32 call beside it takes its memory-efficient
            # kernel
            add(f"library bf16, {which}", calls,
                lambda: F.scaled_dot_product_attention(
                    q16[None], k16[None], v16[None], dropout_p=p))
            add(f"library fp32 4-D, {which}", calls,
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], dropout_p=p))
        if which == "UNet step" or p:
            args16 = (q16, k16, v16, o16, do16, lse16)
            refs = attention.flash_attention_bwd_ref(*args16, *drop)
            fn = lambda: attention.flash_attention_bwd(  # noqa: E731
                *args16, *drop)
            ok &= check(f"K3 bf16 {shape}", fn, refs, BAR_BF16)
            add(f"K3 bf16, {which}", calls, fn)
            ok &= sweep_bf16_tiles(attention, "bwd_tile", length, d, fn, refs)
            add(f"K3 fp32, {which}", calls,
                lambda: attention.flash_attention_bwd(q, k, v, o, do, lse,
                                                      *drop))
            for name, leaves, grad in (("bf16", (q16, k16, v16), do16),
                                       ("fp32 4-D", (q, k, v), do)):
                qkv = [t.detach()[None].requires_grad_() for t in leaves]
                out = F.scaled_dot_product_attention(*qkv, dropout_p=p)
                add(f"library {name} backward, {which}", calls,
                    lambda: torch.autograd.grad(out, qkv, grad[None],
                                                retain_graph=True),
                    graph=False)
    print(f"{root}: sums, ms (single launches, in a row, from a CUDA graph); "
          "K1/K1b one call at each of the UNet's 11 shapes, attention over a "
          "UNet forward's or train step's 11 calls or the DiT's 12:",
          flush=True)
    for key, ts in totals.items():
        print(f"   {key}: {' '.join(f'{t:.4f}' for t in ts)}", flush=True)
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


# (BH, L, d, p) of the wide forms: the DiT at two heads (train step,
# sampling), the widest head_dim and the 64x64 DiT's length
WIDE_CASES = [(256, 256, 192, ATTN_DROPOUT), (64, 256, 192, 0.0),
              (256, 256, 256, ATTN_DROPOUT), (192, 1024, 192, ATTN_DROPOUT)]
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


def wide_bounds(bh, length, d, elem, rate):
    """ms of the least time of K2 and of K3 at one shape: bytes over the
    memory rate or operations over `rate`, whichever is larger (the
    forward: q, k, v in, o out, float32 lse out, 4 d + 5 operations a
    score; the backward: q, k, v, o, dO in and lse, dq, dk, dv out, 10 d +
    8 a score)."""
    side, scores = bh * length * d, bh * length * length
    fwd = max(1e3 * (elem * 4 * side + 4 * bh * length) / PEAK_BYTES,
              1e3 * scores * (4 * d + 5) / rate)
    bwd = max(1e3 * (elem * 8 * side + 4 * bh * length) / PEAK_BYTES,
              1e3 * scores * (10 * d + 8) / rate)
    return fwd, bwd


def library_graph_ms(fn):
    """`graph_ms` of a library call, or None where its capture fails."""
    import torch
    try:
        return graph_ms(fn)
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"   (library call not captured in a CUDA graph: {e})")
        return None


def run_wide(root, attention, randn):
    """K2 and K3 in their wide forms against their plain versions, timed
    beside the library call and the bound."""
    import torch
    import torch.nn.functional as F
    if not hasattr(attention, "WIDE_LAUNCHES"):
        print(f"{root}: no wide forms; skipped", flush=True)
        return True
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        elem = 2 if dtype == torch.bfloat16 else 4
        for bh, length, d, p in WIDE_CASES:
            q, k, v, do = (randn(bh, length, d).to(dtype) for _ in range(4))
            drop = (p, ATTN_DROPOUT_SEED) if p else (0.0, None)
            o_ref, _ = attention.flash_attention_fwd_ref(q, k, v, *drop)
            o, lse = attention.flash_attention_fwd(q, k, v, *drop)
            args = (q, k, v, o, do, lse, *drop)
            refs = attention.flash_attention_bwd_ref(*args)
            shape = f"{name} BH={bh} L={length} d={d} p={p}"
            bars = ((BAR_BF16, BAR_BF16) if dtype == torch.bfloat16
                    else (BAR_FWD, BAR))
            fwd = lambda: attention.flash_attention_fwd(  # noqa: E731
                q, k, v, *drop)[:1]
            bwd = lambda: attention.flash_attention_bwd(*args)  # noqa: E731
            ok &= check(f"K2 wide {shape}", fwd, (o_ref.float(),), bars[0])
            ok &= check(f"K3 wide {shape}", bwd,
                        tuple(r.float() for r in refs), bars[1])
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], k[None], v[None], dropout_p=p)
            qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*qkv, dropout_p=p)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out, qkv, do[None], retain_graph=True)
            bounds = wide_bounds(bh, length, d, elem, PEAK_OPS[name])
            for label, kernel, library, bound in (
                    ("K2", fwd, sdpa, bounds[0]),
                    ("K3", bwd, sdpa_bwd, bounds[1])):
                # capturing autograd's backward of the library's dropout
                # fails and leaves the context faulted: in a row only
                lib = (library_graph_ms(library) if label == "K2" or not p
                       else None)
                print(f"   {label} wide {shape}, ms a call: kernel "
                      f"{median_ms(kernel):.4f} single, "
                      f"{burst_ms(kernel):.4f} in a row, "
                      f"{graph_ms(kernel):.4f} from a CUDA graph; library "
                      f"{median_ms(library):.4f} single, "
                      f"{burst_ms(library):.4f} in a row, "
                      + ("not captured" if lib is None
                         else f"{lib:.4f} from a CUDA graph")
                      + f"; bound {bound:.4f}", flush=True)
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
            qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*qkv)
            ms = median_ms(lambda: torch.autograd.grad(out, qkv, do[None],
                                                       retain_graph=True))
            print(f"   scaled_dot_product_attention backward {ms:.4f} ms")

    if only in (None, "attn_fwd"):
        ok &= run_attn_fwd(root, attention, randn)
    if only in (None, "attn_dropout"):
        ok &= run_attn_dropout(root, attention, randn)
    if only in (None, "scan_fwd"):
        ok &= run_scan_fwd(scan, randn)
    if only in (None, "gn"):
        ok &= run_gn(root, randn)
    if only in (None, "bf16"):
        ok &= run_bf16(root, attention, randn)
    if only in (None, "wide"):
        ok &= run_wide(root, attention, randn)

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
                        choices=["attention", "attn_fwd", "attn_dropout",
                                 "scan", "scan_fwd", "gn", "bf16",
                                 "wide"])
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
