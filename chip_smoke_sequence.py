"""`chip_smoke.py`'s sequence-parallel phase (`phase_sequence_parallel`), the
port's `parallel/sequence_parallel.py` and `parallel/dim_sequence_parallel.py`
on the card, with the kernel forms they run:

* E6, K2 and K3 of Lq queries against Lk keys (`ops/flash_attention.py`,
  `csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`), against their plain
  versions in float32 and bf16, at p 0 and 0.1, fused and two-kernel, at a
  CIFAR-10 DiT shard's (BH 32 x 6, Lq 128, Lk 256, d 64), a 64x64 DiT
  shard's (Lq 512, Lk 1024) and a ragged pair; each shard's dropout mask
  read back (v = I) against its rows of the one-device mask, also at a
  tensor-parallel rank's head grid (E6 x E7); times beside the plain
  versions and `F.scaled_dot_product_attention` on the same shapes;
* E6 and E4 timed again at the CIFAR-10 configs' own batch of 128 (a seq
  rank's BH 768 and scan batch 128 at SP 2, data parallel 1), which the
  gloo legs cut to 32;
* E4, the stated scan (`ops/selective_scan.py` `selective_scan_fwd_state`,
  its state-only form and `selective_scan_bwd_state`; `csrc/
  selective_scan_fwd.cu`, `csrc/selective_scan_bwd.cu`), against the plain
  versions at the DiM's shard shapes (32, 128, 768, N 16), 64x64's (16, 512)
  and a ragged local length (8, 50): y, h_out, bound and every gradient,
  dh_in among them, also of the backward without a cotangent of y (the
  state-only forward's); times beside the plain versions;
* the sequence-parallel legs of `phase_parallel`'s gloo world of two
  processes on the card (that phase holds each against the one-process
  step and checks its launches: the full-width CIFAR-10 DiT, dropout 0.1,
  and DiM at sequence parallel 2, a DiT rank's 12 E6 forwards and 12
  backwards in the dropout form, a DiM rank's 24 stated forwards, two a
  block, and 24 stated backwards): their step seconds and peak memory a
  rank beside data parallel 2's.

Every failure raises. Alone, after `phase_build` (and `phase_parallel` for
the legs):

    python3 -c "import torch, chip_smoke as c, chip_smoke_sequence as s;
        smi = c.device_line(); c.phase_build();
        g = torch.Generator('cuda').manual_seed(0);
        s.phase_sequence_parallel(g, smi, c.phase_parallel(g, smi)['legs'])"
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import chip_smoke as c
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa
from diffusion_models_collection_tpu_torch.ops import selective_scan as scan

SP = c.SP_DEGREE
# (BH, Lq, Lk): a CIFAR-10 DiT seq rank's attention in the world's step (32
# rows, 6 heads, 128 of 256 tokens), a 64x64 DiT rank's (16 rows, 512 of
# 1024 tokens) and a ragged pair
E6_SHAPES = [(c.PARALLEL_BATCH * c.DIT_HEADS, c.DIT_LENGTH // SP,
              c.DIT_LENGTH),
             (16 * c.DIT_HEADS, 512, 1024), (12, 40, 80)]
E6_MASK_LENGTH = 64  # v = I: head_dim = Lk
# (batch, local length): the DiM's seq rank in the world's step, a 64x64
# DiM rank's, and a ragged local length (50 % 16 != 0)
E4_SHAPES = [(c.PARALLEL_BATCH, c.DIT_LENGTH // SP), (16, 512), (8, 50)]
# configs/cifar10_dit.py and cifar10_dim.py train at batch_size 128: at SP 2
# and data parallel 1 a seq rank's attention is (BH 128 x 6, Lq 128, Lk 256)
# and its scans (128, 128, 768, N 16). Timed there too, beside the world's
# cut batch of 32.
CONFIG_BATCH = 128


def check_cross(label, bh, lq, lk, d, dtype, p, fused, gen,
                grid=fa.ONE_DEVICE):
    """E6 forward and backward at one shape and form (the last shard's rows,
    row0 = Lk - Lq) against the plain versions (float32 by relative error,
    bf16 in bf16 steps); returns the worst absolute error of o, dq, dk, dv."""
    row0 = lk - lq
    q, do = (torch.randn(bh, lq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, lk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    drop = (p, c.ATTN_DROPOUT_SEED) if p else (0.0, None)
    c.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, *drop, head_grid=grid, row0=row0)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, *drop, fused=fused,
                                   head_grid=grid, row0=row0)
    torch.cuda.synchronize()
    counts = c.read_launches()
    if (counts["attn_cross"], counts["attn_bwd_cross"]) != (1, 1):
        raise AssertionError(f"{label}: launches {counts}")
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, *drop, None, grid,
                                                row0)
    refs = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop, None, grid,
                                      row0)
    lse_err = (lse - lse_ref).abs().max().item()
    if dtype == torch.bfloat16:
        errs = [c.bf16_check(label, o, o_ref, c.BF16_STEPS_FWD,
                             c.TOL_OUT)[1]]
        errs += [c.bf16_check(label, g, r, c.BF16_STEPS_BWD, c.TOL_BWD)[1]
                 for g, r in zip(grads, refs)]
        ok = lse_err <= c.TOL_LSE
    else:
        errs = [c.max_rel(o, o_ref)] + [c.max_rel(g, r)
                                        for g, r in zip(grads, refs)]
        ok = (errs[0] <= c.TOL_OUT and lse_err <= c.TOL_LSE
              and max(errs[1:]) <= c.TOL_BWD)
    abs_err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip((o, *grads), (o_ref, *refs)))
    print(f"  {label}: BH={bh} Lq={lq} Lk={lk} d={d} row0={row0} p={p} "
          f"[{'fused' if fused else 'two-kernel'}]: o {errs[0]:.3e}, lse "
          f"{lse_err:.3e}, dq/dk/dv {', '.join(f'{e:.3e}' for e in errs[1:])}")
    if not ok or any(g.shape != t.shape for g, t in zip(grads, (q, k, v))):
        raise AssertionError(f"{label}: {errs}, lse {lse_err}")
    return abs_err


def time_cross(bh, lq, lk, d, dtype, gen):
    """ms a call at p 0.1 (the DiT's training form): E6's forward and
    backward, their plain versions, and `F.scaled_dot_product_attention` on
    (1, BH, L, d) inputs with dropout 0.1 and its backward (another mask;
    never called by the port)."""
    q, do = (torch.randn(bh, lq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, lk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    drop = (c.ATTN_DROPOUT, c.ATTN_DROPOUT_SEED)
    o, lse = fa.flash_attention_fwd(q, k, v, *drop, row0=lk - lq)
    args = (q, k, v, o, do, lse, *drop)
    out = {
        "fwd": c.median_ms(lambda: fa.flash_attention_fwd(q, k, v, *drop,
                                                          row0=lk - lq)),
        "fwd_plain": c.median_ms(lambda: fa.flash_attention_fwd_ref(
            q, k, v, *drop, None, fa.ONE_DEVICE, lk - lq), reps=10),
        "fwd_library": c.median_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], dropout_p=c.ATTN_DROPOUT)),
        "bwd": c.median_ms(lambda: fa.flash_attention_bwd(*args,
                                                          row0=lk - lq)),
        "bwd_plain": c.median_ms(lambda: fa.flash_attention_bwd_ref(
            *args, None, fa.ONE_DEVICE, lk - lq), reps=10)}
    qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
    lib = F.scaled_dot_product_attention(*qkv, dropout_p=c.ATTN_DROPOUT)
    out["bwd_library"] = c.median_ms(lambda: torch.autograd.grad(
        lib, qkv, do[None], retain_graph=True))
    elem = 2 if dtype == torch.bfloat16 else 4
    rate = (c.PEAK_BF16_TC_OPS_PER_S if dtype == torch.bfloat16
            else c.PEAK_FP32_OPS_PER_S)
    out["fwd_bound"] = c.Bound(rate).add(*c.attn_work(bh, lq, d, elem=elem,
                                                      keys=lk))
    out["bwd_bound"] = c.Bound(rate).add(*c.attn_work(bh, lq, d, True, elem,
                                                      keys=lk))
    print(f"  E6 {str(dtype).split('.')[-1]} BH={bh} Lq={lq} Lk={lk} d={d} "
          f"p={c.ATTN_DROPOUT}, ms a call: forward {out['fwd']:.4f} (plain "
          f"{out['fwd_plain']:.4f}, scaled_dot_product_attention "
          f"{out['fwd_library']:.4f}, bound {out['fwd_bound'].ms:.4f} "
          f"{out['fwd_bound'].keys()['bound_by']}); backward "
          f"{out['bwd']:.4f} (plain {out['bwd_plain']:.4f}, its backward "
          f"{out['bwd_library']:.4f}, bound {out['bwd_bound'].ms:.4f} "
          f"{out['bwd_bound'].keys()['bound_by']})")
    return out


def check_cross_masks(gen):
    """Each of SP shards' dropout mask, read back from K2 (v = I, head_dim =
    Lk = 64) at row0 = s Lk / SP, is its rows of the one-device mask, in
    float32 and bf16, on one device and at a tensor-parallel rank's head
    grid (E6 x E7)."""
    lk, lq = E6_MASK_LENGTH, E6_MASK_LENGTH // SP
    bh = c.E7_BATCH * c.E7_GRID[0]
    drop = (c.ATTN_DROPOUT, c.ATTN_DROPOUT_SEED)
    for grid in (fa.ONE_DEVICE, c.E7_GRID):
        full_bh = bh if grid == fa.ONE_DEVICE else c.E7_BATCH * c.DIT_HEADS
        index = torch.arange(bh, device="cuda") if grid == fa.ONE_DEVICE \
            else torch.tensor([b * c.DIT_HEADS + grid[3] + h
                               for b in range(c.E7_BATCH)
                               for h in range(grid[0])], device="cuda")
        full = fa.philox_keep_mask(c.ATTN_DROPOUT_SEED, full_bh, lk, lk,
                                   c.ATTN_DROPOUT, device="cuda")[index]
        for dtype in (torch.float32, torch.bfloat16):
            k = torch.randn(bh, lk, lk, generator=gen, device="cuda").to(
                dtype)
            eye = torch.eye(lk, device="cuda", dtype=dtype).expand(
                bh, -1, -1).contiguous()
            for s in range(SP):
                q = torch.randn(bh, lq, lk, generator=gen, device="cuda").to(
                    dtype)
                o, _ = fa.flash_attention_fwd(q, k, eye, *drop,
                                              head_grid=grid, row0=s * lq)
                if not torch.equal(o != 0, full[:, s * lq:(s + 1) * lq]):
                    raise AssertionError(
                        f"E6 mask {dtype} grid {grid} shard {s}: not the "
                        "one-device mask's rows")
    print(f"E6: each of {SP} shards' dropout mask (Lq {lq} of Lk {lk}, BH "
          f"{bh}) read back from K2 in float32 and bf16 equals its rows of "
          f"the one-device mask, on one device and at head grid "
          f"{c.E7_GRID}")


def check_state_scan(label, batch, length, gen):
    """E4 at one shape against the plain versions: the stated forward (y,
    bound, h_out), its state-only form (bound, h_out), the stated backward
    (dx, ddt, dA, dB, dC, dh_in) under cotangents of y and h_out, and its
    form without a cotangent of y (the state-only forward's backward).
    Returns the worst absolute errors (forward, backward)."""
    x, dt, A, B, C, g = c.scan_case(batch, length, gen)
    h_in = 0.5 * torch.randn(batch, c.SCAN_D, c.SCAN_N, generator=gen,
                             device="cuda")
    g_h = torch.randn_like(h_in)
    c.reset_launches()
    y, bound, h_out = scan.selective_scan_fwd_state(x, dt, A, B, C, h_in)
    _, bound_end, h_end = scan.selective_scan_fwd_state(x, dt, A, B, C, h_in,
                                                        with_y=False)
    grads = scan.selective_scan_bwd_state(x, dt, A, B, C, g, bound, g_h)
    grads_end = scan.selective_scan_bwd_state(x, dt, A, B, C, None,
                                              bound_end, g_h)
    torch.cuda.synchronize()
    counts = c.read_launches()
    if (counts["scan_fwd_state"], counts["scan_bwd_state"]) != (2, 2):
        raise AssertionError(f"{label}: launches {counts}")
    y_ref, bound_ref, h_ref = scan.selective_scan_fwd_state_ref(
        x, dt, A, B, C, h_in)
    refs = scan.selective_scan_bwd_state_ref(x, dt, A, B, C, g, bound_ref,
                                             g_h)
    refs_end = scan.selective_scan_bwd_state_ref(x, dt, A, B, C, None,
                                                 bound_ref, g_h)
    shape = f"B={batch} L={length} D={c.SCAN_D} N={c.SCAN_N}"
    fwd = c.check_outputs(f"{label} stated forward {shape} (y, bound, h_out)",
                          (y, bound, h_out),
                          {"plain": (y_ref, bound_ref, h_ref)},
                          c.TOL_SCAN_FWD)
    fwd = max(fwd, c.check_outputs(
        f"{label} state-only forward {shape} (bound, h_out)",
        (bound_end, h_end), {"plain": (bound_ref, h_ref)}, c.TOL_SCAN_FWD))
    bwd = c.check_outputs(
        f"{label} stated backward {shape} (dx, ddt, dA, dB, dC, dh_in)",
        grads, {"plain": refs}, c.TOL_SCAN_BWD)
    bwd = max(bwd, c.check_outputs(
        f"{label} stated backward without g {shape} (dx, ddt, dA, dB, dC, "
        "dh_in)", grads_end, {"plain": refs_end}, c.TOL_SCAN_BWD))
    if grads_end[4].abs().max().item():
        raise AssertionError(f"{label}: dC of the backward without g is not 0")
    return fwd, bwd


def time_state_scan(batch, length, gen):
    """ms a call of E4's forms at one shape beside their plain versions and
    bounds: the stated forward, its state-only form, the stated backward and
    its form without g (the state-only forward's)."""
    x, dt, A, B, C, g = c.scan_case(batch, length, gen)
    h_in = 0.5 * torch.randn(batch, c.SCAN_D, c.SCAN_N, generator=gen,
                             device="cuda")
    g_h = torch.randn_like(h_in)
    args = (x, dt, A, B, C)
    _, bound, _ = scan.selective_scan_fwd_state(*args, h_in)
    times = {
        "fwd": c.median_ms(lambda: scan.selective_scan_fwd_state(
            *args, h_in)),
        "fwd_end": c.median_ms(lambda: scan.selective_scan_fwd_state(
            *args, h_in, with_y=False)),
        "fwd_plain": c.median_ms(lambda: scan.selective_scan_fwd_state_ref(
            *args, h_in), reps=5, warmup=1),
        "bwd": c.median_ms(lambda: scan.selective_scan_bwd_state(
            *args, g, bound, g_h)),
        "bwd_end": c.median_ms(lambda: scan.selective_scan_bwd_state(
            *args, None, bound, g_h)),
        "bwd_plain": c.median_ms(lambda: scan.selective_scan_bwd_state_ref(
            *args, g, bound, g_h), reps=5, warmup=1),
        "fwd_bound": c.Bound().add(*c.scan_work("fwd_states", batch,
                                                length, state=True)),
        "bwd_bound": c.Bound().add(*c.scan_work("bwd", batch, length,
                                                state=True))}
    shape = f"B={batch} L={length} D={c.SCAN_D} N={c.SCAN_N}"
    print(f"  E4 {shape}, ms a call: stated forward {times['fwd']:.4f} "
          f"(state-only {times['fwd_end']:.4f}, plain "
          f"{times['fwd_plain']:.4f}, bound {times['fwd_bound'].ms:.4f} "
          f"{times['fwd_bound'].keys()['bound_by']}); stated backward "
          f"{times['bwd']:.4f} (without g {times['bwd_end']:.4f}, plain "
          f"{times['bwd_plain']:.4f}, bound {times['bwd_bound'].ms:.4f} "
          f"{times['bwd_bound'].keys()['bound_by']})")
    return times


def report_legs(legs, smi):
    """The SP legs of `phase_parallel` beside its DP 2 legs: the first and
    the steady step's seconds (the mean of the steady steps), the peak memory
    a rank and what the step added to the memory allocated at its start."""
    for name in ("DiT", "DiM"):
        sp, dp = legs[(name, f"SP {SP}")], legs[(name, "DP 2")]
        mib = {k: {key: leg[key] / 2**20 for key in ("peak", "base")}
               for k, leg in (("sp", sp), ("dp", dp))}
        grown = ((sp["peak"] - sp["base"]) / (dp["peak"] - dp["base"]))
        print(f"sequence parallel {name} at global batch {c.PARALLEL_BATCH} "
              f"(gloo, 2 ranks on one card): SP {SP} step {sp['seconds']:.3f}"
              f" s (steady {sp['steady']:.4f}), peak a rank "
              f"{mib['sp']['peak']:.1f} MiB ({mib['sp']['base']:.1f} at the "
              f"step's start), error {sp['err']:.3e}; DP 2 step "
              f"{dp['seconds']:.3f} s (steady {dp['steady']:.4f}), peak "
              f"{mib['dp']['peak']:.1f} MiB ({mib['dp']['base']:.1f}); steady"
              f" {sp['steady'] / dp['steady']:.3f}x, peak "
              f"{sp['peak'] / dp['peak']:.3f}x, the step's own {grown:.3f}x; "
              f"launches a rank at SP {SP} {sp['launches']} on {smi}")


def phase_sequence_parallel(gen, smi, legs):
    """E6 and E4 against their plain versions, then `phase_parallel`'s SP
    legs `legs` (see the module docstring). Returns the figures the
    `kernels` line reads."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"e6": 0.0, "e6_bf16": 0.0, "e4_fwd": 0.0, "e4_bwd": 0.0}
    for bh, lq, lk in E6_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            key = "e6" if dtype == torch.float32 else "e6_bf16"
            for p in (0.0, c.ATTN_DROPOUT):
                for fused in (True, False):
                    label = f"E6 {str(dtype).split('.')[-1]}"
                    worst[key] = max(worst[key], check_cross(
                        label, bh, lq, lk, c.DIT_HEAD_DIM, dtype, p, fused,
                        gen))
    # E6 x E7: a tensor-parallel rank's heads of the CIFAR-10 shard
    bh, lq, lk = E6_SHAPES[0]
    worst["e6"] = max(worst["e6"], check_cross(
        "E6 x E7 float32", c.PARALLEL_BATCH * c.E7_GRID[0], lq, lk,
        c.DIT_HEAD_DIM, torch.float32, c.ATTN_DROPOUT, True, gen,
        c.E7_GRID))
    check_cross_masks(gen)
    config_bh = CONFIG_BATCH * c.DIT_HEADS
    times, config = ({dtype: time_cross(rows, lq, lk, c.DIT_HEAD_DIM, dtype,
                                        gen)
                      for dtype in (torch.float32, torch.bfloat16)}
                     for rows in (bh, config_bh))
    for batch, length in E4_SHAPES:
        fwd, bwd = check_state_scan("E4", batch, length, gen)
        worst["e4_fwd"] = max(worst["e4_fwd"], fwd)
        worst["e4_bwd"] = max(worst["e4_bwd"], bwd)
    e4_times, e4_config = (time_state_scan(batch, E4_SHAPES[0][1], gen)
                           for batch in (E4_SHAPES[0][0], CONFIG_BATCH))
    report_legs(legs, smi)
    return {"worst": worst, "times": times, "config": config,
            "e4_times": e4_times, "e4_config": e4_config, "legs": legs}


def kernel_rows(figures):
    """The `kernels` line's rows of E6 and E4, each timed at its shape on the
    main path (a CIFAR-10 DiT or DiM seq rank's in the world's step), ms a
    call, with the launches of the world's sequence-parallel step; beside
    them the `config_*` figures at the configs' batch of 128, E6's bf16
    form, and E4's state-only forms (`state_only_ms`: the forward without y,
    the backward without g)."""
    csrc = "diffusion_models_collection_tpu_torch/csrc/"
    attn = "diffusion_models_collection_tpu/ops/flash_attention.py:"
    pallas = "diffusion_models_collection_tpu/ops/selective_scan_pallas.py:"
    dit = figures["legs"][("DiT", f"SP {SP}")]["launches"]
    dim = figures["legs"][("DiM", f"SP {SP}")]["launches"]
    t32, t16 = (figures["times"][d] for d in (torch.float32, torch.bfloat16))
    c32, c16 = (figures["config"][d] for d in (torch.float32, torch.bfloat16))
    e4, e4c = figures["e4_times"], figures["e4_config"]
    rows = []
    for name, key, source, line, count in (
            ("flash_attn_fwd_cross", "fwd", "flash_attn.cu", "65",
             "attn_cross"),
            ("flash_attn_bwd_cross", "bwd", "flash_attn_bwd.cu", "126",
             "attn_bwd_cross")):
        rows.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": attn + line, "launches": dit[count],
            "launches_by_path": {"dit_sp2_train": dit[count]},
            "max_abs_err": figures["worst"]["e6"], "ms": t32[key],
            "plain_ms": t32[f"{key}_plain"],
            **t32[f"{key}_bound"].keys(),
            "library_ms": t32[f"{key}_library"],
            "bf16_max_abs_err": figures["worst"]["e6_bf16"],
            "bf16_ms": t16[key], "bf16_plain_ms": t16[f"{key}_plain"],
            "bf16_bound_ms": t16[f"{key}_bound"].ms,
            "bf16_library_ms": t16[f"{key}_library"],
            **config_keys(c32, key, CONFIG_BATCH * c.DIT_HEADS),
            **config_keys(c16, key, CONFIG_BATCH * c.DIT_HEADS, "bf16_")})
    for name, key, source, line, count, err in (
            ("selective_scan_fwd_state", "fwd", "selective_scan_fwd.cu",
             "93", "scan_fwd_state", "e4_fwd"),
            ("selective_scan_bwd_state", "bwd", "selective_scan_bwd.cu",
             "511", "scan_bwd_state", "e4_bwd")):
        row = {"name": name, "route": "cuda", "source": csrc + source,
               "replaces": pallas + line, "launches": dim[count],
               "launches_by_path": {"dim_sp2_train": dim[count]},
               "max_abs_err": figures["worst"][err], "ms": e4[key],
               "plain_ms": e4[f"{key}_plain"],
               **e4[f"{key}_bound"].keys(), "library_ms": None,
               **config_keys(e4c, key, CONFIG_BATCH),
               "state_only_ms": e4[f"{key}_end"],
               "config_state_only_ms": e4c[f"{key}_end"]}
        rows.append(row)
    return rows


def config_keys(times, key, rows, prefix=""):
    """A row's figures at the CIFAR-10 configs' batch (`CONFIG_BATCH`):
    `rows` its BH or scan batch."""
    out = {f"{prefix}config_rows": rows, f"{prefix}config_ms": times[key],
           f"{prefix}config_plain_ms": times[f"{key}_plain"],
           f"{prefix}config_bound_ms": times[f"{key}_bound"].ms}
    if f"{key}_library" in times:
        out[f"{prefix}config_library_ms"] = times[f"{key}_library"]
    return out
