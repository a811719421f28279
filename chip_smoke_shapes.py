"""`chip_smoke.py`'s shapes phase (`phase_shapes`): the head widths and state
sizes past the kernels' one-tile forms, which the JAX package runs, on the
card:

* K2 and K3's wide forms (`ops/flash_attention.py` past `WIDE_HEAD_DIM`;
  `csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`, built as
  `flash_attn_wide*.cu`, `flash_attn_bwd_wide*.cu`: one block a tile owns
  every column up to 256, the chunked forms past it) against their plain
  versions: head_dim 136, 192, 256 and 384 at BH 192, L 256 and a ragged
  200; float32 and bf16, p 0 and 0.1, the fused and the two-kernel
  backward; with a key bias and Lq 128 against Lk 256 at 192 and 384; 192
  also at L 1024; the dropout mask read back through v = I at 192, 256 and
  384, bit for bit against `philox_keep_mask`;
* the scan kernels past 32 states (`ops/selective_scan.py`, the chunks of
  `csrc/selective_scan_common.cuh`) against their plain versions at N 33,
  64 and 128, D 768, (batch, L) (32, 256), (8, 100) and (8, 1024): K5, K6
  with its bound, K8, K7, K9 and K10, and E4 from a state to its end state
  with dh_in;
* the int8 product at widths `torch._int_mm` does not take (K 75, N 21),
  padded by `ops/quant.py`, bit for bit against the int32 product on the
  host;
* the full-width paths: `configs/cifar10_dim.py` at `state_size` 64 and
  `configs/cifar10_dit.py` at `num_heads` 2 (head_dim 192), in float32 and
  bf16, each through `sample.main` (DDIM-50 CFG 3, 16 images), its loss and
  every gradient at batch 128 against the same step inside
  `plain_kernels()` (the DiT in train mode, dropout 0.1, the same draws),
  and `train.main` (one step of batch 128 on the fixtures, then the timed
  steps, `TRAIN_TIMED` after `TRAIN_WARMUP`), with exact launches: a DiM
  forward 12 K5 (N 64), a step 12 K6 + 12 K8; a DiT forward 12 K2 in the
  wide form, a step 12 + 12 in the wide dropout form;
* ms a call of each new form on those paths beside its plain version, its
  bound (`scan_work(..., n_state=64)`, `attn_work(..., d=192)`) and, for
  K2 and K3, `F.scaled_dot_product_attention` on (1, BH, L, d) inputs; K2
  and K3 also at head_dim 256 (BH 256, L 256, p 0.1), the widest the
  one-block wide forms take.

Every failure raises. Alone, after `phase_build`:

    python3 -c "import torch, chip_smoke as c, chip_smoke_shapes as s;
        smi = c.device_line(); c.phase_build();
        s.phase_shapes(torch.Generator('cuda').manual_seed(0), smi)"
"""

from __future__ import annotations

import tempfile

import torch
import torch.nn.functional as F

import chip_smoke as c
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa
from diffusion_models_collection_tpu_torch.ops import quant
from diffusion_models_collection_tpu_torch.ops import selective_scan as scan
from diffusion_models_collection_tpu_torch.utils.helpers import load_config

WIDE_HEAD_DIMS = (136, 192, 256, 384)
ATTN_BH = 192
ATTN_LENGTHS = (256, 200)
VARIANT_HEAD_DIMS = (192, 384)  # the key bias and Lq != Lk
LONG_LENGTH = 1024  # d 192 at the 64x64 DiT's L
WIDEST_HEAD_DIM = fa.WIDEST_ONE_BLOCK  # the widest one-block form, timed too
WIDE_STATES = (33, 64, 128)
SCAN_CASES = [(32, 256), (8, 100), (8, 1024)]  # (batch, L) at D 768
INT8_SHAPE = (40, 75, 21)  # (M, K, N)
# the paths: the DiM at 64 states, the DiT at two heads of 192
DIM_STATES, DIT_HEADS = 64, 2
DIT_HEAD_DIM = 384 // DIT_HEADS
SAMPLES = 16  # DDIM-50 CFG 3 images a `sample.main` run
DIM_FORWARD = c.DIM_FORWARD
DIM_STEP = c.DIM_STEP
DIT_FORWARD = dict(c.DIT_FORWARD, attn_wide=c.ATTN_PER_DIT_FORWARD)
DIT_STEP = dict(c.DIT_STEP, attn_wide=c.ATTN_PER_DIT_FORWARD,
                attn_bwd_wide=c.ATTN_PER_DIT_FORWARD)


def bf16_counts(counts):
    """A DiT path's launches in bf16: every attention in the bf16 form too
    (the DiM's scans stay float32)."""
    out = dict(counts)
    for key in ("attn", "attn_bwd"):
        if key in counts:
            out[key + "_bf16"] = counts[key]
    return out


def name_of(dtype):
    return str(dtype).split(".")[-1]


def check_attention(label, bh, lq, lk, d, dtype, p, fused, gen, bias=False):
    """K2 and K3 in their wide form at one shape against the plain versions
    (float32 by relative error, bf16 in bf16 steps): exactly one wide launch
    each way. Returns the worst absolute error of o, dq, dk, dv."""
    q, do = (torch.randn(bh, lq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, lk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kb = (torch.randn(bh // 6, lk, generator=gen, device="cuda")
          if bias else None)
    drop = (p, c.ATTN_DROPOUT_SEED) if p else (0.0, None)
    row0 = lk - lq
    c.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, *drop, bias=kb, row0=row0)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, *drop, fused=fused,
                                   bias=kb, row0=row0)
    torch.cuda.synchronize()
    counts = c.read_launches()
    if (counts["attn_wide"], counts["attn_bwd_wide"]) != (1, 1):
        raise AssertionError(f"{label}: launches {counts}")
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, *drop, kb,
                                                fa.ONE_DEVICE, row0)
    refs = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, *drop, kb,
                                      fa.ONE_DEVICE, row0)
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
    print(f"  {label}: BH={bh} Lq={lq} Lk={lk} d={d} p={p}"
          f"{' bias' if bias else ''} [{'fused' if fused else 'two-kernel'}]"
          f": o {errs[0]:.3e}, lse {lse_err:.3e}, dq/dk/dv "
          f"{', '.join(f'{e:.3e}' for e in errs[1:])}")
    if not ok or any(g.shape != t.shape for g, t in zip(grads, (q, k, v))):
        raise AssertionError(f"{label}: {errs}, lse {lse_err}")
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip((o, *grads), (o_ref, *refs)))


def attention_checks(gen):
    """Every wide form against its plain version; the worst absolute error
    by dtype."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for d in WIDE_HEAD_DIMS:
        for seq in ATTN_LENGTHS:
            for dtype in worst:
                for p in (0.0, c.ATTN_DROPOUT):
                    for fused in (True, False):
                        worst[dtype] = max(worst[dtype], check_attention(
                            f"K2/K3 wide {name_of(dtype)}", ATTN_BH, seq, seq,
                            d, dtype, p, fused, gen))
    for d in VARIANT_HEAD_DIMS:
        for dtype in worst:
            for lq, bias in ((256, True), (128, False)):
                worst[dtype] = max(worst[dtype], check_attention(
                    f"K2/K3 wide {name_of(dtype)}", ATTN_BH, lq, 256, d, dtype,
                    c.ATTN_DROPOUT, True, gen, bias=bias))
    for dtype in worst:
        for fused in (True, False):
            worst[dtype] = max(worst[dtype], check_attention(
                f"K2/K3 wide {name_of(dtype)}", ATTN_BH, LONG_LENGTH,
                LONG_LENGTH, DIT_HEAD_DIM, dtype, c.ATTN_DROPOUT, fused, gen))
    return worst


def check_wide_masks(gen):
    """At L = d, v = I: o = P o Z exactly, so the zeros of the wide forward's
    o must be the dropped keys of `philox_keep_mask`, bit for bit, at the
    one-block forms' two widths (192, 256) and the chunked form's (384) in
    float32 and bf16."""
    for d in (DIT_HEAD_DIM, fa.WIDEST_ONE_BLOCK, WIDE_HEAD_DIMS[-1]):
        keep = fa.philox_keep_mask(c.ATTN_DROPOUT_SEED, ATTN_BH, d, d,
                                   c.ATTN_DROPOUT, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k = (torch.randn(ATTN_BH, d, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            v = torch.eye(d, device="cuda", dtype=dtype).expand(
                ATTN_BH, -1, -1).contiguous()
            c.reset_launches()
            o, _ = fa.flash_attention_fwd(q, k, v, c.ATTN_DROPOUT,
                                          c.ATTN_DROPOUT_SEED)
            torch.cuda.synchronize()
            differ = (o.ne(0) != keep).sum().item()
            print(f"  K2 wide {name_of(dtype)} dropout mask read back through "
                  f"v = I, BH={ATTN_BH} L=d={d} ({keep.numel()} keys): "
                  f"{differ} keys differ from philox_keep_mask")
            if differ or c.read_launches()["attn_wide"] != 1:
                raise AssertionError(f"wide mask read-back d {d} {dtype}: "
                                     f"{differ} keys differ, launches "
                                     f"{c.read_launches()}")


def check_scan_case(batch, length, n_state, gen):
    """Every scan entry at one shape past 32 states against the plain
    versions, one launch each: K5, K6 (y, bound), K9 (y, bound), K8, K7,
    K10, and E4's stated forward (y, bound, h_out), its state-only form and
    its backward (dh_in among the gradients). Returns the worst absolute
    errors (forward, backward)."""
    x, dt, A, B, C, g = c.scan_case(batch, length, gen, n_state=n_state)
    args = (x, dt, A, B, C)
    h_in = 0.5 * torch.randn(batch, c.SCAN_D, n_state, generator=gen,
                             device="cuda")
    g_h = torch.randn_like(h_in)
    c.reset_launches()
    y5, _ = scan.selective_scan_fwd(*args, False)
    y6, bound6 = scan.selective_scan_fwd(*args, True)
    y9, bound9 = scan.selective_scan_fwd_split(*args)
    k8 = scan.selective_scan_bwd(*args, g, bound6)
    k7 = scan.selective_scan_bwd_nostate(*args, g)
    k10 = scan.selective_scan_bwd_split(*args, g, bound6)
    y4, bound4, h_out = scan.selective_scan_fwd_state(*args, h_in)
    _, bound_end, h_end = scan.selective_scan_fwd_state(*args, h_in,
                                                        with_y=False)
    e4 = scan.selective_scan_bwd_state(*args, g, bound4, g_h)
    torch.cuda.synchronize()
    counts = c.read_launches()
    want = c.expect(scan_fwd=2, scan_fwd_states=1, scan_fwd_split=1,
                    scan_bwd=1, scan_bwd_nostate=1, scan_bwd_split=1,
                    scan_fwd_state=2, scan_bwd_state=1)
    if counts != want:
        raise AssertionError(f"scan N {n_state}: launches {counts}")
    y_ref, bound_ref = scan.selective_scan_fwd_ref(*args, True)
    bwd_ref = scan.selective_scan_bwd_ref(*args, g, bound_ref)
    y4_ref, bound4_ref, h_ref = scan.selective_scan_fwd_state_ref(*args, h_in)
    e4_ref = scan.selective_scan_bwd_state_ref(*args, g, bound4_ref, g_h)
    shape = f"B={batch} L={length} D={c.SCAN_D} N={n_state}"
    fwd = max(
        c.check_outputs(f"K5 {shape} (y)", (y5,), {"plain": (y_ref,)},
                        c.TOL_SCAN_FWD),
        c.check_outputs(f"K6 {shape} (y, bound)", (y6, bound6),
                        {"plain": (y_ref, bound_ref)}, c.TOL_SCAN_FWD),
        c.check_outputs(f"K9 {shape} (y, bound)", (y9, bound9),
                        {"plain": (y_ref, bound_ref)}, c.TOL_SCAN_FWD),
        c.check_outputs(f"E4 {shape} (y, bound, h_out)", (y4, bound4, h_out),
                        {"plain": (y4_ref, bound4_ref, h_ref)},
                        c.TOL_SCAN_FWD),
        c.check_outputs(f"E4 state-only {shape} (bound, h_out)",
                        (bound_end, h_end), {"plain": (bound4_ref, h_ref)},
                        c.TOL_SCAN_FWD))
    bwd = max(
        *(c.check_outputs(f"{name} {shape} (dx, ddt, dA, dB, dC)", grads,
                          {"plain": bwd_ref}, c.TOL_SCAN_BWD)
          for name, grads in (("K8", k8), ("K7", k7), ("K10", k10))),
        c.check_outputs(f"E4 backward {shape} (dx, ddt, dA, dB, dC, dh_in)",
                        e4, {"plain": e4_ref}, c.TOL_SCAN_BWD))
    return fwd, bwd


def check_int8():
    """The int8 product at K, N that `torch._int_mm` refuses, padded by the
    wrapper, bit for bit against the int32 product on the host; one counted
    product."""
    m, k, n = INT8_SHAPE
    gen = torch.Generator().manual_seed(INT8_SHAPE[1])
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=gen)
    c.reset_launches()
    got = quant.int8_accumulate(x.cuda(), w.cuda()).cpu()
    want = (x.long() @ w.long().t()).int()
    if not (torch.equal(got, want) and c.read_launches()["int8"] == 1):
        raise AssertionError(f"int8 product at (M, K, N) {INT8_SHAPE}: "
                             f"equal {torch.equal(got, want)}, products "
                             f"{c.read_launches()['int8']}")
    print(f"int8 product at (M, K, N) {INT8_SHAPE}, padded to K "
          f"{quant.padded_width(k)} and N {quant.padded_width(n)}: equal bit "
          "for bit to the int32 product on the host")


def time_attention(bh, seq, d, dtype, p, gen):
    """ms a call of the wide K2 (at p) and K3 beside their plain versions,
    `F.scaled_dot_product_attention` and its backward on (1, BH, L, d)
    inputs (another mask at p > 0; never called by the port) and their
    bounds."""
    q, k, v, do = (torch.randn(bh, seq, d, generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    drop = (p, c.ATTN_DROPOUT_SEED) if p else (0.0, None)
    o, lse = fa.flash_attention_fwd(q, k, v, *drop)
    args = (q, k, v, o, do, lse, *drop)
    out = {
        "fwd": c.median_ms(lambda: fa.flash_attention_fwd(q, k, v, *drop)),
        "fwd_plain": c.median_ms(lambda: fa.flash_attention_fwd_ref(
            q, k, v, *drop), reps=5, warmup=1),
        "fwd_library": c.median_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], dropout_p=p)),
        "bwd": c.median_ms(lambda: fa.flash_attention_bwd(*args)),
        "bwd_plain": c.median_ms(lambda: fa.flash_attention_bwd_ref(*args),
                                 reps=5, warmup=1)}
    qkv = [t.detach()[None].requires_grad_() for t in (q, k, v)]
    lib = F.scaled_dot_product_attention(*qkv, dropout_p=p)
    out["bwd_library"] = c.median_ms(lambda: torch.autograd.grad(
        lib, qkv, do[None], retain_graph=True))
    elem = 2 if dtype == torch.bfloat16 else 4
    rate = (c.PEAK_BF16_TC_OPS_PER_S if dtype == torch.bfloat16
            else c.PEAK_FP32_OPS_PER_S)
    out["fwd_bound"] = c.Bound(rate).add(*c.attn_work(bh, seq, d, elem=elem))
    out["bwd_bound"] = c.Bound(rate).add(*c.attn_work(bh, seq, d, True,
                                                      elem))
    print(f"  K2/K3 wide {name_of(dtype)} BH={bh} L={seq} d={d} p={p}, ms a "
          f"call: forward {out['fwd']:.4f} (plain {out['fwd_plain']:.4f}, "
          f"scaled_dot_product_attention {out['fwd_library']:.4f}, bound "
          f"{out['fwd_bound'].ms:.4f} {out['fwd_bound'].keys()['bound_by']})"
          f"; backward {out['bwd']:.4f} (plain {out['bwd_plain']:.4f}, its "
          f"backward {out['bwd_library']:.4f}, bound "
          f"{out['bwd_bound'].ms:.4f} {out['bwd_bound'].keys()['bound_by']})")
    return out


def time_scan(batch, length, n_state, gen):
    """ms a call of K5 (states off) and K8 at one shape beside their plain
    versions and bounds."""
    x, dt, A, B, C, g = c.scan_case(batch, length, gen, n_state=n_state)
    args = (x, dt, A, B, C)
    _, bound = scan.selective_scan_fwd(*args, True)
    out = {
        "fwd": c.median_ms(lambda: scan.selective_scan_fwd(*args, False)),
        "fwd_plain": c.median_ms(lambda: scan.selective_scan_fwd_ref(
            *args, False), reps=3, warmup=1),
        "bwd": c.median_ms(lambda: scan.selective_scan_bwd(*args, g, bound)),
        "bwd_plain": c.median_ms(lambda: scan.selective_scan_bwd_ref(
            *args, g, bound), reps=3, warmup=1),
        "fwd_bound": c.Bound().add(*c.scan_work("fwd", batch, length,
                                                n_state=n_state)),
        "bwd_bound": c.Bound().add(*c.scan_work("bwd", batch, length,
                                                n_state=n_state))}
    print(f"  scan N={n_state} B={batch} L={length} D={c.SCAN_D}, ms a call:"
          f" K5 {out['fwd']:.4f} (plain {out['fwd_plain']:.4f}, bound "
          f"{out['fwd_bound'].ms:.4f} {out['fwd_bound'].keys()['bound_by']})"
          f"; K8 {out['bwd']:.4f} (plain {out['bwd_plain']:.4f}, bound "
          f"{out['bwd_bound'].ms:.4f} {out['bwd_bound'].keys()['bound_by']})")
    return out


def run_path(label, config, precision, per_forward, per_step, gen, smi,
             train_seed=None):
    """One full-width path: `sample.main` DDIM-50 CFG 3 on `SAMPLES` images
    from a checkpoint of random weights, the loss and gradients at batch
    128 against `plain_kernels()` (train mode with `train_seed`), then one
    step of `train.main` and the timed steps. Exact launches."""
    bf16 = precision == "bf16"
    config16 = dict(config, mixed_precision="bf16") if bf16 else config
    name = f"{label} {precision}"
    model = c.random_model(config16, gen)
    with tempfile.TemporaryDirectory() as tmp:
        sample_launches, seconds = c.phase_sample_main(
            name, config, model, per_forward, tmp, samples=SAMPLES,
            flags=("--mixed_precision", "bf16") if bf16 else ())
    if train_seed is not None:
        model.train()
    tol = ((c.TOL_BF16_LOSS, c.TOL_BF16_GRAD) if bf16
           else (c.TOL_LOSS, c.TOL_GRAD))
    c.phase_train_grads(name, model, config16, per_step, gen,
                        batch_size=c.TRAIN_BATCH, seed=train_seed, tol=tol)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        trainer, train_launches = c.run_train_main(name, config16, per_step,
                                                   tmp, 1, 1)
        rates, peak = c.time_train_rates(trainer)
    print(f"{name}: {SAMPLES / seconds:.2f} samples/s DDIM-{c.STEPS} CFG "
          f"{c.CFG_SCALE} ({SAMPLES} images); {rates[0]:.2f} train images/s "
          f"at batch {config['batch_size']} (median of {c.TRAIN_TIMED} steps "
          f"after {c.TRAIN_WARMUP}), peak device memory {peak / 2**20:.1f} "
          f"MiB; on {smi}")
    return {"sample_launches": sample_launches, "seconds": seconds,
            "train_launches": train_launches, "rates": rates, "peak": peak}


def phase_shapes(gen, smi):
    """The kernel checks, the int8 product and the four paths (see the
    module docstring). Returns the figures the `kernels` line reads."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"attn": attention_checks(gen), "scan_fwd": 0.0, "scan_bwd": 0.0}
    check_wide_masks(gen)
    for n_state in WIDE_STATES:
        for batch, length in SCAN_CASES:
            fwd, bwd = check_scan_case(batch, length, n_state, gen)
            worst["scan_fwd"] = max(worst["scan_fwd"], fwd)
            worst["scan_bwd"] = max(worst["scan_bwd"], bwd)
    check_int8()
    # the shapes the paths give the kernels: the DiT samples at BH 2 x 16
    # images x 2 heads and trains at 128 x 2 with dropout; the DiM samples
    # at batch 32 and trains at 128
    sample_bh, train_bh = 2 * SAMPLES * DIT_HEADS, c.TRAIN_BATCH * DIT_HEADS
    times = {dtype: {"sample": time_attention(sample_bh, c.DIT_LENGTH,
                                              DIT_HEAD_DIM, dtype, 0.0, gen),
                     "train": time_attention(train_bh, c.DIT_LENGTH,
                                             DIT_HEAD_DIM, dtype,
                                             c.ATTN_DROPOUT, gen),
                     "widest": time_attention(train_bh, c.DIT_LENGTH,
                                              WIDEST_HEAD_DIM, dtype,
                                              c.ATTN_DROPOUT, gen)}
             for dtype in (torch.float32, torch.bfloat16)}
    scan_times = {"sample": time_scan(2 * SAMPLES, c.DIT_LENGTH, DIM_STATES,
                                      gen),
                  "train": time_scan(c.TRAIN_BATCH, c.DIT_LENGTH, DIM_STATES,
                                     gen)}
    dim_config = load_config(c.DIM_CONFIG)
    dim_config["model_params"] = dict(dim_config["model_params"],
                                      state_size=DIM_STATES)
    dit_config = load_config(c.DIT_CONFIG)
    dit_config["model_params"] = dict(dit_config["model_params"],
                                      num_heads=DIT_HEADS)
    paths = {}
    for precision in ("fp32", "bf16"):
        paths[("DiM", precision)] = run_path(
            f"DiM state_size {DIM_STATES}", dim_config, precision,
            DIM_FORWARD, DIM_STEP, gen, smi)
        forward, step = ((bf16_counts(DIT_FORWARD), bf16_counts(DIT_STEP))
                         if precision == "bf16" else (DIT_FORWARD, DIT_STEP))
        paths[("DiT", precision)] = run_path(
            f"DiT num_heads {DIT_HEADS}", dit_config, precision, forward,
            step, gen, smi, train_seed=c.TRAIN_SEED)
    return {"worst": worst, "times": times, "scan_times": scan_times,
            "paths": paths}


def kernel_rows(figures):
    """The `kernels` line's rows of the new forms on this phase's paths, ms a
    call at the shape each path gives them: K2 wide at the DiT's sampling
    (BH 64, L 256, d 192) and K3 wide at its train step (BH 256, p 0.1), in
    float32 and bf16; K5 at 64 states at the DiM's sampling batch (32) and
    K8 at its train step (128). `launches` is the path's count (sampling
    for the forwards, `train.main` for the backwards), `forms_max_abs_err`
    the worst of the form checks."""
    csrc = "diffusion_models_collection_tpu_torch/csrc/"
    attn = "diffusion_models_collection_tpu/ops/flash_attention.py:"
    pallas = "diffusion_models_collection_tpu/ops/selective_scan_pallas.py:"
    rows = []
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        precision = "bf16" if suffix else "fp32"
        path = figures["paths"][("DiT", precision)]
        for key, name, source, line, count, when in (
                ("fwd", "flash_attn_fwd_wide", "flash_attn.cu", "65",
                 "attn_wide", "sample"),
                ("bwd", "flash_attn_bwd_wide", "flash_attn_bwd.cu", "126",
                 "attn_bwd_wide", "train")):
            t = figures["times"][dtype][when]
            widest = figures["times"][dtype]["widest"]
            launches = path[f"{when}_launches"][count]
            rows.append({
                "name": name + suffix, "route": "cuda",
                "source": csrc + source, "replaces": attn + line,
                "launches": launches,
                "launches_by_path": {f"dit_heads2_{when}_{precision}":
                                     launches},
                "max_abs_err": figures["worst"]["attn"][dtype],
                "ms": t[key], "plain_ms": t[f"{key}_plain"],
                **t[f"{key}_bound"].keys(),
                "library_ms": t[f"{key}_library"],
                "head_dim": DIT_HEAD_DIM,
                f"ms_d{WIDEST_HEAD_DIM}": widest[key],
                f"library_ms_d{WIDEST_HEAD_DIM}": widest[f"{key}_library"],
                f"bound_ms_d{WIDEST_HEAD_DIM}": widest[f"{key}_bound"].ms})
    for key, name, source, line, count, when, err in (
            ("fwd", "selective_scan_fwd_n64", "selective_scan_fwd.cu", "93",
             "scan_fwd", "sample", "scan_fwd"),
            ("bwd", "selective_scan_bwd_n64", "selective_scan_bwd.cu", "511",
             "scan_bwd", "train", "scan_bwd")):
        t = figures["scan_times"][when]
        by_path = {f"dim_state64_{when}_{p}":
                   figures["paths"][("DiM", p)][f"{when}_launches"][count]
                   for p in ("fp32", "bf16")}
        rows.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": pallas + line,
            "launches": by_path[f"dim_state64_{when}_fp32"],
            "launches_by_path": by_path,
            "max_abs_err": figures["worst"][err], "ms": t[key],
            "plain_ms": t[f"{key}_plain"], **t[f"{key}_bound"].keys(),
            "library_ms": None, "n_state": DIM_STATES})
    return rows
