"""The kernels as `torch.library` operators (`ops/_library.py`), on the CPU.

Every launcher of `ops/fused_norm.py`, `ops/flash_attention.py` and
`ops/selective_scan.py` is one `dmc::` operator with a CPU, a CUDA and a
fake implementation. `torch.library.opcheck` runs each on CPU tensors (its
schema, its fake implementation against the CPU one, its registration, and
a trace through AOT autograd with dynamic shapes) at a tiny shape and at a
length that is no multiple of the kernels' tiles (attention L 33, the scans
L 40, GroupNorm+SiLU H x W 15); the CUDA implementations are checked the
same way by `chip_smoke.py`'s `phase_export` on the card. Then the models
reach the kernels only through the operators: a traced UNet, DiT and DiM
forward holds one opaque node per kernel call and no plain version's
arithmetic."""

import pytest
import torch

from diffusion_models_collection_tpu_torch.models import DiM, DiT, UNet
from diffusion_models_collection_tpu_torch.ops import (
    _library,
    flash_attention,
    fused_norm,
    selective_scan,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIM_PARAMS,
    DIT_PARAMS,
    MODEL_PARAMS,
    one_torch_thread,
)

OPS = ("gn_silu_fwd", "gn_silu_bwd", "flash_attn_fwd", "flash_attn_bwd",
       "selective_scan_fwd", "selective_scan_fwd_states", "selective_scan_bwd",
       "selective_scan_bwd_nostate", "selective_scan_fwd_split",
       "selective_scan_bwd_split")


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


def gn_args(name, hw, dtype):
    gen = torch.Generator().manual_seed(1)
    h, w = hw
    x = randn(gen, 2, h, w, 24, dtype=dtype)
    scale, bias = randn(gen, 24), randn(gen, 24)
    if name == "gn_silu_fwd":
        return (x, scale, bias, 3)
    _, stats = fused_norm.group_norm_silu_fwd_stats(x, scale, bias, 3)
    return (x, scale, bias, randn(gen, 2, h, w, 24, dtype=dtype), stats, 3)


def attn_args(name, length, dtype, form):
    gen = torch.Generator().manual_seed(2)
    q, k, v = (randn(gen, 8, length, 16, dtype=dtype) for _ in range(3))
    dropout_p, seed = (0.1, 2**63 + 5) if form == "dropout" else (0.0, None)
    bias = randn(gen, 2, length) if form == "bias" else None
    signed = flash_attention._signed_seed(seed)
    if name == "flash_attn_fwd":
        return (q, k, v, dropout_p, signed, bias)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, dropout_p, seed,
                                                 bias)
    return (q, k, v, o, randn(gen, 8, length, 16, dtype=dtype), lse,
            dropout_p, signed, form == "fused" or None, bias)


def scan_args(name, length):
    gen = torch.Generator().manual_seed(3)
    x = randn(gen, 2, length, 8)
    dt = torch.rand(2, length, 8, generator=gen) * 0.1
    A = -torch.rand(8, 4, generator=gen)
    B, C = randn(gen, 2, length, 4), randn(gen, 2, length, 4)
    if name in ("selective_scan_fwd", "selective_scan_fwd_states",
                "selective_scan_fwd_split"):
        return (x, dt, A, B, C)
    g = randn(gen, 2, length, 8)
    if name == "selective_scan_bwd_nostate":
        return (x, dt, A, B, C, g)
    _, bound = selective_scan.selective_scan_fwd(x, dt, A, B, C, True)
    return (x, dt, A, B, C, g, bound)


CASES = (
    [(name, hw, dtype) for name in ("gn_silu_fwd", "gn_silu_bwd")
     for hw in ((4, 4), (3, 5)) for dtype in (torch.float32, torch.bfloat16)]
    + [(name, (length, form), dtype)
       for name in ("flash_attn_fwd", "flash_attn_bwd")
       for length, form in ((16, "plain"), (33, "plain"), (33, "dropout"),
                            (33, "bias"), (33, "fused"))
       for dtype in (torch.float32, torch.bfloat16)
       if not (name == "flash_attn_fwd" and form == "fused")]
    + [(name, length, torch.float32)
       for name in OPS if name.startswith("selective_scan")
       for length in (32, 40)])


def case_id(case):
    name, shape, dtype = case
    return f"{name}-{shape}-{str(dtype).split('.')[-1]}".replace(" ", "")


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_opcheck_on_cpu(case):
    name, shape, dtype = case
    if name.startswith("gn_"):
        args = gn_args(name, shape, dtype)
    elif name.startswith("flash_"):
        args = attn_args(name, shape[0], dtype, shape[1])
    else:
        args = scan_args(name, shape)
    torch.library.opcheck(_library.OPS[name], args)


def test_every_kernel_is_an_operator_with_three_implementations():
    assert set(_library.OPS) == set(OPS)
    for name in OPS:
        qualname = f"dmc::{name}"
        for key in ("CPU", "CUDA"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname,
                                                                   key)
        assert torch._library.simple_registry.singleton.find(
            qualname).fake_impl.kernel is not None
        assert getattr(torch.ops.dmc, name).default is _library.OPS[name]


def traced_op_counts(model, *inputs):
    """How many times each `dmc::` operator appears in the graph of a
    traced forward."""
    with torch.no_grad():
        graph = torch.export.export(model, inputs, strict=False).graph
    counts = {}
    for node in graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if name.startswith("dmc::"):
            counts[name[5:].split(".")[0]] = counts.get(
                name[5:].split(".")[0], 0) + 1
    return counts, graph


def inputs(size, channels=3):
    gen = torch.Generator().manual_seed(4)
    return (torch.randn(2, size, size, channels, generator=gen),
            torch.tensor([5, 600]), torch.tensor([1, 0]))


def test_traced_unet_holds_one_node_per_kernel_call():
    """The tiny UNet (two levels, attention at 8x8): its GroupNorm+SiLU
    calls and its attention call, each one opaque node, and nothing of the
    plain versions (no logsumexp, no rsqrt of a variance)."""
    model = UNet(**MODEL_PARAMS, num_classes=10).eval()
    calls = {"gn": 0, "attn": 0}
    fwd_gn, fwd_attn = (fused_norm.group_norm_silu_fwd_stats,
                        flash_attention.flash_attention_fwd)

    def count(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped
    try:
        fused_norm.group_norm_silu_fwd_stats = count("gn", fwd_gn)
        flash_attention.flash_attention_fwd = count("attn", fwd_attn)
        with torch.no_grad():
            model(*inputs(16))
    finally:
        fused_norm.group_norm_silu_fwd_stats = fwd_gn
        flash_attention.flash_attention_fwd = fwd_attn
    counts, graph = traced_op_counts(model, *inputs(16))
    assert counts == {"gn_silu_fwd": calls["gn"],
                      "flash_attn_fwd": calls["attn"]}
    assert calls["gn"] > 10 and calls["attn"] >= 1
    plain = {"aten::logsumexp", "aten::rsqrt"}
    assert not {node.target.name().split(".")[0] for node in graph.nodes
                if hasattr(node.target, "name")} & plain


def test_traced_dit_and_dim_hold_one_node_per_block():
    dit = DiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10).eval()
    assert traced_op_counts(dit, *inputs(16))[0] == {
        "flash_attn_fwd": DIT_PARAMS["depth"]}
    dim = DiM(img_size=(16, 16), **DIM_PARAMS, num_classes=10).eval()
    assert traced_op_counts(dim, *inputs(16))[0] == {
        "selective_scan_fwd": DIM_PARAMS["depth"]}


def test_a_seed_past_int64_keeps_its_mask():
    """The operators take a signed 64-bit seed: the wrapper folds a larger
    one onto the same 64 bits, which give the same mask."""
    seed = 2**64 - 3
    signed = flash_attention._signed_seed(seed)
    assert signed == -3
    assert torch.equal(
        flash_attention.philox_keep_mask(seed, 2, 5, 7, 0.3),
        flash_attention.philox_keep_mask(signed, 2, 5, 7, 0.3))
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 9, 8, generator=gen) for _ in range(3))
    torch.testing.assert_close(
        flash_attention.flash_attention_fwd(q, k, v, 0.3, seed)[0],
        flash_attention.flash_attention_fwd_ref(q, k, v, 0.3, seed)[0],
        rtol=0, atol=0)
