"""The port's sequence parallelism of the DiT (`parallel/sequence_parallel.py`)
and the attention form it runs on (E6: queries against longer keys, dropout
rows keyed on the global row), against the JAX package and against the
port's own one-device step, on the CPU.

The JAX side runs on its virtual CPU devices (`tests/conftest.py`): its
`multihead_attention` with q local and k, v longer, and its
`make_sequence_parallel_apply` step (`torch_parallel_helpers.jax_sp_steps`).
The port runs in one gloo world of four processes for the whole file
(`torch_parallel_jobs.py`, importing no JAX): (2 data, 2 seq), (1 data, 4
seq) and (1 data, 2 seq, 2 model). Against JAX the model runs with dropout 0
(the JAX masks are its own); against the port's one-device step, with
dropout 0.1, whose masks a seq rank draws for its global rows and tokens.
Bars: 2e-4 for attention against JAX, forward and gradients (the
repository's one-forward bar); the trainer bars of
`torch_parallel_helpers.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.ops.attention import (
    multihead_attention as jax_multihead_attention,
)
from diffusion_models_collection_tpu_torch.models import DiM, DiT, UNet
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa
from diffusion_models_collection_tpu_torch.ops.attention import (
    multihead_attention,
)
from diffusion_models_collection_tpu_torch.parallel import plan as plan_mod
from diffusion_models_collection_tpu_torch.parallel.plan import (
    ParallelPlan,
    check_config,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_parallel_helpers import (
    check_against_jax,
    check_against_one_device,
    jax_sp_steps,
    max_rel,
    numpy_state,
    run_world,
    train_config,
)
from torch_parallel_jobs import batches, train_job
from torch_port_helpers import (  # noqa: F401 (autouse: one torch thread)
    jax_dit,
    one_torch_thread,
)

TOL_ATTN = 2e-4


# ------------------------------------------------------------------- E6
def attention_inputs(lq, lk, batch=2, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, lq, dim)).astype(np.float32)
    k = rng.standard_normal((batch, lk, dim)).astype(np.float32)
    v = rng.standard_normal((batch, lk, dim)).astype(np.float32)
    go = rng.standard_normal((batch, lq, dim)).astype(np.float32)
    return q, k, v, go


@pytest.mark.parametrize("lq,lk", [(16, 32), (40, 80)])
def test_queries_against_longer_keys_match_jax(lq, lk):
    """The plain attention of Lq queries against Lk keys against JAX's
    `multihead_attention` on the same q, k, v: output and the gradients of
    q, k and v at 2e-4 (Lq 40, Lk 80: neither a tile multiple)."""
    q, k, v, go = attention_inputs(lq, lk)
    out_j, vjp = jax.vjp(lambda *a: jax_multihead_attention(*a, 2),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(go))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = multihead_attention(*ts, 2)
    out.backward(torch.as_tensor(go))
    assert max_rel(out, np.asarray(out_j)) <= TOL_ATTN
    for t, g in zip(ts, grads_j):
        assert t.grad.shape == t.shape
        assert max_rel(t.grad, np.asarray(g)) <= TOL_ATTN


@pytest.mark.parametrize("shards", [2, 4])
def test_dropout_rows_are_the_one_device_rows(shards):
    """With dropout on, a shard's queries (tokens s L / S ..) against every
    key, `row0` = s L / S, draw exactly the one-device call's mask rows
    (bit for bit), so their outputs and gradients are the one-device
    call's rows (to float rounding of the row subsets' products, 1e-6)."""
    length, seed, p = 32, 1234, 0.1
    q, k, v, go = attention_inputs(length, length, seed=1)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    gen = torch.Generator().manual_seed(seed)
    full = multihead_attention(*ts, 2, dropout_rate=p, deterministic=False,
                               generator=gen)
    full.backward(torch.as_tensor(go))
    n = length // shards
    for s in range(shards):
        rows = slice(s * n, (s + 1) * n)
        part_q = torch.tensor(q[:, rows], requires_grad=True)
        gen = torch.Generator().manual_seed(seed)
        part = multihead_attention(part_q, torch.as_tensor(k),
                                   torch.as_tensor(v), 2, dropout_rate=p,
                                   deterministic=False, generator=gen,
                                   row0=s * n)
        part.backward(torch.as_tensor(go[:, rows]))
        assert max_rel(part, full[:, rows]) <= 1e-6
        assert max_rel(part_q.grad, ts[0].grad[:, rows]) <= 1e-6
        mask = fa.philox_keep_mask(seed, 4, length, length, p)
        mine = fa.philox_keep_mask(seed, 4, n, length, p, row0=s * n)
        assert torch.equal(mine, mask[:, rows])
        # with a tensor-parallel head grid too (E6 x E7)
        grid = (2, 4, 1, 2)
        mask = fa.philox_keep_mask(seed, 4, length, length, p,
                                   head_grid=grid)
        mine = fa.philox_keep_mask(seed, 4, n, length, p, row0=s * n,
                                   head_grid=grid)
        assert torch.equal(mine, mask[:, rows])


def test_the_operators_take_lq_and_lk():
    """`flash_attention` (the operators, their plain versions on the CPU)
    against `flash_attention_ref` under autograd at Lq 24, Lk 40 with
    dropout, a key bias (B, Lk), a head grid and row0: the same output and
    gradients; dk, dv at Lk; a k and v of different lengths raise."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(4, 24, 8, generator=gen, requires_grad=True)
    k = torch.randn(4, 40, 8, generator=gen, requires_grad=True)
    v = torch.randn(4, 40, 8, generator=gen, requires_grad=True)
    bias = torch.randn(2, 40, generator=gen)
    args = (0.1, 77, bias, (2, 4, 3, 2))
    out = fa.flash_attention(q, k, v, *args, row0=24)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = fa.flash_attention_ref(q, k, v, *args, row0=24)
    want = torch.autograd.grad(ref.square().sum(), (q, k, v))
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert grads[1].shape == k.shape
    _, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach())
    assert lse.shape == (4, 24, 1)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v[:, :39])
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, bias=bias[:, :24].contiguous())


# ---------------------------------------------------------------- rules
def dit(**kw):
    return DiT(img_size=(8, 8), patch_size=2, hidden_size=32, depth=1,
               num_heads=4, num_classes=10, **kw)


def dim(img=(8, 8), **kw):
    return DiM(img_size=img, patch_size=2, hidden_size=32, depth=1,
               state_size=4, num_classes=10, **kw)


@pytest.mark.parametrize("config,model,match", [
    ({}, "unet", "sequence_parallel supports the DiT and DiM backbones "
                 r"\(got UNet\)"),
    ({}, "dim_fallback", "sequence_parallel for DiM runs the Mamba mixer — "
                         "the attention fallback has no distributed path"),
    ({}, "dit_9", "9 patch tokens not divisible by sequence_parallel=2"),
    ({"sequence_parallel": 8}, "dim", r"2 local tokens per shard < the "
                                      r"causal-conv halo \(3\)"),
    ({}, "dit_moe", r"MoE models \(num_experts > 0\) do not support "
                    "pipeline/sequence parallelism"),
    ({"pipeline_parallel": 2}, "dit", "sequence_parallel cannot be combined "
                                      "with pipeline_parallel"),
    ({"fsdp": True}, "dit", "fsdp cannot be combined with pipeline_parallel, "
                            "sequence_parallel or expert_parallel"),
    ({"expert_parallel": 2}, "dit", "expert_parallel composes with plain "
                                    "data parallelism only"),
])
def test_every_rejection_has_the_jax_message(config, model, match):
    """The JAX trainer's rules for `sequence_parallel`, word for word
    (`utils/trainer.py` of the JAX package)."""
    models = {
        "unet": lambda: UNet(image_size=(8, 8), model_channels=16,
                             channel_mult=(1, 2), num_res_blocks=1,
                             attention_resolutions=(), num_classes=10),
        "dim_fallback": lambda: dim(use_attention_fallback=True),
        "dit_9": lambda: DiT(img_size=(6, 6), patch_size=2, hidden_size=32,
                             depth=1, num_heads=4),
        "dim": dim, "dit": dit, "dit_moe": lambda: dit(num_experts=2),
    }
    with pytest.raises(ValueError, match=match):
        check_config(dict({"sequence_parallel": 2}, **config),
                     models[model]())


def test_the_data_axis_must_split_the_batch_and_the_grid(monkeypatch):
    """The global batch and `num_samples` divide by the data axis (the JAX
    messages); a world of 2 without a process group needs one; the
    data-parallel-only trainers refuse `sequence_parallel`."""
    with pytest.raises(ValueError, match="global batch size 3 not divisible "
                       "by the data-axis size 2 required by "
                       "sequence_parallel"):
        plan_mod._check_data_axis({"batch_size": 3}, 2)
    with pytest.raises(ValueError, match=r"num_samples 9 not divisible by "
                       "the data-axis size 2 required by sequence_parallel"):
        plan_mod._check_data_axis({"batch_size": 4, "num_samples": 9}, 2)
    with pytest.raises(ValueError, match="sequence_parallel=2 does not "
                       "divide 1 devices"):
        ParallelPlan({"sequence_parallel": 2}, dit(), "cpu")
    with pytest.raises(ValueError, match="data-parallel only"):
        ParallelPlan({"sequence_parallel": 2}, torch.nn.Module(), "cpu",
                     model_parallel=False)
    monkeypatch.setattr(plan_mod, "process_count", lambda: 4)
    check_config({"sequence_parallel": 2, "tensor_parallel": 2}, dit())


def test_token_merging_refuses_a_sequence_group():
    """ToMe needs every token on one device (the JAX message)."""
    model = DiT(img_size=(8, 8), patch_size=2, hidden_size=32, depth=1,
                num_heads=4, tome_ratio=0.25)
    x = torch.zeros(1, 16, 32)
    with pytest.raises(ValueError, match="does not compose with sequence "
                       "parallelism"):
        model.blocks[0](x, torch.zeros(1, 32), kv_group=object())


# ------------------------------------------------------------ the steps
@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    out = {"data": batches(5, 2, (4, 16, 16, 3)), "tmp": tmp}
    for name, conditional in (("dit", True), ("uncond", False)):
        model, params, cfg = jax_dit(conditional, seed=0, size=16)
        out[name] = dict(model=model, params=params,
                         state=numpy_state(state_dict_from_jax(params, cfg)),
                         config=train_config(cfg, tmp / name))
    return out


def job(setup, data, dropout=True, **changes):
    config = dict(setup["config"], **changes)
    if not dropout:
        config = dict(config, model_params=dict(config["model_params"],
                                                dropout=0.0))
    return dict(config=config, state=setup["state"], batches=data, seed=11)


def one_device(j):
    """The port's one-device step of job `j` (no parallel key; remat
    kept)."""
    config = {k: v for k, v in j["config"].items()
              if k not in ("sequence_parallel", "tensor_parallel")}
    return train_job(dict(j, config=config))


@pytest.fixture(scope="module")
def world4(setups):
    data = setups["data"]
    d, u = setups["dit"], setups["uncond"]
    jobs = {
        "jax": job(d, data, False, sequence_parallel=2),
        "uncond_jax": job(u, data, False, sequence_parallel=2),
        "sptp_jax": job(d, data, False, sequence_parallel=2,
                        tensor_parallel=2),
        "sp2": job(d, data, sequence_parallel=2),
        "sp4": job(d, data, sequence_parallel=4),
        "remat": job(d, data, sequence_parallel=2, remat=True),
        "sptp": job(d, data, sequence_parallel=2, tensor_parallel=2),
    }
    results = dict(zip(jobs, run_world(4, list(jobs.values()))))
    return jobs, results


@pytest.mark.parametrize("name,dp,sp,tp", [
    ("jax", 2, 2, 1), ("uncond_jax", 2, 2, 1), ("sptp_jax", 1, 2, 2)])
def test_sp_step_matches_the_jax_sequence_parallel_step(setups, world4, name,
                                                        dp, sp, tp):
    """(2 data, 2 seq), unconditional too, and (1 data, 2 seq, 2 model)
    against the JAX package's `make_sequence_parallel_apply` step on the
    same mesh: losses and parameters after two steps at 2e-4."""
    jobs, results = world4
    s = setups["uncond" if name.startswith("uncond") else "dit"]
    config = jobs[name]["config"]
    losses, params = jax_sp_steps(s["model"], s["params"], config,
                                  setups["data"], dp=dp, sp=sp, tp=tp)
    check_against_jax(results[name], losses, params, config)


@pytest.mark.parametrize("name", ["sp2", "sp4", "remat", "sptp"])
def test_sp_step_with_dropout_is_the_one_device_step(world4, name):
    """With dropout 0.1 (attention masks keyed on the global row, the MLP's
    on the global tokens), each layout's two steps are the one-device
    steps on the same global batches: losses, every update's gathered
    gradients, parameters and EMA."""
    jobs, results = world4
    check_against_one_device(results[name], one_device(jobs[name]))


def test_a_seq_rank_holds_the_whole_model(world4):
    """Parameters are replicated over 'seq': a rank holds every entry at
    its single-device shape (its tensor-parallel slice under SP x TP)."""
    _, results = world4
    shapes = results["sp2"]["local_shapes"]
    assert shapes["blocks.0.attn.in_proj_weight"] == (3 * 64, 64)
    assert shapes["pos_embed"] == (1, 64, 64)
    shapes = results["sptp"]["local_shapes"]
    assert shapes["blocks.0.attn.in_proj_weight"] == (3 * 32, 64)
