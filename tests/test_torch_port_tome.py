"""The port's token merging (ToMe) against the JAX package's, on the CPU, at
tiny widths: `ToMeSpec`, the merge plan's index arrays, `merge`, `unmerge`
and `sizes`, proportional attention over merged keys (`key_sizes`, the
attention kernels' key-bias forms, whose plain versions run here), a DiT
(hidden 64, depth 2, 16x16 images: 64 tokens) with merging at ratios 0.5
and 0.3, with and without `tome_mlp` and beside PAG, and a DDIM-10 CFG
trajectory.

Inputs come from numpy with a seed, the JAX DiT's parameters are perturbed
(`torch_port_helpers.perturbed`), and every case's similarity scores are
distinct, so both sides' stable sorts order the sources alike. Bars: the
plan's index arrays exactly; merge, unmerge and sizes 1e-6 (absolute, on
values of order 1: the sums of a destination and its sources in another
order); attention forward and gradient, and the DiT forward 2e-4, as
max|port - jax| / max|jax| (the repo's forward bar); the trajectory 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion.ddim import DDIM as JaxDDIM
from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.ops import attention as jax_attention
from diffusion_models_collection_tpu.ops import tome as jax_tome
from diffusion_models_collection_tpu_torch.diffusion import DDIM
from diffusion_models_collection_tpu_torch.ops import attention, tome
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIT_PARAMS,
    jax_dit,
    max_rel,
    one_torch_thread,
    torch_dit,
)

TOL = 2e-4


# -------------------------------------------------------------------- spec
@pytest.mark.parametrize("h,w,ratio,sx,sy", [
    (16, 16, 0.5, 2, 2), (16, 16, 0.3, 2, 2), (8, 8, 0.0, 2, 2),
    (8, 8, 0.99, 2, 2), (7, 5, 0.4, 2, 3), (8, 8, 0.5, 1, 1),
    (4, 4, 0.01, 2, 2)])
def test_spec_from_ratio_matches_jax(h, w, ratio, sx, sy):
    ours = tome.ToMeSpec.from_ratio(h, w, ratio, sx, sy)
    ref = jax_tome.ToMeSpec.from_ratio(h, w, ratio, sx, sy)
    if ref is None:
        assert ours is None
    else:
        assert dataclass_fields(ours) == dataclass_fields(ref)
        assert (ours.num_dst, ours.num_src) == (ref.num_dst, ref.num_src)


def dataclass_fields(spec):
    return (spec.h, spec.w, spec.r, spec.sx, spec.sy)


def test_spec_refuses_what_jax_refuses():
    for make, match in [
            (lambda m: m.ToMeSpec(h=4, w=4, r=13), "exceeds"),
            (lambda m: m.ToMeSpec(h=4, w=4, r=1, sx=0), "strides"),
            (lambda m: m.ToMeSpec(h=4, w=4, r=-1), "r must be"),
            (lambda m: m.ToMeSpec.from_ratio(4, 4, 1.5), "tome_ratio"),
            (lambda m: m.ToMeSpec.from_ratio(4, 4, -0.1), "tome_ratio")]:
        for module in (tome, jax_tome):
            with pytest.raises(ValueError, match=match):
                make(module)
    # the CIFAR DiT's 16x16 grid at the ratios the card runs
    assert tome.ToMeSpec.from_ratio(16, 16, 0.5).r == 128
    assert tome.ToMeSpec.from_ratio(16, 16, 0.3).r == 77


# -------------------------------------------------------------------- plan
def metric(seed, batch=2, h=8, w=8, d=16):
    return np.random.default_rng(seed).standard_normal(
        (batch, h * w, d)).astype(np.float32)


@pytest.mark.parametrize("seed,h,w,ratio,sx,sy", [
    (0, 8, 8, 0.5, 2, 2), (1, 8, 8, 0.3, 2, 2), (2, 7, 5, 0.4, 2, 3),
    (3, 16, 16, 0.5, 2, 2)])
def test_build_plan_index_arrays_equal_jax(seed, h, w, ratio, sx, sy):
    m = metric(seed, h=h, w=w)
    spec = tome.ToMeSpec.from_ratio(h, w, ratio, sx, sy)
    ours = tome.build_plan(torch.from_numpy(m), spec)
    ref = jax.jit(lambda x: jax_tome.build_plan(x, jax_tome.ToMeSpec(
        h, w, spec.r, sx, sy)))(jnp.asarray(m))
    for name in ("kept", "merged", "dst_assign", "gather", "idx_dst",
                 "idx_src"):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_array_equal(ours["counts"].numpy(),
                                  np.asarray(ref["counts"]))


@pytest.mark.parametrize("h,w,sy,sx", [(8, 8, 2, 2), (5, 7, 2, 2),
                                        (16, 16, 2, 2), (6, 9, 3, 2)])
def test_layout_equals_jax_partition(h, w, sy, sx):
    """The partition the plan is built on (`_layout`, cached per geometry
    and device) is the JAX package's `_partition`, and its map from a token
    to its column of [sources ; destinations] inverts that order."""
    spec = tome.ToMeSpec(h, w, 1, sx, sy)
    idx_dst, idx_src, inv = tome._layout(spec, torch.device("cpu"))
    ref_dst, ref_src = jax_tome._partition(jax_tome.ToMeSpec(h, w, 1, sx, sy))
    np.testing.assert_array_equal(idx_dst.numpy(), ref_dst)
    np.testing.assert_array_equal(idx_src.numpy(), ref_src)
    order = np.concatenate([ref_src, ref_dst])
    np.testing.assert_array_equal(order[inv.numpy()], np.arange(h * w))
    assert tome._layout(spec, torch.device("cpu"))[0] is idx_dst


@pytest.fixture(scope="module")
def plans():
    m = metric(5)
    spec = tome.ToMeSpec.from_ratio(8, 8, 0.5)
    jspec = jax_tome.ToMeSpec(8, 8, spec.r)
    return (tome.build_plan(torch.from_numpy(m), spec),
            jax_tome.build_plan(jnp.asarray(m), jspec),
            np.random.default_rng(6).standard_normal((2, 64, 24)).astype(
                np.float32))


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_merge_matches_jax(plans, mode):
    ours, ref, t = plans
    got = tome.merge(ours, torch.from_numpy(t), mode).numpy()
    want = np.asarray(jax_tome.merge(ref, jnp.asarray(t), mode))
    assert got.shape == want.shape == (2, 32, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unmerge_and_sizes_match_jax(plans):
    ours, ref, t = plans
    merged = np.random.default_rng(7).standard_normal((2, 32, 24)).astype(
        np.float32)
    np.testing.assert_allclose(
        tome.unmerge(ours, torch.from_numpy(merged)).numpy(),
        np.asarray(jax_tome.unmerge(ref, jnp.asarray(merged))),
        rtol=0, atol=1e-6)
    sizes = tome.sizes(ours).numpy()
    np.testing.assert_allclose(sizes, np.asarray(jax_tome.sizes(ref)),
                               rtol=0, atol=1e-6)
    assert sizes.sum(axis=1).tolist() == [64.0, 64.0]
    with pytest.raises(ValueError, match="Unknown merge mode"):
        tome.merge(ours, torch.from_numpy(t), "max")
    with pytest.raises(ValueError, match="metric must be"):
        tome.build_plan(torch.zeros(2, 63, 4), tome.ToMeSpec(8, 8, 4))


def region_duplicated(seed, h, w, d, sx=2, sy=2, batch=2):
    """(B, h * w, d) whose tokens in each sy x sx region equal the region's
    (distinct random) value."""
    nh, nw = -(-h // sy), -(-w // sx)
    vals = np.random.default_rng(seed).standard_normal(
        (batch, nh, nw, d)).astype(np.float32)
    full = vals[:, np.arange(h) // sy][:, :, np.arange(w) // sx]
    return full.reshape(batch, h * w, d)


def test_merged_attention_is_exact_for_duplicated_tokens():
    """The invariant of the JAX module: with exactly duplicated tokens,
    merge, proportional attention, unmerge equals full attention (the log
    size key bias restores the softmax multiplicity)."""
    x = torch.from_numpy(region_duplicated(2, 8, 8, 32))
    full = attention.multihead_attention(x, x, x, 4)
    spec = tome.ToMeSpec.from_ratio(8, 8, 0.75)  # all 48 sources merge
    assert spec.r == 48
    plan = tome.build_plan(x, spec)
    xm = tome.merge(plan, x)
    out = attention.multihead_attention(xm, xm, xm, 4,
                                        key_sizes=tome.sizes(plan))
    np.testing.assert_allclose(tome.unmerge(plan, out).numpy(), full.numpy(),
                               rtol=0, atol=1e-5)
    ones = attention.multihead_attention(x, x, x, 4,
                                         key_sizes=torch.ones(2, 64))
    np.testing.assert_allclose(ones.numpy(), full.numpy(), rtol=0, atol=1e-6)


# --------------------------------------------------------------- attention
def test_attention_with_key_sizes_matches_jax_forward_and_gradient():
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 4, 20, 16)).astype(np.float32)
               for _ in range(3))
    sizes = rng.integers(1, 9, (2, 20)).astype(np.float32)
    g = rng.standard_normal((2, 4, 20, 16)).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_attention.dot_product_attention(q, k, v,
                                                  key_sizes=jnp.asarray(sizes))
        return jnp.sum(out * g), out

    (_, ref), grads_ref = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    def merge_heads(t):  # (B, H, L, d) -> (B, L, H d)
        return t.transpose(0, 2, 1, 3).reshape(2, 20, 64)

    tq, tk, tv = (torch.from_numpy(merge_heads(a)).requires_grad_()
                  for a in (q, k, v))
    out = attention.multihead_attention(tq, tk, tv, 4,
                                        key_sizes=torch.from_numpy(sizes))
    (out * torch.from_numpy(merge_heads(g))).sum().backward()
    assert max_rel(out.detach().numpy(), merge_heads(np.asarray(ref))) <= TOL
    for ours, want in zip((tq, tk, tv), grads_ref):
        assert max_rel(ours.grad.numpy(), merge_heads(np.asarray(want))) <= TOL


# -------------------------------------------------------------------- DiT
@pytest.fixture(scope="module")
def cond16():
    return jax_dit(conditional=True, seed=0, size=16)


def inputs(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
            np.array([0, 10, 500, 999], np.int64),
            np.array([1, 4, 7, 10], np.int64))


@pytest.mark.parametrize("ratio,mlp,pag", [
    (0.5, False, False), (0.5, True, False), (0.3, False, False),
    (0.3, True, False), (0.5, True, True)])
def test_dit_with_tome_matches_jax(cond16, ratio, mlp, pag):
    """Merging at 0.5 (r 32 of 64) and 0.3 (r 19: a ragged merged length
    of 45), around the attention and with `tome_mlp` the MLP too; beside
    PAG the identity attention is not merged, the MLP still is."""
    _, params, config = cond16
    knobs = dict(tome_ratio=ratio, tome_mlp=mlp, pag_perturb=pag)
    jmodel = JaxDiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10, **knobs)
    x, t, y = inputs()
    ref = jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        jnp.asarray(y, jnp.int32)))(params)
    with torch.no_grad():
        ours = torch_dit(params, config, **knobs)(
            *(torch.from_numpy(a) for a in (x, t, y)))
    assert ours.shape == (4, 16, 16, 3)
    assert max_rel(ours.numpy(), np.asarray(ref)) <= TOL
    with torch.no_grad():
        plain = torch_dit(params, config)(
            *(torch.from_numpy(a) for a in (x, t, y)))
    assert not torch.equal(ours, plain)  # merging changed the result


def test_ddim_10_cfg_trajectory_with_tome_matches_jax(cond16):
    _, params, config = cond16
    knobs = dict(tome_ratio=0.5, tome_mlp=True)
    jmodel = JaxDiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10, **knobs)
    noise = np.random.default_rng(6).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    y = np.array([3, 8], np.int64)
    ref = JaxDDIM(num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
        jax.tree_util.Partial(
            lambda x, t, yy: jmodel.apply({"params": params}, x, t, yy)),
        noise.shape, jnp.asarray(y, jnp.int32), jax.random.PRNGKey(0),
        cfg_scale=3.0, init_noise=jnp.asarray(noise))
    ours = DDIM(num_timesteps=1000, num_inference_steps=10).sample_with_cfg(
        torch_dit(params, config, **knobs), noise.shape, torch.from_numpy(y),
        cfg_scale=3.0, init_noise=torch.from_numpy(noise))
    assert np.isfinite(ours.numpy()).all()
    assert max_rel(ours.numpy(), np.asarray(ref)) <= 5e-4


def test_tome_changes_no_parameter_and_ratio_0_is_the_plain_dit(cond16):
    _, params, config = cond16
    plain = torch_dit(params, config)
    merged = torch_dit(params, config, tome_ratio=0.5, tome_mlp=True)
    assert plain.state_dict().keys() == merged.state_dict().keys()
    x, t, y = (torch.from_numpy(a) for a in inputs(9))
    with torch.no_grad():
        assert torch.equal(torch_dit(params, config, tome_ratio=0.0)(x, t, y),
                           plain(x, t, y))
