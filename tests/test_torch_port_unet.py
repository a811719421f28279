"""The PyTorch port's UNet, layers, weight bridge and checkpoints against the
JAX package, on the CPU, at a small size (32 channels, mult (1, 2), one
residual block per level, 16x16, attention at 8x8).

Forward tolerance: max|port - jax| / max|jax| <= 2e-4, the bar of
tests/test_torch_import.py:63 (float32 on both sides; convolutions and
reductions sum in different orders through ~20 layers).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict

from diffusion_models_collection_tpu.models import layers as jax_layers
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.torch_export import (
    export_torch_state_dict,
    save_reference_checkpoint,
)
from diffusion_models_collection_tpu_torch import factory
from diffusion_models_collection_tpu_torch.models import (
    LabelEmbedder,
    UNet,
    sinusoidal_time_embedding_unet,
)
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (
    MODEL_PARAMS,
    jax_unet,
    max_rel,
    torch_unet,
)

TOL = 2e-4


@pytest.fixture(scope="module")
def cond():
    return jax_unet(conditional=True)


def forward_both(model, params, tmodel, x, t, y):
    yj = None if y is None else jnp.asarray(y, jnp.int32)
    ref = model.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(t, jnp.int32), yj)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                      None if y is None else torch.from_numpy(y))
    return ours.numpy(), np.asarray(ref)


def inputs(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 10, 500, 999][:batch], np.int64)
    return x, t


def test_weight_bridge_equals_jax_exporter(cond):
    _, params, config = cond
    ours = state_dict_from_jax(params, config)
    ref = export_torch_state_dict(params, "unet", config)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_weight_bridge_loads_strict_with_reference_names(cond):
    _, params, config = cond
    model = UNet(**MODEL_PARAMS, num_classes=10)
    result = model.load_state_dict(state_dict_from_jax(params, config),
                                   strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("labels", ["conditional", "null"])
def test_unet_forward_matches_jax(cond, labels):
    model, params, config = cond
    x, t = inputs()
    y = (np.array([1, 4, 7, 10], np.int64) if labels == "conditional"
         else np.zeros(4, np.int64))
    ours, ref = forward_both(model, params, torch_unet(params, config), x, t, y)
    assert ours.shape == ref.shape == (4, 16, 16, 3)
    assert max_rel(ours, ref) <= TOL


def test_unconditional_unet_forward_matches_jax():
    model, params, config = jax_unet(conditional=False, seed=1)
    x, t = inputs(seed=1)
    ours, ref = forward_both(model, params, torch_unet(params, config), x, t,
                             None)
    assert max_rel(ours, ref) <= TOL


def test_sinusoidal_time_embedding_matches_jax():
    t = np.array([0, 1, 17, 250, 999], np.int64)
    ref = jax_layers.sinusoidal_time_embedding_unet(jnp.asarray(t), 128)
    ours = sinusoidal_time_embedding_unet(torch.from_numpy(t), 128)
    # sin/cos of arguments up to 999 rad: one float32 ulp of the argument
    # there is 6e-5, so compare absolutely at 1e-4
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_label_embedder_masks_null_row_like_jax():
    table = np.random.default_rng(2).standard_normal((11, 8)).astype(
        np.float32)  # row 0 deliberately non-zero
    y = np.array([0, 3, 10, 0, 12, -1], np.int64)  # out of range clamps
    ref = jax_layers.LabelEmbedder(10, 8).apply(
        {"params": {"embedding": jnp.asarray(table)}},
        jnp.asarray(y, jnp.int32))
    emb = LabelEmbedder(10, 8)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
        ours = emb(torch.from_numpy(y))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not ours[0].any() and not ours[3].any()


@pytest.mark.parametrize("knob", [dict(pag_perturb=True),
                                  dict(freeu=(1.2, 1.1, 0.9, 0.95)),
                                  dict(deepcache_mode="full")])
def test_unet_raises_on_knobs_not_ported(knob):
    """The three knobs are ported: each builds with the plain UNet's
    parameter names, and a malformed value of each raises the JAX model's
    ValueError (PAG's has none: any truth value is one)."""
    plain = set(UNet(**MODEL_PARAMS, num_classes=10).state_dict())
    assert set(UNet(**MODEL_PARAMS, num_classes=10,
                    **knob).state_dict()) == plain
    bad = {"pag_perturb": None, "freeu": dict(freeu=(1.2, 1.1)),
           "deepcache_mode": dict(deepcache_mode="full",
                                  deepcache_depth=2)}[next(iter(knob))]
    if bad is not None:
        with pytest.raises(ValueError):
            UNet(**MODEL_PARAMS, num_classes=10, **bad)


def test_reference_pth_from_jax_exporter_loads_strict(cond, tmp_path):
    model, params, config = cond
    path = tmp_path / "best_model.pth"
    save_reference_checkpoint(path, params, config, ema_params=params)
    payload = checkpoint.load_checkpoint(path)
    tmodel = factory.load_model_for_inference(payload, payload["config"],
                                              use_ema=True,
                                              device=torch.device("cpu"))
    x, t = inputs(seed=3)
    y = np.array([2, 0, 5, 9], np.int64)
    ours, ref = forward_both(model, params, tmodel, x, t, y)
    assert max_rel(ours, ref) <= TOL


@pytest.mark.parametrize("container", ["dict", "FrozenDict"])
def test_jax_checkpoint_loads_without_jax_classes(cond, tmp_path, container):
    """A JAX .ckpt pickle with an optax state loads through the restricted
    unpickler: optax and flax classes become inert placeholders and the
    params come back bridged (older checkpoints hold FrozenDict params)."""
    _, params, config = cond
    path = tmp_path / "current_model.ckpt"
    opt_state = optax.adamw(1e-4).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    saved = params if container == "dict" else FrozenDict(params)
    jax_save_checkpoint(path, epoch=3, params=saved, opt_state=opt_state,
                        best_loss=0.5, config=config, ema_params=saved)
    payload = checkpoint.load_checkpoint(path)
    assert payload["epoch"] == 3
    want = state_dict_from_jax(params, config)
    for key in ("model_state_dict", "ema_model_state_dict"):
        assert set(payload[key]) == set(want)
        for name, value in want.items():
            torch.testing.assert_close(payload[key][name], value, rtol=0,
                                       atol=0)
    assert all(type(s).__module__.startswith("inert.")
               for s in payload["optimizer_state_dict"])


def test_jax_checkpoint_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.ckpt"
    with path.open("wb") as f:
        pickle.dump({"config": {}, "hook": print}, f)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.load_checkpoint(path)


def test_port_checkpoint_roundtrip(cond, tmp_path):
    _, params, config = cond
    model = torch_unet(params, config)
    path = tmp_path / "port.pth"
    checkpoint.save_checkpoint(path, model.state_dict(), config, epoch=2)
    payload = checkpoint.load_checkpoint(path)
    assert payload["epoch"] == 2 and payload["config"] == config
    reloaded = factory.load_model_for_inference(payload, config, False,
                                                torch.device("cpu"))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(reloaded.state_dict()[key], value, rtol=0,
                                   atol=0)
