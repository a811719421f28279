"""`remat` (gradient checkpointing) in the port's DiM and UNet, and the DiM
at long sequences, on the CPU at a small size.

* A model built with `remat=True` gives the loss and every gradient of the
  same weights without it: exactly with dropout off, and with dropout on
  too, because the recompute replays the first run's draws.
* Both against the JAX models built with `remat=True`, through the weight
  bridge, at 2e-4 max-rel (the repo's forward bar). The JAX models run
  their plain path here (for the DiM the XLA scan, the JAX package's own
  reference for its kernels): `jax.checkpoint` refuses the Pallas
  interpreter's callbacks. The long-sequence tests below, without remat,
  run the Pallas scan kernels in interpret mode (`run_pallas_interpreted`).
* Under `remat` a DiM block's scan saves no states: the forward without
  states runs twice (forward and recompute) and the backward that rebuilds
  them once, shown by recording the wrappers' calls.
* A DiM at L = 512 (32x64 images, patch 2), where the port's scan under a
  gradient takes its time-split path, against the JAX model: loss and
  gradients; and a 64x64 DiM (L = 1024), position embedding included,
  through the weight bridge: forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu_torch import factory
from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.models import DiM, UNet
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIM_PARAMS,
    MODEL_PARAMS,
    max_rel,
    one_torch_thread,
    perturbed,
    record_scan_calls,
    run_pallas_interpreted,
    small_config,
    small_dim_config,
)

TOL = 2e-4


def batch(seed, height, width, n=2):
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, height, width, 3)).astype(np.float32),
        t=rng.integers(0, 1000, n).astype(np.int64),
        noise=rng.standard_normal((n, height, width, 3)).astype(np.float32),
        y=rng.integers(0, 11, n).astype(np.int64),
    )


def jax_params(model, height, width, seed):
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, height, width, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    return perturbed(params, seed)


def jax_loss_and_grads(model, params, b, interpret):
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)

    def loss_fn(p):
        return ddpm.p_losses(
            lambda x, tt, yy: model.apply({"params": p}, x, tt, yy),
            b["x0"], b["t"].astype(np.int32), b["noise"],
            y=b["y"].astype(np.int32))

    fn = jax.value_and_grad(loss_fn)
    if interpret:
        return run_pallas_interpreted(fn, params)
    return jax.block_until_ready(jax.jit(fn)(params))


def torch_loss_and_grads(model, b, seed=None):
    """Loss and gradients by name; `seed` fixes the dropout draws."""
    model.zero_grad(set_to_none=True)
    if seed is not None:
        torch.manual_seed(seed)
    loss = DDPM(num_timesteps=1000).p_losses(
        model, *(torch.from_numpy(b[k]) for k in ("x0", "t", "noise")),
        y=torch.from_numpy(b["y"]))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def dim_pair(config, params, **overrides):
    """The port's DiM of `config` without and with remat, same weights."""
    state = state_dict_from_jax(params, config)
    models = []
    for remat in (False, True):
        model = DiM(img_size=config["image_size"],
                    **dict(DIM_PARAMS, **overrides), num_classes=10,
                    remat=remat)
        model.load_state_dict(state, strict=True)
        models.append(model)
    return models


@pytest.fixture(scope="module")
def dim16():
    model = JaxDiM(img_size=(16, 16), **DIM_PARAMS, num_classes=10,
                   remat=True)
    return model, jax_params(model, 16, 16, 0), small_dim_config(True, 16)


@pytest.fixture(scope="module")
def unet16():
    model = JaxUNet(**MODEL_PARAMS, num_classes=10, remat=True)
    return model, jax_params(model, 16, 16, 1), small_config(True)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_dim_with_remat_gives_the_loss_and_gradients_of_without(dim16,
                                                                dropout):
    _, params, config = dim16
    plain, remat = dim_pair(config, params, dropout=dropout)
    b = batch(2, 16, 16)
    loss, grads = torch_loss_and_grads(plain.train(), b, seed=5)
    loss_r, grads_r = torch_loss_and_grads(remat.train(), b, seed=5)
    assert max_rel(loss_r, loss) <= 1e-6
    assert set(grads) == set(grads_r)
    for name, g in grads.items():
        # the scan's backward rebuilds the states instead of reading them
        assert max_rel(grads_r[name], g) <= 1e-5, name
    if dropout:  # the draws matter: another seed gives another loss
        other, _ = torch_loss_and_grads(plain, b, seed=6)
        assert max_rel(other, loss) > 1e-4


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_unet_with_remat_gives_the_loss_and_gradients_of_without(unet16,
                                                                 dropout):
    _, params, config = unet16
    state = state_dict_from_jax(params, config)
    results = []
    for remat in (False, True):
        model = UNet(**dict(MODEL_PARAMS, dropout=dropout), num_classes=10,
                     remat=remat)
        model.load_state_dict(state, strict=True)
        results.append(torch_loss_and_grads(model.train(), batch(3, 16, 16),
                                            seed=7))
    (loss, grads), (loss_r, grads_r) = results
    torch.testing.assert_close(loss_r, loss, rtol=0, atol=0)
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=1e-6, atol=1e-7,
                                   msg=name)


def test_remat_dim_matches_the_jax_model_built_with_remat(dim16):
    model, params, config = dim16
    b = batch(4, 16, 16)
    loss_ref, grads = jax_loss_and_grads(model, params, b, interpret=False)
    grads_ref = state_dict_from_jax(grads, config)
    _, remat = dim_pair(config, params)
    loss, ours = torch_loss_and_grads(remat.eval(), b)
    assert max_rel(loss, loss_ref) <= TOL
    assert set(ours) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(ours[name], g) <= TOL, name


def test_remat_unet_matches_the_jax_model_built_with_remat(unet16):
    model, params, config = unet16
    b = batch(5, 16, 16)
    loss_ref, grads = jax_loss_and_grads(model, params, b, interpret=False)
    grads_ref = state_dict_from_jax(grads, config)
    tmodel = UNet(**MODEL_PARAMS, num_classes=10, remat=True)
    tmodel.load_state_dict(state_dict_from_jax(params, config), strict=True)
    loss, ours = torch_loss_and_grads(tmodel.eval(), b)
    assert max_rel(loss, loss_ref) <= TOL
    assert set(ours) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(ours[name], g) <= TOL, name


@pytest.mark.parametrize("remat,expected", [
    (False, [("selective_scan_fwd", True)] * 2 + [("selective_scan_bwd",)] * 2),
    # two blocks forward, then per block, last first: recompute, backward
    (True, [("selective_scan_fwd", False)] * 2
     + [("selective_scan_fwd", False), ("selective_scan_bwd_nostate",)] * 2),
])
def test_remat_dim_saves_no_scan_states(monkeypatch, dim16, remat, expected):
    _, params, config = dim16
    model = dim_pair(config, params)[remat]
    calls = record_scan_calls(monkeypatch)
    torch_loss_and_grads(model.train(), batch(6, 16, 16))
    assert calls == expected
    calls.clear()
    with torch.no_grad():  # no gradient: remat changes nothing
        model.eval()(torch.zeros(1, 16, 16, 3), torch.zeros(1, dtype=torch.long),
                     torch.zeros(1, dtype=torch.long))
    assert calls == [("selective_scan_fwd", False)] * 2


def test_remat_keeps_the_parameter_names():
    for cls, kwargs in ((DiM, dict(img_size=(16, 16), **DIM_PARAMS)),
                        (UNet, MODEL_PARAMS)):
        names = [set(cls(**kwargs, num_classes=10, remat=r).state_dict())
                 for r in (False, True)]
        assert names[0] == names[1]


@pytest.mark.parametrize("base", [small_dim_config(True, 16),
                                  small_config(True)],
                         ids=["dim", "unet"])
def test_factory_passes_remat_on(base):
    assert factory.get_model(dict(base, remat=True)).remat is True
    assert factory.get_model(base).remat is False


def test_dim_at_512_tokens_matches_jax_through_the_split_scan(monkeypatch):
    """32x64 images, patch 2: L = 512, sixteen time blocks, so at batch 2
    the port's scan under a gradient is the time-split one."""
    height, width = 32, 64
    model = JaxDiM(img_size=(height, width), **DIM_PARAMS, num_classes=10)
    params = jax_params(model, height, width, 2)
    config = dict(small_dim_config(True, 16), image_size=(height, width))
    config["model_params"]["img_size"] = (height, width)
    b = batch(8, height, width)
    loss_ref, grads = jax_loss_and_grads(model, params, b, interpret=True)
    grads_ref = state_dict_from_jax(grads, config)
    tmodel, _ = dim_pair(config, params)
    calls = record_scan_calls(monkeypatch)
    loss, ours = torch_loss_and_grads(tmodel.eval(), b)
    assert calls == ([("selective_scan_fwd_split",)] * 2
                     + [("selective_scan_bwd_split",)] * 2)
    assert ss.split_forward(2, 512, 128) and ss.split_backward(2, 512, 128)
    assert max_rel(loss, loss_ref) <= TOL
    for name, g in grads_ref.items():
        assert max_rel(ours[name], g) <= TOL, name


def test_64x64_dim_forward_matches_jax_through_the_weight_bridge():
    model = JaxDiM(img_size=(64, 64), **DIM_PARAMS, num_classes=10)
    params = jax_params(model, 64, 64, 3)
    config = small_dim_config(True, 64)
    state = state_dict_from_jax(params, config)
    assert tuple(state["pos_embed"].shape) == (1, 1024, 64)
    tmodel = factory.get_model(config)
    tmodel.load_state_dict(state, strict=True)
    b = batch(9, 64, 64)
    ref = run_pallas_interpreted(
        lambda p: model.apply({"params": p}, b["x0"],
                              b["t"].astype(np.int32),
                              b["y"].astype(np.int32)), params)
    with torch.no_grad():
        ours = tmodel.eval()(*(torch.from_numpy(b[k])
                               for k in ("x0", "t", "y")))
    assert ours.shape == (2, 64, 64, 3)
    assert max_rel(ours, ref) <= TOL
