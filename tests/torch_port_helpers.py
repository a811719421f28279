"""Shared set-up of the PyTorch port's parity tests: a small JAX UNet, DiM
and DiT with seeded, perturbed params, their configs, and the port's models
with the same weights through the weight bridge, and `one_torch_thread`, a
module fixture that a test file imports to run the port on one torch
thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_models_collection_tpu.diffusion import (
    schedule as jax_schedule,
)
from diffusion_models_collection_tpu.models import DiM as JaxDiM
from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.models import UNet as JaxUNet
from diffusion_models_collection_tpu.ops import dispatch
from diffusion_models_collection_tpu_torch.diffusion import NoiseSchedule
from diffusion_models_collection_tpu_torch.models import DiM, DiT, UNet
from diffusion_models_collection_tpu_torch.ops import selective_scan as ss
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side at these tiny shapes runs fastest on one thread and
    leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H = W = 16
MODEL_PARAMS = dict(image_size=(H, W), in_channels=3, model_channels=32,
                    out_channels=3, num_res_blocks=1,
                    attention_resolutions=(8,), dropout=0.1,
                    channel_mult=(1, 2), use_attention=True)


def small_config(conditional=True):
    return {
        "model_type": "unet",
        "model_params": dict(MODEL_PARAMS),
        "image_size": (H, W),
        "conditional": conditional,
        "num_classes": 10,
        "num_timesteps": 1000,
        "beta_start": 0.0001,
        "beta_end": 0.02,
        "beta_schedule": "linear",
        "num_inference_steps": 10,
        "ddim_eta": 0.0,
        "mixed_precision": "none",
    }


def jax_unet(conditional=True, seed=0):
    """(flax model, params as numpy, config). Every param is perturbed by
    seeded noise, so norms are not the identity and the null label's row 0
    is not zero (both sides must mask it at lookup)."""
    num_classes = 10 if conditional else None
    model = JaxUNet(**MODEL_PARAMS, num_classes=num_classes)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
                        jnp.zeros((1,), jnp.int32), y)["params"]
    return model, perturbed(params, seed), small_config(conditional)


def torch_unet(params, config):
    """The port's UNet with the same weights, strict load, eval mode."""
    num_classes = 10 if config["conditional"] else None
    model = UNet(**MODEL_PARAMS, num_classes=num_classes)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def traced_unet(conditional=True, seed=0):
    """(flax UNet of MODEL_PARAMS, params as numpy, config): the param
    shapes from `jax.eval_shape` of its init (traced, never run: seconds
    where the jitted init takes about ten), each drawn from numpy, norm
    scales 1 + N(0, 0.05^2), everything else N(0, 0.05^2)."""
    num_classes = 10 if conditional else None
    model = JaxUNet(**MODEL_PARAMS, num_classes=num_classes)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                           jnp.zeros((1,), jnp.int32), y))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return noise + (1.0 if path[-1].key == "scale" else 0.0)
    return (model, jax.tree_util.tree_map_with_path(draw, shapes),
            small_config(conditional))


def traced_params(model, inputs, seed):
    """A flax model's params from `jax.eval_shape` of its init on `inputs`
    (traced, never run), each drawn from numpy: norm scales 1 + N(0,
    0.05^2), everything else N(0, 0.05^2), so adaLN-Zero layers are not
    zero."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *inputs))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return noise + (1.0 if path[-1].key == "scale" else 0.0)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def perturbed(params, seed):
    """Every param plus seeded noise (0.05 std), as numpy: norms are not the
    identity, adaLN and the output layers are not zero, and the null
    label's row 0 is not zero (both sides must mask it at lookup)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), params)


# hidden 64: d_inner 128, so the JAX gate takes its Pallas scan kernels
DIM_PARAMS = dict(patch_size=2, in_channels=3, hidden_size=64, depth=2,
                  state_size=16, mlp_ratio=4.0, dropout=0.1)


def small_dim_config(conditional=True, size=16):
    return dict(small_config(conditional), model_type="dim",
                model_params=dict(DIM_PARAMS, img_size=(size, size)),
                image_size=(size, size))


def jax_dim(conditional=True, seed=0, size=16):
    """(flax DiM, perturbed params as numpy, config) at size x size, so
    L = (size / 2)^2 tokens."""
    num_classes = 10 if conditional else None
    model = JaxDiM(img_size=(size, size), **DIM_PARAMS,
                   num_classes=num_classes)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)),
                        jnp.zeros((1,), jnp.int32), y)["params"]
    return model, perturbed(params, seed), small_dim_config(conditional, size)


def torch_dim(params, config, **overrides):
    """The port's DiM with the same weights, strict load, eval mode."""
    num_classes = 10 if config["conditional"] else None
    model = DiM(img_size=config["image_size"],
                **dict(DIM_PARAMS, **overrides), num_classes=num_classes)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


# hidden 64 in 4 heads: head_dim 16
DIT_PARAMS = dict(patch_size=2, in_channels=3, hidden_size=64, depth=2,
                  num_heads=4, mlp_ratio=4.0, dropout=0.1)


def small_dit_config(conditional=True, size=16):
    return dict(small_config(conditional), model_type="dit",
                model_params=dict(DIT_PARAMS, img_size=(size, size)),
                image_size=(size, size))


def jax_dit(conditional=True, seed=0, size=16):
    """(flax DiT, perturbed params as numpy, config) at size x size, so
    L = (size / 2)^2 tokens."""
    num_classes = 10 if conditional else None
    model = JaxDiT(img_size=(size, size), **DIT_PARAMS,
                   num_classes=num_classes)
    y = jnp.zeros((1,), jnp.int32) if conditional else None
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)),
                        jnp.zeros((1,), jnp.int32), y)["params"]
    return model, perturbed(params, seed), small_dit_config(conditional, size)


def torch_dit(params, config, **overrides):
    """The port's DiT with the same weights, strict load, eval mode."""
    num_classes = 10 if config["conditional"] else None
    model = DiT(img_size=config["image_size"],
                **dict(DIT_PARAMS, **overrides), num_classes=num_classes)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def max_rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def recording_gradients(trainer):
    """Make `trainer.optimizer.step` record a copy of every gradient of
    `trainer.model` before it runs (clipping included); returns the dict it
    fills."""
    grads = {}
    step = trainer.optimizer.step

    def recording_step():
        grads.update({n: p.grad.detach().clone()
                      for n, p in trainer.model.named_parameters()})
        return step()
    trainer.optimizer.step = recording_step
    return grads


def check_first_adam_update(what, ours, ref, grads, lr, bar=2e-4):
    """Tensors after one Adam(W) update against the JAX package's: Adam's
    first update is about lr sign(g), so where a gradient element lies
    within float noise of 0 the two frameworks may move it by up to 2 lr.
    Held at `bar` (max-rel) over the elements whose gradient is at least
    1e-3 of its tensor's largest, and within 2 lr everywhere."""
    for name, want in ref.items():
        got, g = ours[name].detach(), grads[name].abs()
        want = torch.as_tensor(np.asarray(want))
        decided = g >= 1e-3 * g.max()
        assert max_rel(got[decided], want[decided]) <= bar, (what, name)
        assert (got - want).abs().max().item() <= 2 * lr + 1e-7, (what, name)


def run_pallas_interpreted(fn, *args):
    """`fn(*args)` with the JAX package's Pallas kernels on (also where a
    model reaches them through `ops.dispatch`) and run by the interpreter,
    as one jitted computation that is waited for before anything else is
    dispatched. The interpreter's callbacks dispatch JAX ops of their own;
    called eagerly, a model's next op, dispatched from the test's thread
    while those callbacks run, can deadlock both threads."""
    with dispatch.use_pallas(True), pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)(*args))


SCAN_WRAPPERS = ("selective_scan_fwd", "selective_scan_fwd_split",
                 "selective_scan_bwd", "selective_scan_bwd_split",
                 "selective_scan_bwd_nostate")


def record_scan_calls(monkeypatch, suffix=""):
    """Wrap every scan wrapper `SelectiveScan` can reach (with "_ref", every
    plain version `SelectiveScanRef` can) so that each call appends (its
    name, its `save_states` where it takes one) to the list returned."""
    calls = []
    for name in SCAN_WRAPPERS:
        def wrapper(*args, _real=getattr(ss, name + suffix), _name=name):
            calls.append((_name, *(a for a in args if isinstance(a, bool))))
            return _real(*args)
        monkeypatch.setattr(ss, name + suffix, wrapper)
    return calls


def shared_schedule(num_timesteps=1000):
    """The JAX schedule, and the port's NoiseSchedule holding its arrays:
    both sides on one set of coefficients, so only the arithmetic that
    uses them is compared."""
    jsched = jax_schedule.NoiseSchedule.create(num_timesteps)
    fields = {name: torch.tensor(np.asarray(getattr(jsched, name)))
              for name in NoiseSchedule.__dataclass_fields__}
    return jsched, NoiseSchedule(**fields)


def affine_xty(x, t, y, lib):
    """A stand-in model both frameworks can run: affine in x, t and y
    (`lib` is jnp or torch)."""
    if lib is jnp:
        tt, yy = t.astype(jnp.float32), y.astype(jnp.float32)
    else:
        tt, yy = t.to(torch.float32), y.to(torch.float32)
    return (0.6 * x + 1e-3 * tt[:, None, None, None]
            - 0.05 * yy[:, None, None, None])


def normal_arrays(seed, n=3, shape=(3, 8, 8, 3)):
    """`n` standard normal float32 arrays of `shape` from one seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
