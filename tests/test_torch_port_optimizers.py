"""The PyTorch port's Adafactor and Lion (`utils/optimizers.py`) against
Optax 0.2.6 as the JAX package builds them (`build_optimizer` of both
packages: clip by global norm 1.0, `MultiSteps` accumulation, the
learning-rate schedule), and the trainers' `progress` key.

The optimizers run on the full-width UNet's own parameter shapes
(`configs/cifar10_unet.py`: its 27 distinct shapes, 4,978,947 values), each
side in its own layout (Flax's (kh, kw, in, out) and (in, out) on the JAX
side, torch's (out, in, kh, kw) and (out, in) on the port's), from the same
numpy parameters and gradients, over 5 updates; the parameters after them
are held at max-rel 1e-6 (max|port - optax| / max|optax|, per tensor).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _factored_dims as optax_factored_dims

from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import factory, train
from diffusion_models_collection_tpu_torch.utils import trainer as trainer_mod
from diffusion_models_collection_tpu_torch.utils.helpers import load_config
from diffusion_models_collection_tpu_torch.utils.optimizers import (
    factored_dims,
)
from diffusion_models_collection_tpu_torch.utils.trainer import (
    build_optimizer,
)
from torch_port_helpers import max_rel, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
UPDATES = 5


def unet_shapes():
    """The distinct parameter shapes of the full-width UNet, torch layout
    (built on the meta device: no memory)."""
    config = load_config(REPO / "configs" / "cifar10_unet.py")
    with torch.device("meta"):
        model = factory.get_model(config)
    return sorted({tuple(p.shape) for p in model.parameters()})


def to_flax(a):
    """A torch-layout array in Flax's layout: conv (out, in, kh, kw) ->
    (kh, kw, in, out), linear (out, in) -> (in, out)."""
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


TORCH_TO_FLAX_AXIS = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}


def test_factored_axes_are_optax_axes_on_the_unet_shapes():
    """The pair of axes the port factors is the pair Optax factors in
    Flax's layout (which of the two is the row may differ where their
    sizes tie; the estimate is symmetric in the pair)."""
    shapes = unet_shapes()
    assert len(shapes) == 27
    factored = 0
    for shape in shapes:
        ours = factored_dims(shape)
        flax_shape = to_flax(np.zeros(shape, np.int8)).shape
        ref = optax_factored_dims(flax_shape, True, 128)
        assert (ours is None) == (ref is None), shape
        if ours is not None:
            factored += 1
            mapped = {TORCH_TO_FLAX_AXIS[len(shape)][d] for d in ours}
            assert mapped == set(ref), shape
    assert factored == 18


@pytest.mark.parametrize("name,wd,accum", [
    ("adafactor", 0.0, 1), ("adafactor", 1e-2, 2),
    ("lion", 0.0, 2), ("lion", 1e-2, 1)])
def test_optimizer_matches_optax_over_five_updates(name, wd, accum):
    config = {"optimizer": name, "learning_rate": 1e-3, "weight_decay": wd,
              "gradient_accumulation_steps": accum, "use_scheduler": True,
              "scheduler_type": "warmup_cosine", "warmup_epochs": 1,
              "epochs": 2}
    shapes = unet_shapes()
    rng = np.random.default_rng(0)
    init = [0.05 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    p_jax = {str(i): jnp.asarray(to_flax(a)) for i, a in enumerate(init)}
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    tx, _, _ = jax_build_optimizer(config, 3)
    opt = build_optimizer(config, params, 3)
    update = jax.jit(tx.update)
    state = tx.init(p_jax)
    # Lion's update is the sign of (1 - b1) g + b1 m, discontinuous where
    # that is 0, and the global-norm clip's factor differs between the
    # frameworks in its last bits: its gradients keep one sign an element
    # (the magnitudes drawn anew each step), so the sign stays decided
    signs = [np.sign(rng.standard_normal(s)).astype(np.float32)
             if name == "lion" else 1.0 for s in shapes]
    for _ in range(UPDATES * accum):
        # scales that differ a step and a tensor, so the moments and the
        # global-norm clip move
        grads = [(0.1 + rng.uniform()) * sign * (
            np.abs(rng.standard_normal(s)) + 0.1 if name == "lion"
            else rng.standard_normal(s)).astype(np.float32)
            for s, sign in zip(shapes, signs)]
        updates, state = update({str(i): jnp.asarray(to_flax(g))
                                 for i, g in enumerate(grads)}, state, p_jax)
        # waited for: JAX may read the numpy gradients in place, and the
        # next step's draw frees them
        p_jax = jax.block_until_ready(optax.apply_updates(p_jax, updates))
        for p, g in zip(params, grads):
            g = torch.from_numpy(g)
            p.grad = g if p.grad is None else p.grad + g
        opt.step()
    assert opt.count == UPDATES
    for i, p in enumerate(params):
        ours = to_flax(p.detach().numpy())
        assert max_rel(ours, p_jax[str(i)]) <= 1e-6, shapes[i]
        assert not np.array_equal(ours, to_flax(init[i])), shapes[i]


def test_optimizer_state_sizes():
    """Adafactor keeps O(rows + cols) for a factored weight, Lion one
    momentum a parameter; both save and load as torch state."""
    params = [torch.nn.Parameter(torch.zeros(256, 512, 3, 3)),
              torch.nn.Parameter(torch.zeros(384))]
    for name, sizes in (("adafactor", [512 * 9, 256 * 9, 384]),
                        ("lion", [256 * 512 * 9, 384])):
        opt = build_optimizer({"optimizer": name, "learning_rate": 1e-3},
                              params, 1)
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
        state = opt.state_dict()
        got = [t.numel() for s in state["state"].values()
               for t in s.values() if torch.is_tensor(t)]
        assert sorted(got) == sorted(sizes), name
        opt.load_state_dict(state)


# --------------------------------------------------------------- progress
@pytest.mark.parametrize("progress,tty,shown", [
    (True, True, True), (True, False, False), ("force", False, True),
    ("force", True, True), (False, True, False), (False, False, False)])
def test_progress_rule(monkeypatch, progress, tty, shown):
    monkeypatch.setattr(trainer_mod.sys.stderr, "isatty", lambda: tty)
    assert trainer_mod.progress_shown({"progress": progress}) is shown
    if progress is True:
        assert trainer_mod.progress_shown({}) is shown  # the default


@pytest.mark.parametrize("progress", [False, "force"])
def test_train_prints_a_line_a_batch_under_progress(tmp_path, capsys,
                                                    progress):
    config = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (4,),
                         "dropout": 0.1, "channel_mult": (1, 2),
                         "use_attention": True},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear", "epochs": 1,
        "batch_size": 128, "num_workers": 0, "optimizer": "lion",
        "learning_rate": 1e-4, "sample_start_epoch": 10,
        "save_dir": str(tmp_path / "ckpt"), "seed": 0, "progress": progress}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    trainer = train.main(["--config", str(path), "--device", "cpu"])
    err = capsys.readouterr().err
    lines = [f"Epoch 1/1: step {k}/4" for k in range(1, 5)]
    assert trainer.global_step == 4
    assert all((line in err) == (progress == "force") for line in lines)
