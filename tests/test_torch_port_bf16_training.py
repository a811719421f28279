"""Two train steps of the port's models in mixed precision
(`mixed_precision: 'bf16'`) against the JAX package's pieces, on the CPU:
the UNet, the DiT and the DiM (its Mamba mixer and its attention fallback)
at tiny widths, with the set-up, the bars and their reasons of
tests/test_torch_port_bf16_models.py. The steps (AdamW, warmup-cosine
schedule, EMA, CFG label dropout) take the same t, noise and drop masks on
both sides, with dropout 0 (the two frameworks' generators never agree);
the loss, the gradients, AdamW's moments and the EMA stay float32 on the
port's side. What is compared is the losses and the change the two steps
made to the parameters and to the EMA, in the distance and for the reasons
given beside `TRAIN_BAR`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.utils.ema import gated_ema_update
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from test_torch_port_bf16_models import (
    BF16,
    FORWARD_BAR,
    LOSS_BAR,
    TRAIN_BAR,
    TRAIN_NAMES,
    built,
    check_bar,
    port_model,
    rel_norm,
)
from torch_port_helpers import max_rel


def batch(seed, n=4):
    """x0 in [-1, 1], labels 0..9, t, noise and a CFG drop mask."""
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
        labels=rng.integers(0, 10, n).astype(np.int64),
        t=rng.integers(0, 1000, n).astype(np.int64),
        noise=rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
        drop=rng.uniform(size=n) < 0.3,
    )


def jax_two_steps(model, params, config, batches):
    """The JAX pieces of two train steps: the DDPM eps-loss and its
    gradients, the Optax chain, the gated EMA. Returns the losses, the
    parameters and the EMA."""
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)
    tx, _, _ = jax_build_optimizer(config, 1)

    @jax.jit
    def step(p, opt_state, ema, x0, t, noise, y):
        def loss_fn(q):
            return ddpm.p_losses(
                lambda x, tt, yy: model.apply({"params": q}, x, tt, yy),
                x0, t, noise, y=y)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return loss, p, opt_state, gated_ema_update(tx, opt_state, ema, p,
                                                    config["ema_decay"])

    p = ema = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    losses = []
    for b in batches:
        y = np.where(b["drop"], 0, b["labels"] + 1).astype(np.int32)
        loss, p, opt_state, ema = step(p, opt_state, ema, b["x0"],
                                       b["t"].astype(np.int32), b["noise"], y)
        losses.append(float(loss))
    return losses, p, ema


def flat(state, config):
    """The parameters of a JAX tree or a port state dict as one vector, in
    the port's names and order."""
    if not isinstance(state, dict) or not all(
            isinstance(v, torch.Tensor) for v in state.values()):
        state = state_dict_from_jax(state, config)
    return np.concatenate([np.asarray(state[k], np.float32).ravel()
                           for k in sorted(state)])


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_bf16_two_train_steps_match_jax(name, tmp_path):
    model, params, config = built(name)
    config = dict(
        config, optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        use_scheduler=True, scheduler_type="warmup_cosine", epochs=4,
        warmup_epochs=2, warmup_start_factor=0.1, use_ema=True,
        ema_decay=0.9, cfg_dropout_prob=0.2, gradient_accumulation_steps=1,
        loss_type="l2", batch_size=4, save_dir=str(tmp_path / "ckpt"),
        sample_dir=str(tmp_path / "samples"), seed=0)
    batches = [batch(10), batch(11)]
    losses16, p16, ema16 = jax_two_steps(model.clone(dtype=BF16), params,
                                         config, batches)
    losses32, p32, ema32 = jax_two_steps(model, params, config, batches)

    def port_two_steps(mixed_precision):
        trainer = DiffusionTrainer(
            port_model(params, config, dropout=0.0,
                       mixed_precision=mixed_precision),
            DDPM(num_timesteps=1000), [None], config, "cpu")
        losses = []
        for b in batches:
            tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            loss = trainer.train_step(tb["x0"], tb["labels"], tb["t"],
                                      tb["noise"], tb["drop"])
            assert loss.dtype == torch.float32
            losses.append(loss.item())
        return trainer, losses

    trainer, losses = port_two_steps("bf16")
    for p in (*trainer.model.parameters(), *trainer.ema_model.parameters()):
        assert p.dtype == torch.float32
    for state in trainer.optimizer.inner.state.values():
        assert all(v.dtype == torch.float32 for v in state.values()
                   if isinstance(v, torch.Tensor) and v.dim())
    # the losses, then the change the two steps made to the parameters and
    # the EMA (a trainer that applied no update is 1 away from JAX's)
    assert LOSS_BAR <= FORWARD_BAR[name] / 10
    for ref in (losses16, losses32):
        assert max_rel(losses, ref) <= LOSS_BAR, (losses, ref)
    start = flat(params, config)

    trainer32, _ = port_two_steps("none")
    for i, (what, ours, ours32, jax16, jax32) in enumerate((
            ("parameters", trainer.model, trainer32.model, p16, p32),
            ("EMA", trainer.ema_model, trainer32.ema_model, ema16, ema32))):
        ours, ours32 = (flat(m.state_dict(), config) - start
                        for m in (ours, ours32))
        assert np.abs(ours).max() > 0
        check_bar(TRAIN_BAR[name][i], f"{name} {what}", ours, ours32,
                  flat(jax16, config) - start, flat(jax32, config) - start,
                  distance=rel_norm)
