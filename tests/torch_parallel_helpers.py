"""Shared set-up of the parallel tests (`test_torch_port_parallel.py`,
`test_torch_port_fsdp.py`, `test_torch_port_tensor_parallel.py`,
`test_torch_port_sequence_parallel.py`,
`test_torch_port_dim_sequence_parallel.py`,
`test_torch_port_pipeline_parallel.py`,
`test_torch_port_expert_parallel.py`): the JAX package's sharded step (and
its sequence-parallel, pipeline and MoE steps) on its virtual CPU devices,
the port's ranks in a gloo world (`torch_parallel_jobs.py`, which imports no
JAX), and the bars.

Bars: against JAX, 2e-4 (max|port - jax| / max|jax|) for the losses and
the parameters, the bar of `test_torch_port_training.py`; against the
port's own one-device step, 1e-6 for the losses and 1e-5 for the
parameters and gradients. Adam's (and Adafactor's) first update moves an
element by about lr sign(g), so where a gradient element lies within float
noise of 0 (the key bias's, whose true gradient is 0, among them) two
orders of summation may move it by up to 2 lr an update: the parameters are
held to the bar over the elements whose first gradient is at least 1e-3 of
its tensor's largest, and to 2 lr a step everywhere
(`torch_port_helpers.check_first_adam_update`'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.parallel.fsdp import fsdp_shardings
from diffusion_models_collection_tpu.parallel.tensor_parallel import (
    data_model_mesh,
    tp_shardings,
)
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch.tools.dryrun_multichip import (
    launch,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)

TOL_JAX = 2e-4
TOL_LOSS = 1e-6
TOL_PARAMS = 1e-5
LR = 1e-4


def max_rel(ours, ref):
    ours = np.asarray(torch.as_tensor(ours).detach(), np.float64)
    ref = np.asarray(torch.as_tensor(ref).detach(), np.float64)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def train_config(config, tmp_path, **changes):
    """A training config on `config`'s model: AdamW at a constant 1e-4,
    EMA 0.9, CFG drop 0.2, checkpoints under `tmp_path`."""
    return dict(config, optimizer="adamw", learning_rate=LR,
                weight_decay=1e-4, use_scheduler=False, epochs=1,
                use_ema=True, ema_decay=0.9, cfg_dropout_prob=0.2,
                gradient_accumulation_steps=1, loss_type="l2",
                # the global batch (the tests' batches hold 4 rows), split
                # over the data-parallel ranks, as the JAX package reads it
                batch_size=4, save_dir=str(tmp_path / "ckpt"),
                sample_dir=str(tmp_path / "samples"), seed=0,
                progress=False, **changes)


def run_world(world, jobs, timeout=300):
    """The jobs in a gloo world of `world` processes: rank 0's results."""
    return launch(world, "torch_parallel_jobs.run_jobs", jobs,
                  timeout=timeout)[0]


def numpy_state(state_dict):
    return {k: np.asarray(v) for k, v in state_dict.items()}


def cfg_labels(batch):
    return np.where(batch["drop"], 0, batch["labels"] + 1).astype(np.int32)


def jax_sharded_steps(model, params, config, batches, dp, tp=1, fsdp=False,
                      min_size=None):
    """The JAX package's train step in pieces (the DDPM loss of `model`,
    its gradient, the Optax chain of `build_optimizer`) jitted over a (dp,
    tp) mesh of the virtual CPU devices, with the parameters placed by the
    JAX package's rules: Megatron over 'model' (`tp_shardings`, ZeRO over
    'data' too with `fsdp`), or ZeRO alone (`fsdp_shardings`), or
    replicated; the batch sharded over 'data'. Returns the losses and the
    parameters (numpy) after the steps."""
    mesh = data_model_mesh(dp, tp, jax.devices()[:dp * tp])
    if tp > 1:
        shardings = tp_shardings(mesh, params, zero=fsdp,
                                 zero_min_size=min_size)
    elif fsdp:
        shardings = fsdp_shardings(jax.sharding.Mesh(
            np.asarray(jax.devices()[:dp]), ("data",)), params, min_size)
    else:
        shardings = jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P()), params)
    p = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                               params, shardings)
    tx, _, _ = jax_build_optimizer(config, 1)
    opt_state = tx.init(p)
    ddpm = jax_ddpm.DDPM(num_timesteps=config["num_timesteps"])
    rows = NamedSharding(mesh, P("data"))

    @jax.jit
    def step(p, opt_state, x0, t, noise, y):
        def loss_fn(q):
            return ddpm.p_losses(
                lambda x, tt, yy: model.apply({"params": q}, x, tt, yy),
                x0, t, noise, y=y)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    losses = []
    for b in batches:
        args = [jax.device_put(jnp.asarray(a), rows) for a in (
            b["x0"], b["t"].astype(np.int32), b["noise"], cfg_labels(b))]
        p, opt_state, loss = step(p, opt_state, *args)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


def jax_sp_steps(model, params, config, batches, dp, sp, tp=1):
    """The JAX package's sequence-parallel train step
    (`make_sequence_parallel_apply`, or `make_dim_sequence_parallel_apply`
    for a DiM, as its trainer picks) jitted over a (dp, sp[, tp]) mesh of
    the virtual CPU devices, the parameters replicated (or placed by the
    Megatron rules at tp > 1, `shard_model_params`), dropout off: the
    losses and the parameters (numpy) after the steps."""
    from diffusion_models_collection_tpu.parallel import (
        make_dim_sequence_parallel_apply,
        make_sequence_parallel_apply,
    )
    from diffusion_models_collection_tpu.parallel import mesh as pmesh
    from diffusion_models_collection_tpu.parallel.sequence_parallel import (
        data_seq_mesh,
        data_seq_model_mesh,
    )
    from diffusion_models_collection_tpu.parallel.tensor_parallel import (
        shard_model_params,
    )

    if tp > 1:
        mesh = data_seq_model_mesh(dp, sp, tp, jax.devices()[:dp * sp * tp])
        p = shard_model_params(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                            params))
    else:
        mesh = data_seq_mesh(dp, sp, jax.devices()[:dp * sp])
        p = pmesh.replicate(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                         params))
    make = (make_dim_sequence_parallel_apply
            if type(model).__name__ == "DiM" else make_sequence_parallel_apply)
    apply_fn = make(model, mesh)
    tx, _, _ = jax_build_optimizer(config, 1)
    opt_state = tx.init(p)
    ddpm = jax_ddpm.DDPM(num_timesteps=config["num_timesteps"])
    rows = NamedSharding(mesh, P("data"))
    conditional = config.get("conditional", False)

    @jax.jit
    def step(p, opt_state, x0, t, noise, y):
        def loss_fn(q):
            return ddpm.p_losses(
                lambda x, tt, yy: apply_fn(q, x, tt, yy), x0, t, noise,
                y=y if conditional else None)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    losses = []
    for b in batches:
        args = [jax.device_put(jnp.asarray(a), rows) for a in (
            b["x0"], b["t"].astype(np.int32), b["noise"], cfg_labels(b))]
        p, opt_state, loss = step(p, opt_state, *args)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


def _jax_train(loss_of, p, config, batches, rows):
    """Adam steps (the Optax chain of `build_optimizer`) of the jitted
    `loss_of(params, x0, t, noise, y)` from `p` on `batches` placed by
    `rows`: the losses, the first step's gradients and the parameters
    after the steps (numpy)."""
    tx, _, _ = jax_build_optimizer(config, 1)
    opt_state = tx.init(p)

    @jax.jit
    def step(p, opt_state, *args):
        loss, grads = jax.value_and_grad(loss_of)(p, *args)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, grads

    losses, first = [], None
    for b in batches:
        args = [jax.device_put(jnp.asarray(a), rows) for a in (
            b["x0"], b["t"].astype(np.int32), b["noise"], cfg_labels(b))]
        p, opt_state, loss, grads = step(p, opt_state, *args)
        losses.append(float(loss))
        if first is None:
            first = jax.tree_util.tree_map(np.asarray, grads)
    return losses, first, jax.tree_util.tree_map(np.asarray, p)


def jax_pp_steps(model, params, config, batches, dp, pp, tp=1,
                 microbatches=None):
    """The JAX package's pipeline-parallel train step
    (`make_pipeline_apply` over its stacked-block tree, placed by
    `shard_pp_param_tree`: the blocks over 'stage', Megatron over 'model'
    at tp > 1) jitted over a (dp, pp[, tp]) mesh of the virtual CPU
    devices, dropout off: the losses and the parameters (numpy, the
    standard tree) after the steps."""
    from diffusion_models_collection_tpu.parallel import pipeline_parallel \
        as pp_lib

    devices = jax.devices()[:dp * pp * tp]
    mesh = (pp_lib.data_stage_model_mesh(dp, pp, tp, devices) if tp > 1
            else pp_lib.data_stage_mesh(dp, pp, devices))
    prefix, depth = pp_lib.block_prefix_for(model), model.depth
    tree = pp_lib.shard_pp_param_tree(mesh, pp_lib.to_pp_tree(
        jax.tree_util.tree_map(jnp.asarray, params), depth, prefix))
    apply_fn = pp_lib.make_pipeline_apply(model, mesh,
                                          num_microbatches=microbatches)
    ddpm = jax_ddpm.DDPM(num_timesteps=config["num_timesteps"])
    conditional = config.get("conditional", False)

    def loss_of(q, x0, t, noise, y):
        return ddpm.p_losses(
            lambda x, tt, yy: apply_fn(q["blocks"], q["rest"], x, tt, yy),
            x0, t, noise, y=y if conditional else None)

    losses, _, p = _jax_train(loss_of, tree, config, batches,
                              NamedSharding(mesh, P("data")))
    return losses, pp_lib.from_pp_tree(p, depth, prefix)


def jax_moe_steps(model, params, config, batches, dp, ep=1):
    """The JAX package's MoE DiT train step, DDPM's loss plus
    `moe_aux_weight` times the blocks' mean load-balance loss (its
    trainer's objective), jitted over its virtual CPU devices: a (dp,)
    data mesh with the parameters replicated (the data-parallel step), or
    at ep > 1 the (dp, ep) mesh with the expert weights over 'expert'
    (`shard_model_params`), the batch over both axes, traced under
    `jax.set_mesh` as its trainer does. Dropout off. The losses, the first
    step's gradients and the parameters (numpy) after the steps."""
    from diffusion_models_collection_tpu.parallel import expert_parallel
    from diffusion_models_collection_tpu.parallel import mesh as pmesh

    weight = float(config.get("moe_aux_weight", 0.01))
    ddpm = jax_ddpm.DDPM(num_timesteps=config["num_timesteps"])
    p = jax.tree_util.tree_map(jnp.asarray, params)
    if ep > 1:
        mesh = expert_parallel.data_expert_mesh(dp, ep,
                                                jax.devices()[:dp * ep])
        p = expert_parallel.shard_model_params(mesh, p)
        rows = NamedSharding(mesh, P(("data", "expert")))
    else:
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:dp]), ("data",))
        p = pmesh.replicate(mesh, p)
        rows = NamedSharding(mesh, P("data"))

    def loss_of(q, x0, t, noise, y):
        aux = []

        def model_fn(x, tt, yy):
            eps, sown = model.apply({"params": q}, x, tt, yy,
                                    mutable=["losses"])
            vals = jax.tree_util.tree_leaves(sown["losses"])
            aux.append(sum(vals) / len(vals))
            return eps

        main = ddpm.p_losses(model_fn, x0, t, noise, y=y)
        return main + weight * aux[0]

    with jax.set_mesh(mesh):
        return _jax_train(loss_of, p, config, batches, rows)


def check_against_jax(result, jax_losses, jax_params, config):
    """The port's sharded run against the JAX package's: losses and
    parameters at `TOL_JAX`, Adam's near-zero elements within 2 lr a step
    (the first gradient from the port's run)."""
    assert max_rel(result["losses"], jax_losses) <= TOL_JAX
    check_params(result, state_dict_from_jax(jax_params, config), TOL_JAX,
                 len(jax_losses))


def check_params(result, want, bar, steps, what="params", move=2 * LR):
    """`result[what]` against `want`, by name: at `bar` over the elements
    whose first gradient is decided, within `move` a step everywhere (2 lr
    for Adam; Adafactor's second update of an undecided element reaches lr
    / sqrt(1 - 2^-0.8), 1.32 lr, so 3 lr there)."""
    grads = result["grads"][0]
    for name, ref in want.items():
        got = torch.as_tensor(result[what][name]).double()
        ref = torch.as_tensor(np.asarray(ref)).double()
        g = grads[name].abs() if name in grads else None
        decided = (torch.ones_like(got, dtype=torch.bool) if g is None
                   else g >= 1e-3 * g.max())
        assert max_rel(got[decided], ref[decided]) <= bar, (what, name)
        assert (got - ref).abs().max().item() <= move * steps + 1e-6, (
            what, name)


def check_against_one_device(result, ref, what=("params", "ema"),
                             move=2 * LR):
    """A sharded run against the port's one-device run of the same job:
    losses at `TOL_LOSS`, every update's gradients and the parameters (and
    EMA) at `TOL_PARAMS` (`check_params`)."""
    assert max_rel(result["losses"], ref["losses"]) <= TOL_LOSS, (
        result["losses"], ref["losses"])
    assert len(result["grads"]) == len(ref["grads"])
    for got, want in zip(result["grads"], ref["grads"]):
        assert set(got) == set(want)
        for name in want:
            assert max_rel(got[name], want[name]) <= TOL_PARAMS, name
    for key in what:
        assert set(result[key]) == set(ref[key])
        check_params(result, ref[key], TOL_PARAMS, len(ref["losses"]), key,
                     move)
