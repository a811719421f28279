"""The port's Mixture-of-Experts DiT against the JAX package's, on the CPU,
at tiny widths: `moe_capacity`, the routed `MoeMlp` (4 experts, top 2,
d 16) with and without capacity overflow and with top-k = E, its
load-balance loss, a MoE DiT (hidden 64, depth 2, 4 experts) forward, one
train step's loss with `moe_aux_weight` times the loss and its gradients,
also under remat, the weight bridge and checkpoints, and the train, sample
and serve entry points on a MoE config.

Inputs come from numpy with a seed and the JAX parameters are perturbed
(`torch_port_helpers.perturbed`), so the router's top-k choices are
distinct (each case checks the gap); dropout is 0 where a gradient is
taken. Bars, as max|port - jax| / max|jax|: 2e-4 for a forward and the
load-balance loss (the repo's forward bar), 1e-4 for a train step's loss
and its gradients (the two sides route alike, so their sums differ only in
order); bf16 as `tests/test_torch_port_bf16_models.py` holds the DiT.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import ddpm as jax_ddpm
from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.models import moe as jax_moe
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu_torch import factory, sample, serve, train
from diffusion_models_collection_tpu_torch.diffusion import DDPM
from diffusion_models_collection_tpu_torch.models import DiT
from diffusion_models_collection_tpu_torch.models.moe import (
    MoeMlp,
    moe_capacity,
)
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.trainer import (
    DiffusionTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    resolved_model_cfg,
    state_dict_from_jax,
)
from test_torch_port_bf16_models import check_bar
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIT_PARAMS,
    max_rel,
    one_torch_thread,
    perturbed,
    small_dit_config,
)

TOL = 2e-4
TOL_STEP = 1e-4
E, K, D, HID, S = 4, 2, 16, 32, 12
MOE = dict(num_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- capacity
@pytest.mark.parametrize("seq,experts,k,factor", [
    (256, 8, 2, 1.25), (4, 4, 2, 1.25), (1, 64, 1, 1.0), (12, 4, 2, 0.5),
    (12, 4, 2, 4.0), (179, 8, 2, 1.25), (64, 4, 4, 1.0)])
def test_moe_capacity_matches_jax(seq, experts, k, factor):
    assert moe_capacity(seq, experts, k, factor) == jax_moe.moe_capacity(
        seq, experts, k, factor)


# ------------------------------------------------------------------- layer
def jax_layer(k=K, factor=1.25, seed=0):
    """(flax MoeMlp, perturbed params, x (3, 12, 16))."""
    layer = jax_moe.MoeMlp(hidden_dim=HID, out_dim=D, num_experts=E,
                           top_k=k, capacity_factor=factor, dropout=0.0)
    x = np.random.default_rng(seed).standard_normal((3, S, D)).astype(
        np.float32)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return layer, perturbed(params, seed), x


def torch_layer(params, k=K, factor=1.25):
    layer = MoeMlp(D, HID, D, E, k, factor, dropout=0.0)
    state = {"router.weight": params["router"]["kernel"].T,
             "router.bias": params["router"]["bias"],
             **{n: params[n] for n in ("w1", "b1", "w2", "b2")}}
    layer.load_state_dict({n: torch.tensor(np.ascontiguousarray(v))
                           for n, v in state.items()}, strict=True)
    return layer.eval()


def run_both(layer, params, x, k, factor):
    ref, sown = jax.jit(lambda p, xx: layer.apply(
        {"params": p}, xx, mutable=["losses"]))(params, jnp.asarray(x))
    ours_layer = torch_layer(params, k, factor)
    with torch.no_grad():
        ours, loss = ours_layer(torch.from_numpy(x))
        routing = ours_layer.route(torch.from_numpy(x))
    sown = jax.tree_util.tree_leaves(sown["losses"])
    assert len(sown) == 1
    return ours.numpy(), np.asarray(ref), float(loss), float(sown[0]), routing


def assert_distinct_choices(layer, x):
    """The router's top-k and the next expert are apart by far more than
    the rounding, so torch.topk and lax.top_k choose alike."""
    with torch.no_grad():
        probs = torch.softmax(layer.router(torch.from_numpy(x)), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    gaps = top[..., :-1] - top[..., 1:]
    assert gaps[..., :min(K + 1, E - 1)].min() > 1e-5


@pytest.mark.parametrize("factor,overflow", [(1.25, None), (0.5, True),
                                             (4.0, False)])
def test_moe_mlp_matches_jax(factor, overflow):
    """The forward at a capacity factor that drops (token, slot)s (0.5: C 3
    for 24 slots), one that cannot (4.0: C 24 >= the 12 tokens an expert can
    get) and the config's 1.25; a token all of whose slots are dropped
    gives exactly 0."""
    layer, params, x = jax_layer(K, factor)
    assert_distinct_choices(torch_layer(params, K, factor), x)
    ours, ref, loss, sown, routing = run_both(layer, params, x, K, factor)
    assert ours.shape == ref.shape == (3, S, D)
    assert max_rel(ours, ref) <= TOL
    assert abs(loss - sown) <= TOL * abs(sown)
    cap = moe_capacity(S, E, K, factor)
    dropped = (routing[2] >= cap).numpy()
    if overflow is not None:
        assert dropped.any() == overflow
    gone = dropped.all(axis=-1)
    if overflow:
        assert gone.any()
    assert (ours[gone] == 0).all() and (ref[gone] == 0).all()


def test_moe_mlp_with_top_k_of_every_expert_is_the_dense_mixture():
    """top_k = E with room for every token: the output is sum_e p_e
    expert_e(x), computed by hand from the same parameters, as the JAX
    package's own test holds its module; and the JAX module's output."""
    layer, params, x = jax_layer(E, float(E), seed=3)
    ours, ref, loss, sown, _ = run_both(layer, params, x, E, float(E))
    tl = torch_layer(params, E, float(E))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        probs = torch.softmax(tl.router(xt), dim=-1)
        dense = sum(probs[..., e:e + 1] * (torch.nn.functional.gelu(
            xt @ tl.w1[e] + tl.b1[e]) @ tl.w2[e] + tl.b2[e])
            for e in range(E))
    np.testing.assert_allclose(ours, dense.numpy(), rtol=2e-5, atol=2e-6)
    assert max_rel(ours, ref) <= TOL
    assert abs(loss - sown) <= TOL * abs(sown)


def test_load_balance_loss_is_one_at_perfect_balance():
    """A router of zeros: every probability 1/E, and top-k over ties still
    spreads f over experts summing to 1, so E sum f_e / E = 1."""
    layer = MoeMlp(D, HID, D, E, K, 1.25, dropout=0.0)
    torch.nn.init.zeros_(layer.router.weight)
    with torch.no_grad():
        _, loss = layer(torch.randn(2, S, D))
    assert abs(float(loss) - 1.0) <= 1e-6


def test_moe_mlp_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="out_dim == model dim"):
        MoeMlp(D, HID, D + 1, E)
    with pytest.raises(ValueError, match="moe_top_k"):
        MoeMlp(D, HID, D, E, top_k=E + 1)


# ------------------------------------------------------------------- model
def jax_moe_dit(seed=0, dropout=0.1, **changes):
    """(flax MoE DiT, perturbed params, config): DIT_PARAMS with 4 experts,
    top 2, at 16x16 (L 64)."""
    cfg = dict(DIT_PARAMS, dropout=dropout, **MOE, **changes)
    model = JaxDiT(img_size=(16, 16), **cfg, num_classes=10)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1,), jnp.int32))["params"]
    config = small_dit_config(True, 16)
    config["model_params"] = dict(config["model_params"], **MOE, **changes,
                                  dropout=dropout)
    return model, perturbed(params, seed), config


@pytest.fixture(scope="module")
def moe16():
    return jax_moe_dit(seed=0)


def torch_moe_dit(params, config, **changes):
    model = DiT(**dict(config["model_params"], **changes), num_classes=10)
    model.load_state_dict(state_dict_from_jax(params, config), strict=True)
    return model.eval()


def inputs(seed=4, n=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            np.array([0, 10, 500, 999][:n], np.int64),
            np.array([1, 4, 7, 10][:n], np.int64))


def test_moe_dit_forward_and_load_balance_match_jax(moe16):
    model, params, config = moe16
    x, t, y = inputs()
    ref, sown = jax.jit(lambda p: model.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        jnp.asarray(y, jnp.int32), mutable=["losses"]))(params)
    losses = []
    with torch.no_grad():
        ours = torch_moe_dit(params, config)(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
            moe_losses=losses)
    assert ours.shape == (4, 16, 16, 3) and ours.dtype == torch.float32
    assert max_rel(ours.numpy(), np.asarray(ref)) <= TOL
    vals = jax.tree_util.tree_leaves(sown["losses"])
    assert len(vals) == 2 and len(losses) == 1
    want = float(sum(vals) / len(vals))
    assert abs(float(losses[0]) - want) <= TOL * want


def test_bridge_names_and_parameter_count(moe16):
    """The Flax `MoeMlp_0` lands on the port's own names, strict; the
    full-width config has the dense DiT's 32,573,964 parameters plus 12 x
    8,274,056 for the experts."""
    _, params, config = moe16
    sd = state_dict_from_jax(params, config)
    names = {k for k in sd if k.startswith("blocks.0.mlp.")}
    assert names == {f"blocks.0.mlp.{n}" for n in (
        "router.weight", "router.bias", "w1", "b1", "w2", "b2")}
    assert sd["blocks.0.mlp.router.weight"].shape == (4, 64)
    assert sd["blocks.0.mlp.w1"].shape == (4, 64, 256)
    cfg = resolved_model_cfg(dict(config, model_params=dict(
        config["model_params"])))
    assert {k: cfg[k] for k in MOE} == MOE
    full = factory.get_model(json.loads(json.dumps(
        _load_config("cifar10_dit_moe.py"))))
    assert sum(p.numel() for p in full.parameters()) == (
        32_573_964 + 12 * 8_274_056)


def _load_config(name):
    scope = {}
    exec((REPO / "configs" / name).read_text(), scope)
    return scope["config"]


# ------------------------------------------------------- loss and gradients
def batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
        labels=rng.integers(0, 10, n).astype(np.int64),
        t=rng.integers(0, 1000, n).astype(np.int64),
        noise=rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
        drop=rng.uniform(size=n) < 0.3)


def cfg_labels(b):
    return np.where(b["drop"], 0, b["labels"] + 1).astype(np.int64)


@pytest.fixture(scope="module")
def moe_step_ref():
    """The JAX trainer's loss for a MoE DiT (dropout 0): DDPM's eps-loss
    plus moe_aux_weight (0.01) times the mean sown load-balance loss, and
    its gradients, from `value_and_grad`."""
    model, params, config = jax_moe_dit(seed=1, dropout=0.0)
    ddpm = jax_ddpm.DDPM(num_timesteps=1000)
    b = batch(7)

    @jax.jit
    def value_and_grad(p):
        def loss_fn(pp):
            aux = []

            def model_fn(x, tt, yy):
                eps, sown = model.apply({"params": pp}, x, tt, yy,
                                        train=True, mutable=["losses"])
                vals = jax.tree_util.tree_leaves(sown["losses"])
                aux.append(sum(vals) / len(vals))
                return eps

            main = ddpm.p_losses(model_fn, b["x0"], b["t"].astype(np.int32),
                                 b["noise"], y=cfg_labels(b).astype(np.int32))
            return main + 0.01 * aux[0]
        return jax.value_and_grad(loss_fn)(p)

    loss, grads = value_and_grad(params)
    return params, config, b, float(loss), state_dict_from_jax(grads, config)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_and_gradients_match_jax(moe_step_ref, remat):
    params, config, b, loss_ref, grads_ref = moe_step_ref
    model = torch_moe_dit(params, config, remat=remat).train()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    losses = []
    loss = DDPM(num_timesteps=1000).p_losses(
        lambda x, t, y: model(x, t, y, moe_losses=losses), tb["x0"], tb["t"],
        tb["noise"], y=torch.from_numpy(cfg_labels(b)))
    loss = loss + 0.01 * losses[0]
    loss.backward()
    assert abs(float(loss) - loss_ref) <= TOL_STEP * abs(loss_ref)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_ref)
    for name, g in grads_ref.items():
        assert max_rel(named[name].grad, g) <= TOL_STEP, name
    # the router and the experts learn from the loss
    assert named["blocks.0.mlp.router.weight"].grad.abs().max() > 0


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_step_adds_the_weighted_load_balance_loss(moe_step_ref,
                                                          tmp_path, remat):
    """`DiffusionTrainer.train_step` returns the JAX trainer's loss with
    `moe_aux_weight` 0.01 (the default), and with 0 the plain eps-loss."""
    params, config, b, loss_ref, _ = moe_step_ref
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    got = {}
    for weight in (None, 0.0):
        cfg = dict(config, save_dir=str(tmp_path / "c"),
                   sample_dir=str(tmp_path / "s"), optimizer="adamw",
                   learning_rate=1e-4, use_ema=False, remat=remat)
        if weight is not None:
            cfg["moe_aux_weight"] = weight
        trainer = DiffusionTrainer(
            torch_moe_dit(params, config, remat=remat), DDPM(num_timesteps=1000),
            [], cfg, "cpu", tracker=_NullTracker())
        got[weight] = float(trainer.train_step(
            tb["x0"], tb["labels"], tb["t"], tb["noise"], tb["drop"]))
    assert abs(got[None] - loss_ref) <= TOL_STEP * abs(loss_ref)
    assert got[0.0] < got[None]  # the load-balance loss is about 1


class _NullTracker:
    def log(self, *args, **kwargs):
        pass

    def finish(self):
        pass


# ------------------------------------------------------------ checkpoints
def test_jax_checkpoint_and_port_pth_round_trip(moe16, tmp_path):
    """A JAX `.ckpt` of a MoE DiT loads through the bridge, strict; the
    port's `.pth` of it loads back into an equal model."""
    model, params, config = moe16
    opt_state = {"count": np.zeros((), np.int32)}
    jax_save_checkpoint(tmp_path / "m.ckpt", epoch=1, params=params,
                        opt_state=opt_state, best_loss=1.0, config=config,
                        ema_params=params)
    loaded = checkpoint.load_checkpoint(tmp_path / "m.ckpt")
    first = factory.load_model_for_inference(loaded, loaded["config"], True,
                                             torch.device("cpu"))
    checkpoint.save_checkpoint(tmp_path / "m.pth", first.state_dict(),
                               loaded["config"])
    again = checkpoint.load_checkpoint(tmp_path / "m.pth")
    second = factory.load_model_for_inference(again, again["config"], False,
                                              torch.device("cpu"))
    x, t, y = (torch.from_numpy(a) for a in inputs(seed=9, n=2))
    with torch.no_grad():
        assert torch.equal(first(x, t, y), second(x, t, y))


# ------------------------------------------------------------ entry points
def tiny_moe_config(tmp_path, **changes):
    """A synthetic 8x8 MoE DiT config (L 16, 4 experts, top 2) that trains
    in seconds on the CPU: 512 images at batch 128, one epoch."""
    config = {
        "model_type": "dit", "experiment_name": "tiny-dit-moe",
        "model_params": {"img_size": (8, 8), "patch_size": 2,
                         "in_channels": 3, "hidden_size": 32, "depth": 2,
                         "num_heads": 4, "mlp_ratio": 2.0, "dropout": 0.1,
                         **MOE},
        "moe_aux_weight": 0.01, "expert_parallel": 1,
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "num_timesteps": 20, "beta_start": 0.0001,
        "beta_end": 0.02, "beta_schedule": "linear", "loss_type": "l2",
        "cfg_scale": 1.4, "num_inference_steps": 5, "epochs": 1,
        "batch_size": 128, "num_workers": 0, "optimizer": "adamw",
        "learning_rate": 1e-3, "weight_decay": 1e-4, "use_ema": True,
        "ema_decay": 0.99, "cfg_dropout_prob": 0.2, "use_scheduler": True,
        "scheduler_type": "warmup_cosine", "warmup_epochs": 1,
        "save_dir": str(tmp_path / "ckpt"),
        "sample_dir": str(tmp_path / "samples"), "save_interval": 1,
        "sample_interval": 1, "sample_start_epoch": 1, "num_samples": 4,
        "seed": 42, **changes,
    }
    path = tmp_path / "moe.json"
    path.write_text(json.dumps(config))
    return str(path), config


@pytest.fixture(scope="module")
def trained_moe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    cfg_path, config = tiny_moe_config(tmp)
    trainer = train.main(["--config", cfg_path, "--device", "cpu"])
    return tmp, config, trainer


def test_train_takes_steps_and_resumes(trained_moe):
    tmp, config, trainer = trained_moe
    assert isinstance(trainer.model, DiT) and trainer.model.num_experts == 4
    assert trainer.moe_aux_weight == 0.01 and trainer.global_step == 4
    ckpt = Path(config["save_dir"]) / "current_model.pth"
    (tmp / "resumed").mkdir()
    cfg_path, _ = tiny_moe_config(tmp / "resumed", epochs=2,
                                  resume_path=str(ckpt))
    resumed = train.main(["--config", cfg_path, "--device", "cpu"])
    assert resumed.global_step == 8 and np.isfinite(resumed.best_loss)
    assert (Path(resumed.config["save_dir"]) / "current_model.pth").is_file()


def test_expert_parallel_still_names_its_item(tmp_path):
    """`expert_parallel: 2` through `train.main` in one process raises the
    JAX trainer's ValueError: the layout needs two devices (its steps:
    test_torch_port_expert_parallel.py)."""
    cfg_path, _ = tiny_moe_config(tmp_path, expert_parallel=2)
    with pytest.raises(ValueError, match="expert_parallel=2 does not divide "
                       "1 devices"):
        train.main(["--config", cfg_path, "--device", "cpu"])


def test_sample_and_serve_answer_from_a_moe_checkpoint(trained_moe):
    tmp, config, _ = trained_moe
    ckpt = Path(config["save_dir"]) / "current_model.pth"
    result = sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_inference_steps", "3", "--num_samples", "3", "--batch_size",
        "3", "--cfg_scale", "2", "--use_ema", "--device", "cpu",
        "--output_dir", str(tmp / "out")])
    assert result["samples"].shape == (3, 8, 8, 3)
    assert np.isfinite(result["samples"]).all()
    for continuous in (False, True):
        service = serve.SamplerService(str(ckpt), device="cpu", use_ema=True,
                                       num_inference_steps=3, batch_size=2,
                                       continuous=continuous)
        try:
            images = service.generate(num_samples=2, labels=[1, 3], seed=5)
        finally:
            service.close()
        assert images.shape == (2, 8, 8, 3) and np.isfinite(images).all()


# -------------------------------------------------------------------- bf16
# The MoE DiT's bf16 bar, measured as `tests/test_torch_port_bf16_models.py`
# measures its bars (port-vs-jax-bf16 8.24e-2, port-vs-jax-fp32 5.99e-2;
# JAX's own bf16-vs-fp32 8.26e-2) and held by its `check_bar` to at most
# twice JAX's own distance. It is ten times the dense DiT's 1.5e-2: the
# router runs in float32 on both sides, but its input is the block's bf16
# activations, and a token whose two best experts lie within bf16's
# rounding routes to another expert in bf16 than in float32, in JAX as in
# the port (the dense DiT's bar is `FORWARD_BAR["dit"]` there).
MOE_FORWARD_BAR = 0.1


def test_bf16_moe_dit_forward_within_the_dit_bar(moe16):
    """The MoE DiT in `mixed_precision: 'bf16'` (router float32 on both
    sides) against JAX's bf16 and float32 runs, by the DiT's bf16 rule, at
    the bar above."""
    model, params, config = moe16
    x, t, y = inputs()
    args = (jnp.asarray(x), jnp.asarray(t, jnp.int32),
            jnp.asarray(y, jnp.int32))
    jax32 = np.asarray(jax.jit(
        lambda p: model.apply({"params": p}, *args))(params))
    jax16 = np.asarray(jax.jit(lambda p: model.clone(
        dtype=jnp.bfloat16).apply({"params": p}, *args))(params))
    outs = {}
    for mp in ("bf16", "none"):
        m = factory.get_model(dict(config, mixed_precision=mp))
        m.load_state_dict(state_dict_from_jax(params, config), strict=True)
        with torch.no_grad():
            outs[mp] = m.eval()(*(torch.from_numpy(a) for a in (x, t, y)))
    assert outs["bf16"].dtype == torch.float32
    check_bar(MOE_FORWARD_BAR, "dit_moe", outs["bf16"].numpy(),
              outs["none"].numpy(), jax16, jax32)
