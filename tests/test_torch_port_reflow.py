"""The PyTorch port's reflow against the JAX package, on the CPU:
`ReflowTrainer`'s pair synthesis (the couplings of the teacher's own
sampler from their z, guided and not), one step against JAX's on the same
pairs and draws, the port's `tools/reflow.py` end to end over two rounds
(`reflow_rounds_done`, 1-step sampling of the result), and the
validations' messages. Teachers are JAX `.ckpt`s of the small UNet with
perturbed weights, or a flow-matching UNet trained by the port's `train`.

Bars: synthesized pairs equal the sampler's run from their z; the step's
loss and every gradient 2e-4 (max-rel, the forward bar), the updated
student and EMA 2e-4 where the gradient decides Adam's first update
(`torch_port_helpers.check_first_adam_update`), 2 lr elsewhere.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_models_collection_tpu.diffusion import base as jax_base
from diffusion_models_collection_tpu.diffusion.flow_matching import (
    FlowMatching as JaxFlowMatching,
)
from diffusion_models_collection_tpu.diffusion.flow_matching import (
    interpolate as jax_interpolate,
)
from diffusion_models_collection_tpu.utils import reflow_trainer as jax_rt
from diffusion_models_collection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from diffusion_models_collection_tpu.utils.ema import (
    gated_ema_update as jax_gated_ema_update,
)
from diffusion_models_collection_tpu.utils.trainer import (
    build_optimizer as jax_build_optimizer,
)
from diffusion_models_collection_tpu_torch import sample, train
from diffusion_models_collection_tpu_torch.diffusion import FlowMatching
from diffusion_models_collection_tpu_torch.tools import reflow as tool
from diffusion_models_collection_tpu_torch.utils.reflow_trainer import (
    ReflowTrainer,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    H,
    W,
    check_first_adam_update,
    max_rel,
    one_torch_thread,
    recording_gradients,
    traced_unet,
)

B = 4


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """JAX `.ckpt`s of the small UNet (dropout 0, perturbed weights) as a
    flow-matching teacher, conditional and not, and as a DDPM one:
    (paths, params, flax model, flow config)."""
    model, params, config = traced_unet(seed=6)
    _, uncond_params, uncond_config = traced_unet(conditional=False, seed=6)
    changes = dict(diffusion_type="flow_matching", num_inference_steps=50,
                   model_params=dict(config["model_params"], dropout=0.0))
    flow = dict(config, **changes)
    root = tmp_path_factory.mktemp("teachers")
    paths = {}
    for name, p, cfg in (
            ("flow", params, flow),
            ("unconditional", uncond_params, dict(uncond_config, **changes)),
            ("vp", params, dict(flow, diffusion_type="ddpm"))):
        paths[name] = root / f"{name}.ckpt"
        jax_save_checkpoint(paths[name], epoch=1, params=p, opt_state=None,
                            best_loss=1.0, config=cfg)
    return paths, params, model, flow


def reflow_config(tmp_path, teacher_path, **changes):
    return dict(dict(
        teacher_checkpoint=str(teacher_path), reflow_pairs=2 * B,
        pair_batch_size=B, teacher_sample_steps=3, epochs=1,
        optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        use_scheduler=False, ema_decay=0.9, save_dir=str(tmp_path / "reflow"),
        seed=0), **changes)


@pytest.mark.parametrize("which,cfg_scale", [("unconditional", 0.0),
                                             ("flow", 0.0), ("flow", 3.0)])
def test_pairs_are_the_teacher_samplers_couplings_of_their_z(
        teachers, tmp_path, which, cfg_scale):
    paths = teachers[0]
    trainer = ReflowTrainer(reflow_config(tmp_path, paths[which],
                                          reflow_cfg_scale=cfg_scale), "cpu")
    teacher = trainer.student.eval()
    x_hat, z, y = trainer.synthesize_pairs(teacher)
    assert x_hat.shape == z.shape == (2 * B, H, W, 3)
    conditional = which == "flow"
    assert ((1 <= y) & (y <= 10)).all() if conditional else not y.any()
    flow = FlowMatching(num_timesteps=1000, num_inference_steps=3)
    for rows in (slice(0, B), slice(B, 2 * B)):
        if cfg_scale:
            ref = flow.sample_with_cfg(teacher, z[rows].shape, y[rows],
                                       cfg_scale=cfg_scale,
                                       init_noise=z[rows])
        else:
            ref = flow.sample(teacher, z[rows].shape,
                              y=y[rows] if conditional else None,
                              init_noise=z[rows])
        torch.testing.assert_close(x_hat[rows], ref, rtol=0, atol=0)
    assert (x_hat - z).abs().max().item() > 1e-3


def test_one_reflow_step_matches_jax(teachers, tmp_path):
    paths, params, model, flow_cfg = teachers
    config = reflow_config(tmp_path, paths["flow"])
    rng = np.random.default_rng(0)
    x_hat = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    z = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    y = rng.integers(1, 11, B)
    t = np.array([0, 999, 400, 77])
    tx, _, _ = jax_build_optimizer(config, 1)
    jflow = JaxFlowMatching(num_timesteps=1000)

    @jax.jit
    def step(p):
        x_t = jax_interpolate(x_hat, jflow.tau_of_t(t), z)

        def loss_fn(pp):
            v = model.apply({"params": pp}, x_t, t, y.astype(np.int32))
            return jax_base.diffusion_loss(z - x_hat, v, "l2")
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, tx.init(p), p)
        new = optax.apply_updates(p, updates)
        return (loss, grads, new,
                jax_gated_ema_update(tx, opt_state, p, new, 0.9))

    loss_ref, grads_ref, p_ref, ema_ref = step(jax.tree_util.tree_map(
        jnp.asarray, params))
    trainer = ReflowTrainer(config, "cpu")
    trainer.start(trainer.student, 1, 0.9)
    grads = recording_gradients(trainer)
    loss = trainer.train_step(torch.from_numpy(x_hat), torch.from_numpy(z),
                              torch.from_numpy(y), torch.from_numpy(t))
    assert max_rel(loss, loss_ref) <= 2e-4
    for name, want in state_dict_from_jax(grads_ref, flow_cfg).items():
        assert max_rel(grads[name], want) <= 2e-4, name
    for what, ours, ref in (("student", trainer.model, p_ref),
                            ("ema", trainer.ema_model, ema_ref)):
        check_first_adam_update(what, ours.state_dict(),
                                state_dict_from_jax(ref, flow_cfg), grads,
                                1e-3)


def test_reflow_tool_runs_two_rounds_and_sample_runs_one_step(tmp_path):
    teacher = {
        "model_type": "unet",
        "model_params": {"image_size": (8, 8), "in_channels": 3,
                         "model_channels": 16, "out_channels": 3,
                         "num_res_blocks": 1, "attention_resolutions": (4,),
                         "dropout": 0.1, "channel_mult": (1, 2),
                         "use_attention": True},
        "dataset": "synthetic", "image_size": (8, 8), "conditional": True,
        "num_classes": 10, "diffusion_type": "flow_matching",
        "num_timesteps": 20, "beta_start": 0.0001, "beta_end": 0.02,
        "beta_schedule": "linear", "num_inference_steps": 8, "epochs": 1,
        "batch_size": 128, "num_workers": 0, "optimizer": "adamw",
        "learning_rate": 1e-3, "use_ema": True, "ema_decay": 0.9,
        "sample_start_epoch": 10, "save_dir": str(tmp_path / "teacher"),
        "seed": 0}
    path = tmp_path / "teacher.json"
    path.write_text(json.dumps(teacher))
    train.main(["--config", str(path), "--device", "cpu"])
    config = {"teacher_checkpoint": str(tmp_path / "teacher" /
                                        "current_model.pth"),
              "reflow_pairs": 100, "pair_batch_size": 64,
              "teacher_sample_steps": 4, "reflow_cfg_scale": 2.0,
              "reflow_rounds": 2, "epochs": 2, "optimizer": "lion",
              "learning_rate": 1e-4, "save_dir": str(tmp_path / "reflow"),
              "seed": 0}
    path = tmp_path / "reflow.json"
    path.write_text(json.dumps(config))
    trainer = tool.main(["--config", str(path), "--device", "cpu"])
    assert trainer.n_pairs == 128 and trainer.global_step == 2 * 2 * 2
    for rnd in (1, 2):
        cfg = torch.load(tmp_path / "reflow" / f"reflow_round{rnd}.pth",
                         weights_only=True)["config"]
        assert (cfg["reflow_rounds_done"], cfg["diffusion_type"]) == (
            rnd, "flow_matching")
    result = sample.main([
        "--checkpoint", str(tmp_path / "reflow" / "reflow_round2.pth"),
        "--num_inference_steps", "1", "--num_samples", "3",
        "--batch_size", "3", "--cfg_scale", "2", "--use_ema", "--device",
        "cpu", "--output_dir", str(tmp_path / "s")])
    assert result["samples"].shape == (3, 8, 8, 3)
    assert np.isfinite(result["samples"]).all()


@pytest.mark.parametrize("which,changes", [
    ("vp", {}),
    ("unconditional", {"reflow_cfg_scale": 2.0}),
    ("flow", {"reflow_pairs": 2, "pair_batch_size": 8}),
    ("flow", {"reflow_rounds": 0}),
])
def test_validation_matches_jax(teachers, tmp_path, which, changes):
    config = reflow_config(tmp_path, teachers[0][which], **changes)
    with pytest.raises(ValueError) as ref:
        jax_rt.ReflowTrainer(config)
    with pytest.raises(ValueError) as ours:
        ReflowTrainer(config, "cpu")
    assert str(ours.value) == str(ref.value)


def test_pair_count_rounds_up_as_in_jax(teachers, tmp_path):
    config = reflow_config(tmp_path, teachers[0]["flow"], reflow_pairs=10,
                           pair_batch_size=8)
    assert ReflowTrainer(config, "cpu").n_pairs == jax_rt.ReflowTrainer(
        config, tracker=jax_rt.NullTracker()).n_pairs == 16
