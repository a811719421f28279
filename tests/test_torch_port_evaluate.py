"""The PyTorch port's evaluation entry point, `python -m
diffusion_models_collection_tpu_torch.evaluate`, on the CPU.

The parser is held to the root `evaluate.py`'s (the same flag names and
defaults but `--device`); its SystemExit rules raise the root's messages,
each found among the root source's string constants; what the port does
not have yet raises `NotImplementedError` naming its ROADMAP item; and two
runs of `main` on a tiny UNet trained on the committed CIFAR-10 fixtures
mirror the root CLI's tests (`tests/test_cli.py`): the metrics JSON's keys,
its relative-only labels, SWD by default without weights, the saved image
trees, and the exact key set with `--no_swd`.
"""

import argparse
import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import linalg
from threadpoolctl import threadpool_limits

from diffusion_models_collection_tpu_torch import evaluate, factory, train
from diffusion_models_collection_tpu_torch.diffusion import ConsistencyModel
from diffusion_models_collection_tpu_torch.utils import checkpoint
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    small_config,
    small_dim_config,
    small_dit_config,
)

REPO = Path(__file__).resolve().parent.parent
ROOT_EVALUATE = REPO / "evaluate.py"
FIXTURES = REPO / "tests" / "fixtures" / "data"


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """FID's scipy sqrtm at 2048x2048 takes about 15 s on one BLAS thread
    and 12 s on eight; under six test workers, eight threads each would
    oversubscribe the cores."""
    with threadpool_limits(1):
        yield


def root_evaluate_parser() -> argparse.ArgumentParser:
    """The root CLI's parser, rebuilt from the statements of its `main()`
    up to `parse_args`: importing `evaluate.py` itself would configure the
    JAX platform as a side effect."""
    tree = ast.parse(ROOT_EVALUATE.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = []
    for stmt in fn.body:
        if "parse_args" in ast.unparse(stmt):
            break
        body.append(stmt)
    body.append(ast.parse("result = parser").body[0])
    scope = {"argparse": argparse}
    exec(compile(ast.Module(body, []), "evaluate.py", "exec"), scope)
    return scope["result"]


def root_strings():
    """Every string constant of the root `evaluate.py` (implicit
    concatenations joined), and the literal parts of its f-strings."""
    return {node.value for node in ast.walk(ast.parse(ROOT_EVALUATE.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)}


def test_parser_matches_the_root_cli():
    ours = {a.dest: a for a in evaluate.build_parser()._actions}
    root = {a.dest: a for a in root_evaluate_parser()._actions}
    assert set(ours) == set(root)
    for dest, action in root.items():
        mine = ours[dest]
        assert mine.option_strings == action.option_strings, dest
        assert type(mine) is type(action), dest
        assert mine.choices == action.choices, dest
        assert mine.type == action.type, dest
        assert mine.required == action.required, dest
        if dest != "device":
            assert mine.default == action.default, dest
    assert ours["device"].default == "cuda" and root["device"].default == "tpu"


def save_random(tmp_path, config, name="model.pth"):
    """A .pth of `config`'s model with random weights."""
    torch.manual_seed(0)
    path = tmp_path / name
    checkpoint.save_checkpoint(path, factory.get_model(config).state_dict(),
                               config)
    return path


def unet_config(**changes):
    config = dict(small_config(), num_timesteps=10, dataset="cifar10",
                  data_root=str(FIXTURES))
    config.update(changes)
    return config


def run_main(ckpt, *flags):
    return evaluate.main(["--checkpoint", str(ckpt), "--device", "cpu",
                          "--num_samples", "4", "--batch_size", "2",
                          "--save_images_dir", "", *flags])


PAG_EPS = "PAG shifts the EPS prediction; this checkpoint predicts "
PAG_TYPES = ("PAG perturbs self-attention maps — implemented for UNet and DiT "
             "checkpoints, not ")


@pytest.mark.parametrize("model,changes,flags,message", [
    ("unet", {}, ["--pag_scale", "-1"], "--pag_scale must be >= 0"),
    ("unet", {"diffusion_type": "flow_matching"}, ["--pag_scale", "1"],
     "PAG extrapolates the VP family's eps predictions — not "
     "flow/edm/consistency checkpoints"),
    ("unet", {"diffusion_type": "consistency"}, ["--pag_scale", "1"],
     "PAG extrapolates the VP family's eps predictions — not "
     "flow/edm/consistency checkpoints"),
    ("unet", {"prediction_type": "v"}, ["--pag_scale", "1"], PAG_EPS),
    ("dim", {}, ["--pag_scale", "1"], PAG_TYPES),
    ("unet", {"model_params": dict(small_config()["model_params"],
                                   use_attention=False)},
     ["--pag_scale", "1"], "PAG perturbs attention maps — this UNet was "
     "built with use_attention: false"),
    ("dit", {}, ["--freeu", "1,1,1,1"], "--freeu applies to UNet checkpoints"),
    ("unet", {}, ["--freeu", "1,2,x,4"],
     "--freeu expects four floats: b1,b2,s1,s2"),
    ("unet", {}, ["--freeu", "1,2,3"],
     "--freeu expects four floats: b1,b2,s1,s2"),
    ("unet", {}, ["--num_inference_steps", "4"],
     "--num_inference_steps has no effect with the default DDPM eval "
     "protocol (always full-step) — pass --sampling_method ddim or dpm++ to "
     "use it"),
    ("unet", {}, ["--tome_ratio", "0.5"],
     "--tome_ratio applies to DiT checkpoints"),
    ("dim", {}, ["--quantize", "int8"],
     "--quantize applies to DiT checkpoints"),
    ("classifier", {}, [],
     "this is a noise-conditional CLASSIFIER checkpoint — it has no sampler "
     "to evaluate (it guides sample.py via --classifier_checkpoint)"),
])
def test_system_exit_rules_match_the_root_cli(tmp_path, model, changes,
                                              flags, message):
    """Each rule raises SystemExit with the root CLI's message (for PAG's
    prediction and model-type rules, its literal prefix)."""
    if model == "classifier":
        config = unet_config(model_type="classifier")
        ckpt = tmp_path / "classifier.pth"
        checkpoint.save_checkpoint(ckpt, {}, config)
    else:
        base = {"unet": unet_config, "dim": small_dim_config,
                "dit": small_dit_config}[model]
        ckpt = save_random(tmp_path, dict(base(), **changes))
    assert message in root_strings()
    with pytest.raises(SystemExit) as err:
        run_main(ckpt, *flags)
    assert str(err.value).startswith(message)


# consistency checkpoints, which raised until they were ported, evaluate
# with their own sampler (the DiT's ToMe, int8 and MoE: the next test)
@pytest.mark.parametrize("model,changes,flags,steps", [
    ("unet", {"diffusion_type": "consistency",
              "num_inference_steps": 2}, ["--cfg_scale", "2"], 2),
])
def test_what_is_not_ported_raises_naming_its_item(tmp_path, monkeypatch,
                                                   model, changes, flags,
                                                   steps):
    """The default protocol's DDPM and `--sampling_method ddim` both give
    way to the checkpoint's consistency sampler at its step count, or at
    `--num_inference_steps` (the root CLI allows it for consistency
    checkpoints); the images reach the metrics (stubbed)."""
    seen = []
    monkeypatch.setattr(evaluate, "calculate_all_metrics",
                        lambda real, fake, **kw: seen.append(fake) or {})
    calls = []
    real_run = ConsistencyModel._run
    monkeypatch.setattr(ConsistencyModel, "_run", lambda self, *a, **kw: (
        calls.append(self.num_inference_steps), real_run(self, *a, **kw))[1])
    base = {"unet": unet_config, "dit": small_dit_config}[model]()
    ckpt = save_random(tmp_path, dict(base, **changes))
    flags = [*flags, "--output", str(tmp_path / "metrics.json")]
    run_main(ckpt, *flags)
    run_main(ckpt, *flags, "--sampling_method", "ddim",
             "--num_inference_steps", "1")
    assert calls == [steps, steps, 1, 1]  # two batches a run
    for fake in seen:
        assert fake.shape == (4, 16, 16, 3) and np.isfinite(fake).all()


@pytest.mark.parametrize("changes,flags", [
    ({}, ["--tome_ratio", "0.5", "--tome_mlp"]),
    ({}, ["--quantize", "int8", "--tome_ratio", "0.3"]),
    ({"num_experts": 4}, []),
])
def test_tome_int8_and_moe_dits_evaluate(tmp_path, monkeypatch, changes,
                                         flags):
    """`evaluate` generates through a DiT with token merging, int8
    products and both, and from a MoE DiT's checkpoint, and hands the
    images to the metrics (stubbed here: the metric networks have tests of
    their own)."""
    seen = []

    def metrics_stub(real, fake, **kwargs):
        seen.append(fake)
        return {"stub": float(fake.mean())}

    monkeypatch.setattr(evaluate, "calculate_all_metrics", metrics_stub)
    base = small_dit_config(size=8)
    config = dict(base, num_timesteps=10, dataset="cifar10",
                  data_root=str(FIXTURES), model_params=dict(
                      base["model_params"], **changes))
    ckpt = save_random(tmp_path, config)
    report = run_main(ckpt, "--sampling_method", "ddim",
                      "--num_inference_steps", "2", "--cfg_scale", "2",
                      "--output", str(tmp_path / "m.json"), *flags)
    assert len(seen) == 1 and seen[0].shape == (4, 8, 8, 3)
    assert np.isfinite(seen[0]).all() and math.isfinite(report["stub"])


def test_device_cuda_raises_where_cuda_is_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--checkpoint", str(tmp_path / "none.pth")])


# ------------------------------------------------- runs on a trained UNet
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny conditional UNet at 8x8 trained two epochs on the committed
    CIFAR-10 fixtures (200 images, batch 32, T 50) by the port's `train`."""
    tmp = tmp_path_factory.mktemp("trained")
    config = unet_config(
        image_size=(8, 8), num_timesteps=50,
        model_params=dict(small_config()["model_params"], image_size=(8, 8),
                          model_channels=16, attention_resolutions=(4,)),
        loss_type="l2", epochs=2, batch_size=32, num_workers=0,
        optimizer="adamw", learning_rate=1e-3, weight_decay=0.0,
        use_ema=True, ema_decay=0.9, cfg_dropout_prob=0.2,
        use_scheduler=False, save_dir=str(tmp / "ckpt"),
        sample_dir=str(tmp / "samples"), save_interval=2,
        sample_start_epoch=100, seed=42)
    path = tmp / "config.json"
    path.write_text(json.dumps(config))
    train.main(["--config", str(path), "--device", "cpu"])
    return tmp


def test_evaluate_cli(trained, capsys):
    """The root CLI's default-metrics run: --use_ema --cfg_scale 1.5, DDPM
    over all 50 steps, 16 samples; SWD on by default (no weights), the
    random-feature metrics labelled relative-only, precision/recall skipped
    at N 16, no NaN, the image trees written."""
    out_json = trained / "metrics.json"
    report = evaluate.main([
        "--checkpoint", str(trained / "ckpt" / "best_model.pth"),
        "--num_samples", "16", "--batch_size", "8", "--use_ema",
        "--cfg_scale", "1.5", "--device", "cpu", "--output", str(out_json),
        "--save_images_dir", str(trained / "eval_imgs")])
    metrics = json.loads(out_json.read_text())
    assert metrics == report
    assert {"FID", "KID_mean", "KID_std", "IS_mean", "IS_std",
            "LPIPS_diversity", "swd_avg", "swd_8x8",
            "uncalibrated_relative_only"} <= set(metrics)
    assert "precision" not in metrics and "recall" not in metrics
    assert metrics["uncalibrated_relative_only"] == [
        "FID", "KID_mean", "KID_std", "IS_mean", "IS_std", "LPIPS_diversity"]
    assert all(math.isfinite(v) for k, v in metrics.items()
               if k != "uncalibrated_relative_only")
    for sub, prefix in (("real", "real"), ("generate", "generate")):
        assert len(list((trained / "eval_imgs" / sub).glob("*.png"))) == 16
        assert (trained / "eval_imgs" / f"{prefix}_grid_1.png").is_file()
    out = capsys.readouterr().out
    assert "Using EMA model" in out and "Results saved" in out
    assert "swd_* are the calibrated values." in out


def test_evaluate_cli_fast_sampler(trained, capsys, monkeypatch):
    """--sampling_method ddim --num_inference_steps 4 --no_swd: the exact
    key set of the root CLI's test, and its note. FID's host sqrtm, whose
    value this test does not read (the run above computes it), is replaced
    by a cheap stand-in."""
    monkeypatch.setattr(linalg, "sqrtm", lambda m: np.eye(len(m)))
    out_json = trained / "metrics_ddim.json"
    evaluate.main([
        "--checkpoint", str(trained / "ckpt" / "best_model.pth"),
        "--num_samples", "16", "--batch_size", "8", "--sampling_method",
        "ddim", "--num_inference_steps", "4", "--no_swd", "--device", "cpu",
        "--output", str(out_json), "--save_images_dir", ""])
    metrics = json.loads(out_json.read_text())
    assert set(metrics) == {"FID", "KID_mean", "KID_std", "IS_mean",
                            "IS_std", "LPIPS_diversity",
                            "uncalibrated_relative_only",
                            "precision_recall_skipped_below_n"}
    assert "evaluating with ddim sampling" in capsys.readouterr().out
