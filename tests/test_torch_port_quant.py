"""The port's int8 (w8a8) inference against the JAX package's, on the CPU,
at tiny widths: `int8_matmul` (its int8 operands and int32 sums exactly, its
float32 result within 1e-6 of JAX's, also for calls of 16 rows or fewer,
which the port pads for the card's integer product), the weight cache, a
DiT (hidden 64, depth 2) with `quant='int8'` in float32 (2e-4, the repo's
forward bar, as max|port - jax| / max|jax|) and in bf16 (the DiT's bf16 bar
of `tests/test_torch_port_bf16_models.py`), the refusal in training mode,
and `sample --quantize int8` and `--tome_ratio --tome_mlp` through the
port's CLI, alone, together and in bf16.

Rounding to int8 is discontinuous: an activation whose value lies within
float32 rounding of a half step rounds up on one side and down on the
other, and a step of 1/127 of its row's largest value then runs through the
rest of the network. Upstream of every product the two sides differ at
float32 rounding (sums in other orders), so over the 10^5 activations of a
forward some round apart (JAX alone moves its output by 2e-3 when its input
moves by 1e-6; int8 itself moves it by 9e-3 from float). So the DiT cases
record JAX's int8 activations product by product, hold the port's to them
(equal but for values one step apart: at most 1 % of them; 2.3e-3 measured,
most downstream of an earlier product's flip), and
then run the port on JAX's integer activations, with its own scales, to
hold everything else to the float bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_collection_tpu.models import DiT as JaxDiT
from diffusion_models_collection_tpu.ops import quant as jax_quant
from diffusion_models_collection_tpu_torch import factory, sample
from diffusion_models_collection_tpu_torch.ops import quant
from diffusion_models_collection_tpu_torch.utils import checkpoint
from diffusion_models_collection_tpu_torch.utils.weights import (
    state_dict_from_jax,
)
from test_torch_port_bf16_models import FORWARD_BAR, check_bar
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    DIT_PARAMS,
    jax_dit,
    max_rel,
    one_torch_thread,
    torch_dit,
)

TOL = 2e-4


def jax_operands(x, w):
    """The JAX `int8_matmul`'s int8 operands and int32 sums, step by step
    as it computes them (w is (K, N), x (M, K))."""
    s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=0, keepdims=True) / 127.0,
                      1e-12)
    wq = jnp.clip(jnp.round(w / s_w), -127, 127).astype(jnp.int8)
    s_x = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0,
                      1e-12)
    xq = jnp.clip(jnp.round(x / s_x), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(wq), np.asarray(acc)


@pytest.mark.parametrize("rows,k,n", [(40, 64, 192), (5, 64, 96),
                                      (16, 32, 32), (17, 384, 1152)])
def test_int8_matmul_matches_jax(rows, k, n):
    """The accumulator exactly, the result within 1e-6 relative; 5 and 16
    rows take the padded call."""
    rng = np.random.default_rng(rows + k)
    x = (rng.standard_normal((rows, k)) * rng.uniform(0.1, 3, (rows, 1))
         ).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    xq_ref, wq_ref, acc_ref = jax_operands(jnp.asarray(x), jnp.asarray(w))
    xq, _ = quant.quantize_rows(torch.from_numpy(x))
    wq, _ = quant.quantize_rows(torch.from_numpy(np.ascontiguousarray(w.T)))
    np.testing.assert_array_equal(xq.numpy(), xq_ref)
    np.testing.assert_array_equal(wq.numpy().T, wq_ref)
    acc = quant.int8_accumulate(xq, wq)
    assert acc.dtype == torch.int32 and acc.shape == (rows, n)
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    got = quant.int8_matmul(torch.from_numpy(x),
                            torch.from_numpy(np.ascontiguousarray(w.T)))
    want = np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    assert max_rel(got.numpy(), want) <= 1e-6


def test_int8_linear_caches_the_weight_until_it_changes():
    weight = torch.nn.Parameter(torch.randn(32, 16))
    cache = quant.Int8Weights()
    first = cache.get(weight)
    assert cache.get(weight) is first
    with torch.no_grad():
        weight.mul_(2.0)  # an in-place update: quantized again
    second = cache.get(weight)
    assert second is not first
    assert torch.equal(second[0], first[0])
    assert torch.equal(second[1], 2 * first[1])
    x = torch.randn(3, 7, 16)
    out = quant.int8_linear(x, weight, torch.ones(32), torch.bfloat16, cache)
    assert out.shape == (3, 7, 32) and out.dtype == torch.bfloat16
    assert quant.int8_linear(x, weight, None, None).dtype == torch.float32


def test_check_quant_takes_int8_only():
    assert quant.check_quant(None) is None
    assert quant.check_quant("int8") == "int8"
    with pytest.raises(ValueError, match="Unknown quant mode"):
        quant.check_quant("int4")


@pytest.fixture(scope="module")
def cond16():
    return jax_dit(conditional=True, seed=0, size=16)


def inputs(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
            np.array([0, 10, 500, 999], np.int64),
            np.array([1, 4, 7, 10], np.int64))


def jax_forward(params, x, t, y, **fields):
    model = JaxDiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10, **fields)
    return np.asarray(jax.jit(lambda p: model.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        jnp.asarray(y, jnp.int32)))(params))


def jax_int8_run(monkeypatch, params, x, t, y, **fields):
    """JAX's int8 DiT, run eagerly, and the int8 activations of each of its
    products in call order."""
    recorded = []
    real = jax_quant.int8_matmul

    def recording(xx, w):
        xf = xx.astype(jnp.float32)
        s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
                          / 127.0, 1e-12)
        recorded.append(np.asarray(jnp.clip(jnp.round(xf / s_x), -127, 127)
                                   ).astype(np.int8).reshape(-1, xx.shape[-1]))
        return real(xx, w)

    monkeypatch.setattr(jax_quant, "int8_matmul", recording)
    model = JaxDiT(img_size=(16, 16), **DIT_PARAMS, num_classes=10,
                   quant="int8", **fields)
    out = model.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32))
    monkeypatch.setattr(jax_quant, "int8_matmul", real)
    return np.asarray(out), recorded


def port_int8_run(monkeypatch, model, x, t, y, jax_activations=None):
    """The port's int8 DiT and its int8 activations product by product;
    with `jax_activations`, each product takes JAX's instead of its own."""
    recorded = []
    real = quant.int8_accumulate

    def swapping(xq, wq):
        recorded.append(xq.numpy().copy())
        if jax_activations is not None:
            xq = torch.from_numpy(jax_activations[len(recorded) - 1])
        return real(xq, wq)

    monkeypatch.setattr(quant, "int8_accumulate", swapping)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, t, y)))
    monkeypatch.setattr(quant, "int8_accumulate", real)
    return out.numpy(), recorded


@pytest.mark.parametrize("tome_ratio", [0.0, 0.5])
def test_int8_dit_matches_jax(cond16, monkeypatch, tome_ratio):
    """The int8 DiT alone and composed with token merging: the same four
    products a block in the same order, the port's int8 activations JAX's
    but for values one step apart (at most 1 % of them), and on JAX's
    integer activations the output within the forward bar."""
    _, params, config = cond16
    x, t, y = inputs()
    ref, jax_acts = jax_int8_run(monkeypatch, params, x, t, y,
                                 tome_ratio=tome_ratio)
    model = torch_dit(params, config, quant="int8", tome_ratio=tome_ratio)
    _, own = port_int8_run(monkeypatch, model, x, t, y)
    assert len(own) == len(jax_acts) == 4 * DIT_PARAMS["depth"]
    apart = sum(int((a != b).sum()) for a, b in zip(own, jax_acts))
    total = sum(a.size for a in jax_acts)
    assert apart <= 1e-2 * total, (apart, total)
    assert all(np.abs(a.astype(int) - b).max() <= 1
               for a, b in zip(own, jax_acts))
    ours, _ = port_int8_run(monkeypatch, model, x, t, y, jax_acts)
    assert max_rel(ours, ref) <= TOL
    # int8 is not the float path: the output moved by the quantization
    assert max_rel(ours, jax_forward(params, x, t, y,
                                     tome_ratio=tome_ratio)) > 10 * TOL


def test_bf16_int8_dit_within_the_dit_bar(cond16, monkeypatch):
    """The int8 DiT in `mixed_precision: 'bf16'`: the products int8, their
    results cast to bf16, the rest as the bf16 DiT; held by the DiT's bf16
    rule against JAX's bf16 and float32 int8 runs, each port run on the
    integer activations of the JAX run of its precision."""
    _, params, config = cond16
    x, t, y = inputs()
    jax32, acts32 = jax_int8_run(monkeypatch, params, x, t, y)
    jax16, acts16 = jax_int8_run(monkeypatch, params, x, t, y,
                                 dtype=jnp.bfloat16)
    outs = {}
    for mp, acts in (("bf16", acts16), ("none", acts32)):
        cfg = dict(config, mixed_precision=mp, model_params=dict(
            config["model_params"], quant="int8"))
        m = factory.get_model(cfg)
        m.load_state_dict(state_dict_from_jax(params, config), strict=True)
        outs[mp] = port_int8_run(monkeypatch, m.eval(), x, t, y, acts)[0]
    assert outs["bf16"].dtype == np.float32
    check_bar(FORWARD_BAR["dit"], "dit_int8", outs["bf16"], outs["none"],
              jax16, jax32)


def test_int8_refuses_training_mode(cond16):
    _, params, config = cond16
    model = torch_dit(params, config, quant="int8", dropout=0.0).train()
    x, t, y = (torch.from_numpy(a) for a in inputs())
    with pytest.raises(ValueError, match="inference-only"):
        model(x, t, y)
    with pytest.raises(ValueError, match="Unknown quant mode"):
        torch_dit(params, config, quant="int4")


def sample_from(tmp_path, ckpt, *flags):
    return sample.main([
        "--checkpoint", str(ckpt), "--sampling_method", "ddim",
        "--num_inference_steps", "3", "--num_samples", "4", "--batch_size",
        "4", "--cfg_scale", "2", "--device", "cpu", "--output_dir",
        str(tmp_path / "out"), "--seed", "3", *flags])["samples"]


@pytest.mark.parametrize("flags", [
    ["--quantize", "int8"], ["--tome_ratio", "0.5", "--tome_mlp"],
    ["--tome_ratio", "0.3"],
    ["--quantize", "int8", "--tome_ratio", "0.5", "--tome_mlp"],
    ["--quantize", "int8", "--mixed_precision", "bf16"]])
def test_sample_cli_takes_quantize_and_tome(cond16, tmp_path, capsys, flags):
    """The port's `sample` with the root CLI's flags: the DiT runs with the
    fields they set (printed as the root CLI prints them) and its samples
    differ from the plain DiT's from the same seed."""
    _, params, config = cond16
    ckpt = tmp_path / "dit.pth"
    checkpoint.save_checkpoint(ckpt, torch_dit(params, config).state_dict(),
                               dict(config, num_timesteps=1000))
    plain = sample_from(tmp_path, ckpt)
    got = sample_from(tmp_path, ckpt, *flags)
    out = capsys.readouterr().out
    assert got.shape == (4, 16, 16, 3) and np.isfinite(got).all()
    assert not np.array_equal(got, plain)
    if "--quantize" in flags:
        assert "Quantized inference: int8" in out
    if "--tome_ratio" in flags:
        ratio = flags[flags.index("--tome_ratio") + 1]
        assert f"Token merging: ratio {ratio}" in out


@pytest.mark.parametrize("flags,message", [
    (["--quantize", "int8"], "--quantize int8 is implemented for DiT"),
    (["--tome_ratio", "0.5"], "--tome_ratio is a DiT token-merging knob")])
def test_sample_cli_refuses_them_off_the_dit(tmp_path, flags, message):
    from torch_port_helpers import small_config

    config = dict(small_config(), num_timesteps=10)
    ckpt = tmp_path / "unet.pth"
    checkpoint.save_checkpoint(ckpt, factory.get_model(config).state_dict(),
                               config)
    with pytest.raises(SystemExit, match=message):
        sample_from(tmp_path, ckpt, *flags)
