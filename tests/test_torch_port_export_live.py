"""The sampler export (`serving.py`) for the families and samplers whose
program is held to the port's live sampler, on the CPU: the MoE DiT, the
ToMe DiT, the int8 DiT and the bf16 UNet and DiT under DDIM with CFG, and
DPM-Solver++ (and its SDE form), UniPC, flow matching with Heun, EDM with
churn, DDIM with eta > 0 and DDPM with CFG on the UNet. Each exported
program, run on the same draws as the live sampler, must equal it bit for
bit: the same operations in the same order. The JAX parity of the export
is `tests/test_torch_port_export*.py`'s."""

import pytest
import torch

from diffusion_models_collection_tpu_torch import factory, serving
from test_torch_port_export import LABELS
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    small_config,
    small_dit_config,
)


def perturbed_model(config, seed):
    """The factory's model, every parameter moved by N(0, 0.05^2), so the
    adaLN-Zero layers are not zero."""
    torch.manual_seed(seed)
    model = factory.get_model(config).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def program_and_live(config, seed, method="ddim"):
    """(the exported program's images, the live sampler's) for one config
    on the same draws."""
    model = perturbed_model(config, seed)
    params = dict(model.named_parameters())
    blob = serving.export_sampler(model, params, config, batch_size=2,
                                  sampling_method=method, device="cpu")
    _, meta = serving.load_exported(blob)
    shape = tuple(meta["shape"])
    gen = torch.Generator().manual_seed(seed)
    x_T = torch.randn(shape, generator=gen)
    noises = (torch.randn((meta["draws"], *shape), generator=gen)
              if meta["draws"] else None)
    got = serving.run_exported(blob, params, None, LABELS, init_noise=x_T,
                               noises=noises, device="cpu")
    process = factory.get_diffusion(config, method)
    draws = {} if noises is None else {"noises": list(noises)}
    with torch.no_grad():
        if config.get("cfg_scale", 0.0) > 0:
            live = process.sample_with_cfg(
                model, shape, torch.from_numpy(LABELS),
                cfg_scale=config["cfg_scale"], init_noise=x_T, **draws)
        else:
            live = process.sample(model, shape, init_noise=x_T, **draws)
    return got, torch.clamp((live + 1.0) * 0.5, 0.0, 1.0)


DIT = small_dit_config(True)
FAMILIES = {
    "moe": dict(DIT, model_params=dict(DIT["model_params"], num_experts=4,
                                       moe_top_k=2)),
    "tome": dict(DIT, model_params=dict(DIT["model_params"],
                                        tome_ratio=0.5, tome_mlp=True)),
    "int8": dict(DIT, model_params=dict(DIT["model_params"], quant="int8")),
    "dit_bf16": dict(DIT, mixed_precision="bf16"),
    "unet_bf16": dict(small_config(True), mixed_precision="bf16"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_program_is_the_live_sampler(family):
    config = dict(FAMILIES[family], num_inference_steps=3, cfg_scale=3.0)
    got, live = program_and_live(config, seed=30)
    torch.testing.assert_close(got, live, rtol=0, atol=0)


BASE = dict(small_config(True), cfg_scale=3.0, num_inference_steps=2)
SAMPLERS = {
    "dpm++": (BASE, "dpm++"),
    "dpm++sde": (BASE, "dpm++sde"),
    "unipc": (BASE, "unipc"),
    "flow_heun": (dict(BASE, diffusion_type="flow_matching",
                       flow_solver="heun"), "ddim"),
    "edm_churn": (dict(BASE, diffusion_type="edm", s_churn=20.0, s_min=0.05,
                       s_max=50.0), "ddim"),
    "ddim_eta": (dict(BASE, ddim_eta=0.5), "ddim"),
    "ddpm_cfg": (dict(BASE, num_timesteps=5), "ddpm"),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_program_is_the_live_sampler(name):
    config, method = SAMPLERS[name]
    got, live = program_and_live(config, seed=45, method=method)
    torch.testing.assert_close(got, live, rtol=0, atol=0)
