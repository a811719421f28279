"""Ahead-of-time export of samplers for serving.

Counterpart of `diffusion_models_collection_tpu/serving.py`: the whole
trajectory (schedule, classifier-free guidance, the denoiser, the optional
latent decode and the clip to [0, 1]) becomes one program, serialised with
`torch.export` so that a serving binary loads the bytes and generates with
no Python model code, no checkpoint parsing and no retracing.

    blob = export_sampler(model, params, config, batch_size=64)
    Path("sampler.pt2").write_bytes(blob)
    ...
    samples = run_exported(blob, params, generator, labels)

As in JAX, the parameters are an input of the program and not constants:
one blob runs any checkpoint of its config (`params` maps each parameter's
name in `model.named_parameters()` to its tensor; a `state_dict` does). The
frozen VAE of a latent config rides inside as constants, as JAX's closure
constants do. The noise is an input too, because the port's generators
cannot reproduce JAX's: `x_T` and, where the sampler draws per step (DDPM,
DDIM with eta > 0, DPM-Solver++ SDE, EDM with churn, the consistency
sampler's re-noising), one draw a step stacked as `noises`. `run_exported`
draws them from the caller's `torch.Generator` on the program's device when
they are not passed. Labels use the +1 convention, 0 the null label.

DDIM and DDPM trace their step once: the program runs it inside
`torch._higher_order_ops.scan` over the grid's timesteps (and draws), with
the sampler's own `guided_eps_x0` and `step`, the code of its live loop,
so their export time does not grow with the step count. The other samplers
(DPM-Solver++, UniPC, flow matching, EDM, consistency) are exported through
their own `sample`/`sample_with_cfg`, unrolled: each step's model call is
traced anew, so their export time grows with the steps. The kernels are
the `torch.library` operators of `ops/_library.py`, which the tracer sees
as single nodes; `run_exported` imports them before it loads a blob.

Both functions run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import io
import json
import time
from typing import Mapping, Optional

import torch
from torch import nn

from .diffusion import (DDIM, DDPM, ConsistencyModel, DPMSolverPP, EDM,
                        UniPC)
from .diffusion import NoiseSchedule
from .diffusion.dpm_solver import alpha_sigma_lambda
from .factory import get_diffusion
# the kernels' operators, registered as these modules load: a loaded
# program calls them by name
from .ops import flash_attention, fused_norm, selective_scan  # noqa: F401
from .utils.helpers import resolve_image_size
from .utils.latent import LatentCodec

# the blob's own description of the program, beside the serialised graph
META = "dmc_sampler.json"


def _draw_count(diffusion) -> int:
    """How many per-step draws of the sample's shape the sampler takes."""
    if isinstance(diffusion, DDPM):
        return diffusion.num_timesteps
    if isinstance(diffusion, DDIM):
        return diffusion.num_inference_steps if diffusion.eta > 0 else 0
    if isinstance(diffusion, DPMSolverPP):
        return diffusion.num_inference_steps if diffusion.sde else 0
    if isinstance(diffusion, EDM):
        rows = diffusion.rows
        return len(rows) if (rows[:, 1] > rows[:, 0]).any() else 0
    if isinstance(diffusion, ConsistencyModel):
        return len(diffusion.inference_timesteps) - 1
    return 0


def _scanned_vp(diffusion, model, params, labels, x_T, noises,
                cfg_scale: Optional[float]):
    """DDIM's or DDPM's trajectory from x_T with the step traced once: the
    scan operator over the sampler's (t, t_next) pairs (`timestep_pairs`,
    broadcast to the batch) and draws, each step the sampler's own `step`
    through its `guided_eps_x0`. The step is a closed function: what it
    reads from outside (the parameters, the labels, the schedule) comes in
    as the scan's inputs, the schedule as copies made inside the trace (the
    scan refuses a constant, a real tensor among the traced ones), which
    the step hands to the sampler."""
    from torch._higher_order_ops.scan import scan_op

    device, batch = x_T.device, x_T.shape[0]
    names = list(params)
    fields = [f.name for f in dataclasses.fields(NoiseSchedule)]
    schedule = diffusion.schedule_on(device)
    rows = [torch.tensor(ts, device=device)[:, None].expand(-1, batch)
            .contiguous() for ts in diffusion.timestep_pairs()]
    if noises is not None:
        rows.append(noises)
    inputs = [*params.values(), *(getattr(schedule, f).clone()
                                  for f in fields), labels]

    def step(x, t, t_next, *rest):
        noise = None
        if noises is not None:
            noise, *rest = rest
        weights = dict(zip(names, rest))
        sched = NoiseSchedule(**dict(zip(fields, rest[len(names):])))

        def model_fn(x, t, y=None):
            return torch.func.functional_call(model, weights, (x, t, y))

        eps_x0 = diffusion.guided_eps_x0(
            model_fn, device, rest[-1] if cfg_scale is not None else None,
            cfg_scale, schedule=sched)
        return [diffusion.step(sched, x, t, t_next, noise, eps_x0)]

    return scan_op(step, [x_T], rows, tuple(inputs))[0]


def _sample(diffusion, model, params, shape, labels, x_T, noises,
            cfg_scale: Optional[float]):
    """The sampler's trajectory from x_T (and the draws `noises`), with
    classifier-free guidance at `cfg_scale`, or unguided when it is None."""
    if isinstance(diffusion, (DDIM, DDPM)):
        return _scanned_vp(diffusion, model, params, labels, x_T, noises,
                           cfg_scale)

    def model_fn(x, t, y=None):
        return torch.func.functional_call(model, params, (x, t, y))

    draws = {} if noises is None else {"noises": list(noises.unbind(0))}
    if cfg_scale is not None:
        return diffusion.sample_with_cfg(model_fn, shape, labels,
                                         cfg_scale=cfg_scale, init_noise=x_T,
                                         **draws)
    return diffusion.sample(model_fn, shape, init_noise=x_T, **draws)


def _build_sampler_fn(model: nn.Module, config: dict, batch_size: int,
                      sampling_method: str, cfg_scale: float, device):
    """A (params, x_T, labels, noises) -> images function with everything
    else fixed, the sample's shape and the sampler's draws a run."""
    if config.get("super_resolution"):
        raise ValueError(
            "super-resolution checkpoints are not exportable as "
            "self-contained samplers: they need a per-call LR "
            "conditioning input (use sample.py --sr_source)"
        )
    diffusion = get_diffusion(config, sampling_method=sampling_method)
    if isinstance(diffusion, (DPMSolverPP, UniPC)):
        alpha_sigma_lambda(diffusion.schedule)  # host scalars, before tracing
    # latent diffusion: sample latents, decode inside the exported program
    # (the frozen VAE rides along as constants)
    codec = LatentCodec.from_config(config, device=device)
    if codec is not None:
        shape = codec.latent_shape(batch_size)
    else:
        h, w = resolve_image_size(config["image_size"])
        in_ch = config["model_params"]["in_channels"]
        shape = (batch_size, h, w, in_ch)
    guided = bool(config.get("conditional", False)) and cfg_scale > 0
    guidance = float(cfg_scale) if guided else None

    def sampler(params, x_T, labels, noises):
        out = _sample(diffusion, model, params, shape, labels, x_T, noises,
                      guidance)
        if codec is not None:
            out = codec.decode(out)
        return torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)

    return sampler, shape, _draw_count(diffusion)


class _Program(nn.Module):
    """The root `torch.export` takes. The model is held by the sampler
    function, not as a submodule: its parameters are inputs, not state."""

    def __init__(self, sampler):
        super().__init__()
        self.sampler = sampler

    def forward(self, params, x_T, labels, noises):
        return self.sampler(params, x_T, labels, noises)


def _param_names(model: nn.Module):
    return [name for name, _ in model.named_parameters()]


def _params_on(params: Mapping, names, device) -> dict:
    missing = [n for n in names if n not in params]
    if missing:
        raise KeyError(f"params lacks {len(missing)} of the model's "
                       f"parameters, e.g. {missing[:3]}")
    return {n: torch.as_tensor(params[n]).to(device) for n in names}


def export_sampler(
    model: nn.Module,
    params: Mapping,
    config: dict,
    batch_size: int = 64,
    sampling_method: str = "ddim",
    cfg_scale: Optional[float] = None,
    *,
    device="cuda",
    seconds: Optional[dict] = None,
) -> bytes:
    """Serialise the full sampling trajectory of `model` (moved to `device`
    and put in eval mode) as a `torch.export` program.

    The program's signature is (params, x_T, labels, noises) -> images
    (B, H, W, C) in [0, 1]: `params` the model's parameters by name, `x_T`
    the initial draw of the sample's shape, labels (B,) in the +1-shifted
    convention (0 = null), `noises` the sampler's per-step draws stacked
    (steps, *shape) or None when it takes none. `seconds`, when given, is
    filled with the host seconds of the trace ("export") and of the
    serialisation ("save")."""
    if cfg_scale is None:
        cfg_scale = float(config.get("cfg_scale", 0.0))
    device = torch.device(device)
    model = model.to(device).eval()
    sampler, shape, draws = _build_sampler_fn(
        model, config, batch_size, sampling_method, cfg_scale, device)
    names = _param_names(model)
    args = (_params_on(params, names, device),
            torch.zeros(shape, device=device),
            torch.zeros((batch_size,), dtype=torch.int64, device=device),
            torch.zeros((draws, *shape), device=device) if draws else None)
    start = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(_Program(sampler), args, strict=False)
    traced = time.perf_counter()
    # the example inputs (zeros of every input, the parameters among them)
    # are not saved: the program's signature holds their shapes
    program.example_inputs = None
    meta = {"shape": list(shape), "draws": draws, "params": names,
            "device": device.type}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    if seconds is not None:
        seconds.update(export=traced - start,
                       save=time.perf_counter() - traced)
    return buf.getvalue()


def load_exported(blob: bytes):
    """(the loaded program, its description) of an exported sampler."""
    extra = {META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return program, json.loads(extra[META])


def run_exported(blob: bytes, params: Mapping, generator, labels, *,
                 init_noise: Optional[torch.Tensor] = None,
                 noises: Optional[torch.Tensor] = None, device="cuda"):
    """Load and call an exported sampler on `device`, the device it was
    exported for. `init_noise` (x_T) and `noises` (the per-step draws, where
    the sampler takes them) are drawn from `generator`, a `torch.Generator`
    on that device, when not given: x_T first, then the draws in one call."""
    program, meta = load_exported(blob)
    device = torch.device(device)
    if device.type != meta["device"]:
        raise ValueError(f"the sampler was exported for {meta['device']}, "
                         f"not {device.type}")
    shape = tuple(meta["shape"])

    def drawn(given, draw_shape):
        if given is not None:
            return torch.as_tensor(given, dtype=torch.float32).to(device)
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        return torch.randn(draw_shape, generator=generator, device=device)

    x_T = drawn(init_noise, shape)
    draws = (drawn(noises, (meta["draws"], *shape)) if meta["draws"]
             else None)
    labels = torch.as_tensor(labels, dtype=torch.int64).to(device)
    with torch.no_grad():
        return program.module()(_params_on(params, meta["params"], device),
                                x_T, labels, draws)
