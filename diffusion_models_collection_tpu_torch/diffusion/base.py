"""Shared diffusion-process pieces: the forward process and training
losses, x0 recovery, parameterization views, classifier-free guidance and
x0 constraints, and `VPProcess`, what the processes over one VP schedule
(DDPM, DDIM, DPM-Solver++, UniPC) share.

Counterpart of `diffusion_models_collection_tpu/diffusion/base.py`. Plain
functions on tensors; the model is any callable `(x, t, y) -> output` on
NHWC tensors, and the noise is always passed in (the callers draw it from a
`torch.Generator`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .schedule import NoiseSchedule, extract, inference_timesteps

VALID_LOSS_TYPES = ("l1", "l2", "huber")
VALID_PREDICTION_TYPES = ("eps", "v", "x0")
VALID_LOSS_WEIGHTINGS = ("uniform", "snr", "min_snr")

# Sentinel default for p_threshold: 0.995 in bounded (pixel) spaces, None
# in unbounded (latent) ones.
AUTO_THRESHOLD = "auto"


class ScheduledProcess:
    """A diffusion process over one `NoiseSchedule` (`self.schedule`, on
    the CPU), whose tensors it copies to each device once."""

    schedule: NoiseSchedule

    def schedule_on(self, device) -> NoiseSchedule:
        """The schedule's tensors on `device`, copied once per device."""
        cache = self.__dict__.setdefault("_schedules", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = self.schedule.to(device)
        return cache[key]


def invalid_choice(kind: str, value, valid) -> ValueError:
    """The error for a value that is not one of `valid`."""
    return ValueError(f"Unknown {kind}: {value!r} (expected one of {valid})")


def q_sample(schedule: NoiseSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) = sqrt(acp_t) x_0 + sqrt(1 - acp_t)
    noise."""
    a = extract(schedule.sqrt_alphas_cumprod, t, x_start.ndim)
    b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
    return a * x_start + b * noise


def _elementwise_loss(diff: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type == "l1":
        return diff.abs()
    if loss_type == "l2":
        return diff**2
    if loss_type == "huber":  # torch's smooth_l1_loss with beta 1
        absd = diff.abs()
        return torch.where(absd < 1.0, 0.5 * diff**2, absd - 0.5)
    raise invalid_choice("loss type", loss_type, VALID_LOSS_TYPES)


def diffusion_loss(target: torch.Tensor, predicted: torch.Tensor,
                   loss_type: str = "l2") -> torch.Tensor:
    """Mean l1, l2 or huber loss of the prediction against the target."""
    return _elementwise_loss(predicted - target, loss_type).mean()


def per_sample_loss(target: torch.Tensor, predicted: torch.Tensor,
                    loss_type: str = "l2") -> torch.Tensor:
    """`diffusion_loss` reduced per sample, shape (batch,)."""
    loss = _elementwise_loss(predicted - target, loss_type)
    return loss.mean(dim=tuple(range(1, loss.ndim)))


def prediction_target(schedule: NoiseSchedule, x_start: torch.Tensor,
                      noise: torch.Tensor, t: torch.Tensor,
                      prediction_type: str = "eps") -> torch.Tensor:
    """The regression target: the noise (eps), the clean image (x0), or
    v = sqrt(acp_t) eps - sqrt(1 - acp_t) x0."""
    if prediction_type == "eps":
        return noise
    if prediction_type == "x0":
        return x_start
    if prediction_type == "v":
        a = extract(schedule.sqrt_alphas_cumprod, t, x_start.ndim)
        b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
        return a * noise - b * x_start
    raise invalid_choice("prediction type", prediction_type,
                         VALID_PREDICTION_TYPES)


def loss_weight(schedule: NoiseSchedule, t: torch.Tensor,
                prediction_type: str = "eps", weighting: str = "uniform",
                snr_gamma: float = 5.0) -> torch.Tensor:
    """Per-sample timestep weights, shape (batch,): a weight W(t) on the
    x0-space error (uniform: 1 in target space; snr: SNR; min_snr:
    min(SNR, gamma)), divided by the target's conversion factor (SNR for
    eps, SNR + 1 for v, 1 for x0)."""
    if weighting == "uniform":
        return torch.ones(t.shape, dtype=torch.float32, device=t.device)
    acp = extract(schedule.alphas_cumprod, t, 1)
    snr = acp / (1.0 - acp)
    if weighting == "snr":
        w_x0 = snr
    elif weighting == "min_snr":
        w_x0 = torch.clamp(snr, max=float(snr_gamma))
    else:
        raise invalid_choice("loss weighting", weighting,
                             VALID_LOSS_WEIGHTINGS)
    if prediction_type == "eps":
        return w_x0 / snr
    if prediction_type == "v":
        return w_x0 / (snr + 1.0)
    if prediction_type == "x0":
        return w_x0
    raise invalid_choice("prediction type", prediction_type,
                         VALID_PREDICTION_TYPES)


def p_losses(schedule: NoiseSchedule, model_fn: Callable,
             x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             y: Optional[torch.Tensor] = None, loss_type: str = "l2",
             prediction_type: str = "eps", weighting: str = "uniform",
             snr_gamma: float = 5.0) -> torch.Tensor:
    """Training loss: noise x_start to x_t, predict the target, and take
    the loss, weighted per sample unless the weighting is uniform."""
    x_noisy = q_sample(schedule, x_start, t, noise)
    predicted = model_fn(x_noisy, t, y)
    target = prediction_target(schedule, x_start, noise, t, prediction_type)
    if weighting == "uniform":
        return diffusion_loss(target, predicted, loss_type)
    w = loss_weight(schedule, t, prediction_type, weighting, snr_gamma)
    return (w * per_sample_loss(target, predicted, loss_type)).mean()


def predict_x0_from_eps(schedule: NoiseSchedule, x: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """x0 = sqrt(1/acp_t) * x_t - sqrt(1/acp_t - 1) * eps."""
    c1 = extract(schedule.sqrt_recip_alphas_cumprod, t, x.ndim)
    c2 = extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.ndim)
    return c1 * x - c2 * eps


def eps_from_prediction(schedule: NoiseSchedule, x: torch.Tensor,
                        t: torch.Tensor, out: torch.Tensor,
                        prediction_type: str) -> torch.Tensor:
    """A model output in any parameterization as eps: v gives
    b x_t + a v, x0 gives (c1 x_t - x0) / c2, with a = sqrt(acp_t),
    b = sqrt(1 - acp_t), c1 = sqrt(1/acp_t), c2 = sqrt(1/acp_t - 1)."""
    if prediction_type == "eps":
        return out
    if prediction_type == "v":
        a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
        b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
        return b * x + a * out
    if prediction_type == "x0":
        c1 = extract(schedule.sqrt_recip_alphas_cumprod, t, x.ndim)
        c2 = extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.ndim)
        return (c1 * x - out) / c2
    raise invalid_choice("prediction type", prediction_type,
                         VALID_PREDICTION_TYPES)


def wrap_model_as_eps(schedule: NoiseSchedule, model_fn: Callable,
                      prediction_type: str) -> Callable:
    """An `(x, t, y) -> eps` view of a model in any parameterization."""
    if prediction_type not in VALID_PREDICTION_TYPES:
        raise invalid_choice("prediction type", prediction_type,
                             VALID_PREDICTION_TYPES)
    if prediction_type == "eps":
        return model_fn

    def eps_fn(x, t, y=None):
        return eps_from_prediction(schedule, x, t, model_fn(x, t, y),
                                   prediction_type)
    return eps_fn


def wrap_model_as_eps_x0(schedule: NoiseSchedule, model_fn: Callable,
                         prediction_type: str) -> Callable:
    """A `(x, t, y) -> (eps, x0)` view of a model in any parameterization,
    converting the raw output to each directly (the only finite route under
    zero-terminal-SNR schedules, where eps carries no x0 information)."""
    if prediction_type == "eps":
        def pair(x, t, y=None):
            eps = model_fn(x, t, y)
            return eps, predict_x0_from_eps(schedule, x, t, eps)
    elif prediction_type == "v":
        def pair(x, t, y=None):
            v = model_fn(x, t, y)
            a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
            b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
            return b * x + a * v, a * x - b * v
    elif prediction_type == "x0":
        def pair(x, t, y=None):
            x0 = model_fn(x, t, y)
            a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
            b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
            return (x - a * x0) / torch.clamp(b, min=1e-12), x0
    else:
        raise invalid_choice("prediction type", prediction_type,
                       VALID_PREDICTION_TYPES)
    return pair


def resolve_p_threshold(p_threshold, clip_sample: bool):
    """AUTO_THRESHOLD becomes 0.995 for bounded spaces and None for
    unbounded ones; floats in (0, 1) and None pass through."""
    if isinstance(p_threshold, str):
        if p_threshold != AUTO_THRESHOLD:
            raise ValueError(f"Unknown p_threshold: {p_threshold!r}")
        return 0.995 if clip_sample else None
    if p_threshold is not None and not 0.0 < float(p_threshold) < 1.0:
        raise ValueError("p_threshold must be in (0, 1) or None")
    return p_threshold


def dynamic_threshold(x0: torch.Tensor, p_threshold: float) -> torch.Tensor:
    """Imagen dynamic thresholding: per-sample quantile s of |x0| at
    p_threshold (linear interpolation), floored at 1; clamp to [-s, s] and
    divide by s."""
    batch = x0.shape[0]
    flat = x0.reshape(batch, -1).abs()
    s = torch.quantile(flat, p_threshold, dim=1, interpolation="linear")
    s = torch.clamp(s, min=1.0).reshape(batch, *((1,) * (x0.ndim - 1)))
    return torch.clamp(x0, -s, s) / s


def constrain_x0(x0: torch.Tensor, p_threshold: Optional[float],
                 clip_denoised: bool) -> torch.Tensor:
    """Dynamic threshold when p_threshold is set, else clamp to [-1, 1] when
    clip_denoised, else pass through (unbounded latent spaces)."""
    if p_threshold is not None:
        if not 0.0 < float(p_threshold) < 1.0:
            raise ValueError("p_threshold must be in (0, 1) or None")
        return dynamic_threshold(x0, float(p_threshold))
    if clip_denoised:
        return torch.clamp(x0, -1.0, 1.0)
    return x0


def apply_x0_constraint(x0: torch.Tensor,
                        p_threshold: Optional[float]) -> torch.Tensor:
    """Dynamic thresholding when p_threshold is set, else clamp to
    [-1, 1]."""
    return constrain_x0(x0, p_threshold, clip_denoised=True)


def rescale_guided(x_g: torch.Tensor, x_c: torch.Tensor,
                   phi: float) -> torch.Tensor:
    """Guidance contrast rescale (Lin et al. 2023 section 3.4): pull the
    guided prediction's per-sample std toward the conditional branch's and
    blend with factor phi. Population std, as jnp.std."""
    axes = tuple(range(1, x_g.ndim))
    std_c = torch.std(x_c, dim=axes, keepdim=True, correction=0)
    std_g = torch.std(x_g, dim=axes, keepdim=True, correction=0)
    res = x_g * (std_c / torch.clamp(std_g, min=1e-12))
    return phi * res + (1.0 - phi) * x_g


def validate_guidance_rescale(value) -> float:
    v = float(value)
    if not 0.0 <= v <= 1.0:
        raise ValueError(f"guidance_rescale must be in [0, 1], got {value!r}")
    return v


def validate_cfg_interval(value, num_timesteps: int):
    """A `cfg_interval: [t_lo, t_hi]` value (0 <= lo <= hi < T) or None."""
    if value is None:
        return None
    lo, hi = int(value[0]), int(value[1])
    if not 0 <= lo <= hi < num_timesteps:
        raise ValueError(f"cfg_interval must satisfy 0 <= lo <= hi < "
                         f"{num_timesteps}, got {value!r}")
    return (lo, hi)


def cfg_eps_x0(pair_fn: Callable, x: torch.Tensor, t: torch.Tensor,
               y: torch.Tensor, cfg_scale: float, guidance_rescale: float = 0.0,
               schedule: Optional[NoiseSchedule] = None, cfg_interval=None):
    """Classifier-free guidance on an (eps, x0) pair with one model call on
    the [cond; uncond] batch (labels, then the null label 0).

    `guidance_rescale` (phi in [0, 1]) rescales the guided x0 toward the
    conditional branch's std and re-derives eps from it; `cfg_interval`
    (t_lo, t_hi) guides only inside that timestep range and uses the
    conditional prediction outside it.
    """
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    y2 = torch.cat([y, torch.zeros_like(y)], dim=0)
    eps2, x02 = pair_fn(x2, t2, y2)
    eps_c, eps_u = eps2.chunk(2, dim=0)
    x0_c, x0_u = x02.chunk(2, dim=0)
    eps_g = eps_u + cfg_scale * (eps_c - eps_u)
    x0_g = x0_u + cfg_scale * (x0_c - x0_u)
    if float(guidance_rescale) > 0.0:
        if schedule is None:
            raise ValueError("guidance_rescale needs the noise schedule")
        x0_g = rescale_guided(x0_g, x0_c, float(guidance_rescale))
        a = extract(schedule.sqrt_alphas_cumprod, t, x.ndim)
        b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.ndim)
        eps_g = (x - a * x0_g) / torch.clamp(b, min=1e-12)
    if cfg_interval is not None:
        lo, hi = cfg_interval
        gate = ((t >= lo) & (t <= hi)).reshape(-1, *((1,) * (x.ndim - 1)))
        eps_g = torch.where(gate, eps_g, eps_c)
        x0_g = torch.where(gate, x0_g, x0_c)
    return eps_g, x0_g


def cfg_eps(model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
            y: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """Classifier-free-guided eps with one model call on the [cond; uncond]
    batch."""
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    y2 = torch.cat([y, torch.zeros_like(y)], dim=0)
    eps_c, eps_u = model_fn(x2, t2, y2).chunk(2, dim=0)
    return eps_u + cfg_scale * (eps_c - eps_u)


def editing_start(init_image: torch.Tensor, mask):
    """An img2img's float32 init image and `known` = (init image, mask
    broadcast to its shape; 1 regenerates, 0 keeps), or None without a
    mask."""
    init_image = init_image.to(torch.float32)
    if mask is None:
        return init_image, None
    mask = torch.as_tensor(mask, dtype=torch.float32,
                           device=init_image.device).expand(init_image.shape)
    return init_image, (init_image, mask)


def initial_image(shape, generator: Optional[torch.Generator],
                  init_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """`init_noise` as float32, or a standard normal draw of `shape` from
    `generator`, on the generator's device."""
    if init_noise is not None:
        return init_noise.to(torch.float32)
    if generator is None:
        raise ValueError("pass a torch.Generator or init_noise")
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


def step_noise(noises: Optional[Sequence], i: int, like: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The noise of step `i`: `noises[i]` when the caller passed the
    sequence, else a standard normal draw from `generator`."""
    if noises is not None:
        return noises[i].to(like.device, torch.float32)
    if generator is None:
        raise ValueError("pass a torch.Generator or the per-step noises")
    return torch.randn(like.shape, generator=generator,
                       device=generator.device).to(like.device)


def check_noises(noises: Optional[Sequence], steps: int):
    if noises is not None and len(noises) != steps:
        raise ValueError(f"noises: {len(noises)} given for {steps} steps")


class Trajectory:
    """The states a sampler returns: the last one, or with
    `return_all_timesteps` every step's, stacked as (S, B, H, W, C)."""

    def __init__(self, return_all_timesteps: bool):
        self.frames = [] if return_all_timesteps else None
        self.last = None

    def add(self, x: torch.Tensor) -> None:
        self.last = x
        if self.frames is not None:
            self.frames.append(x)

    def result(self) -> torch.Tensor:
        return (torch.stack(self.frames) if self.frames is not None
                else self.last)


def report_progress(progress: bool, desc: str, done: int, total: int,
                    every: int = 5, file=None) -> None:
    """Print `desc: step done/total` about `every` times over `total`
    steps (to `file`, stdout by default) when `progress`."""
    if progress and done % max(1, total // every) == 0:
        print(f"{desc}: step {done}/{total}", flush=True, file=file)


class VPProcess(ScheduledProcess):
    """A process over one VP `NoiseSchedule`: its options, the training API
    (`q_sample`, `p_losses`), the guided, constrained (eps, x0) each
    sampling step reads (`eps_x0_fn`, JAX's `make_x0_fn`) and the sampling
    API (`sample`, `sample_with_cfg`) around a subclass's `_solve` loop.
    DDPM, DDIM, DPM-Solver++ and UniPC build on it, as the JAX classes
    share these pieces."""

    DESC = "Sampling"

    def __init__(self, num_timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 0.02, beta_schedule: str = "linear",
                 prediction_type: str = "eps",
                 loss_weighting: str = "uniform",
                 min_snr_gamma: float = 5.0, zero_terminal_snr: bool = False,
                 guidance_rescale: float = 0.0, clip_sample: bool = True,
                 cfg_interval=None):
        if prediction_type not in VALID_PREDICTION_TYPES:
            raise invalid_choice("prediction type", prediction_type,
                                 VALID_PREDICTION_TYPES)
        if zero_terminal_snr and prediction_type == "eps":
            raise ValueError(
                "zero_terminal_snr requires prediction_type 'v' or 'x0': at "
                "SNR = 0 an eps-prediction carries no signal to denoise from")
        if loss_weighting not in VALID_LOSS_WEIGHTINGS:
            raise invalid_choice("loss weighting", loss_weighting,
                                 VALID_LOSS_WEIGHTINGS)
        self.num_timesteps = num_timesteps
        self.prediction_type = prediction_type
        self.loss_weighting = loss_weighting
        self.min_snr_gamma = float(min_snr_gamma)
        self.zero_terminal_snr = bool(zero_terminal_snr)
        self.guidance_rescale = validate_guidance_rescale(guidance_rescale)
        self.clip_sample = bool(clip_sample)
        self.cfg_interval = validate_cfg_interval(cfg_interval, num_timesteps)
        self.schedule = NoiseSchedule.create(
            num_timesteps, beta_start, beta_end, beta_schedule,
            zero_terminal_snr=zero_terminal_snr)

    # -- training --------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        return q_sample(self.schedule_on(x_start.device), x_start, t, noise)

    def p_losses(self, model_fn, x_start, t, noise, y=None, loss_type="l2"):
        return p_losses(
            self.schedule_on(x_start.device), model_fn, x_start, t, noise,
            y=y, loss_type=loss_type, prediction_type=self.prediction_type,
            weighting=self.loss_weighting, snr_gamma=self.min_snr_gamma)

    # -- sampling --------------------------------------------------------
    def pair_fn(self, model_fn, device,
                schedule: Optional[NoiseSchedule] = None) -> Callable:
        """The `(x, t, y) -> (eps, x0)` view of `model_fn` over `schedule`,
        by default the process's own on `device`."""
        if schedule is None:
            schedule = self.schedule_on(device)
        return wrap_model_as_eps_x0(schedule, model_fn, self.prediction_type)

    def eps_x0_fn(self, model_fn, device, y, cfg_scale: float, *,
                  use_cfg: bool, p_threshold,
                  schedule: Optional[NoiseSchedule] = None) -> Callable:
        """`(x, t) -> (eps, x0)` of one sampling step: one model call on the
        [cond; uncond] batch with guidance rescale, interval and the x0
        constraint under CFG; else the plain call and the clamp when
        `clip_sample`. `schedule` as in `pair_fn`."""
        if schedule is None:
            schedule = self.schedule_on(device)
        pair_fn = self.pair_fn(model_fn, device, schedule)

        def eps_x0(x, t):
            if use_cfg:
                eps, x0 = cfg_eps_x0(
                    pair_fn, x, t, y, cfg_scale,
                    guidance_rescale=self.guidance_rescale,
                    schedule=schedule, cfg_interval=self.cfg_interval)
                return eps, constrain_x0(x0, p_threshold, self.clip_sample)
            eps, x0 = pair_fn(x, t, y)
            return eps, (torch.clamp(x0, -1.0, 1.0) if self.clip_sample
                         else x0)
        return eps_x0

    def guided_eps_x0(self, model_fn, device, y, cfg_scale: Optional[float],
                      p_threshold=AUTO_THRESHOLD,
                      schedule: Optional[NoiseSchedule] = None) -> Callable:
        """`eps_x0_fn` unguided (`cfg_scale` None) or with classifier-free
        guidance on labels `y` and the x0 constraint `p_threshold` (0.995
        by default in pixel space)."""
        use_cfg = cfg_scale is not None
        if y is not None:
            y = torch.as_tensor(y, device=device)
        return self.eps_x0_fn(
            model_fn, device, y, float(cfg_scale) if use_cfg else 0.0,
            use_cfg=use_cfg,
            p_threshold=(resolve_p_threshold(p_threshold, self.clip_sample)
                         if use_cfg else None),
            schedule=schedule)

    def sample(self, model_fn, shape, generator=None, y=None,
               init_noise=None, noises: Optional[Sequence] = None,
               return_all_timesteps: bool = False,
               progress: bool = False) -> torch.Tensor:
        """Unguided sampling: (B, H, W, C), or every step's state
        (S, B, H, W, C) with `return_all_timesteps`."""
        img = initial_image(shape, generator, init_noise)
        eps_x0 = self.guided_eps_x0(model_fn, img.device, y, None)
        return self._solve(eps_x0, img, generator, noises,
                           return_all_timesteps, progress, self.DESC)

    def sample_with_cfg(self, model_fn, shape, y, generator=None,
                        cfg_scale: float = 3.0, p_threshold=AUTO_THRESHOLD,
                        init_noise=None, noises: Optional[Sequence] = None,
                        return_all_timesteps: bool = False,
                        progress: bool = False) -> torch.Tensor:
        """Sampling with classifier-free guidance on labels `y` (shifted
        +1) and dynamic thresholding of x0 (p = 0.995 by default in pixel
        space)."""
        if y is None:
            raise ValueError("CFG sampling requires class labels y.")
        img = initial_image(shape, generator, init_noise)
        eps_x0 = self.guided_eps_x0(model_fn, img.device, y, cfg_scale,
                                    p_threshold)
        return self._solve(eps_x0, img, generator, noises,
                           return_all_timesteps, progress,
                           f"{self.DESC} with CFG scale {cfg_scale}")


class FastVPSampler(VPProcess):
    """A VP process that samples on a grid of `num_inference_steps`
    timesteps, uniform (`ddim_timesteps`) or Karras-spaced
    (`timestep_spacing: 'karras'`, `karras_rho`): DDIM, DPM-Solver++ and
    UniPC."""

    def __init__(self, num_inference_steps: int = 50,
                 timestep_spacing: str = "uniform", karras_rho: float = 7.0,
                 **common):
        super().__init__(**common)
        self.timestep_spacing = timestep_spacing
        self.karras_rho = float(karras_rho)
        self.set_inference_steps(num_inference_steps)

    def set_inference_steps(self, num_inference_steps: int):
        self.num_inference_steps = num_inference_steps
        self.inference_timesteps = inference_timesteps(
            self.schedule, num_inference_steps, self.timestep_spacing,
            self.karras_rho)
