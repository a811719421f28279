"""Sampling pipeline behind `sample.py`.

Counterpart of `diffusion_models_collection_tpu/pipeline.py` for the
branches this port serves: DDPM, DDIM, DPM-Solver++ (2M and SDE) and UniPC
on a VP checkpoint, and the flow-matching, EDM and consistency checkpoints'
own samplers (their step count is the checkpoint's unless
--num_inference_steps says otherwise), each with classifier-free guidance (conditional checkpoints with
--cfg_scale > 0; --guidance_rescale and --cfg_interval override the
config's keys) or plain, optionally returning every step's state;
--num_inference_steps and --mixed_precision override the config's keys.
The JAX pipeline's editing and training-free knobs, with its rules and
messages: FreeU (--freeu, a model field), PAG (--pag_scale, a wrapper of
the model), DeepCache (--deepcache, two views of the model), img2img,
inpainting and RePaint (--init_image, --strength, --mask, --repaint_*) and
restart sampling (--restarts, --restart_interval); each batch goes to
img2img, then restarts, then DeepCache, then guided, then plain sampling,
in the JAX pipeline's order. PAG and DeepCache call the one model with
call-time arguments (`pag_perturb`, `deepcache_mode`), so no weights are
copied. A latent-diffusion checkpoint samples the VAE's latents and decodes
them (every step's with `return_all`) before they leave the pipeline; its
img2img encodes the init image to the posterior mode, and --mask raises, as
in the JAX pipeline. Classifier guidance (--classifier_checkpoint,
--classifier_scale: `diffusion/guidance.py`, the classifier in its own
config's dtype) and SR3 super-resolution (a checkpoint with a
`super_resolution` block and --sr_source: `utils/sr.py`) wrap the model per
batch, SR conditioning first and guidance after it (after PAG), as the JAX
pipeline composes them, so both reach img2img, restarts, CFG and plain
sampling. Token merging (--tome_ratio, --tome_mlp) and int8 inference
(--quantize int8) are DiT model fields, applied in the JAX pipeline's order
of overrides: steps and precision, ToMe, FreeU, quantization, the CFG knobs
(`apply_tome`, `apply_quantize`, with its messages). Under torchrun each
model call is split over the ranks (`SamplingPipeline.apply`), as the JAX
pipeline shards each batch over its devices (`dp_sampling_sharding`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .diffusion.deepcache import deepcache_sample
from .diffusion.guidance import classifier_guided_model_fn
from .diffusion.pag import pag_model_fn
from .factory import get_diffusion, get_model, load_model_for_inference
from .parallel.data_parallel import DataParallelApply
from .parallel.mesh import Layout
from .utils import sr as sr_lib
from .utils.checkpoint import load_checkpoint
from .utils.helpers import (load_image_for_model, load_mask_for_model,
                            resolve_image_size)
from .utils.latent import LatentCodec


def split_model_calls(model, layout: Layout):
    """`model`, or with several data ranks in `layout` the model on this
    rank's rows of each call, gathered in rank order."""
    if layout.dp == 1:
        return model
    print(f"Sampling data-parallel over {layout.dp} processes (each model "
          "call's rows split in rank order)")
    return DataParallelApply(model, layout)


def build_labels(args, config, nrow: int, num_rows: int):
    """Per-row class labels shifted by +1 (0 is the CFG null label), or None
    for an unconditional checkpoint."""
    conditional = config.get("conditional", False)
    num_classes = config.get("num_classes")
    if not conditional:
        return None
    if args.labels:
        row_labels = [int(x.strip()) for x in args.labels.split(",")]
        if num_classes is not None:
            for lbl in row_labels:
                if not 0 <= lbl < num_classes:
                    raise ValueError(
                        f"Label {lbl} is out of range [0, {num_classes})")
        if len(row_labels) < num_rows:
            row_labels = (row_labels * (num_rows // len(row_labels) + 1))[
                :num_rows]
        else:
            row_labels = row_labels[:num_rows]
        labels = np.repeat(np.asarray(row_labels) + 1, nrow)[:args.num_samples]
    elif num_classes is not None:
        rng = np.random.default_rng(args.seed)
        row_labels = rng.integers(0, num_classes, size=num_rows)
        labels = np.repeat(row_labels + 1, nrow)[:args.num_samples]
    else:
        raise ValueError("Conditional generation requires either --labels "
                         "or known num_classes.")
    print(f"Using conditional generation with labels: {labels.tolist()}")
    return labels.astype(np.int64)


FAST_SAMPLERS = ("ddim", "dpm++", "dpm++sde", "unipc")


def process_flags(config):
    """(is_flow, is_edm, is_cm): whether the checkpoint's own process is
    flow matching, EDM or a consistency model, each of which owns its
    sampler and step count."""
    dtype_key = str(config.get("diffusion_type", "ddpm")).lower()
    return (dtype_key in ("flow", "flow_matching", "rectified_flow"),
            dtype_key == "edm", dtype_key == "consistency")


def apply_steps_and_precision(args, config, flags) -> None:
    """The JAX pipeline's step-count rule: --num_inference_steps sets the
    config's count for the fast samplers and for flow, EDM and consistency
    checkpoints; without it DDIM on a VP checkpoint takes the CLI's default
    of 50 and every other case keeps the checkpoint's count (a distilled
    consistency checkpoint's embedded one among them). --mixed_precision
    overrides the compute dtype."""
    method = args.sampling_method.lower()
    if args.num_inference_steps is not None:
        if method in FAST_SAMPLERS or any(flags):
            config["num_inference_steps"] = args.num_inference_steps
    elif method == "ddim" and not any(flags):
        config["num_inference_steps"] = 50
    if args.mixed_precision is not None:
        config["mixed_precision"] = args.mixed_precision


def apply_tome(args, config) -> None:
    """--tome_ratio (and --tome_mlp) as the DiT's `tome_ratio` and
    `tome_mlp` fields: parameter-free, so any DiT checkpoint applies."""
    if args.tome_ratio <= 0:
        return
    if str(config.get("model_type", "")).lower() != "dit":
        raise SystemExit(
            "--tome_ratio is a DiT token-merging knob (the UNet has "
            "no token stream; DiM's scan is already linear in L)")
    mp = dict(config.get("model_params", {}))
    mp["tome_ratio"] = args.tome_ratio
    if args.tome_mlp:
        mp["tome_mlp"] = True
    config["model_params"] = mp
    print(f"Token merging: ratio {args.tome_ratio}"
          + (" (attention + MLP)" if args.tome_mlp else " (attention)"))


def apply_quantize(args, config) -> None:
    """--quantize int8 as the DiT's `quant` field: any float DiT checkpoint
    applies unchanged."""
    if not args.quantize:
        return
    if str(config.get("model_type", "")).lower() != "dit":
        raise SystemExit(
            "--quantize int8 is implemented for DiT checkpoints (the "
            "UNet is conv-bound; int8 convs showed no MXU win)")
    config["model_params"] = dict(config.get("model_params", {}),
                                  quant=args.quantize)
    print(f"Quantized inference: {args.quantize}")


def apply_freeu(args, config) -> None:
    """--freeu b1,b2,s1,s2 as the UNet's `freeu` field (no weights
    change)."""
    if args.freeu is None:
        return
    if str(config.get("model_type", "")).lower() != "unet":
        raise SystemExit("--freeu reweights UNet skip connections — DiT/DiM "
                         "have no skip-concat up path")
    try:
        factors = tuple(float(v) for v in args.freeu.split(","))
    except ValueError:
        factors = ()
    if len(factors) != 4:
        raise SystemExit("--freeu expects four floats: b1,b2,s1,s2")
    config["model_params"] = dict(config.get("model_params", {}),
                                  freeu=factors)
    print(f"FreeU: b1,b2={factors[0]},{factors[1]} "
          f"s1,s2={factors[2]},{factors[3]}")


def wrap_pag(args, config, model, flags):
    """--pag_scale: the PAG-rectified eps of `model` and the same model
    called with `pag_perturb=True` (else `model` itself), ahead of any
    other wrapper, so the fused-CFG batch inside the samplers sees it."""
    if args.pag_scale == 0.0:
        return model
    if args.pag_scale < 0:
        raise SystemExit("--pag_scale must be >= 0")
    if any(flags):
        raise SystemExit("PAG extrapolates the VP family's eps predictions — "
                         "not flow/edm/consistency checkpoints")
    if str(config.get("prediction_type", "eps")) != "eps":
        raise SystemExit("PAG shifts the EPS prediction; this checkpoint "
                         f"predicts {config.get('prediction_type')!r}")
    model_type = str(config.get("model_type", "")).lower()
    if model_type not in ("unet", "dit"):
        raise SystemExit(
            "PAG perturbs self-attention maps — implemented for UNet and DiT "
            f"checkpoints, not {model_type!r} (DiM's Mamba mixer has no "
            "attention map)")
    if model_type == "unet" and not config.get("model_params", {}).get(
            "use_attention", True):
        raise SystemExit("PAG perturbs attention maps — this UNet was built "
                         "with use_attention: false")

    def perturbed_fn(x, t, y=None):
        return model(x, t, y, pag_perturb=True)

    print(f"Perturbed Attention Guidance: scale {args.pag_scale}")
    return pag_model_fn(model, perturbed_fn, args.pag_scale)


def build_deepcache(args, config, model, flags, base_wrapped: bool):
    """--deepcache: the model's 'full' and 'shallow' views at
    --deepcache_depth, or (None, None). Any wrapper of the model (PAG,
    `base_wrapped`) is refused, since the views call the model itself."""
    if args.deepcache <= 0:
        return None, None
    if str(config.get("model_type", "")).lower() != "unet":
        raise SystemExit(
            "--deepcache caches UNet deep features across steps — DiT/DiM "
            "have no resolution hierarchy to cache (use --tome_ratio for "
            "DiT)")
    if args.sampling_method.lower() != "ddim" or any(flags):
        raise SystemExit("--deepcache is implemented on the DDIM trajectory "
                         "(--sampling_method ddim on a VP checkpoint)")
    # getattr defaults: `evaluate` shares this builder but has only a
    # subset of `sample`'s flags (no img2img, trajectory or restarts)
    incompatible = [
        (getattr(args, "save_intermediate", False)
         or getattr(args, "create_gif", False),
         "--save_intermediate/--create_gif (the cached scan returns final "
         "samples only)"),
        (bool(getattr(args, "init_image", None)), "img2img"),
        (getattr(args, "restarts", 0) > 0, "--restarts"),
        (bool(getattr(args, "classifier_checkpoint", None)),
         "classifier guidance"),
        (args.pag_scale != 0.0, "--pag_scale"),
        (bool(getattr(args, "sr_source", None)), "super-resolution"),
        (base_wrapped, "the active model_fn wrapper"),
    ]
    for cond, what in incompatible:
        if cond:
            raise SystemExit(f"--deepcache does not compose with {what}")
    n_levels = len(config.get("model_params", {}).get("channel_mult",
                                                      (1, 2, 2, 2)))
    depth = args.deepcache_depth
    if not 1 <= depth <= n_levels - 1:
        raise SystemExit(f"--deepcache_depth must be in [1, {n_levels - 1}] "
                         "for this checkpoint's channel_mult")

    def full_fn(x, t, y):
        return model(x, t, y, deepcache_mode="full", deepcache_depth=depth)

    def shallow_fn(x, t, y, cache):
        return model(x, t, y, cache, deepcache_mode="shallow",
                     deepcache_depth=depth)

    print(f"DeepCache: full pass every {args.deepcache} steps, depth {depth}")
    return full_fn, shallow_fn


def load_sr_sources(source, lr_hw, in_channels: int,
                    num_samples: int) -> np.ndarray:
    """LR conditioning images for SR sampling from an image file (repeated)
    or a directory (sorted, cycled to `num_samples`): (num_samples, lr_h,
    lr_w, C) in [-1, 1]."""
    src = Path(source)
    if src.is_dir():
        exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
        files = sorted(p for p in src.iterdir() if p.suffix.lower() in exts)
        if not files:
            raise SystemExit(f"--sr_source directory {src} has no images")
    elif src.is_file():
        files = [src]
    else:
        raise SystemExit(f"--sr_source {src} does not exist")
    return np.stack([
        load_image_for_model(files[i % len(files)], lr_hw, in_channels)[0]
        for i in range(num_samples)])


def build_classifier(args, config, flags, nrow: int, num_rows: int, labels,
                     device):
    """--classifier_checkpoint: (the classifier on `device`, frozen, in its
    own config's dtype; the guidance targets, raw 0..K-1, one a sample), or
    (None, None). The targets are the CFG labels - 1, or built as for a
    conditional checkpoint of the classifier's class count."""
    if not getattr(args, "classifier_checkpoint", None):
        return None, None
    if any(flags):
        raise SystemExit(
            "classifier guidance is defined on the VP (DDPM/DDIM/"
            "DPM++/UniPC) family's eps predictions — not flow/edm/"
            "consistency checkpoints")
    if str(config.get("prediction_type", "eps")) != "eps":
        raise SystemExit(
            "classifier guidance shifts the EPS prediction; this checkpoint "
            f"predicts {config.get('prediction_type')!r}")
    if config.get("latent_diffusion"):
        raise SystemExit(
            "classifier guidance is defined on pixels — a latent-diffusion "
            "checkpoint samples VAE latents the pixel classifier cannot "
            "score")
    payload = load_checkpoint(args.classifier_checkpoint)
    cls_config = dict(payload["config"])
    if str(cls_config.get("model_type", "")).lower() != "classifier":
        raise SystemExit(
            "--classifier_checkpoint must be a model_type 'classifier' "
            "checkpoint (train one with utils/classifier_trainer.py through "
            "train.py)")
    for key in ("num_timesteps", "beta_start", "beta_end", "beta_schedule"):
        if cls_config.get(key) != config.get(key):
            raise SystemExit(
                f"classifier/diffusion schedule mismatch on {key!r}: "
                f"{cls_config.get(key)!r} vs {config.get(key)!r} — the "
                "classifier must be trained on the same noising schedule it "
                "guides")
    cls_config["image_size"] = resolve_image_size(cls_config["image_size"])
    classifier = get_model(cls_config)
    state = payload.get("ema_model_state_dict")
    if not args.use_ema or state is None:
        state = payload["model_state_dict"]
    classifier.load_state_dict(state, strict=True)
    classifier.requires_grad_(False)  # the gradient is taken in x only
    classifier = classifier.to(device).eval()
    num_classes = int(cls_config["num_classes"])
    print(f"Classifier guidance: scale {args.classifier_scale}, "
          f"{num_classes} classes")
    if labels is not None:
        targets = np.asarray(labels, np.int64) - 1
    else:
        fake = {"conditional": True, "num_classes": num_classes}
        targets = build_labels(args, fake, nrow, num_rows) - 1
    if int(targets.max()) >= num_classes:
        raise SystemExit(
            f"label {int(targets.max())} is out of the classifier's range "
            f"[0, {num_classes})")
    return classifier, targets


def build_sr(args, config, in_channels: int):
    """A super-resolution checkpoint's (SRSpec, LR images (N, lr_h, lr_w,
    C) in [-1, 1] from --sr_source), or (None, None); --sr_source is
    required with one and refused without."""
    spec = sr_lib.SRSpec.from_config(config)
    source = getattr(args, "sr_source", None)
    if spec is None:
        if source:
            raise SystemExit("--sr_source requires a checkpoint trained with "
                             "a super_resolution config block")
        return None, None
    if not source:
        raise SystemExit(
            "this checkpoint was trained with super_resolution: pass "
            "--sr_source <image|directory> to condition on")
    lr_hw = spec.lr_hw(config["image_size"])
    lr_all = load_sr_sources(source, lr_hw, in_channels, args.num_samples)
    print(f"Super-resolving {len(lr_all)} conditioning images {lr_hw} -> "
          f"{tuple(config['image_size'])} (factor {spec.factor})")
    return spec, lr_all


def validate_editing(args, config, flags, in_channels):
    """The img2img, inpainting, RePaint and restart rules; returns the init
    image (1, H, W, C) in [-1, 1] and the mask (1, H, W, 1), or Nones."""
    is_flow, is_edm, is_cm = flags
    method = args.sampling_method.lower()
    if args.mask and not args.init_image:
        raise SystemExit("--mask requires --init_image")
    if args.repaint_resample > 1 and not args.mask:
        raise SystemExit("--repaint_resample requires --init_image and --mask "
                         "(RePaint is an inpainting schedule)")
    if args.restarts > 0:
        if method != "ddim" or any(flags):
            raise SystemExit("--restarts is defined on the deterministic DDIM "
                             "ODE (--sampling_method ddim on a VP checkpoint)")
        if args.init_image:
            raise SystemExit("--restarts composes with from-noise sampling, "
                             "not img2img")
        if float(config.get("ddim_eta", 0.0) or 0.0) != 0.0:
            raise SystemExit("--restarts requires ddim_eta = 0")
    if not args.init_image:
        return None, None
    if is_cm:
        raise SystemExit("img2img is not defined for consistency checkpoints "
                         "(f(x, t) maps straight to x0 — there is no partial "
                         "trajectory to start from)")
    if ((method.startswith("dpm++") or method == "unipc")
            and not (is_flow or is_edm)):
        raise SystemExit("img2img supports --sampling_method ddpm/ddim (and "
                         "flow/edm checkpoints), not dpm++/dpm++sde/unipc")
    if not 0.0 < args.strength <= 1.0:
        raise SystemExit("--strength must be in (0, 1] for img2img")
    if args.repaint_resample > 1:
        if not args.mask:
            raise SystemExit("--repaint_resample requires --mask")
        if method != "ddpm" or is_flow or is_edm:
            raise SystemExit("RePaint resampling is defined on the DDPM "
                             "ancestral sampler (--sampling_method ddpm)")
        if args.repaint_jump < 1:
            raise SystemExit("--repaint_resample needs --repaint_jump >= 1")
    init_image = load_image_for_model(args.init_image, config["image_size"],
                                      in_channels)
    mask = (load_mask_for_model(args.mask, config["image_size"])
            if args.mask else None)
    print(f"img2img from {args.init_image} at strength {args.strength}"
          + (f" with inpainting mask {args.mask}" if args.mask else ""))
    return init_image, mask


class SamplingPipeline:
    """Model, sampler and per-batch dispatch for `sample.py`: construct,
    then `setup_conditioning()` once the labels are built, then `run_batch`
    a batch. With a `layout` of several data ranks (`parallel/mesh.py`
    `join_world`) every model call runs on this rank's rows and is gathered
    (`apply`, `parallel/data_parallel.py`): the bare model is split, inside
    every per-batch composition (PAG, DeepCache's views, SR's concatenated
    condition, classifier guidance), and the samplers' state and draws stay
    the whole batch's on every rank."""

    def __init__(self, args, config, checkpoint, device: torch.device,
                 layout: Optional[Layout] = None):
        self.args = args
        self.config = config
        self.device = device
        self.layout = layout if layout is not None else Layout()
        if str(config.get("model_type", "")).lower() == "classifier":
            raise SystemExit(
                "this is a noise-conditional CLASSIFIER checkpoint — pass it "
                "via --classifier_checkpoint alongside a diffusion "
                "checkpoint")
        self.flags = flags = process_flags(config)
        apply_steps_and_precision(args, config, flags)
        apply_tome(args, config)
        apply_freeu(args, config)
        apply_quantize(args, config)
        if args.guidance_rescale is not None:
            config["guidance_rescale"] = args.guidance_rescale
        if args.cfg_interval is not None:
            lo, hi = (int(v) for v in args.cfg_interval.split(","))
            config["cfg_interval"] = (lo, hi)
        config["image_size"] = resolve_image_size(config["image_size"])
        print("Creating model...")
        self.model = load_model_for_inference(checkpoint, config, args.use_ema,
                                              device)
        self.apply = split_model_calls(self.model, self.layout)
        self.model_fn = wrap_pag(args, config, self.apply, flags)
        self.dc_full_fn, self.dc_shallow_fn = build_deepcache(
            args, config, self.apply, flags,
            base_wrapped=self.model_fn is not self.apply)
        print(f"Using sampling method: {args.sampling_method.upper()}")
        self.diffusion = get_diffusion(config, args.sampling_method)
        self.conditional = bool(config.get("conditional", False))
        self.codec = LatentCodec.from_config(config, device=device)
        if self.codec is not None:
            self.hw = self.codec.latent_hw()
            self.channels = self.codec.latent_channels
            self.pixel_channels = self.codec.in_channels
            print(f"Latent diffusion: sampling {self.hw[0]}x{self.hw[1]}x"
                  f"{self.channels} latents, decoding through the VAE")
        else:
            self.hw = tuple(config["image_size"])
            self.channels = self.pixel_channels = config["model_params"][
                "in_channels"]
        self.init_image = self.mask = None
        self.classifier = self.guidance_labels = None
        self.sr_spec = self.sr_lr_all = None

    def setup_conditioning(self, labels, nrow: int, num_rows: int) -> None:
        """Load the classifier of --classifier_checkpoint (its targets from
        `labels`, the CFG labels of all samples, or built), the LR images of
        --sr_source, then check the editing flags and load --init_image and
        --mask, in the JAX pipeline's order."""
        flags = self.flags
        self.classifier, self.guidance_labels = build_classifier(
            self.args, self.config, flags, nrow, num_rows, labels,
            self.device)
        self.sr_spec, self.sr_lr_all = build_sr(self.args, self.config,
                                                self.pixel_channels)
        self.init_image, self.mask = validate_editing(
            self.args, self.config, flags, self.pixel_channels)
        if self.codec is not None and self.mask is not None:
            raise SystemExit(
                "--mask is not supported with latent-diffusion checkpoints "
                "(pixel masks do not map exactly onto the latent grid)")

    def batch_model_fn(self, start: int, end: int,
                       generator: torch.Generator):
        """The model callable of samples [start, end): the PAG-wrapped model,
        conditioned on its LR images (SR), then classifier-guided."""
        fn = self.model_fn
        if self.sr_lr_all is not None:
            cond = sr_lib.batch_condition(
                self.sr_spec, self.config["image_size"], self.sr_lr_all,
                start, end, end - start, generator, device=self.device)
            fn = sr_lib.wrap_model_fn(fn, cond)
        if self.classifier is not None:
            fn = classifier_guided_model_fn(
                fn, self.classifier,
                torch.as_tensor(self.guidance_labels[start:end],
                                device=self.device),
                self.args.classifier_scale, self.diffusion.schedule)
        return fn

    def run_batch(self, i: int, num_batches: int, start: int, end: int,
                  labels, generator: torch.Generator,
                  return_all: bool = False) -> torch.Tensor:
        """Generate samples [start, end) with their labels `labels[start:
        end]` (`labels` None for an unconditional model): (B, H, W, C) in
        [-1, 1], or with `return_all` every step's state, (S, B, H, W, C); a
        latent checkpoint's decoded (the trajectory on the host)."""
        samples = self._sample(i, num_batches, start, end, labels, generator,
                               return_all)
        if self.codec is None:
            return samples
        return (self.codec.decode_trajectory(samples) if return_all
                else self.codec.decode(samples))

    def _sample(self, i, num_batches, start, end, labels, generator,
                return_all):
        """`run_batch` in the model's space."""
        args = self.args
        batch = end - start
        shape = (batch, *self.hw, self.channels)
        y = (torch.as_tensor(labels[start:end], device=self.device)
             if labels is not None else None)
        model_fn = self.batch_model_fn(start, end, generator)
        use_cfg = args.cfg_scale > 0 and self.conditional
        cfg_scale = args.cfg_scale if use_cfg else None
        with_cfg = f" with CFG scale {args.cfg_scale}" if use_cfg else ""
        if self.init_image is not None:
            init = torch.as_tensor(np.repeat(self.init_image, batch, axis=0),
                                   device=self.device)
            if self.codec is not None:
                init = self.codec.encode_mode(init)
            mask = (torch.as_tensor(np.repeat(self.mask, batch, axis=0),
                                    device=self.device)
                    if self.mask is not None else None)
            repaint = ({} if args.repaint_resample <= 1 else dict(
                repaint_jump=args.repaint_jump,
                repaint_resample=args.repaint_resample))
            print(f"img2img batch {i + 1}/{num_batches}{with_cfg}...")
            return self.diffusion.img2img(
                model_fn, init, generator, strength=args.strength, y=y,
                cfg_scale=cfg_scale, mask=mask,
                return_all_timesteps=return_all, progress=True, **repaint)
        if args.restarts > 0:
            if args.restart_interval is not None:
                lo, hi = (int(v) for v in args.restart_interval.split(","))
            else:
                # the bottom 30 % of the checkpoint's schedule
                lo, hi = 1, max(2, int(0.3 * self.diffusion.num_timesteps))
            print(f"Restart sampling batch {i + 1}/{num_batches} "
                  f"({args.restarts} restarts in [{lo}, {hi}]){with_cfg}...")
            return self.diffusion.sample_restart(
                model_fn, shape, generator, y=y, cfg_scale=cfg_scale,
                restart_interval=(lo, hi), restarts=args.restarts,
                return_all_timesteps=return_all, progress=True)
        if args.deepcache > 0:
            print(f"DeepCache batch {i + 1}/{num_batches} (interval "
                  f"{args.deepcache}){with_cfg}...")
            return deepcache_sample(
                self.diffusion, self.dc_full_fn, self.dc_shallow_fn, shape,
                generator, y=y, cfg_scale=cfg_scale, interval=args.deepcache)
        if use_cfg:
            print(f"Sampling batch {i + 1}/{num_batches} with CFG scale "
                  f"{args.cfg_scale}...")
            return self.diffusion.sample_with_cfg(
                model_fn, shape, y, generator, cfg_scale=args.cfg_scale,
                return_all_timesteps=return_all, progress=True)
        print(f"Sampling batch {i + 1}/{num_batches}...")
        return self.diffusion.sample(model_fn, shape, generator, y=y,
                                     return_all_timesteps=return_all,
                                     progress=True)
