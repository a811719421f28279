"""Weight bridge: a Flax UNet, DiT, DiM, VAE or classifier param tree
(nested dicts of numpy arrays, as a JAX checkpoint stores it) to the port's
`state_dict`; and the metric networks' param trees (InceptionV3, the LPIPS
AlexNet) to torchvision's keys, the inverses of the JAX package's
`convert_torchvision_state` and `convert_lpips_state`.

Counterpart of `diffusion_models_collection_tpu/utils/torch_export.py`
(`_unet_torch_plan`, `_export_unet`, `_export_patch_scaffold`,
`_export_dit`, `_export_dim`), in numpy and torch only: that module imports
the JAX package's helpers, which need JAX. The port's models use the PyTorch
reference's key names, so the result also equals what the JAX exporter
writes for the reference, and loads with `strict=True`. The VAE, the
classifier and a MoE DiT's expert MLPs have no reference names (the JAX
exporter refuses a MoE DiT): their keys are the port's own (`models/vae.py`,
`models/classifier.py`, `models/moe.py`). A DiT block's `MoeMlp_0` maps to
`blocks.{i}.mlp.router.weight` (the router kernel, transposed to (E, d)),
`blocks.{i}.mlp.router.bias`, and `blocks.{i}.mlp.w1`, `.b1`, `.w2`, `.b2`
as they are (w1 (E, d, h), b1 (E, h), w2 (E, h, d), b2 (E, d)).

Layouts (Flax -> torch): Dense kernel (in, out) -> Linear weight (out, in);
Conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw); depthwise conv
kernel (k, 1, D) -> Conv1d weight (D, 1, k); GroupNorm and LayerNorm scale
-> weight; embedding -> weight. DiM's two input projections (x, z) become
one fused `in_proj` with rows [x; z]; a self-attention's qkv Dense becomes
`nn.MultiheadAttention`'s `in_proj_weight` and `in_proj_bias`, its output
Dense `out_proj`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.classifier import classifier_plan
from .helpers import resolve_image_size


def _lin(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k, dtype=np.float32).T)


def _conv2d(k) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(k, dtype=np.float32).transpose(3, 2, 0, 1))


def _conv1d_dw(k) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(k, dtype=np.float32).transpose(2, 1, 0))


def _arr(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k, dtype=np.float32))


def unet_torch_plan(image_size: Tuple[int, int], num_res_blocks: int,
                    attention_resolutions, channel_mult,
                    use_attention: bool) -> List[Tuple[str, str]]:
    """Ordered (torch_prefix, kind) pairs, kind in {res, attn, down, up},
    replaying the reference constructor and its up-path attention timing.
    The order equals the Flax call order, so per-kind counters pair the two
    naming schemes."""

    def attend(resolution):
        return use_attention and (resolution[0] in attention_resolutions
                                  or resolution[1] in attention_resolutions)

    plan: List[Tuple[str, str]] = []
    resolution = list(image_size)
    g = 0
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            plan.append((f"down_blocks.{g}.0", "res"))
            if attend(resolution):
                plan.append((f"down_blocks.{g}.1", "attn"))
            g += 1
        if level != len(channel_mult) - 1:
            plan.append((f"down_blocks.{g}.0", "down"))
            g += 1
            resolution = [r // 2 for r in resolution]

    plan.append(("middle_block.0", "res"))
    if use_attention:
        plan.append(("middle_block.1", "attn"))
    plan.append(("middle_block.2", "res"))

    g = 0
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks + 1):
            plan.append((f"up_blocks.{g}.0", "res"))
            j = 1
            if attend(resolution):
                plan.append((f"up_blocks.{g}.{j}", "attn"))
                j += 1
            if level != len(channel_mult) - 1 and i == num_res_blocks:
                plan.append((f"up_blocks.{g}.{j}", "up"))
                resolution = [r * 2 for r in resolution]
            g += 1
    return plan


def unet_params_to_numpy_state_dict(
        params: Mapping, model_cfg: Mapping) -> Dict[str, np.ndarray]:
    """Flax UNet params -> reference-named arrays. `model_cfg` holds the
    UNet's constructor fields (image_size, num_res_blocks, ...)."""
    sd: Dict[str, np.ndarray] = {}
    te = params["UNetTimeEmbed_0"]
    sd["time_embed.1.weight"] = _lin(te["Dense_0"]["kernel"])
    sd["time_embed.1.bias"] = _arr(te["Dense_0"]["bias"])
    sd["time_embed.3.weight"] = _lin(te["Dense_1"]["kernel"])
    sd["time_embed.3.bias"] = _arr(te["Dense_1"]["bias"])
    if "LabelEmbedder_0" in params:
        sd["label_embed.weight"] = _arr(params["LabelEmbedder_0"]["embedding"])
    sd["input_conv.weight"] = _conv2d(params["Conv_0"]["kernel"])
    sd["input_conv.bias"] = _arr(params["Conv_0"]["bias"])
    sd["output.0.weight"] = _arr(params["FusedGroupNormSiLU_0"]["scale"])
    sd["output.0.bias"] = _arr(params["FusedGroupNormSiLU_0"]["bias"])
    sd["output.2.weight"] = _conv2d(params["Conv_1"]["kernel"])
    sd["output.2.bias"] = _arr(params["Conv_1"]["bias"])

    plan = unet_torch_plan(
        tuple(model_cfg["image_size"]),
        model_cfg.get("num_res_blocks", 2),
        tuple(model_cfg.get("attention_resolutions", (16, 8))),
        tuple(model_cfg.get("channel_mult", (1, 2, 2, 2))),
        model_cfg.get("use_attention", True),
    )
    counters = {"res": 0, "attn": 0, "down": 0, "up": 0}
    jax_name = {"res": "ResidualBlock", "attn": "AttentionBlock",
                 "down": "Downsample", "up": "Upsample"}
    for pref, kind in plan:
        blk = params[f"{jax_name[kind]}_{counters[kind]}"]
        counters[kind] += 1
        if kind == "res":
            sd[f"{pref}.conv1.0.weight"] = _arr(blk["FusedGroupNormSiLU_0"]["scale"])
            sd[f"{pref}.conv1.0.bias"] = _arr(blk["FusedGroupNormSiLU_0"]["bias"])
            sd[f"{pref}.conv1.2.weight"] = _conv2d(blk["Conv_0"]["kernel"])
            sd[f"{pref}.conv1.2.bias"] = _arr(blk["Conv_0"]["bias"])
            sd[f"{pref}.time_mlp.1.weight"] = _lin(blk["Dense_0"]["kernel"])
            sd[f"{pref}.time_mlp.1.bias"] = _arr(blk["Dense_0"]["bias"])
            if "Dense_1" in blk:  # label projection, conditional models
                sd[f"{pref}.label_proj.1.weight"] = _lin(blk["Dense_1"]["kernel"])
            sd[f"{pref}.conv2.0.weight"] = _arr(blk["FusedGroupNormSiLU_1"]["scale"])
            sd[f"{pref}.conv2.0.bias"] = _arr(blk["FusedGroupNormSiLU_1"]["bias"])
            sd[f"{pref}.conv2.3.weight"] = _conv2d(blk["Conv_1"]["kernel"])
            sd[f"{pref}.conv2.3.bias"] = _arr(blk["Conv_1"]["bias"])
            if "Conv_2" in blk:  # 1x1 shortcut of channel-changing blocks
                sd[f"{pref}.shortcut.weight"] = _conv2d(blk["Conv_2"]["kernel"])
                sd[f"{pref}.shortcut.bias"] = _arr(blk["Conv_2"]["bias"])
        elif kind == "attn":
            sd[f"{pref}.norm.weight"] = _arr(blk["GroupNorm_0"]["scale"])
            sd[f"{pref}.norm.bias"] = _arr(blk["GroupNorm_0"]["bias"])
            sd[f"{pref}.qkv.weight"] = _conv2d(blk["Conv_0"]["kernel"])
            sd[f"{pref}.qkv.bias"] = _arr(blk["Conv_0"]["bias"])
            sd[f"{pref}.proj.weight"] = _conv2d(blk["Conv_1"]["kernel"])
            sd[f"{pref}.proj.bias"] = _arr(blk["Conv_1"]["bias"])
        else:
            sd[f"{pref}.conv.weight"] = _conv2d(blk["Conv_0"]["kernel"])
            sd[f"{pref}.conv.bias"] = _arr(blk["Conv_0"]["bias"])

    # every Flax block must have been consumed: a leftover means the config
    # does not describe the params
    for kind, count in counters.items():
        extra = f"{jax_name[kind]}_{count}"
        if extra in params:
            raise ValueError(
                f"UNet plan consumed {count} {jax_name[kind]}s but the params "
                f"contain {extra}: the model config does not match the "
                "checkpoint (attention_resolutions, channel_mult, "
                "num_res_blocks, image_size)")
    return sd


def _dense(sd: Dict, key: str, dense: Mapping) -> None:
    sd[f"{key}.weight"] = _lin(dense["kernel"])
    if "bias" in dense:
        sd[f"{key}.bias"] = _arr(dense["bias"])


def _norm(sd: Dict, key: str, norm: Mapping) -> None:
    sd[f"{key}.weight"] = _arr(norm["scale"])
    sd[f"{key}.bias"] = _arr(norm["bias"])


def _attention(sd: Dict, key: str, attn: Mapping) -> None:
    """A `SelfAttention`'s Dense_0 (qkv) and Dense_1 (out) under
    `nn.MultiheadAttention`'s names."""
    sd[f"{key}.in_proj_weight"] = _lin(attn["Dense_0"]["kernel"])
    sd[f"{key}.in_proj_bias"] = _arr(attn["Dense_0"]["bias"])
    _dense(sd, f"{key}.out_proj", attn["Dense_1"])


def _patch_scaffold(params: Mapping) -> Dict[str, np.ndarray]:
    """The patch embedding, positions, timestep and label embedders that DiT
    and DiM share."""
    sd: Dict[str, np.ndarray] = {"pos_embed": _arr(params["pos_embed"])}
    patch = params["PatchEmbed_0"]["Conv_0"]
    sd["x_embedder.proj.weight"] = _conv2d(patch["kernel"])
    sd["x_embedder.proj.bias"] = _arr(patch["bias"])
    te = params["TimestepEmbedder_0"]
    _dense(sd, "t_embedder.mlp.0", te["Dense_0"])
    _dense(sd, "t_embedder.mlp.2", te["Dense_1"])
    if "LabelEmbedder_0" in params:
        sd["y_embedder.embedding_table.weight"] = _arr(
            params["LabelEmbedder_0"]["embedding"])
    return sd


def _moe(sd: Dict, key: str, moe: Mapping) -> None:
    """A `MoeMlp`'s router and stacked experts under the port's names."""
    _dense(sd, f"{key}.router", moe["router"])
    for name in ("w1", "b1", "w2", "b2"):
        sd[f"{key}.{name}"] = _arr(moe[name])


def dit_params_to_numpy_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax DiT params -> reference-named arrays (its LayerNorms are
    affine-free: nothing to bridge); a MoE block's experts under the port's
    names."""
    sd = _patch_scaffold(params)
    i = 0
    while f"DiTBlock_{i}" in params:
        blk, ref = params[f"DiTBlock_{i}"], f"blocks.{i}"
        _attention(sd, f"{ref}.attn", blk["SelfAttention_0"])
        if "MoeMlp_0" in blk:
            _moe(sd, f"{ref}.mlp", blk["MoeMlp_0"])
        else:
            _dense(sd, f"{ref}.mlp.0", blk["Mlp_0"]["Dense_0"])
            _dense(sd, f"{ref}.mlp.3", blk["Mlp_0"]["Dense_1"])
        _dense(sd, f"{ref}.adaLN_modulation.1",
               blk["AdaLNModulation_0"]["Dense_0"])
        i += 1
    fl = params["FinalLayer_0"]
    _dense(sd, "final_layer.linear", fl["Dense_0"])
    _dense(sd, "final_layer.adaLN_modulation.1",
           fl["AdaLNModulation_0"]["Dense_0"])
    return sd


def _mamba(sd: Dict, key: str, m: Mapping) -> None:
    """A Mamba mixer under mamba_ssm's names: the fused in_proj with rows
    [x; z], the depthwise conv, x_proj, dt_proj, A_log, D, out_proj."""
    sd[f"{key}.in_proj.weight"] = np.ascontiguousarray(np.concatenate(
        [_lin(m["in_proj_x"]["kernel"]), _lin(m["in_proj_z"]["kernel"])]))
    sd[f"{key}.conv1d.weight"] = _conv1d_dw(m["conv"]["kernel"])
    sd[f"{key}.conv1d.bias"] = _arr(m["conv"]["bias"])
    _dense(sd, f"{key}.x_proj", m["x_dbl"])
    _dense(sd, f"{key}.dt_proj", m["dt_proj"])
    sd[f"{key}.A_log"] = _arr(m["A_log"])
    sd[f"{key}.D"] = _arr(m["D"])
    _dense(sd, f"{key}.out_proj", m["out_proj"])


def dim_params_to_numpy_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax DiM params -> reference-named arrays."""
    sd = _patch_scaffold(params)
    i = 0
    while f"DiMBlock_{i}" in params:
        blk, ref = params[f"DiMBlock_{i}"], f"blocks.{i}"
        mb = blk["MambaBlock_0"]
        _norm(sd, f"{ref}.mamba_block.norm", mb["LayerNorm_0"])
        _dense(sd, f"{ref}.mamba_block.adaLN_modulation.1",
               mb["AdaLNModulation_0"]["Dense_0"])
        mm = f"{ref}.mamba_block.mamba"
        if "attn" in mb:  # the attention-fallback mixer, in the mixer's place
            _attention(sd, mm, mb["attn"])
        elif "Mamba_0" not in mb:
            raise ValueError(f"DiMBlock_{i} has neither Mamba_0 nor attn")
        else:
            _mamba(sd, mm, mb["Mamba_0"])
        ff = blk["FeedForward_0"]
        _norm(sd, f"{ref}.ff_block.norm", ff["LayerNorm_0"])
        _dense(sd, f"{ref}.ff_block.mlp.0", ff["Mlp_0"]["Dense_0"])
        _dense(sd, f"{ref}.ff_block.mlp.3", ff["Mlp_0"]["Dense_1"])
        _dense(sd, f"{ref}.ff_block.adaLN_modulation.1",
               ff["AdaLNModulation_0"]["Dense_0"])
        i += 1
    fl = params["DiMFinalLayer_0"]
    _norm(sd, "final_layer.norm_final", fl["LayerNorm_0"])
    _dense(sd, "final_layer.linear", fl["Dense_0"])
    _dense(sd, "final_layer.adaLN_modulation.1",
           fl["AdaLNModulation_0"]["Dense_0"])
    return sd


def _vae_block(sd: Dict, key: str, blk: Mapping) -> None:
    """A Flax `VAEResBlock`: FusedGroupNormSiLU_0/1, Conv_0/1 and the 1x1
    shortcut Conv_2 of a block that changes the width."""
    _norm(sd, f"{key}.norm1", blk["FusedGroupNormSiLU_0"])
    sd[f"{key}.conv1.weight"] = _conv2d(blk["Conv_0"]["kernel"])
    sd[f"{key}.conv1.bias"] = _arr(blk["Conv_0"]["bias"])
    _norm(sd, f"{key}.norm2", blk["FusedGroupNormSiLU_1"])
    sd[f"{key}.conv2.weight"] = _conv2d(blk["Conv_1"]["kernel"])
    sd[f"{key}.conv2.bias"] = _arr(blk["Conv_1"]["bias"])
    if "Conv_2" in blk:
        sd[f"{key}.shortcut.weight"] = _conv2d(blk["Conv_2"]["kernel"])
        sd[f"{key}.shortcut.bias"] = _arr(blk["Conv_2"]["bias"])


def _conv(sd: Dict, key: str, conv: Mapping) -> None:
    sd[f"{key}.weight"] = _conv2d(conv["kernel"])
    sd[f"{key}.bias"] = _arr(conv["bias"])


def vae_params_to_numpy_state_dict(params: Mapping,
                                   model_cfg: Mapping) -> Dict[str, np.ndarray]:
    """Flax VAE params -> the port's VAE keys. `model_cfg` holds the VAE's
    constructor fields (channel_mult, num_res_blocks). Flax names a block
    `VAEResBlock_N`, or `CheckpointVAEResBlock_N` under `remat: true`, and
    numbers a coder's convs in call order: Conv_0 in, Conv_1 out."""
    n_levels = len(tuple(model_cfg.get("channel_mult", (1, 2))))
    n_blocks = int(model_cfg.get("num_res_blocks", 1))
    sd: Dict[str, np.ndarray] = {}
    for part in ("encoder", "decoder"):
        tree = params[part]
        prefix = ("CheckpointVAEResBlock" if "CheckpointVAEResBlock_0" in tree
                  else "VAEResBlock")
        blocks = iter(range(n_levels * n_blocks + 1))
        _conv(sd, f"{part}.conv_in", tree["Conv_0"])
        _conv(sd, f"{part}.conv_out", tree["Conv_1"])
        _norm(sd, f"{part}.norm_out", tree["FusedGroupNormSiLU_0"])
        if "AttentionBlock_0" in tree:
            attn = tree["AttentionBlock_0"]
            _norm(sd, f"{part}.attn.norm", attn["GroupNorm_0"])
            _conv(sd, f"{part}.attn.qkv", attn["Conv_0"])
            _conv(sd, f"{part}.attn.proj", attn["Conv_1"])
        if part == "decoder":  # the middle block runs first
            _vae_block(sd, f"{part}.mid", tree[f"{prefix}_{next(blocks)}"])
        # the blocks and resamplers in call order: down.{i} or up.{i}
        seq, resampler = ((f"{part}.down", "Downsample") if part == "encoder"
                          else (f"{part}.up", "Upsample"))
        i = 0
        for level in range(n_levels):
            for _ in range(n_blocks):
                _vae_block(sd, f"{seq}.{i}", tree[f"{prefix}_{next(blocks)}"])
                i += 1
            if level != n_levels - 1:
                _conv(sd, f"{seq}.{i}.conv",
                      tree[f"{resampler}_{level}"]["Conv_0"])
                i += 1
        if part == "encoder":
            _vae_block(sd, f"{part}.mid", tree[f"{prefix}_{next(blocks)}"])
        extra = f"{prefix}_{n_levels * n_blocks + 1}"
        if extra in tree:
            raise ValueError(
                f"VAE {part} holds {extra}: the model config does not match "
                "the checkpoint (channel_mult, num_res_blocks)")
    return sd


def classifier_params_to_numpy_state_dict(
        params: Mapping, model_cfg: Mapping) -> Dict[str, np.ndarray]:
    """Flax `NoisyClassifier` params -> the port's classifier keys.
    `model_cfg` holds its constructor fields. Flax names the residual blocks
    `ResidualBlock_N` explicitly (with and without `remat`), the others in
    call order: AttentionBlock_N, Downsample_N, Conv_0 (the input conv),
    FusedGroupNormSiLU_0 and Dense_0 (the head)."""
    sd: Dict[str, np.ndarray] = {}
    te = params["UNetTimeEmbed_0"]
    _dense(sd, "time_embed.1", te["Dense_0"])
    _dense(sd, "time_embed.3", te["Dense_1"])
    _conv(sd, "input_conv", params["Conv_0"])
    _norm(sd, "norm_out", params["FusedGroupNormSiLU_0"])
    _dense(sd, "head", params["Dense_0"])
    plan = classifier_plan(
        tuple(model_cfg["image_size"]), model_cfg.get("num_res_blocks", 1),
        tuple(model_cfg.get("attention_resolutions", (8,))),
        tuple(model_cfg.get("channel_mult", (1, 2, 2))),
        model_cfg.get("use_attention", True))
    counters = {"res": 0, "attn": 0, "down": 0}
    jax_name = {"res": "ResidualBlock", "attn": "AttentionBlock",
                "down": "Downsample"}
    for i, (kind, _) in enumerate(plan):
        blk = params[f"{jax_name[kind]}_{counters[kind]}"]
        counters[kind] += 1
        pref = f"blocks.{i}"
        if kind == "res":
            _norm(sd, f"{pref}.conv1.0", blk["FusedGroupNormSiLU_0"])
            _conv(sd, f"{pref}.conv1.2", blk["Conv_0"])
            _dense(sd, f"{pref}.time_mlp.1", blk["Dense_0"])
            _norm(sd, f"{pref}.conv2.0", blk["FusedGroupNormSiLU_1"])
            _conv(sd, f"{pref}.conv2.3", blk["Conv_1"])
            if "Conv_2" in blk:  # 1x1 shortcut of channel-changing blocks
                _conv(sd, f"{pref}.shortcut", blk["Conv_2"])
        elif kind == "attn":
            _norm(sd, f"{pref}.norm", blk["GroupNorm_0"])
            _conv(sd, f"{pref}.qkv", blk["Conv_0"])
            _conv(sd, f"{pref}.proj", blk["Conv_1"])
        else:
            _conv(sd, f"{pref}.conv", blk["Conv_0"])
    for kind, count in counters.items():
        extra = f"{jax_name[kind]}_{count}"
        if extra in params:
            raise ValueError(
                f"classifier plan consumed {count} {jax_name[kind]}s but the "
                f"params contain {extra}: the model config does not match "
                "the checkpoint (attention_resolutions, channel_mult, "
                "num_res_blocks, image_size)")
    return sd


def resolved_model_cfg(config: Mapping) -> Dict:
    """model_params with the image_size, channels and num_classes that the
    factory injects (under latent diffusion the size of the VAE's latents;
    under super_resolution twice the data channels in)."""
    cfg = dict(config.get("model_params", {}))
    cfg["image_size"] = resolve_image_size(config["image_size"])
    if config.get("latent_diffusion"):
        from .latent import LatentCodec  # deferred: it loads checkpoints

        cfg["image_size"] = LatentCodec.from_config(
            config, device="cpu").latent_hw()
    if config.get("super_resolution"):
        data_ch = int(cfg.get("in_channels", 3))
        cfg["in_channels"] = 2 * data_ch
        cfg.setdefault("out_channels", data_ch)
    if not config.get("conditional", False):
        cfg["num_classes"] = None
    return cfg


def state_dict_from_jax(params: Mapping,
                       config: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax UNet, DiT, DiM, VAE or classifier param tree -> the port's
    (and, but for the VAE and the classifier, the reference's) `state_dict`,
    for the model that `config` describes."""
    model_type = str(config.get("model_type", "unet")).lower()
    if model_type == "unet":
        sd = unet_params_to_numpy_state_dict(params,
                                             resolved_model_cfg(config))
    elif model_type == "dit":
        sd = dit_params_to_numpy_state_dict(params)
    elif model_type == "dim":
        sd = dim_params_to_numpy_state_dict(params)
    elif model_type == "vae":
        sd = vae_params_to_numpy_state_dict(params,
                                            config.get("model_params", {}))
    elif model_type == "classifier":
        sd = classifier_params_to_numpy_state_dict(
            params, resolved_model_cfg(config))
    else:
        raise ValueError(f"Unknown model type: {model_type}")
    return {k: torch.tensor(v) for k, v in sd.items()}  # copies: jax arrays are read-only


def inception_state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """A Flax `metrics.inception.InceptionV3` param tree -> torchvision
    `inception_v3` keys (without `AuxLogits.*` and `num_batches_tracked`):
    `<block>.conv.weight` (OIHW), `<block>.bn.{weight, bias, running_mean,
    running_var}` from `bn_scale`, `bn_bias`, `bn_mean`, `bn_var`, and
    `fc.weight`, `fc.bias`."""
    bn = {"bn_scale": "bn.weight", "bn_bias": "bn.bias",
          "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}
    sd: Dict[str, np.ndarray] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, child in node.items():
            if prefix == "" and name == "fc":
                _dense(sd, "fc", child)
            elif name == "conv":
                sd[f"{prefix}conv.weight"] = _conv2d(child["kernel"])
            elif name in bn:
                sd[f"{prefix}{bn[name]}"] = _arr(child)
            else:
                walk(child, f"{prefix}{name}.")

    walk(params, "")
    return sd


# torchvision alexnet `features` index of the LPIPS AlexNet's conv1..conv5
ALEXNET_CONV_IDS = (0, 3, 6, 8, 10)


def alexnet_state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """A Flax `metrics.lpips_score.AlexNetFeatures` param tree (conv1..conv5)
    -> torchvision alexnet keys `features.N.{weight, bias}`."""
    sd: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(ALEXNET_CONV_IDS, start=1):
        conv = params[f"conv{i}"]
        sd[f"features.{idx}.weight"] = _conv2d(conv["kernel"])
        sd[f"features.{idx}.bias"] = _arr(conv["bias"])
    return sd
