"""Weight bridge: a Flax UNet or DiM param tree (nested dicts of numpy
arrays, as a JAX checkpoint stores it) to the port's `state_dict`.

Counterpart of `diffusion_models_collection_tpu/utils/torch_export.py`
(`_unet_torch_plan`, `_export_unet`, `_export_patch_scaffold`,
`_export_dim`), in numpy and torch only: that module imports the JAX
package's helpers, which need JAX. The port's models use the PyTorch
reference's key names, so the result also equals what the JAX exporter
writes for the reference, and loads with `strict=True`.

Layouts (Flax -> torch): Dense kernel (in, out) -> Linear weight (out, in);
Conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw); depthwise conv
kernel (k, 1, D) -> Conv1d weight (D, 1, k); GroupNorm and LayerNorm scale
-> weight; embedding -> weight. DiM's two input projections (x, z) become
one fused `in_proj` with rows [x; z].
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

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


def dim_params_to_numpy_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax DiM params -> reference-named arrays."""
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
    i = 0
    while f"DiMBlock_{i}" in params:
        blk, ref = params[f"DiMBlock_{i}"], f"blocks.{i}"
        mb = blk["MambaBlock_0"]
        if "Mamba_0" not in mb:
            raise NotImplementedError(
                f"DiMBlock_{i} holds the attention-fallback mixer, which is "
                "not ported yet (ROADMAP queue 1 item 8)")
        _norm(sd, f"{ref}.mamba_block.norm", mb["LayerNorm_0"])
        _dense(sd, f"{ref}.mamba_block.adaLN_modulation.1",
               mb["AdaLNModulation_0"]["Dense_0"])
        m, mm = mb["Mamba_0"], f"{ref}.mamba_block.mamba"
        sd[f"{mm}.in_proj.weight"] = np.ascontiguousarray(np.concatenate(
            [_lin(m["in_proj_x"]["kernel"]), _lin(m["in_proj_z"]["kernel"])]))
        sd[f"{mm}.conv1d.weight"] = _conv1d_dw(m["conv"]["kernel"])
        sd[f"{mm}.conv1d.bias"] = _arr(m["conv"]["bias"])
        _dense(sd, f"{mm}.x_proj", m["x_dbl"])
        _dense(sd, f"{mm}.dt_proj", m["dt_proj"])
        sd[f"{mm}.A_log"] = _arr(m["A_log"])
        sd[f"{mm}.D"] = _arr(m["D"])
        _dense(sd, f"{mm}.out_proj", m["out_proj"])
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


def resolved_model_cfg(config: Mapping) -> Dict:
    """model_params with the image_size and num_classes that the factory
    injects."""
    cfg = dict(config.get("model_params", {}))
    cfg["image_size"] = resolve_image_size(config["image_size"])
    if not config.get("conditional", False):
        cfg["num_classes"] = None
    return cfg


def state_dict_from_jax(params: Mapping,
                       config: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax UNet or DiM param tree -> the port's (and the reference's)
    `state_dict`, for the model that `config` describes."""
    model_type = str(config.get("model_type", "unet")).lower()
    if model_type == "unet":
        sd = unet_params_to_numpy_state_dict(params,
                                             resolved_model_cfg(config))
    elif model_type == "dim":
        sd = dim_params_to_numpy_state_dict(params)
    else:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP queue 1 "
            "items 8 and 11)")
    return {k: torch.tensor(v) for k, v in sd.items()}  # copies: jax arrays are read-only
