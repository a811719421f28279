"""Utility functions of the sampling and training paths.

Counterpart of `diffusion_models_collection_tpu/utils/helpers.py`.
`set_seed` returns a `torch.Generator` (the JAX package returns a PRNG key),
and images are written and read as PNG by a small zlib codec, since Pillow
is not a dependency of the port: only `create_gif` and a resize in
`load_image_for_model` or `load_mask_for_model` import it, when called.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import struct
import sys
import zlib
from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np
import torch


def set_seed(seed: int = 42, device: Union[str, torch.device] = "cpu",
             process_offset: int = 0) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators (torch's draws
    the dropout masks) and return a `torch.Generator` on `device` seeded
    with `seed`. `process_offset` (a rank) is added to the seed of Python's
    and numpy's generators only, as the JAX CLI offsets its host seed by
    the process index: torch's generators, which draw the weights, the
    dropout masks and the step's draws over the global batch, are seeded
    alike on every rank."""
    random.seed(seed + process_offset)
    np.random.seed(seed + process_offset)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def resolve_device(name: str, task: str) -> torch.device:
    """The device a CLI asked for with `--device`: CUDA must be present when
    asked for, and then runs float32 without TF32 in matrix products and
    convolutions; the CPU runs only when asked for."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: CUDA is not available on this machine "
                f"(pass --device cpu to {task} on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"--device {name}: expected cuda or cpu")
    return device


def count_parameters(model: torch.nn.Module) -> int:
    """Total number of parameter elements."""
    return sum(p.numel() for p in model.parameters())


def resolve_image_size(image_size: Union[int, Sequence[int]]
                       ) -> Tuple[int, int]:
    """Normalize image_size to (H, W)."""
    if isinstance(image_size, int):
        return (image_size, image_size)
    if isinstance(image_size, (list, tuple)) and len(image_size) == 2:
        h, w = image_size
        if not (isinstance(h, int) and isinstance(w, int)):
            raise ValueError("image_size values must be integers")
        return (h, w)
    raise ValueError("image_size must be int or a pair (H, W)")


def load_config(config_path: Union[str, Path]) -> dict:
    """A config dict from a `.py` module (its `config` variable), a `.json`
    or a `.yaml`/`.yml` file."""
    path = Path(config_path)
    if path.suffix == ".json":
        with path.open("r", encoding="utf-8") as f:
            return json.load(f)
    if path.suffix in (".yaml", ".yml"):
        import yaml

        with path.open("r", encoding="utf-8") as f:
            return yaml.safe_load(f)
    spec = importlib.util.spec_from_file_location("config", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules["config"] = module
    spec.loader.exec_module(module)
    return module.config


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2
              ) -> np.ndarray:
    """Tile (N, H, W, C) images into one (GH, GW, C) grid, `nrow` images per
    row, zero padding between them."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    rows = math.ceil(n / nrow)
    grid = np.zeros((rows * h + (rows + 1) * padding,
                     nrow * w + (nrow + 1) * padding, c), dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, nrow)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[idx]
    return grid


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels: gray, RGB, gray + alpha, RGBA
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def encode_png(image: np.ndarray) -> bytes:
    """An (H, W) or (H, W, C) uint8 image, C in {1, 3, 4}, as the bytes of
    an 8-bit PNG (no filtering, zlib level 6)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    rows = image.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: Union[str, Path], image: np.ndarray) -> None:
    """Write an (H, W) or (H, W, C) uint8 image, C in {1, 3, 4}, as an
    8-bit PNG (`encode_png`)."""
    data = encode_png(image)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(data)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB, gray + alpha or RGBA PNG as an
    (H, W, C) uint8 array (every filter type; no palette, 16-bit or
    interlaced files)."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray, RGB, gray + alpha and "
            f"RGBA PNGs are read here (bit depth {depth}, colour type "
            f"{color_type}, interlace {interlace})")
    bpp = PNG_CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.int32)
    for r in range(h):
        kind, row = raw[r, 0], raw[r, 1:].astype(np.int32)
        if kind == 1:  # Sub: a running sum along the row, per channel
            row = np.cumsum(row.reshape(w, bpp), axis=0).reshape(-1)
        elif kind == 2:  # Up
            row = row + prior
        elif kind in (3, 4):  # Average, Paeth: each pixel needs its left
            row = row.copy()
            for x in range(w):
                cur = slice(x * bpp, (x + 1) * bpp)
                up = prior[cur]
                left = (row[cur.start - bpp:cur.start] % 256 if x
                        else np.zeros(bpp, np.int32))
                if kind == 3:
                    row[cur] += (left + up) // 2
                else:
                    diag = (prior[cur.start - bpp:cur.start] if x
                            else np.zeros(bpp, np.int32))
                    pa = np.abs(up - diag)
                    pb = np.abs(left - diag)
                    pc = np.abs(left + up - 2 * diag)
                    row[cur] += np.where((pa <= pb) & (pa <= pc), left,
                                         np.where(pb <= pc, up, diag))
        elif kind != 0:
            raise ValueError(f"{path}: unknown PNG filter type {kind}")
        prior = row % 256
        out[r] = prior
    return out.reshape(h, w, bpp)


def _to_gray_or_rgb(image: np.ndarray, gray: bool) -> np.ndarray:
    """Pillow's `convert('L')` or `convert('RGB')` of an (H, W, C) uint8
    image: alpha dropped, gray copied to three channels, RGB to gray by
    the ITU-R 601-2 luma in Pillow's integer form."""
    color = image[..., :3] if image.shape[2] >= 3 else image[..., :1]
    if not gray:
        return np.repeat(color, 3, axis=2) if color.shape[2] == 1 else color
    if color.shape[2] == 1:
        return color
    rgb = color.astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)[..., None]


def _read_at_size(path, image_size: Tuple[int, int], mode: str,
                  resample: str) -> np.ndarray:
    """The file as (H, W, C) uint8 in Pillow mode `mode` ('L' or 'RGB') at
    `image_size`: read here when it already has that size, else opened,
    converted and resized (`resample`) by Pillow."""
    h, w = image_size
    try:
        image = read_png(path)
    except ValueError:
        image = None
    if image is not None and image.shape[:2] == (h, w):
        return _to_gray_or_rgb(image, mode == "L")
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit(
            f"{path} is not an 8-bit PNG of the model's size {h}x{w}: "
            "reading and resizing it needs Pillow, which is not installed"
        ) from None
    img = Image.open(path).convert(mode)
    img = img.resize((w, h), getattr(Image, resample))
    arr = np.asarray(img)
    return arr[..., None] if arr.ndim == 2 else arr


def load_image_for_model(path, image_size: Tuple[int, int],
                         in_channels: int) -> np.ndarray:
    """An image as the model's (1, H, W, C) float32 input in [-1, 1]: gray
    for one channel, else RGB, bilinear resize when its size differs (the
    JAX pipeline's `load_image_for_model`)."""
    arr = _read_at_size(path, image_size, "L" if in_channels == 1 else "RGB",
                        "BILINEAR")
    return np.asarray(arr, np.float32)[None] / 255.0 * 2.0 - 1.0


def load_mask_for_model(path, image_size: Tuple[int, int]) -> np.ndarray:
    """An inpainting mask as (1, H, W, 1) float32: white (gray >= 0.5)
    regenerates (1), black keeps (0); nearest resize when its size
    differs (the JAX pipeline's `load_mask_for_model`)."""
    arr = _read_at_size(path, image_size, "L", "NEAREST")
    return (np.asarray(arr, np.float32) / 255.0 >= 0.5).astype(
        np.float32)[None]


def save_image(image: np.ndarray, save_path: Union[str, Path]) -> None:
    """Save one (H, W, C) float image in [0, 1] as an 8-bit PNG."""
    write_png(save_path, (np.clip(np.asarray(image, np.float32), 0.0, 1.0)
                          * 255).round().astype(np.uint8))


def save_image_grid(images: np.ndarray, save_path: Union[str, Path],
                    nrow: int = 8, padding: int = 2) -> None:
    """Save (N, H, W, C) float images in [0, 1] as one PNG grid."""
    grid = make_grid(np.asarray(images, dtype=np.float32), nrow, padding)
    write_png(save_path,
              (np.clip(grid, 0.0, 1.0) * 255).round().astype(np.uint8))


def create_gif(frames: Sequence[np.ndarray], save_path: Union[str, Path],
               fps: int = 20) -> None:
    """Write (H, W, C) float frames in [0, 1] as a looping GIF (Pillow)."""
    from PIL import Image

    images = []
    for frame in frames:
        arr = (np.clip(np.asarray(frame, np.float32), 0.0, 1.0) * 255
               ).round().astype(np.uint8)
        images.append(Image.fromarray(arr[..., 0] if arr.shape[-1] == 1
                                      else arr))
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    images[0].save(str(save_path), save_all=True, append_images=images[1:],
                   duration=1000 / fps, loop=0)


def format_duration(total_seconds: float) -> str:
    """'Xh Ym Zs' wall-time string."""
    hours = int(total_seconds // 3600)
    minutes = int((total_seconds % 3600) // 60)
    return f"{hours}h {minutes}m {total_seconds % 60:.1f}s"
