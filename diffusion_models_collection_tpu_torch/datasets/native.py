"""ctypes bindings for the native C++ data-pipeline library.

Loads (building on first use) native/libdmc_native.so and exposes the
fused gather+normalize+flip batch assembly, batched bilinear resize and
denormalize kernels. Every entry point has a numpy fallback, so the
framework works identically without a C++ toolchain — the native path is
a host-throughput optimization (SURVEY.md §2.2: the reference's native
surface lives in its dependencies; ours lives here).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "libdmc_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


_ABI_VERSION = 2


def _build() -> None:
    subprocess.run(
        ["sh", str(_NATIVE_DIR / "build.sh")],
        check=True,
        capture_output=True,
        timeout=120,
    )


def _open_fresh() -> ctypes.CDLL:
    """dlopen the just-rebuilt library under a unique path: the dynamic
    loader caches handles by pathname, so re-CDLL'ing the canonical path
    after an in-place rebuild returns the STALE handle. A transient copy
    (unlinked immediately — the mapping keeps it alive) sidesteps the
    cache."""
    import os
    import shutil

    tmp = _NATIVE_DIR / f".libdmc_native.{os.getpid()}.so"
    shutil.copy2(_LIB_PATH, tmp)
    try:
        return ctypes.CDLL(str(tmp))
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _LIB_PATH.exists():
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.dmc_native_abi_version.restype = ctypes.c_int
            if lib.dmc_native_abi_version() != _ABI_VERSION:
                # stale .so from an older checkout — rebuild, then load
                # the fresh binary under a unique name (see _open_fresh)
                _build()
                lib = _open_fresh()
                lib.dmc_native_abi_version.restype = ctypes.c_int
                if lib.dmc_native_abi_version() != _ABI_VERSION:
                    return None
            lib.dmc_gather_normalize.argtypes = [
                _u8p, _i64p, ctypes.c_void_p, _f32p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.dmc_resize_bilinear.argtypes = [
                _u8p, _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.dmc_denormalize_to_u8.argtypes = [_f32p, _u8p, ctypes.c_int64]
            lib.dmc_jpeg_dims.restype = ctypes.c_int
            lib.dmc_jpeg_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.dmc_decode_jpeg_rgb.restype = ctypes.c_int
            lib.dmc_decode_jpeg_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, _u8p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def gather_normalize(
    images: np.ndarray,
    indices: np.ndarray,
    flip_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gather images[indices] as float32 HWC in [-1, 1], flipping where
    flip_mask is set. images: (N, H, W, C) uint8 contiguous."""
    lib = _load()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    n, h, w, c = images.shape
    batch = len(indices)
    if lib is None or not images.flags["C_CONTIGUOUS"]:
        out = images[indices].astype(np.float32) / 255.0 * 2.0 - 1.0
        if flip_mask is not None and flip_mask.any():
            out[flip_mask.astype(bool)] = out[flip_mask.astype(bool), :, ::-1]
        return out
    out = np.empty((batch, h, w, c), dtype=np.float32)
    mask_ptr = None
    if flip_mask is not None:
        flip_mask = np.ascontiguousarray(flip_mask, dtype=np.uint8)
        mask_ptr = flip_mask.ctypes.data_as(ctypes.c_void_p)
    lib.dmc_gather_normalize(images, indices, mask_ptr, out, batch, h, w, c)
    return out


def resize_bilinear_batch(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Batched uint8 bilinear resize (N, H, W, C) -> (N, dh, dw, C)."""
    lib = _load()
    n, sh, sw, c = src.shape
    if sh == dh and sw == dw:
        return src
    if lib is None:
        from .transforms import resize_image

        return np.stack([resize_image(im, (dh, dw)) for im in src])
    src = np.ascontiguousarray(src)
    out = np.empty((n, dh, dw, c), dtype=np.uint8)
    lib.dmc_resize_bilinear(src, out, n, sh, sw, dh, dw, c)
    return out


_JPEG_MAGIC = b"\xff\xd8\xff"


def decode_jpeg(data: bytes, scale_denom: int = 1) -> Optional[np.ndarray]:
    """Decode JPEG bytes to uint8 (H, W, 3) RGB via libjpeg directly —
    the same decoder PIL wraps, minus the Image-object machinery and with
    the GIL released for the whole decode (ctypes drops it around the C
    call), so decode threads scale on multi-core hosts (reference analog:
    torch DataLoader worker processes, train.py:107-128).

    scale_denom in {1, 2, 4, 8} decodes at 1/denom resolution straight
    out of the DCT (libjpeg scaled IDCT — same output as PIL's
    `Image.draft`), skipping most of the decode work when the pipeline
    resizes down anyway. Returns None when the native path can't handle
    the input (no libjpeg at build time, corrupt stream, CMYK) — callers
    fall back to PIL."""
    lib = _load()
    if lib is None or not data.startswith(_JPEG_MAGIC):
        return None
    full_hw = _probe_dims(lib, data)
    if full_hw is None:
        return None
    return _decode(lib, data, full_hw, scale_denom)


def _probe_dims(lib, data: bytes):
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    if lib.dmc_jpeg_dims(data, len(data), ctypes.byref(h),
                         ctypes.byref(w)) != 0:
        return None
    if h.value <= 0 or w.value <= 0 or h.value * w.value > 10_000 ** 2:
        return None
    return (h.value, w.value)


def _decode(lib, data: bytes, full_hw, scale_denom: int):
    oh = -(-full_hw[0] // scale_denom)  # libjpeg: ceil(dim/denom)
    ow = -(-full_hw[1] // scale_denom)
    out = np.empty((oh, ow, 3), dtype=np.uint8)
    if lib.dmc_decode_jpeg_rgb(data, len(data), out, oh, ow,
                               scale_denom) != 0:
        return None
    return out


def jpeg_scale_denom(full_hw, min_hw) -> int:
    """Largest denom in {8, 4, 2, 1} whose scaled dims still cover
    min_hw (so a following resize only ever downscales)."""
    for denom in (8, 4, 2):
        if (-(-full_hw[0] // denom) >= min_hw[0]
                and -(-full_hw[1] // denom) >= min_hw[1]):
            return denom
    return 1


def decode_image_file(path, min_hw=None) -> Optional[np.ndarray]:
    """Native decode of an image file if it is a JPEG; None otherwise
    (PNG/BMP/... and any failure fall back to the caller's PIL path).
    min_hw (H, W) opts into DCT-scaled decode: the image is decoded at
    the coarsest 1/denom scale that still covers min_hw."""
    lib = _load()
    if lib is None:
        return None  # before reading the file — PIL will read it anyway
    try:
        with open(path, "rb") as f:
            head = f.read(3)
            if head != _JPEG_MAGIC:
                return None
            data = head + f.read()
    except OSError:
        return None
    full_hw = _probe_dims(lib, data)
    if full_hw is None:
        return None
    denom = jpeg_scale_denom(full_hw, min_hw) if min_hw is not None else 1
    return _decode(lib, data, full_hw, denom)


def denormalize_to_u8(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> uint8 [0, 255], any shape."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None:
        return (np.clip((x + 1) * 0.5, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    out = np.empty(x.shape, dtype=np.uint8)
    lib.dmc_denormalize_to_u8(x.reshape(-1), out.reshape(-1), x.size)
    return out
