"""Build and load the port's CUDA kernels.

Replaces the JAX package's `ops/dispatch.py`: there is no backend choice to
make. A wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises.

The kernels are CUDA C++ for Hopper (`sm_90a`) under `../csrc/`, compiled
with nvcc into one shared library with a plain C interface and loaded with
ctypes. Each source compiles in its own nvcc process, all started together,
and one more nvcc links the objects. The build runs at the first kernel
launch, never at import (this package imports on machines without nvcc), and
goes into `<checkout>/build/torch_kernels/`, keyed by a hash of the sources
and flags, so a second process reuses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None

# Filled by the build that this process ran or found: the library's path,
# the seconds nvcc took (0.0 when an earlier build was reused) and the
# compiler's output (registers, shared memory and spills per kernel).
build_info: dict = {}


def _sources():
    """Every source the build compiles or includes (`philox.cuh`,
    `selective_scan_common.cuh`, and `flash_attn.cu`, `flash_attn_bwd.cu`
    once more through the bias forms' units): all of them key the build's
    hash."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built on this machine"
    )


def build() -> Path:
    """Compile `csrc/*.cu` into the shared library unless a build of the
    same sources and flags exists; return its path."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libdmc_torch_kernels-{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0,
                          log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    cus = [src for src in srcs if src.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cus]
    start = time.perf_counter()
    # one nvcc per source, all started at once; then one link
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(cus, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *[str(o) for o in objs]]
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - start
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(out for _, out, _ in steps)
    for cmd, out, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{out}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    build_info.update(path=str(lib_path), seconds=seconds, log=log)
    return lib_path


def kernel_sass() -> dict:
    """The SASS of every kernel in the built library, by mangled name, as
    `cuobjdump -sass` (beside nvcc) prints it: what shows which units a
    kernel runs on (`HMMA`: the tensor cores)."""
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name(
        "cuobjdump"))
    out = subprocess.run([tool, "-sass", str(build())],
                         capture_output=True, text=True, check=True).stdout
    sass, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            sass[name] = []
        elif name is not None:
            sass[name].append(line)
    return {key: "\n".join(lines) for key, lines in sass.items()}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the attention kernels' dropout: on, threshold, 1 / (1 - p), seed
    dropout = [i32, ctypes.c_uint32, f32, ctypes.c_uint64]
    # the GroupNorm+SiLU and attention entries end in (bf16, stream): bf16
    # != 0 takes the bfloat16 form
    lib.gn_silu_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [f32, i32, ptr]
    lib.gn_silu_fwd.restype = i32
    lib.gn_silu_bwd.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.gn_silu_bwd.restype = i32
    lib.gn_silu_form.argtypes = [i32] * 5
    lib.gn_silu_form.restype = i32
    lib.flash_attn_fwd.argtypes = ([ptr] * 5 + [i32, i32, i32, f32, i32]
                                   + dropout + [i32, ptr])
    lib.flash_attn_fwd.restype = i32
    lib.flash_attn_bwd.argtypes = ([ptr] * 11 + [i32, i32, i32, f32, i32, i32]
                                   + dropout + [i32, ptr])
    lib.flash_attn_bwd.restype = i32
    # the bias forms: the same arguments, then (bias, heads) before the stream
    lib.flash_attn_fwd_bias.argtypes = (lib.flash_attn_fwd.argtypes[:-1]
                                        + [ptr, i32, ptr])
    lib.flash_attn_fwd_bias.restype = i32
    lib.flash_attn_bwd_bias.argtypes = (lib.flash_attn_bwd.argtypes[:-1]
                                        + [ptr, i32, ptr])
    lib.flash_attn_bwd_bias.restype = i32
    lib.selective_scan_fwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.selective_scan_fwd.restype = i32
    lib.selective_scan_bwd.argtypes = [ptr] * 13 + [i32] * 5 + [ptr]
    lib.selective_scan_bwd.restype = i32
    lib.selective_scan_bwd_nostate.argtypes = [ptr] * 13 + [i32] * 5 + [ptr]
    lib.selective_scan_bwd_nostate.restype = i32
    lib.selective_scan_bwd_nostate_needs_scratch.argtypes = [i32] * 3
    lib.selective_scan_bwd_nostate_needs_scratch.restype = i32
    lib.selective_scan_fwd_split.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.selective_scan_fwd_split.restype = i32
    lib.selective_scan_bwd_split.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
    lib.selective_scan_bwd_split.restype = i32
    for name in ("selective_scan_bwd_tiles", "selective_scan_bwd_width"):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = i32
    lib.dmc_cuda_error_string.argtypes = [i32]
    lib.dmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = library().dmc_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


FLOAT32 = (torch.float32,)
# the element types of the GroupNorm+SiLU and attention kernels' activations
FLOAT32_OR_BF16 = (torch.float32, torch.bfloat16)


def check_inputs(name: str, *tensors, dtypes=FLOAT32) -> None:
    """What every kernel takes: contiguous tensors of one of `dtypes`, on one
    device that is the CPU (plain version) or a CUDA device (kernel)."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {' or '.join(map(str, dtypes))} only, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def check_io_dtype(name: str, io, fp32=()) -> bool:
    """`check_inputs` for a kernel whose activations `io` are float32 or
    bfloat16, all of one type, beside float32 tensors `fp32` (parameters,
    statistics) on the same device; returns whether `io` is bfloat16 (the
    kernel's bf16 form)."""
    check_inputs(name, *io, *fp32, dtypes=FLOAT32_OR_BF16)
    if fp32:
        check_inputs(name, *fp32)
    if any(t.dtype != io[0].dtype for t in io):
        raise TypeError(f"{name}: the activations must share one dtype, got "
                        + ", ".join(str(t.dtype) for t in io))
    return io[0].dtype == torch.bfloat16
