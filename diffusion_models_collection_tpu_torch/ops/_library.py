"""The port's kernels as `torch.library` operators, namespace `dmc`.

Every kernel launcher of `fused_norm.py`, `flash_attention.py` and
`selective_scan.py` is one operator with three implementations: CUDA (the
ctypes launch of the kernel, which counts its launch), CPU (the kernel's
plain version) and fake (the outputs' shapes, dtypes and strides from the
inputs' alone). The dispatcher picks the implementation from the inputs'
device, so a CUDA tensor launches the kernel or raises, as before; and a
tracer (`torch.export`, `torch.compile`, a CUDA graph's capture) sees one
opaque node whose outputs it can size without a data pointer.

The operators are defined with `torch.library.Library`'s `define` and `impl`
and `register_fake`, not the `custom_op` decorator, which wraps every call
in Python layers of its own: the bf16 sampling paths are host-bound, and
each call's dispatch cost is paid about 56 times a UNet forward
(`tools/profile_torch_dispatch.py` times both). The autograd Functions
(`GroupNormSiLU`, `FlashAttention`, `SelectiveScan`) call the operators in
their forward and backward, so no operator needs an autograd kernel.
`torch.ops.dmc.<name>` names each; `OPS` lists them for `opcheck`.
"""

from __future__ import annotations

import torch

LIB = torch.library.Library("dmc", "DEF")

# name -> the operator's default overload, in the order of definition
OPS: dict = {}


def define(schema: str, *, cpu, cuda, fake):
    """Define `dmc::<schema>` with its CPU, CUDA and fake implementations;
    returns the operator (its default overload)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"dmc::{name}", fake, lib=LIB)
    OPS[name] = getattr(torch.ops.dmc, name).default
    return OPS[name]
