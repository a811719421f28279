"""int8 (w8a8) linear layers for DiT inference.

Counterpart of `diffusion_models_collection_tpu/ops/quant.py`
(`int8_matmul`, `Int8Dense`, `dense_layer`). Symmetric absmax quantization:
the weight per output channel, the activations per token (row), each scale
max|.| / 127 floored at 1e-12, values rounded half to even (`torch.round`,
as `jnp.round`), clipped to +-127 and stored as int8; the product sums in
int32, is dequantized in float32 (acc * s_x * s_w), the float32 bias is
added and the result is cast to the layer's compute type.

The integer product is `torch._int_mm` (cuBLASLt's int8 product on the card,
int8 x int8 -> int32), the counterpart of the XLA `dot_general` with an
int32 result that the JAX package calls: a library product, as a float
product goes to `torch.matmul`, not a kernel of the JAX package's. On CUDA
it takes more than 16 rows and K, N multiples of 8 (at least 16): calls of
16 rows or fewer are padded with zero rows, which change no other row.

The JAX package quantizes the weights once, at compile, where they are
constants of the jitted sampler. Here `Int8Weights` keeps each layer's int8
weight and scales from its first call and quantizes again only when the
float weight changes (another tensor, or an in-place update: a checkpoint
load, an optimizer step). Inference only: rounding has no gradient, and
the DiT refuses `quant` in training mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

QUANT_MODES = ("int8",)

# torch._int_mm's limits on CUDA: rows > 16; K and N multiples of 8, >= 16
_MIN_ROWS = 17

# int8 products on a CUDA tensor since the process started (or since a
# caller reset it): what shows that a run went through the int8 path
PRODUCTS = 0


def check_quant(quant: Optional[str]) -> Optional[str]:
    """The model's `quant` field: None, or 'int8'."""
    if quant is None:
        return None
    if str(quant) not in QUANT_MODES:
        raise ValueError(f"Unknown quant mode: {quant!r} (only 'int8')")
    return str(quant)


def quantize_rows(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of a (rows, K) tensor: (q int8,
    scale float32 (rows, 1)) with t ~ q * scale."""
    tf = t.float()
    scale = (tf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, the exact integer sums."""
    global PRODUCTS
    rows = xq.shape[0]
    if xq.device.type == "cuda":
        k, n = xq.shape[1], wq.shape[0]
        if k % 8 or n % 8 or k < 16 or n < 16:
            raise ValueError(f"int8 product: K ({k}) and N ({n}) must be "
                             "multiples of 8 of at least 16 on CUDA")
        PRODUCTS += 1
    if rows < _MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(_MIN_ROWS - rows, xq.shape[1])])
    return torch._int_mm(xq, wq.t())[:rows]


class Int8Weights:
    """A layer's int8 weight (N, K) and its float32 scales (1, N),
    quantized at the first call and again only when the float weight
    changes: another tensor or device, or an in-place update (its version
    counter)."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if torch.compiler.is_exporting():
            # a traced weight (an input of `serving.py`'s program) has no
            # storage to key on: the program quantizes it at each call
            wq, scale = quantize_rows(weight.detach())
            return wq, scale.reshape(1, -1)
        key = (weight.data_ptr(), weight._version, weight.device,
               tuple(weight.shape))
        if key != self._key:
            with torch.no_grad():
                wq, scale = quantize_rows(weight.detach())
            self._value = (wq, scale.reshape(1, -1))
            self._key = key
        return self._value


def int8_matmul(x: torch.Tensor, weight: torch.Tensor,
                cache: Optional[Int8Weights] = None) -> torch.Tensor:
    """(..., K) x a Linear's (N, K) weight -> float32 (..., N) through the
    int8 product: per-token activation scales, per-channel weight scales
    (from `cache` when given), int32 sums, float32 dequantize."""
    wq, s_w = (cache if cache is not None else Int8Weights()).get(weight)
    lead = x.shape[:-1]
    xq, s_x = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = int8_accumulate(xq, wq)
    return (acc.float() * s_x * s_w).reshape(*lead, wq.shape[0])


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                dtype: Optional[torch.dtype],
                cache: Optional[Int8Weights] = None) -> torch.Tensor:
    """`F.linear` through the int8 product (the JAX `Int8Dense`): float32
    result plus the float32 bias, cast to `dtype`, or to x's type when
    `dtype` is None."""
    out = int8_matmul(x, weight, cache)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype if dtype is None else dtype)
