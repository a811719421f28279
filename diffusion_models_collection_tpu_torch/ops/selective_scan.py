"""Selective-state-space scan (the Mamba recurrence), forward and backward.

Counterpart of `diffusion_models_collection_tpu/ops/selective_scan.py` and
`ops/selective_scan_pallas.py`. With a = exp(dt * A) and b = (dt * x) B,

    h_t = a_t * h_{t-1} + b_t,    y_t = sum_N C_t * h_t  (+ D * x_t)

over x, dt (batch, L, D); A (D, N); B, C (batch, L, N); h (D, N) per row.

* `selective_scan_fwd` runs the recurrence in time blocks of `t_block_for(L)`
  steps (32 when L % 32 == 0, else 16; a shorter last block covers any other
  L) and, with `save_states`, also returns `bound`, the state entering each
  block, (batch, n_blocks, N, D) float32 in the JAX kernels' layout. It
  launches `csrc/selective_scan_fwd.cu` on a CUDA tensor (the JAX package's
  K5 `_scan_kernel_blocked`, K6 `_scan_kernel_blocked_ckpt` and, for the
  ragged last block, K4 `_scan_kernel`) and runs `selective_scan_fwd_ref` on
  a CPU tensor.
* `selective_scan_bwd` walks the blocks in reverse from `bound`, recomputes
  the states inside each one and carries the adjoint, as the JAX package's
  K8 `_scan_bwd_kernel_from_ckpt` with `_bwd_block_body`: it launches
  `csrc/selective_scan_bwd.cu` on a CUDA tensor and runs
  `selective_scan_bwd_ref` on a CPU tensor.
* `selective_scan_bwd_nostate` is the backward for a forward that saved
  nothing (the JAX package's K7 `_scan_bwd_kernel`): it first rebuilds the
  state entering each block, then runs the same reverse sweep, in one
  launch of `csrc/selective_scan_bwd.cu`; `selective_scan_bwd_nostate_ref`
  on a CPU tensor.
* `selective_scan_fwd_split` and `selective_scan_bwd_split` give the outputs
  of the forward with states and of the backward from them with the time
  axis split across thread blocks (the JAX package's grid-over-time K9
  `_scan_fwd_ckpt_kernel_grid` and K10 `_scan_bwd_from_ckpt_kernel_grid`),
  for long sequences at a small batch, where one block per (row, 64
  channels) leaves most of the card idle. The forward scans chunks of
  `fwd_chunk_blocks` time blocks from zero (chunk 0 whole, with its
  output; the last chunk not at all), then completes every later chunk
  from the state entering it, rebuilt from the chunks before. The backward
  scans chunks of `bwd_chunk_blocks` time blocks from zero, carries the
  adjoint from chunk to chunk in a serial pass and completes each chunk.
  `csrc/selective_scan_split.cu` on a CUDA tensor, the `_ref` versions, the
  same passes in plain PyTorch, on a CPU tensor.
* `selective_scan_with_state` (E4, the JAX package's
  `selective_scan_with_state`, the sequence-parallel DiM's building block:
  `parallel/dim_sequence_parallel.py`) runs the recurrence from a state
  h_in (batch, D, N) and returns (y, h_out), the state after the last step;
  `selective_scan_end_state` returns h_out alone (no y: the distributed
  scan's first pass). Their forward is `selective_scan_fwd_state`, K5/K6's
  walk from h_in (`csrc/selective_scan_fwd.cu`, always with its block
  states), their backward `selective_scan_bwd_state`, K8's sweep with its
  adjoint starting from the cotangent of h_out and ending in dh_in
  (`csrc/selective_scan_bwd.cu`). The time-split routes (`split_forward`,
  `split_backward`) never take a stated scan: its shards are short (L / S
  tokens), and K9/K10's passes start from zero. A stated scan keeps its
  block states under gradient checkpointing too (the recompute holds them
  only inside its window), so there is no stated K7.
* `chunk_size` (the JAX package's XLA chunked scan) scans the chunks of
  that many steps in turn, each a stated scan from the state the one before
  left: the same function of the inputs as the whole scan, through the
  stated kernels on the card and their plain versions on the CPU.
* Each launcher is a `torch.library` operator (`ops/_library.py`):
  `dmc::selective_scan_fwd` and `dmc::selective_scan_fwd_states` (states
  off and on), `dmc::selective_scan_bwd`, `dmc::selective_scan_bwd_nostate`,
  `dmc::selective_scan_fwd_split` and `dmc::selective_scan_bwd_split`,
  `dmc::selective_scan_fwd_state`, `dmc::selective_scan_end_state` and
  `dmc::selective_scan_bwd_state`.
* `SelectiveScan` joins them as the JAX `_selective_scan_core` custom_vjp
  does. With no gradient wanted the forward saves nothing (K5). With one,
  it saves the block states (K6, or K9 where `split_forward` says so) and
  the backward runs from them (K8, or K10 where `split_backward` says so:
  both take the same `bound`); or, when the caller asks for no
  saved states (gradient checkpointing), the forward is K5 again and the
  backward rebuilds them (K7). `selective_scan` is the entry point and
  adds the D skip outside the op; `selective_scan_sequential` is the O(L)
  reference that autograd differentiates, for tests.

The JAX gate `supported()` (D % 128, N <= 32, L >= 8) is a TPU lane limit
and is not ported: the kernels take any L >= 1, any D and any N. A walk
holds at most `STATE_CHUNK` (32) states of a channel, four lanes of eight;
past that every kernel entry walks the states in chunks of 32 in turn, one
launch of the same kernel a chunk (the JAX package runs its XLA scan
there), each chunk adding its share to the sums over the states (y; dx,
ddt) and owning its columns of the rest (`csrc/selective_scan_common.cuh`).
A wrapper counts one launch a call whatever the chunks. Under tensor
parallelism the scan needs no form of its own: the DiM's `Mamba` mixer, cut
to a tensor-parallel rank
(`parallel/tensor_parallel.py`), calls these kernels unchanged on its rank's
d_inner / tp channels, with (dt, B, C) all-reduced before the scan, and
`scan_tensor_parallel`, the JAX package's scope for it, is a no-op kept for
its callers.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

from . import _build, _library

# the states one walk of a kernel holds; a larger N runs in chunks of it
STATE_CHUNK = 32

# Kernel launches since the process started (or since a caller reset them):
# the forward's (K5, K6), the forward's with saved states (K6, counted in
# both), the backward's from saved states (K8), the backward's with none
# (K7), and the time-split forward's and backward's (K9, K10).
FWD_LAUNCHES = 0
FWD_STATES_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_NOSTATE_LAUNCHES = 0
FWD_SPLIT_LAUNCHES = 0
BWD_SPLIT_LAUNCHES = 0
# the stated forms' (E4): the forward from h_in (with y or without) and the
# backward to dh_in
FWD_STATE_LAUNCHES = 0
BWD_STATE_LAUNCHES = 0

# Channels of one row in a tile of the backward rules (`split_backward`,
# `bwd_chunk_blocks`; the thread-a-channel passes of K10 cover 128) and in a
# thread block of the forward walk (64, four lanes a channel), and the
# forward walk's thread blocks that an H100 holds at once (four on each of
# its 132 SMs).
TILE, FWD_TILE, FWD_SLOTS = 128, 64, 528


def t_block_for(length: int) -> int:
    """The time block of the JAX kernels (`selective_scan_pallas.py:139`):
    32 when L % 32 == 0, else 16."""
    return 32 if length % 32 == 0 else 16


def _blocks(length: int) -> List[Tuple[int, int]]:
    """(start, steps) of each time block; the last may be shorter."""
    tb = t_block_for(length)
    return [(t0, min(tb, length - t0)) for t0 in range(0, length, tb)]


def fwd_chunk_blocks(batch: int, length: int, d_inner: int) -> int:
    """Time blocks in a chunk of the time-split forward (K9). Each of its
    two launches runs (chunks - 1) x (rows x 64-channel tiles) thread blocks
    that walk one chunk each: take the most chunks for which that many fit
    the card at once, so each launch is one wave and its walk the shortest
    such a wave allows."""
    tiles = batch * -(-d_inner // FWD_TILE)
    n_blocks = len(_blocks(length))
    chunks = max(1, min(n_blocks, 1 + FWD_SLOTS // tiles))
    return -(-n_blocks // chunks)


def bwd_chunk_blocks(batch: int, length: int, d_inner: int) -> int:
    """Time blocks in a chunk of the time-split backward (K10): 8, halved
    while that leaves fewer than four thread blocks of its local and sweep
    passes for each of the 132 SMs."""
    rows = batch * -(-d_inner // TILE)
    n_blocks = len(_blocks(length))
    chunk = 8
    while chunk > 1 and rows * -(-n_blocks // chunk) < 528:
        chunk //= 2
    return chunk


def split_forward(batch: int, length: int, d_inner: int) -> bool:
    """Whether a forward with saved states of this shape runs time-split
    (K9) rather than with one thread block per (row, 64 channels) walking
    the whole sequence (K6): at least 16 time blocks, and at least three
    chunks (`fwd_chunk_blocks`), so that each of K9's two launches walks at
    most a third of the sequence (at D 768: up to batch 22). Set by
    `chip_smoke.py`'s `phase_scan_sweep` on an H100 at L 1024, D 768,
    where K9 led K6 from batch 1 to 16 and fell behind at 32, with two
    chunks; the readings are in PERF.md."""
    n_blocks = len(_blocks(length))
    return (n_blocks >= 16
            and -(-n_blocks // fwd_chunk_blocks(batch, length, d_inner)) >= 3)


def split_backward(batch: int, length: int, d_inner: int) -> bool:
    """Whether a backward from saved states of this shape runs time-split
    (K10) rather than K8's whole reverse sweep: at least 16 time blocks, and
    at most 48 (row, 128-channel) tiles (at D 768: up to batch 8). Set by
    `chip_smoke.py`'s `phase_scan_sweep` on an H100 at L 1024, D 768, where
    K10 led K8 up to batch 8 and fell behind from 16; the readings are in
    PERF.md."""
    return (len(_blocks(length)) >= 16
            and batch * -(-d_inner // TILE) <= 48)


def _chunks(length: int, chunk_blocks: int) -> List[List[Tuple[int, int]]]:
    """The time blocks of each chunk; the last chunk may hold fewer."""
    blocks = _blocks(length)
    return [blocks[i:i + chunk_blocks]
            for i in range(0, len(blocks), chunk_blocks)]


def selective_scan_sequential(x, dt, A, B, C, D=None) -> torch.Tensor:
    """O(L) step-by-step reference that autograd differentiates (JAX
    `selective_scan_sequential`). For tests."""
    batch, length, d_inner = x.shape
    decay = torch.exp(dt[..., None] * A)
    drive = dt[..., None] * B[:, :, None, :] * x[..., None]
    h = x.new_zeros(batch, d_inner, A.shape[1])
    ys = []
    for t in range(length):
        h = decay[:, t] * h + drive[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x * D
    return y


def _fwd_blocks_ref(x, dt, A, B, C, h, blocks):
    """The blocked forward over the time blocks `blocks` from the state h:
    per block, the decays and drives of all its steps at once, then the
    serial update. Returns (each block's y, or nothing when C is None; the
    state entering each block; the state after the last)."""
    ys, bounds = [], []
    for t0, steps in blocks:
        bounds.append(h)
        dt_c = dt[:, t0:t0 + steps]
        decay = torch.exp(dt_c[..., None] * A)                 # (B, T, D, N)
        drive = (dt_c * x[:, t0:t0 + steps])[..., None] * B[:, t0:t0 + steps,
                                                            None, :]
        hs = []
        for s in range(steps):
            h = decay[:, s] * h + drive[:, s]
            hs.append(h)
        if C is not None:
            ys.append((torch.stack(hs, 1)
                       * C[:, t0:t0 + steps, None, :]).sum(-1))
    return ys, bounds, h


def _stack_bound(bounds) -> torch.Tensor:
    """(batch, D, N) states -> `bound` (batch, n_blocks, N, D)."""
    return torch.stack(bounds, 1).transpose(2, 3).contiguous()


def selective_scan_fwd_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, save_states: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch forward in the kernels' time blocks. Returns (y without
    the D skip, bound or None)."""
    batch, length, d_inner = x.shape
    h = x.new_zeros(batch, d_inner, A.shape[1])
    ys, bounds, _ = _fwd_blocks_ref(x, dt, A, B, C, h, _blocks(length))
    if not ys:  # L == 0
        return x.clone(), (x.new_zeros(batch, 0, A.shape[1], d_inner)
                           if save_states else None)
    y = torch.cat(ys, dim=1)
    return y, (_stack_bound(bounds) if save_states else None)


def _chunk_span(chunk) -> slice:
    return slice(chunk[0][0], chunk[-1][0] + chunk[-1][1])


def selective_scan_fwd_split_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch time-split forward, the two passes of
    `csrc/selective_scan_split.cu`: (a) chunk 0 whole from the zero state,
    and every later chunk but the last from a zero state: each one's end
    state and sum of dt (exp(A * sum) is the product of its decays); (c)
    each later chunk from the state entering it, rebuilt from the end states
    and sums of the chunks before it. Returns (y without the D skip,
    bound)."""
    batch, length, d_inner = x.shape
    if length == 0:
        return selective_scan_fwd_ref(x, dt, A, B, C, True)
    chunks = _chunks(length, fwd_chunk_blocks(batch, length, d_inner))
    zero = x.new_zeros(batch, d_inner, A.shape[1])
    ys, bounds, end = _fwd_blocks_ref(x, dt, A, B, C, zero, chunks[0])
    ends = [end] + [_fwd_blocks_ref(x, dt, A, B, None, zero, chunk)[2]
                    for chunk in chunks[1:-1]]
    decays = [torch.exp(dt[:, _chunk_span(chunk)].sum(1)[..., None] * A)
              for chunk in chunks[:-1]]
    for c, chunk in enumerate(chunks[1:], 1):
        h = zero
        for decay, end in zip(decays[:c], ends[:c]):
            h = decay * h + end
        ys_c, bounds_c, _ = _fwd_blocks_ref(x, dt, A, B, C, h, chunk)
        ys += ys_c
        bounds += bounds_c
    return torch.cat(ys, dim=1), _stack_bound(bounds)


def _bwd_blocks_ref(x, dt, A, B, C, g, bound, phi, first, blocks, outs):
    """The reverse sweep (JAX `_bwd_block_body`) over the time blocks
    `blocks`, the first of which is block number `first`, last to first:
    recompute h inside each block from `bound`, run the adjoint gamma_t =
    C_t ybar_t + a_{t+1} gamma_{t+1} backwards from the carry phi = a_{t+1}
    gamma_{t+1}. Writes dx, ddt, dB, dC of those steps into `outs` (dC 0
    where g, the cotangent of y, is None); returns (the carry out of the
    first block, dA (D, N) summed over the batch)."""
    dx, ddt, dB, dC = outs
    dA = torch.zeros_like(A)
    for k in range(len(blocks) - 1, -1, -1):
        t0, steps = blocks[k]
        sl = slice(t0, t0 + steps)
        dt_c, x_c, b_c = dt[:, sl], x[:, sl], B[:, sl]
        decay = torch.exp(dt_c[..., None] * A)                 # (B, T, D, N)
        u_c = dt_c * x_c
        drive = u_c[..., None] * b_c[:, :, None, :]
        # C_t (x) ybar_t; none without a cotangent of y
        w = None if g is None else C[:, sl, None, :] * g[:, sl, :, None]
        h = bound[:, first + k].transpose(1, 2)
        h_prevs, hs = [], []
        for s in range(steps):
            h_prevs.append(h)
            h = decay[:, s] * h + drive[:, s]
            hs.append(h)
        gammas = [None] * steps
        for s in range(steps - 1, -1, -1):
            gammas[s] = phi if w is None else w[:, s] + phi
            phi = decay[:, s] * gammas[s]
        gamma = torch.stack(gammas, 1)
        dadec = gamma * torch.stack(h_prevs, 1) * decay
        g_b = (gamma * b_c[:, :, None, :]).sum(-1)              # (B, T, D)
        ddt[:, sl] = (dadec * A).sum(-1) + g_b * x_c
        dx[:, sl] = g_b * dt_c
        dB[:, sl] = (gamma * u_c[..., None]).sum(2)
        dC[:, sl] = (0.0 if g is None else
                     (torch.stack(hs, 1) * g[:, sl, :, None]).sum(2))
        dA += (dadec * dt_c[..., None]).sum((0, 1))
    return phi, dA


def _empty_grads(x, B, C):
    return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(B),
            torch.empty_like(C))


def selective_scan_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor, bound: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward from the forward's block states: the reverse
    sweep over all the blocks from a zero carry. Returns (dx, ddt, dA, dB,
    dC), dA (D, N) summed over the batch."""
    phi = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    outs = _empty_grads(x, B, C)
    _, dA = _bwd_blocks_ref(x, dt, A, B, C, g, bound, phi, 0,
                            _blocks(x.shape[1]), outs)
    dx, ddt, dB, dC = outs
    return dx, ddt, dA, dB, dC


def selective_scan_bwd_nostate_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward with nothing saved: rebuild the block states
    with the plain forward, then the plain backward from them."""
    _, bound = selective_scan_fwd_ref(x, dt, A, B, C, True)
    return selective_scan_bwd_ref(x, dt, A, B, C, g, bound)


def selective_scan_bwd_split_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor, bound: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch time-split backward, the three passes of
    `csrc/selective_scan_split.cu`. `bound` is given, so only the adjoint
    needs a carry: (a) each chunk's outgoing carry from a zero incoming one
    and its sum of dt; (b) a serial walk over the chunks, last to first,
    that gives the carry entering each; (c) the reverse sweep over each
    chunk from it, dA summed over the chunks."""
    batch, length, d_inner = x.shape
    chunks = _chunks(length, bwd_chunk_blocks(batch, length, d_inner))
    zero = x.new_zeros(batch, d_inner, A.shape[1])
    local = []
    for chunk in chunks:
        span = _chunk_span(chunk)
        decay = torch.exp(dt[:, span, :, None] * A)
        w = C[:, span, None, :] * g[:, span, :, None]
        phi = zero
        for s in range(decay.shape[1] - 1, -1, -1):
            phi = decay[:, s] * (w[:, s] + phi)
        local.append((phi, dt[:, span].sum(1)))
    outs = _empty_grads(x, B, C)
    dA = torch.zeros_like(A)
    phi, first = zero, len(_blocks(length))
    for chunk, (out, total) in zip(reversed(chunks), reversed(local)):
        first -= len(chunk)
        dA += _bwd_blocks_ref(x, dt, A, B, C, g, bound, phi, first, chunk,
                              outs)[1]
        phi = torch.exp(total[..., None] * A) * phi + out
    dx, ddt, dB, dC = outs
    return dx, ddt, dA, dB, dC


def selective_scan_fwd_state_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, h_in: torch.Tensor, with_y: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain PyTorch stated forward: the blocked walk from h_in (batch, D,
    N). Returns (y without the D skip, or None without `with_y`; bound,
    whose block 0 is h_in; h_out)."""
    ys, bounds, h_out = _fwd_blocks_ref(x, dt, A, B, C if with_y else None,
                                        h_in, _blocks(x.shape[1]))
    y = None
    if with_y:
        y = torch.cat(ys, dim=1) if ys else x.clone()
    bound = (_stack_bound(bounds) if bounds else
             x.new_zeros(x.shape[0], 0, A.shape[1], x.shape[2]))
    return y, bound, h_out.clone()


def selective_scan_bwd_state_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: Optional[torch.Tensor], bound: torch.Tensor,
    g_hout: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch stated backward: the reverse sweep from the stated
    forward's `bound` with the carry starting from g_hout, the cotangent of
    h_out; g, the cotangent of y, is None for the state-only form. Returns
    (dx, ddt, dA, dB, dC, dh_in)."""
    outs = _empty_grads(x, B, C)
    dh_in, dA = _bwd_blocks_ref(x, dt, A, B, C, g, bound, g_hout, 0,
                                _blocks(x.shape[1]), outs)
    dx, ddt, dB, dC = outs
    return dx, ddt, dA, dB, dC, dh_in.clone()


def _check_shapes(name: str, x, dt, A, B, C, *others) -> Tuple[int, ...]:
    """x, dt and `others` one (batch, L, D) shape, A (D, N) with N >= 1, B
    and C (batch, L, N); on the card within the kernels' grid and 32-bit
    indexing."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{name}: x must be (batch, L, D) and A (D, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    if A.shape[0] != d_inner or any(t.shape != x.shape for t in (dt, *others)):
        raise ValueError(
            f"{name}: x, dt{', g' if others else ''} must share one (batch, L, "
            f"D) shape and A be (D, N), got "
            + ", ".join(str(tuple(t.shape)) for t in (x, dt, *others, A)))
    if B.shape != (batch, length, n_state) or C.shape != B.shape:
        raise ValueError(f"{name}: B and C must be {(batch, length, n_state)}, "
                         f"got {tuple(B.shape)} and {tuple(C.shape)}")
    if n_state < 1:
        raise ValueError(f"{name}: state size must be at least 1")
    if x.device.type == "cuda" and (batch >= 65536 or x.numel() >= 2**31):
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the "
                         "kernel's grid or 32-bit indexing")
    return batch, length, d_inner, n_state


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _n_blocks(length) -> int:
    """The number of time blocks, `len(_blocks(length))` in arithmetic (the
    fake implementations take symbolic lengths)."""
    return -(-length // t_block_for(length))


def _bound_like(x: torch.Tensor, n_state: int) -> torch.Tensor:
    """An empty `bound` (batch, n_blocks, N, D) for x (batch, L, D)."""
    batch, length, d_inner = x.shape
    return x.new_empty((batch, _n_blocks(length), n_state, d_inner))


def _fwd_cuda(x, dt, A, B, C, save_states: bool):
    """The forward kernel's launch (K5, or K6 with `save_states`): (y,
    bound or None)."""
    global FWD_LAUNCHES, FWD_STATES_LAUNCHES
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    lib = _build.library()
    y = torch.empty_like(x)
    bound = _bound_like(x, n_state) if save_states else None
    if x.numel():
        with torch.cuda.device(x.device):
            err = lib.selective_scan_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(),
                bound.data_ptr() if save_states else None, batch, length,
                d_inner, n_state, t_block_for(length), _stream(x.device))
        _build.check(err, "selective_scan_fwd")
        FWD_LAUNCHES += 1
        FWD_STATES_LAUNCHES += bool(save_states)
    return y, bound


_SCAN_ARGS = "Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C"
_GRADS = "-> (Tensor, Tensor, Tensor, Tensor, Tensor)"


def _grads_fake(x, dt, A, B, C, *rest):
    return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(A),
            torch.empty_like(B), torch.empty_like(C))


_FWD = _library.define(
    f"selective_scan_fwd({_SCAN_ARGS}) -> Tensor",
    cpu=lambda x, dt, A, B, C: selective_scan_fwd_ref(x, dt, A, B, C,
                                                      False)[0],
    cuda=lambda x, dt, A, B, C: _fwd_cuda(x, dt, A, B, C, False)[0],
    fake=lambda x, dt, A, B, C: torch.empty_like(x))
_FWD_STATES = _library.define(
    f"selective_scan_fwd_states({_SCAN_ARGS}) -> (Tensor, Tensor)",
    cpu=lambda x, dt, A, B, C: selective_scan_fwd_ref(x, dt, A, B, C, True),
    cuda=lambda x, dt, A, B, C: _fwd_cuda(x, dt, A, B, C, True),
    fake=lambda x, dt, A, B, C: (torch.empty_like(x),
                                 _bound_like(x, A.shape[1])))


def selective_scan_fwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, save_states: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scan forward over float32 inputs, the operator `dmc::selective_scan_fwd`
    (`dmc::selective_scan_fwd_states` with `save_states`): the kernel for
    CUDA tensors, the plain version for CPU tensors. Returns (y without the
    D skip, bound): bound (batch, n_blocks, N, D) with `save_states`, else
    None."""
    _build.check_inputs("selective_scan_fwd", x, dt, A, B, C)
    _check_shapes("selective_scan_fwd", x, dt, A, B, C)
    if save_states:
        return _FWD_STATES(x, dt, A, B, C)
    return _FWD(x, dt, A, B, C), None


def _check_bound(name: str, bound, batch, length, d_inner, n_state) -> None:
    want = (batch, len(_blocks(length)), n_state, d_inner)
    if bound.shape != want:
        raise ValueError(f"{name}: bound must be {want}, got "
                         f"{tuple(bound.shape)}")


def _bwd_outputs(lib, x, B, C, da_shape):
    """dx, ddt, dB, dC, the per-row dA and the per-tile dB/dC sums that
    every backward kernel writes."""
    batch, length, d_inner = x.shape
    n_state = B.shape[2]
    dx, ddt, dB, dC = _empty_grads(x, B, C)
    da_rows = torch.zeros(da_shape, dtype=torch.float32, device=x.device)
    partial = torch.empty(
        (batch, lib.selective_scan_bwd_tiles(d_inner), length,
         lib.selective_scan_bwd_width(n_state)),
        dtype=torch.float32, device=x.device)
    return dx, ddt, dB, dC, da_rows, partial


def _zero_grads(x, A, B, C):
    """The gradients of an empty x: the sums over L and D are empty."""
    return (torch.empty_like(x), torch.empty_like(x), torch.zeros_like(A),
            torch.zeros_like(B), torch.zeros_like(C))


def _bwd_cuda(x, dt, A, B, C, g, bound):
    """The backward kernel's launch from saved states (K8): (dx, ddt, dA,
    dB, dC). The kernel writes dA per batch row, (batch, D, N), summed over
    the batch here, outside the kernel, as the JAX wrapper does
    (`selective_scan_pallas.py:571`)."""
    global BWD_LAUNCHES
    if not x.numel():
        return _zero_grads(x, A, B, C)
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    lib = _build.library()
    dx, ddt, dB, dC, da_rows, partial = _bwd_outputs(
        lib, x, B, C, (batch, d_inner, n_state))
    # autograd runs a backward on its own thread: take that thread's
    # current stream for the device here, at the launch
    with torch.cuda.device(x.device):
        err = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), g.data_ptr(), bound.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da_rows.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), partial.data_ptr(), batch, length, d_inner,
            n_state, t_block_for(length), _stream(x.device))
    _build.check(err, "selective_scan_bwd")
    BWD_LAUNCHES += 1
    return dx, ddt, da_rows.sum(0), dB, dC


_BWD = _library.define(
    f"selective_scan_bwd({_SCAN_ARGS}, Tensor g, Tensor bound) {_GRADS}",
    cpu=selective_scan_bwd_ref, cuda=_bwd_cuda, fake=_grads_fake)


def selective_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor, bound: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Scan backward from the forward's `bound`, the operator
    `dmc::selective_scan_bwd`: the kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (dx, ddt, dA, dB, dC)."""
    _build.check_inputs("selective_scan_bwd", x, dt, A, B, C, g, bound)
    batch, length, d_inner, n_state = _check_shapes(
        "selective_scan_bwd", x, dt, A, B, C, g)
    _check_bound("selective_scan_bwd", bound, batch, length, d_inner, n_state)
    return _BWD(x, dt, A, B, C, g, bound)


def _bwd_nostate_cuda(x, dt, A, B, C, g):
    """The backward kernel's launch with nothing saved (K7). The rebuilt
    states stay in the kernel's shared memory where they fit, else in a
    scratch buffer allocated here."""
    global BWD_NOSTATE_LAUNCHES
    if not x.numel():
        return _zero_grads(x, A, B, C)
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    lib = _build.library()
    dx, ddt, dB, dC, da_rows, partial = _bwd_outputs(
        lib, x, B, C, (batch, d_inner, n_state))
    t_block = t_block_for(length)
    scratch = None
    if lib.selective_scan_bwd_nostate_needs_scratch(length, n_state, t_block):
        scratch = _bound_like(x, n_state)
    with torch.cuda.device(x.device):  # the stream: see _bwd_cuda
        err = lib.selective_scan_bwd_nostate(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), g.data_ptr(),
            None if scratch is None else scratch.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da_rows.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            partial.data_ptr(), batch, length, d_inner, n_state, t_block,
            _stream(x.device))
    _build.check(err, "selective_scan_bwd_nostate")
    BWD_NOSTATE_LAUNCHES += 1
    return dx, ddt, da_rows.sum(0), dB, dC


_BWD_NOSTATE = _library.define(
    f"selective_scan_bwd_nostate({_SCAN_ARGS}, Tensor g) {_GRADS}",
    cpu=selective_scan_bwd_nostate_ref, cuda=_bwd_nostate_cuda,
    fake=_grads_fake)


def selective_scan_bwd_nostate(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Scan backward for a forward that saved nothing (JAX
    `selective_scan_bwd_pallas`), the operator
    `dmc::selective_scan_bwd_nostate`: one kernel launch that rebuilds the
    state entering each time block and then sweeps in reverse, for CUDA
    tensors; the plain version for CPU tensors. Returns (dx, ddt, dA, dB,
    dC)."""
    name = "selective_scan_bwd_nostate"
    _build.check_inputs(name, x, dt, A, B, C, g)
    _check_shapes(name, x, dt, A, B, C, g)
    return _BWD_NOSTATE(x, dt, A, B, C, g)


def _fwd_split_cuda(x, dt, A, B, C):
    """The time-split forward's launch (K9): (y, bound)."""
    global FWD_SPLIT_LAUNCHES
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    y = torch.empty_like(x)
    bound = _bound_like(x, n_state)
    if x.numel():
        lib = _build.library()
        n_blocks = bound.shape[1]
        chunk = fwd_chunk_blocks(batch, length, d_inner)
        # the end state and sum of dt of every chunk but the last
        carried = -(-n_blocks // chunk) - 1
        ends = torch.empty((batch, carried, n_state, d_inner),
                           dtype=torch.float32, device=x.device)
        sdt = torch.empty((batch, carried, d_inner), dtype=torch.float32,
                          device=x.device)
        with torch.cuda.device(x.device):
            err = lib.selective_scan_fwd_split(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), bound.data_ptr(),
                ends.data_ptr() if carried else None,
                sdt.data_ptr() if carried else None, batch, length, d_inner,
                n_state, t_block_for(length), chunk, _stream(x.device))
        _build.check(err, "selective_scan_fwd_split")
        FWD_SPLIT_LAUNCHES += 1
    return y, bound


_FWD_SPLIT = _library.define(
    f"selective_scan_fwd_split({_SCAN_ARGS}) -> (Tensor, Tensor)",
    cpu=selective_scan_fwd_split_ref, cuda=_fwd_split_cuda,
    fake=lambda x, dt, A, B, C: (torch.empty_like(x),
                                 _bound_like(x, A.shape[1])))


def selective_scan_fwd_split(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-split scan forward with saved states (JAX
    `selective_scan_fwd_ckpt_pallas_grid`), the operator
    `dmc::selective_scan_fwd_split`: the kernels for CUDA tensors, the plain
    version for CPU tensors. Returns (y without the D skip, bound), the same
    function of the inputs as `selective_scan_fwd(..., save_states=True)`."""
    name = "selective_scan_fwd_split"
    _build.check_inputs(name, x, dt, A, B, C)
    _check_shapes(name, x, dt, A, B, C)
    return _FWD_SPLIT(x, dt, A, B, C)


def _bwd_split_cuda(x, dt, A, B, C, g, bound):
    """The time-split backward's launch (K10). The kernel writes dA per
    (row, chunk) and it is summed here."""
    global BWD_SPLIT_LAUNCHES
    if not x.numel():
        return _zero_grads(x, A, B, C)
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    lib = _build.library()
    chunk = bwd_chunk_blocks(batch, length, d_inner)
    n_chunks = -(-len(_blocks(length)) // chunk)
    dx, ddt, dB, dC, da_rows, partial = _bwd_outputs(
        lib, x, B, C, (batch, n_chunks, d_inner, n_state))
    phi = torch.empty((batch, n_chunks, n_state, d_inner),
                      dtype=torch.float32, device=x.device)
    sdt = torch.empty((batch, n_chunks, d_inner), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):  # the stream: see _bwd_cuda
        err = lib.selective_scan_bwd_split(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), g.data_ptr(), bound.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da_rows.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            partial.data_ptr(), phi.data_ptr(), sdt.data_ptr(), batch, length,
            d_inner, n_state, t_block_for(length), chunk, _stream(x.device))
    _build.check(err, "selective_scan_bwd_split")
    BWD_SPLIT_LAUNCHES += 1
    return dx, ddt, da_rows.sum((0, 1)), dB, dC


_BWD_SPLIT = _library.define(
    f"selective_scan_bwd_split({_SCAN_ARGS}, Tensor g, Tensor bound) "
    f"{_GRADS}",
    cpu=selective_scan_bwd_split_ref, cuda=_bwd_split_cuda,
    fake=_grads_fake)


def selective_scan_bwd_split(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor, bound: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Time-split scan backward from the forward's `bound` (JAX
    `selective_scan_bwd_from_ckpt_pallas_grid`), the operator
    `dmc::selective_scan_bwd_split`: the kernels for CUDA tensors, the plain
    version for CPU tensors. Returns (dx, ddt, dA, dB, dC), the same
    function of the inputs as `selective_scan_bwd`."""
    name = "selective_scan_bwd_split"
    _build.check_inputs(name, x, dt, A, B, C, g, bound)
    batch, length, d_inner, n_state = _check_shapes(name, x, dt, A, B, C, g)
    _check_bound(name, bound, batch, length, d_inner, n_state)
    return _BWD_SPLIT(x, dt, A, B, C, g, bound)


def _check_state(name: str, h, batch, d_inner, n_state) -> None:
    if h.shape != (batch, d_inner, n_state):
        raise ValueError(f"{name}: a state must be {(batch, d_inner, n_state)}"
                         f", got {tuple(h.shape)}")


def _fwd_state_cuda(x, dt, A, B, C, h_in, with_y: bool):
    """The stated forward's launch (E4): (y or None, bound, h_out)."""
    global FWD_STATE_LAUNCHES
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    y = torch.empty_like(x) if with_y else None
    bound = _bound_like(x, n_state)
    if not x.numel():
        return y, bound, h_in.clone()
    h_out = torch.empty_like(h_in)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.selective_scan_fwd_state(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if y is None else y.data_ptr(),
            bound.data_ptr(), h_in.data_ptr(), h_out.data_ptr(), batch,
            length, d_inner, n_state, t_block_for(length), _stream(x.device))
    _build.check(err, "selective_scan_fwd_state")
    FWD_STATE_LAUNCHES += 1
    return y, bound, h_out


def _state_fake(x, dt, A, B, C, h_in):
    return _bound_like(x, A.shape[1]), torch.empty_like(h_in)


_FWD_STATE = _library.define(
    f"selective_scan_fwd_state({_SCAN_ARGS}, Tensor h_in) "
    "-> (Tensor, Tensor, Tensor)",
    cpu=lambda *a: selective_scan_fwd_state_ref(*a, with_y=True),
    cuda=lambda *a: _fwd_state_cuda(*a, with_y=True),
    fake=lambda x, *a: (torch.empty_like(x), *_state_fake(x, *a)))
_END_STATE = _library.define(
    f"selective_scan_end_state({_SCAN_ARGS}, Tensor h_in) "
    "-> (Tensor, Tensor)",
    cpu=lambda *a: selective_scan_fwd_state_ref(*a, with_y=False)[1:],
    cuda=lambda *a: _fwd_state_cuda(*a, with_y=False)[1:],
    fake=_state_fake)


def selective_scan_fwd_state(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, h_in: torch.Tensor, with_y: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Stated scan forward over float32 inputs from h_in (batch, D, N), the
    operator `dmc::selective_scan_fwd_state` (`dmc::selective_scan_end_state`
    without `with_y`): the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (y without the D skip, or None without `with_y`; bound;
    h_out)."""
    name = "selective_scan_fwd_state"
    _build.check_inputs(name, x, dt, A, B, C, h_in)
    batch, _, d_inner, n_state = _check_shapes(name, x, dt, A, B, C)
    _check_state(name, h_in, batch, d_inner, n_state)
    if with_y:
        return _FWD_STATE(x, dt, A, B, C, h_in)
    return (None, *_END_STATE(x, dt, A, B, C, h_in))


def _bwd_state_cuda(x, dt, A, B, C, g, bound, g_hout):
    """The stated backward's launch (E4): (dx, ddt, dA, dB, dC, dh_in); g
    None launches the form without a cotangent of y (no g or C read, dC
    0)."""
    global BWD_STATE_LAUNCHES
    if not x.numel():
        return (*_zero_grads(x, A, B, C), g_hout.clone())
    batch, length, d_inner = x.shape
    n_state = A.shape[1]
    lib = _build.library()
    dx, ddt, dB, dC, da_rows, partial = _bwd_outputs(
        lib, x, B, C, (batch, d_inner, n_state))
    dh_in = torch.empty_like(g_hout)
    with torch.cuda.device(x.device):  # the stream: see _bwd_cuda
        err = lib.selective_scan_bwd_state(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if g is None else g.data_ptr(),
            bound.data_ptr(), g_hout.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da_rows.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), partial.data_ptr(), dh_in.data_ptr(), batch,
            length, d_inner, n_state, t_block_for(length), _stream(x.device))
    _build.check(err, "selective_scan_bwd_state")
    BWD_STATE_LAUNCHES += 1
    return dx, ddt, da_rows.sum(0), dB, dC, dh_in


_BWD_STATE = _library.define(
    f"selective_scan_bwd_state({_SCAN_ARGS}, Tensor? g, Tensor bound, "
    "Tensor g_hout) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=selective_scan_bwd_state_ref, cuda=_bwd_state_cuda,
    fake=lambda x, dt, A, B, C, g, bound, g_hout: (
        *_grads_fake(x, dt, A, B, C), torch.empty_like(g_hout)))


def selective_scan_bwd_state(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: Optional[torch.Tensor], bound: torch.Tensor,
    g_hout: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Stated scan backward from the stated forward's `bound` and the
    cotangents g of y (None after the state-only form, whose y nobody
    reads) and g_hout of h_out, the operator `dmc::selective_scan_bwd_state`:
    the kernel for CUDA tensors, the plain version for CPU tensors. Returns
    (dx, ddt, dA, dB, dC, dh_in)."""
    name = "selective_scan_bwd_state"
    ys = () if g is None else (g,)
    _build.check_inputs(name, x, dt, A, B, C, *ys, bound, g_hout)
    batch, length, d_inner, n_state = _check_shapes(name, x, dt, A, B, C,
                                                    *ys)
    _check_bound(name, bound, batch, length, d_inner, n_state)
    _check_state(name, g_hout, batch, d_inner, n_state)
    return _BWD_STATE(x, dt, A, B, C, g, bound, g_hout)


def _scan_forward(ctx, suffix, x, dt, A, B, C, save_states):
    """Forward of the wrappers (suffix "") or the plain versions ("_ref"),
    looked up by name at the call."""
    fns = globals()
    if save_states and split_forward(*x.shape):
        y, bound = fns["selective_scan_fwd_split" + suffix](x, dt, A, B, C)
    else:
        y, bound = fns["selective_scan_fwd" + suffix](x, dt, A, B, C,
                                                      save_states)
    ctx.save_for_backward(x, dt, A, B, C, *([bound] if save_states else []))
    return y


def _scan_backward(ctx, suffix, g):
    fns = globals()
    x, dt, A, B, C, *bound = ctx.saved_tensors
    g = g.contiguous()  # autograd hands it over in the consumer's layout
    if not bound:
        name = "selective_scan_bwd_nostate"
    elif split_backward(*x.shape):
        name = "selective_scan_bwd_split"
    else:
        name = "selective_scan_bwd"
    return (*fns[name + suffix](x, dt, A, B, C, g, *bound), None)


class SelectiveScan(torch.autograd.Function):
    """The scan without the D skip, as the JAX `_selective_scan_core`
    custom_vjp. `save_states` is set when a gradient is wanted and the
    caller keeps residuals: the forward then saves the block states
    (`selective_scan_fwd`, or `selective_scan_fwd_split` where
    `split_forward` says so) and the backward runs from them
    (`selective_scan_bwd`, or `selective_scan_bwd_split` where
    `split_backward` says so). Without it the forward saves no states and
    a backward, if one comes, rebuilds them (`selective_scan_bwd_nostate`)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, save_states):
        return _scan_forward(ctx, "", x, dt, A, B, C, save_states)

    @staticmethod
    def backward(ctx, g):
        return _scan_backward(ctx, "", g)


class SelectiveScanRef(torch.autograd.Function):
    """`SelectiveScan` over the plain versions on any device, for
    `ops.plain.plain_kernels`: autograd never steps through the L-step
    loop, so its memory and time are the op's, not autograd's."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, save_states):
        return _scan_forward(ctx, "_ref", x, dt, A, B, C, save_states)

    @staticmethod
    def backward(ctx, g):
        return _scan_backward(ctx, "_ref", g)


def _state_forward(ctx, suffix, x, dt, A, B, C, h_in, with_y):
    y, bound, h_out = globals()["selective_scan_fwd_state" + suffix](
        x, dt, A, B, C, h_in, with_y)
    ctx.save_for_backward(x, dt, A, B, C, bound)
    ctx.with_y = with_y
    return (y, h_out) if with_y else h_out


def _state_backward(ctx, suffix, *grads):
    x, dt, A, B, C, bound = ctx.saved_tensors
    g = grads[0].contiguous() if ctx.with_y else None
    g_hout = grads[-1].contiguous()
    out = (selective_scan_bwd_state if suffix == "" else
           selective_scan_bwd_state_ref)(x, dt, A, B, C, g, bound, g_hout)
    return (*out, None)


class SelectiveScanState(torch.autograd.Function):
    """The stated scan (JAX `selective_scan_with_state`'s custom_vjp): from
    (x, dt, A, B, C, h_in) to (y, h_out), or h_out alone without `with_y`;
    the forward saves its block states, the backward runs from them with
    both cotangents and returns dh_in beside the other gradients."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h_in, with_y):
        return _state_forward(ctx, "", x, dt, A, B, C, h_in, with_y)

    @staticmethod
    def backward(ctx, *grads):
        return _state_backward(ctx, "", *grads)


class SelectiveScanStateRef(torch.autograd.Function):
    """`SelectiveScanState` over the plain versions, for
    `ops.plain.plain_kernels`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h_in, with_y):
        return _state_forward(ctx, "_ref", x, dt, A, B, C, h_in, with_y)

    @staticmethod
    def backward(ctx, *grads):
        return _state_backward(ctx, "_ref", *grads)


def _chunked(state_fn, x, dt, A, B, C, chunk_size: int) -> torch.Tensor:
    """The scan over chunks of `chunk_size` steps in turn, each from the
    state the one before left (JAX `_scan_state_impl` with an int chunk):
    y without the D skip."""
    batch, length, d_inner = x.shape
    if chunk_size < 1 or length % chunk_size:
        raise ValueError("sequence length must divide chunk_size")
    h = x.new_zeros(batch, d_inner, A.shape[1])
    ys = []
    for t0 in range(0, length, chunk_size):
        part = slice(t0, t0 + chunk_size)
        y, h = state_fn(*(t[:, part].contiguous() for t in (x, dt)), A,
                        *(t[:, part].contiguous() for t in (B, C)), h)
        ys.append(y)
    return torch.cat(ys, dim=1) if ys else x.new_zeros(x.shape)


def _apply(fn, x, dt, A, B, C, D, chunk_size, save_states):
    if chunk_size is not None:
        state_fn = (selective_scan_with_state if fn is SelectiveScan
                    else selective_scan_with_state_ref)
        y = _chunked(state_fn, x, dt, A, B, C, int(chunk_size))
    else:
        inputs = [t.contiguous() for t in (x, dt, A, B, C)]
        wants_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in inputs)
        y = fn.apply(*inputs, wants_grad and save_states)
    if D is not None:
        y = y + x * D
    return y


def selective_scan(x, dt, A, B, C, D=None, *, chunk_size=None,
                   save_states=True) -> torch.Tensor:
    """Differentiable selective scan (JAX `selective_scan`) through the
    forward and backward kernels, their plain versions on the CPU; A is
    (D, N) negative real (the caller takes -exp(A_log), so autograd carries
    A's gradient on to A_log), D the optional (D,) skip. `save_states=False`
    keeps no block states for the backward, which then rebuilds them: for a
    caller under gradient checkpointing, which exists to keep no
    residuals. `chunk_size` (dividing L) scans chunks of that many steps in
    turn through the stated scan (the JAX package's XLA chunked path); the
    result is the whole scan's."""
    return _apply(SelectiveScan, x, dt, A, B, C, D, chunk_size, save_states)


def selective_scan_ref(x, dt, A, B, C, D=None, *, chunk_size=None,
                       save_states=True) -> torch.Tensor:
    """`selective_scan` through the plain versions (`SelectiveScanRef`)."""
    return _apply(SelectiveScanRef, x, dt, A, B, C, D, chunk_size,
                  save_states)


def _with_state(fn, x, dt, A, B, C, h_in, with_y):
    return fn.apply(*(t.contiguous() for t in (x, dt, A, B, C, h_in)),
                    with_y)


def selective_scan_with_state(x, dt, A, B, C, h_in):
    """Differentiable selective scan from the state h_in (batch, D, N)
    float32 (JAX `selective_scan_with_state`): returns (y without a D skip,
    h_out), through the stated kernels (their plain versions on the CPU);
    the gradients reach x, dt, A, B, C and h_in."""
    return _with_state(SelectiveScanState, x, dt, A, B, C, h_in, True)


def selective_scan_end_state(x, dt, A, B, C, h_in):
    """h_out of `selective_scan_with_state` alone: the stated forward
    without y (no C read, no y written), differentiable the same way."""
    return _with_state(SelectiveScanState, x, dt, A, B, C, h_in, False)


def selective_scan_with_state_ref(x, dt, A, B, C, h_in):
    """`selective_scan_with_state` through the plain versions."""
    return _with_state(SelectiveScanStateRef, x, dt, A, B, C, h_in, True)


def selective_scan_end_state_ref(x, dt, A, B, C, h_in):
    """`selective_scan_end_state` through the plain versions."""
    return _with_state(SelectiveScanStateRef, x, dt, A, B, C, h_in, False)


@contextlib.contextmanager
def scan_tensor_parallel(*args, **kwargs):
    """The JAX package's tensor-parallel scan scope, a no-op here: the
    tensor-parallel DiM (`parallel/tensor_parallel.py`) runs the scan on its
    rank's channels as it is."""
    yield
