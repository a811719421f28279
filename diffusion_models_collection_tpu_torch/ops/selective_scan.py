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
* `SelectiveScan` joins the two as the JAX `_selective_scan_core`
  custom_vjp does: the forward saves the block states only when an input
  needs a gradient (K6), else it runs without them (K5); the backward is
  `selective_scan_bwd` from the saved states. `selective_scan` is the entry
  point and adds the D skip outside the op; `selective_scan_sequential` is
  the O(L) reference that autograd differentiates, for tests.

The JAX gate `supported()` (D % 128, N <= 32, L >= 8) is a TPU lane limit
and is not ported: the kernels take any L >= 1 and any D, and N up to 32,
the most state a thread keeps in registers. The sequence-parallel scan
(`selective_scan_with_state`), the tensor-parallel scope
(`scan_tensor_parallel`) and the XLA `chunk_size` path raise (ROADMAP queue
1 item 15).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _build

MAX_STATE = 32

# Kernel launches since the process started (or since a caller reset them):
# the forward's, the forward's with saved states (counted in both), and the
# backward's.
FWD_LAUNCHES = 0
FWD_STATES_LAUNCHES = 0
BWD_LAUNCHES = 0


def t_block_for(length: int) -> int:
    """The time block of the JAX kernels (`selective_scan_pallas.py:139`):
    32 when L % 32 == 0, else 16."""
    return 32 if length % 32 == 0 else 16


def _blocks(length: int) -> List[Tuple[int, int]]:
    """(start, steps) of each time block; the last may be shorter."""
    tb = t_block_for(length)
    return [(t0, min(tb, length - t0)) for t0 in range(0, length, tb)]


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


def selective_scan_fwd_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, save_states: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch forward in the kernels' time blocks: per block, the
    decays and drives of all its steps at once, then the serial update.
    Returns (y without the D skip, bound or None)."""
    batch, _, d_inner = x.shape
    h = x.new_zeros(batch, d_inner, A.shape[1])
    ys, bounds = [], []
    for t0, steps in _blocks(x.shape[1]):
        bounds.append(h)
        dt_c = dt[:, t0:t0 + steps]
        decay = torch.exp(dt_c[..., None] * A)                 # (B, T, D, N)
        drive = (dt_c * x[:, t0:t0 + steps])[..., None] * B[:, t0:t0 + steps,
                                                            None, :]
        hs = []
        for s in range(steps):
            h = decay[:, s] * h + drive[:, s]
            hs.append(h)
        ys.append((torch.stack(hs, 1) * C[:, t0:t0 + steps, None, :]).sum(-1))
    if not ys:  # L == 0
        return x.clone(), (x.new_zeros(batch, 0, A.shape[1], d_inner)
                           if save_states else None)
    y = torch.cat(ys, dim=1)
    if not save_states:
        return y, None
    return y, torch.stack(bounds, 1).transpose(2, 3).contiguous()


def selective_scan_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor, bound: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward from the forward's block states (JAX
    `_bwd_block_body` over the blocks in reverse): recompute h inside each
    block from `bound`, run the adjoint gamma_t = C_t ybar_t + a_{t+1}
    gamma_{t+1} backwards, carrying phi = a_{t+1} gamma_{t+1} across blocks.
    Returns (dx, ddt, dA, dB, dC), dA (D, N) summed over the batch."""
    phi = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(A)
    blocks = _blocks(x.shape[1])
    for k in range(len(blocks) - 1, -1, -1):
        t0, steps = blocks[k]
        sl = slice(t0, t0 + steps)
        dt_c, x_c, b_c, c_c, g_c = dt[:, sl], x[:, sl], B[:, sl], C[:, sl], g[:, sl]
        decay = torch.exp(dt_c[..., None] * A)                 # (B, T, D, N)
        u_c = dt_c * x_c
        drive = u_c[..., None] * b_c[:, :, None, :]
        w = c_c[:, :, None, :] * g_c[..., None]                 # C_t (x) ybar_t
        h = bound[:, k].transpose(1, 2)
        h_prevs, hs = [], []
        for s in range(steps):
            h_prevs.append(h)
            h = decay[:, s] * h + drive[:, s]
            hs.append(h)
        gammas = [None] * steps
        for s in range(steps - 1, -1, -1):
            gammas[s] = w[:, s] + phi
            phi = decay[:, s] * gammas[s]
        gamma = torch.stack(gammas, 1)
        dadec = gamma * torch.stack(h_prevs, 1) * decay
        g_b = (gamma * b_c[:, :, None, :]).sum(-1)              # (B, T, D)
        ddt[:, sl] = (dadec * A).sum(-1) + g_b * x_c
        dx[:, sl] = g_b * dt_c
        dB[:, sl] = (gamma * u_c[..., None]).sum(2)
        dC[:, sl] = (torch.stack(hs, 1) * g_c[..., None]).sum(2)
        dA += (dadec * dt_c[..., None]).sum((0, 1))
    return dx, ddt, dA, dB, dC


def _check_shapes(name: str, x, dt, A, B, C, *others) -> Tuple[int, ...]:
    """x, dt and `others` one (batch, L, D) shape, A (D, N) with
    1 <= N <= MAX_STATE, B and C (batch, L, N)."""
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
    if not 1 <= n_state <= MAX_STATE:
        raise ValueError(
            f"{name}: state size {n_state} outside [1, {MAX_STATE}]: each "
            "kernel thread keeps one channel's whole state in registers")
    if x.device.type == "cuda" and (batch >= 65536 or x.numel() >= 2**31):
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the "
                         "kernel's grid or 32-bit indexing")
    return batch, length, d_inner, n_state


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def selective_scan_fwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, save_states: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scan forward over float32 inputs: the kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (y without the D skip, bound):
    bound (batch, n_blocks, N, D) with `save_states`, else None."""
    global FWD_LAUNCHES, FWD_STATES_LAUNCHES
    _build.check_inputs("selective_scan_fwd", x, dt, A, B, C)
    batch, length, d_inner, n_state = _check_shapes(
        "selective_scan_fwd", x, dt, A, B, C)
    if x.device.type == "cpu":
        return selective_scan_fwd_ref(x, dt, A, B, C, save_states)
    lib = _build.library()
    y = torch.empty_like(x)
    n_blocks = len(_blocks(length))
    bound = (torch.empty((batch, n_blocks, n_state, d_inner),
                         dtype=torch.float32, device=x.device)
             if save_states else None)
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


def selective_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, g: torch.Tensor, bound: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Scan backward from the forward's `bound`: the kernel for CUDA
    tensors, the plain version for CPU tensors. Returns (dx, ddt, dA, dB,
    dC). The kernel writes dA per batch row, (batch, D, N), and it is summed
    over the batch here, outside the kernel, as the JAX wrapper does
    (`selective_scan_pallas.py:571`)."""
    global BWD_LAUNCHES
    _build.check_inputs("selective_scan_bwd", x, dt, A, B, C, g, bound)
    batch, length, d_inner, n_state = _check_shapes(
        "selective_scan_bwd", x, dt, A, B, C, g)
    n_blocks = len(_blocks(length))
    if bound.shape != (batch, n_blocks, n_state, d_inner):
        raise ValueError(
            f"selective_scan_bwd: bound must be "
            f"{(batch, n_blocks, n_state, d_inner)}, got {tuple(bound.shape)}")
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, A, B, C, g, bound)
    lib = _build.library()
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    da_rows = torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                          device=x.device)
    if x.numel():
        tiles = lib.selective_scan_bwd_tiles(d_inner)
        width = lib.selective_scan_bwd_width(n_state)
        partial = torch.empty((batch, tiles, length, width),
                              dtype=torch.float32, device=x.device)
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
    else:  # an empty x: the sums over D are empty
        dB.zero_()
        dC.zero_()
    return dx, ddt, da_rows.sum(0), dB, dC


def _scan_forward(ctx, fwd, x, dt, A, B, C, save_states):
    y, bound = fwd(x, dt, A, B, C, save_states)
    if save_states:
        ctx.save_for_backward(x, dt, A, B, C, bound)
    return y


def _scan_backward(ctx, bwd, g):
    # autograd hands the gradient over in the consumer's layout
    return (*bwd(*ctx.saved_tensors[:5], g.contiguous(),
                 ctx.saved_tensors[5]), None)


class SelectiveScan(torch.autograd.Function):
    """The scan without the D skip, as the JAX `_selective_scan_core`
    custom_vjp: `selective_scan_fwd` (states saved only when a gradient is
    wanted), backward `selective_scan_bwd` from the saved states."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, save_states):
        return _scan_forward(ctx, selective_scan_fwd, x, dt, A, B, C,
                             save_states)

    @staticmethod
    def backward(ctx, g):
        return _scan_backward(ctx, selective_scan_bwd, g)


class SelectiveScanRef(torch.autograd.Function):
    """`SelectiveScan` over the plain versions on any device, for
    `ops.plain.plain_kernels`: autograd never steps through the L-step
    loop, so its memory and time are the op's, not autograd's."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, save_states):
        return _scan_forward(ctx, selective_scan_fwd_ref, x, dt, A, B, C,
                             save_states)

    @staticmethod
    def backward(ctx, g):
        return _scan_backward(ctx, selective_scan_bwd_ref, g)


def _apply(fn, x, dt, A, B, C, D, chunk_size):
    if chunk_size is not None:
        raise NotImplementedError(
            "selective_scan: chunk_size selects the JAX package's XLA "
            "chunked scan, which is not ported (ROADMAP queue 1 item 15)")
    inputs = [t.contiguous() for t in (x, dt, A, B, C)]
    save_states = torch.is_grad_enabled() and any(
        t.requires_grad for t in inputs)
    y = fn.apply(*inputs, save_states)
    if D is not None:
        y = y + x * D
    return y


def selective_scan(x, dt, A, B, C, D=None, *, chunk_size=None) -> torch.Tensor:
    """Differentiable selective scan (JAX `selective_scan`) through the
    forward and backward kernels, their plain versions on the CPU; A is
    (D, N) negative real (the caller takes -exp(A_log), so autograd carries
    A's gradient on to A_log), D the optional (D,) skip."""
    return _apply(SelectiveScan, x, dt, A, B, C, D, chunk_size)


def selective_scan_ref(x, dt, A, B, C, D=None, *,
                       chunk_size=None) -> torch.Tensor:
    """`selective_scan` through the plain versions (`SelectiveScanRef`)."""
    return _apply(SelectiveScanRef, x, dt, A, B, C, D, chunk_size)


def selective_scan_with_state(*args, **kwargs):
    """Not ported: the sequence-parallel scan's building block."""
    raise NotImplementedError(
        "selective_scan_with_state (the sequence-parallel DiM scan) is not "
        "ported yet (ROADMAP queue 1 item 15)")


def scan_tensor_parallel(*args, **kwargs):
    """Not ported: the tensor-parallel scan scope."""
    raise NotImplementedError(
        "scan_tensor_parallel (the tensor-parallel DiM scan) is not ported "
        "yet (ROADMAP queue 1 item 15)")
