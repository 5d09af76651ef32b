"""RotatE's complex-modulus pool distance, K6, as hand-written CUDA kernels,
forward and backward, and the sweep's router.

Rows are complex vectors of width D in the port's layout, real parts
first: (B, 2D) queries q and (K, 2D) pool or entity rows p. `rotate_pool(q,
p)` is the (B, K) matrix

    S[b, k] = -sum_c |q[b, c] - p[k, c]|
            = -sum_c sqrt((q_re - p_re)^2 + (q_im - p_im)^2),

the negated sum of complex moduli of Sun et al. 2019 (RotatE's published
distance), differentiable in both inputs: given G = dL/dS and u = (q[b] -
p[k]) / m per complex dimension (each part divided by its modulus m),

    dq[b] = -sum_k G[b, k] u,   dp[k] = +sum_b G[b, k] u,

with u = 0 where m == 0: the gradient `torch.linalg.vector_norm` gives at 0,
which the authors' code takes through `.norm(dim=0)`. It is the sweep of
RotatE's `distance="modulus"` (models/rotate.py) in every shared-pool
step, serving batch and all-entity ranking. It replaces no TPU kernel; the
kernels are `csrc/rotate_pool.cu`.

`modulus_sweep(q, rows)` is the one place that routes, by device alone:
the kernels on the card, in one call over the whole pool or table; the
plain version on the CPU, chunked over the rows to bound the (B, chunk, 2D)
broadcast, each chunk recomputed in the backward pass
(`torch.utils.checkpoint`) when autograd records. `rotate_pool` takes CUDA
fp32 tensors only and raises on anything else, so a bfloat16 or fp64 sweep
on the card is refused, never sent to the plain version. No (B, K, 2D) tensor is stored: the backward recomputes
each modulus from q and p, the only tensors kept for it.
`rotate_pool_reference` is the plain forward, `rotate_pool_backward_reference`
the plain backward from the formulas above; the CPU tests run both, and the
card checks hold the kernels to them.

The forward sums each output's moduli 8 at a time in order and the chunk
sums with Kahan's compensation; the backward each gradient over the reduced
rows in order. Where the tiles alone would leave the card's slots empty
(`split_count`), the forward splits the complex dimensions and the backward
the reduced rows, and a second launch adds the partial sums in split order.
No atomics: results repeat bit for bit, and equal rows of p score bit-equal.

`launches` counts forward launches and `backward_launches` the backward's
gradient launches (one for dq, one for dp, each where autograd asks for it),
so a run can show that its sweeps went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.checkpoint import checkpoint

from skge_torch.ops import _build
from skge_torch.ops.grouping import unfilled

launches = 0
backward_launches = 0

# Mirrors of csrc/rotate_pool.cu's tiles and __launch_bounds__, which the
# split choice reads; the kernels size their grids from their own constants.
FWD_TILE = 64       # rows of q and of p a forward block
GRAD_ROWS = 64      # output rows a backward block
SLOTS = 2           # blocks resident on an SM
MIN_SPLIT = 128     # complex dimensions (forward) or reduced rows (backward) a split at least
MAX_SPLIT = 16
# elements of the (B, chunk, 2D) broadcast a plain chunk holds at most
CHUNK_ELEMENTS = 1 << 22


def complex_moduli(x: torch.Tensor) -> torch.Tensor:
    """(..., D) moduli of (..., 2D) complex rows, by `torch.linalg.vector_norm`
    (gradient 0 at 0)."""
    return torch.linalg.vector_norm(x.unflatten(-1, (2, x.shape[-1] // 2)), dim=-2)


def rotate_pool_reference(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: (B, K) = -sum_c |q[b, c] - p[k, c]|; a
    (B, K, 2D) broadcast."""
    return -torch.sum(complex_moduli(q[:, None, :] - p[None, :, :]), dim=-1)


def rotate_pool_backward_reference(q: torch.Tensor, p: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward: (dq, dp) for G = `g` (B, K), the unit
    differences u as a (B, K, 2D) tensor, 0 where a modulus is 0."""
    diff = (q[:, None, :] - p[None, :, :]).unflatten(-1, (2, q.shape[-1] // 2))
    m = torch.linalg.vector_norm(diff, dim=-2, keepdim=True)
    u = torch.where(m > 0, diff / torch.where(m > 0, m, 1.0), 0.0).flatten(-2)
    w = g[:, :, None] * u
    return -torch.sum(w, dim=1), torch.sum(w, dim=0)


def split_count(blocks: int, reduced: int, n_sm: int) -> int:
    """The splits of one launch's reduction: 1 where its `blocks` fill the
    card's resident slots; otherwise the count up to MAX_SPLIT, each split
    at least MIN_SPLIT of the `reduced` axis, whose waves take the least
    time (fewest waves a split's share of the work; the fewest splits on a
    tie)."""
    slots = SLOTS * n_sm
    top = max(1, min(MAX_SPLIT, reduced // MIN_SPLIT))
    if blocks >= slots:
        return 1
    return min(range(1, top + 1), key=lambda n: (-(-blocks * n // slots) / n, n))


def _td(d: int) -> int:
    """Complex dimensions a backward lane: 2 (64 a block) above 32."""
    return 1 if d <= 32 else 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("rotate_pool")
    fwd = lib.skge_rotate_pool_forward_f32
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        grad = lib.skge_rotate_pool_grad_f32
        grad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        grad.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            "rotate_pool kernel launch failed: " + lib.skge_cuda_error_string(err).decode()
        )


def _forward(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    global launches
    (b, w), k = q.shape, p.shape[0]
    d = w // 2
    blocks = -(-b // FWD_TILE) * -(-k // FWD_TILE)
    nsplit = split_count(blocks, d, _sm_count(q.device.index))
    with unfilled():  # the kernels write every element of both
        s = torch.empty((b, k), dtype=q.dtype, device=q.device)
        scratch = (torch.empty((nsplit, b, k), dtype=q.dtype, device=q.device)
                   if nsplit > 1 else None)
    if b == 0 or k == 0:
        return s
    lib = _lib()
    _raise(lib, lib.skge_rotate_pool_forward_f32(
        q.data_ptr(), p.data_ptr(), s.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, k, d, nsplit,
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    launches += 1
    return s


def _grad(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, dp: bool) -> torch.Tensor:
    """dq (x = q, y = p, g (B, K)) or dp (x = p, y = q, the same g)."""
    global backward_launches
    (rows, w), reduced = x.shape, y.shape[0]
    d, td = w // 2, _td(w // 2)
    blocks = -(-rows // GRAD_ROWS) * -(-d // (32 * td))
    nsplit = split_count(blocks, reduced, _sm_count(x.device.index))
    with unfilled():  # the kernels write every element of both
        out = torch.empty_like(x)
        scratch = (torch.empty((nsplit, rows, w), dtype=x.dtype, device=x.device)
                   if nsplit > 1 else None)
    if rows == 0:
        return out
    lib = _lib()
    _raise(lib, lib.skge_rotate_pool_grad_f32(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        rows, reduced, d, td, int(dp), nsplit,
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    backward_launches += 1
    return out


class _RotatePool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, p):
        ctx.save_for_backward(q, p)
        with torch.cuda.device(q.device):
            return _forward(q, p)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, p = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        with torch.cuda.device(q.device):
            dq = _grad(q, p, g, dp=False) if ctx.needs_input_grad[0] else None
            dp = _grad(p, q, g, dp=True) if ctx.needs_input_grad[1] else None
        return dq, dp


def rotate_pool(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """S (B, K) = -sum_c |q[b, c] - p[k, c]| for complex rows q (B, 2D) and
    p (K, 2D) on the card, with the gradient above in both inputs."""
    if q.dim() != 2 or p.dim() != 2 or q.shape[1] != p.shape[1]:
        raise ValueError(
            f"want q (B, 2D) and p (K, 2D), got {tuple(q.shape)} and {tuple(p.shape)}"
        )
    if q.shape[1] == 0 or q.shape[1] % 2:
        raise ValueError(f"complex rows are 2D wide, D >= 1; got width {q.shape[1]}")
    if q.device != p.device:
        raise ValueError(f"q on {q.device}, p on {p.device}")
    if q.device.type != "cuda":
        raise ValueError(f"rotate_pool runs on the card only, got {q.device}")
    if q.dtype != torch.float32 or p.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels are fp32-only, got {q.dtype} and {p.dtype}")
    if not (q.is_contiguous() and p.is_contiguous()):
        raise ValueError("q and p must be contiguous")
    return _RotatePool.apply(q, p)


def modulus_sweep(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, n) = -sum_c |q[b, c] - rows[e, c]|: K6 in one call on the card
    (which raises on anything but fp32); on the CPU the plain version over
    chunks of rows, each recomputed in the backward pass when autograd
    records."""
    if q.is_cuda:
        return rotate_pool(q.contiguous(), rows.contiguous())
    chunk = max(1, CHUNK_ELEMENTS // max(1, q.shape[0] * q.shape[1]))

    def one(c):
        if torch.is_grad_enabled() and (q.requires_grad or c.requires_grad):
            # no RNG state to save: the sweep draws nothing
            return checkpoint(rotate_pool_reference, q, c, use_reentrant=False,
                              preserve_rng_state=False)
        return rotate_pool_reference(q, c)

    return torch.cat([one(c) for c in torch.split(rows, chunk)], dim=1)
