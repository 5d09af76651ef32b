"""The L1 pool distance, K3, as hand-written CUDA kernels, forward and backward.

`l1_pool(q, p)` is the (B, K) matrix S[b, k] = -sum_d |q[b, d] - p[k, d]|,
differentiable in both inputs: given G = dL/dS,

    dq[b] = -sum_k G[b, k] s(q[b] - p[k]),   dp[k] = +sum_b G[b, k] s(q[b] - p[k]),

with s(x) = +1 where x >= 0 (at +0 and -0 too) and -1 elsewhere: the
gradient of `where(x >= 0, x, -x)`, as `jax.grad(jnp.abs)` gives it. It is
the TransE-L1 sweep of every shared-pool step, serving batch and
all-entity ranking (models/transe.py). It replaces no TPU kernel; the
kernels are `csrc/l1_pool.cu`.

`l1_pool` takes CUDA fp32 contiguous tensors only and raises on anything
else; `models/transe._neg_l1_chunks` is the one place that routes between
it and the plain sweep. No (B, K, d) tensor is stored: the backward
recomputes the signs from q and p, the only tensors kept for it.
`l1_pool_reference` is the plain PyTorch version of the forward,
`l1_pool_backward_reference` the plain backward from the formulas above;
the CPU tests run both, and the card tests hold the kernels to them.

The forward sums each output's terms 8 d at a time in order, and the
chunk sums in order with Kahan's compensation (within ~2e-6 of the exact
sum at scores of ~16, where a plain running sum drifts by 1.7e-5); the
backward each gradient over the reduced rows in order within a split and
then the splits in order (no atomics): results repeat bit for bit, and equal rows
of p score bit-equal. The backward's tiling adapts to the shape
(`grad_tiling`): one algorithm, its parameters chosen so that the blocks
fill the card.

`launches` counts forward launches and `backward_launches` the backward's
gradient launches (one for dq, one for dp, each where autograd asks for
it), so a run can show that its sweeps went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from skge_torch.ops import _build
from skge_torch.ops.grouping import unfilled

launches = 0
backward_launches = 0

# The backward's split choice (`grad_tiling`) reads these mirrors of
# csrc/l1_pool.cu's kGradRows, kMaxTd and __launch_bounds__; the kernels
# size their grids from their own constants and refuse a td out of range.
GRAD_ROWS = 64      # output rows a block
MAX_TD = 5          # d a lane, 160 a block
SLOTS = 2           # blocks resident on an SM
MIN_SPLIT_ROWS = 128  # reduced rows a split at least


def l1_pool_reference(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: (B, K) = -sum_d |q[b] - p[k]|, with |x|
    as `where(x >= 0, x, -x)` (gradient +1 at 0); a (B, K, d) broadcast."""
    d = q[:, None, :] - p[None, :, :]
    return -torch.sum(torch.where(d >= 0, d, -d), dim=-1)


def l1_pool_backward_reference(q: torch.Tensor, p: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward: (dq, dp) for G = `g` (B, K), the
    signs s(q[b] - p[k]) as a (B, K, d) tensor."""
    s = torch.where(q[:, None, :] - p[None, :, :] >= 0, 1.0, -1.0).to(q.dtype)
    w = g[:, :, None] * s
    return -torch.sum(w, dim=1), torch.sum(w, dim=0)


def grad_tiling(rows: int, reduced: int, d: int, n_sm: int) -> tuple:
    """(td, nsplit) of one backward launch: `rows` output rows of width
    `d`, reduced over `reduced` rows. td d a lane (up to MAX_TD); the
    reduction split into nsplit ranges of at least MIN_SPLIT_ROWS where
    the output alone gives fewer than two waves of blocks."""
    td = min(MAX_TD, -(-min(max(d, 1), 32 * MAX_TD) // 32))
    blocks = -(-rows // GRAD_ROWS) * -(-max(d, 1) // (32 * td))
    want = -(-2 * SLOTS * n_sm // max(blocks, 1))
    return td, max(1, min(want, reduced // MIN_SPLIT_ROWS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("l1_pool")
    fwd = lib.skge_l1_pool_forward_f32
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        grad = lib.skge_l1_pool_grad_f32
        grad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
            ctypes.c_int
        ] * 3 + [ctypes.c_void_p]
        grad.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            "l1_pool kernel launch failed: " + lib.skge_cuda_error_string(err).decode()
        )


def _forward(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    global launches
    (b, d), k = q.shape, p.shape[0]
    with unfilled():  # the kernel writes every output
        s = torch.empty((b, k), dtype=q.dtype, device=q.device)
    if b == 0 or k == 0:
        return s
    lib = _lib()
    _raise(lib, lib.skge_l1_pool_forward_f32(
        q.data_ptr(), p.data_ptr(), s.data_ptr(), b, k, d,
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    launches += 1
    return s


def _grad(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, dp: bool) -> torch.Tensor:
    """dq (x = q, y = p, g (B, K)) or dp (x = p, y = q, the same g)."""
    global backward_launches
    (rows, d), reduced = x.shape, y.shape[0]
    td, nsplit = grad_tiling(rows, reduced, d, _sm_count(x.device.index))
    with unfilled():  # the kernels write every element of both
        out = torch.empty_like(x)
        scratch = (torch.empty((nsplit, rows, d), dtype=x.dtype, device=x.device)
                   if nsplit > 1 else None)
    if rows == 0 or d == 0:
        return out
    lib = _lib()
    _raise(lib, lib.skge_l1_pool_grad_f32(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        rows, reduced, d, td, int(dp), nsplit,
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    backward_launches += 1
    return out


class _L1Pool(torch.autograd.Function):
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


def l1_pool(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """S (B, K) = -||q[b] - p[k]||_1 for q (B, d) and p (K, d) on the card,
    with the gradient above in both inputs."""
    if q.dim() != 2 or p.dim() != 2 or q.shape[1] != p.shape[1]:
        raise ValueError(
            f"want q (B, d) and p (K, d), got {tuple(q.shape)} and {tuple(p.shape)}"
        )
    if q.device != p.device:
        raise ValueError(f"q on {q.device}, p on {p.device}")
    if q.device.type != "cuda":
        raise ValueError(f"l1_pool runs on the card only, got {q.device}")
    if q.dtype != torch.float32 or p.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels are fp32-only, got {q.dtype} and {p.dtype}")
    if not (q.is_contiguous() and p.is_contiguous()):
        raise ValueError("q and p must be contiguous")
    return _L1Pool.apply(q, p)
