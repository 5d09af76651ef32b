"""Segment outer sum, RESCAL's factored W-gradient scatter, as a hand-written
CUDA kernel.

`segment_outer_sum(indices, us, vs, num_rows)` sums the low-rank outer
products `sum_f us[f][t] (x) vs[f][t]` into a (num_rows, d, d) table by
`indices`, without materializing the (T, d, d) products. Ids < 0 or
>= num_rows are dropped; negative ids do not wrap. Each row's occurrences
are added in their order in `indices`, one at a time, as the TPU kernel
adds them, so the result is deterministic. It is the port of
`segment_outer_sum_pallas` (skge_tpu/ops/pallas_outer.py); the kernel is
`csrc/segment_outer_sum.cu`.

- `group_by_row` (ops/grouping.py) orders the occurrences by row (a stable
  sort: on the card, the hand-written kernel `csrc/group_by_row.cu`); the
  kernel and the plain version both walk that order.
- A CUDA tensor goes to the kernel, fp32 only, or the call raises.
- A CPU tensor goes to `segment_outer_sum_reference`, the plain PyTorch
  version of the same function in the same order (fp32 or fp64), which the
  CPU tests run and which the kernel is checked against, bit for bit, on
  the card.

`launches` counts kernel launches, so a run can show that its W scatters
went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from skge_torch.ops import _build
from skge_torch.ops.grouping import group_by_row, group_by_row_reference, unfilled

launches = 0

MAX_RANK = 4  # the kernel's Factors struct


def segment_outer_sum_reference(
    indices: torch.Tensor,
    us: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    num_rows: int,
) -> torch.Tensor:
    """Plain version, in the kernel's order: step k adds the k-th occurrence
    of every row that has one, its rank terms summed first, each product
    and each sum a separate op."""
    d = us[0].shape[1]
    out = us[0].new_zeros((num_rows, d, d))
    perm, offsets = group_by_row_reference(indices, num_rows)
    starts, counts = offsets[:-1], offsets[1:] - offsets[:-1]
    for k in range(int(counts.max()) if num_rows else 0):
        rows = torch.nonzero(counts > k).squeeze(1)
        occ = perm[starts[rows] + k]
        delta = us[0][occ, :, None] * vs[0][occ, None, :]
        for u, v in zip(us[1:], vs[1:]):
            delta = delta + u[occ, :, None] * v[occ, None, :]
        out[rows] += delta
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_outer_sum")
    fn = lib.skge_segment_outer_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,                      # perm
            ctypes.c_void_p,                      # offsets
            ctypes.POINTER(ctypes.c_void_p),      # us
            ctypes.POINTER(ctypes.c_void_p),      # vs
            ctypes.c_int,                         # rank
            ctypes.c_void_p,                      # out
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # T, d, R
            ctypes.c_void_p,                      # stream
        ]
        fn.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(indices, us, vs, num_rows) -> None:
    if len(us) == 0 or len(us) != len(vs):
        raise ValueError(
            f"want as many left as right factors, at least one; got "
            f"{len(us)} and {len(vs)}"
        )
    if indices.dim() != 1:
        raise ValueError(f"want indices (T,), got {tuple(indices.shape)}")
    if indices.dtype != torch.int64:
        raise TypeError(f"indices must be int64, got {indices.dtype}")
    shape = us[0].shape
    if len(shape) != 2 or shape[0] != indices.shape[0]:
        raise ValueError(
            f"want factors ({indices.shape[0]}, d), got {tuple(shape)}"
        )
    for a in (*us, *vs):
        if a.shape != shape:
            raise ValueError(
                f"all factors must share one shape {tuple(shape)}, "
                f"got {tuple(a.shape)}"
            )
        if a.dtype != us[0].dtype:
            raise TypeError(f"factors mix {us[0].dtype} and {a.dtype}")
        if a.device != indices.device:
            raise ValueError(f"indices on {indices.device}, a factor on {a.device}")
    if not 0 <= num_rows < 2**31 - 1:
        raise ValueError(f"num_rows must lie in [0, 2**31 - 1), got {num_rows}")


def segment_outer_sum(
    indices: torch.Tensor,
    us: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    num_rows: int,
) -> torch.Tensor:
    """Sum `sum_f us[f][t] (x) vs[f][t]` into a (num_rows, d, d) table by
    `indices` (T,); `us` and `vs` hold the (T, d) factors, one pair per
    rank term. Each row sums its occurrences in their order in `indices`:
    the kernel and the plain version agree bit for bit. On the card the
    output, which the kernel writes whole, is allocated with PyTorch's NaN
    fill of new tensors (under deterministic algorithms) suspended
    (`grouping.unfilled`, a process-wide flag).
    """
    global launches
    us, vs = tuple(us), tuple(vs)
    _check(indices, us, vs, num_rows)
    dtype, device = us[0].dtype, us[0].device
    if device.type == "cpu":
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"fp32 or fp64 only, got {dtype}")
        return segment_outer_sum_reference(indices, us, vs, num_rows)
    if device.type != "cuda":
        raise ValueError(f"no segment_outer_sum for device {device}")
    if dtype != torch.float32:
        raise TypeError(f"the CUDA kernel is fp32-only, got {dtype}")
    rank = len(us)
    t, d = us[0].shape
    if rank > MAX_RANK:
        raise ValueError(f"the CUDA kernel takes rank <= {MAX_RANK}, got {rank}")
    if not all(a.is_contiguous() for a in (indices, *us, *vs)):
        raise ValueError("indices and factors must be contiguous")
    if t == 0 or d == 0 or num_rows == 0:
        return torch.zeros((num_rows, d, d), dtype=dtype, device=device)
    lib = _lib()
    ptrs = ctypes.c_void_p * rank
    with torch.cuda.device(device):
        perm, offsets = group_by_row(indices, num_rows)
        with unfilled():  # every cell is written by the kernel
            out = torch.empty((num_rows, d, d), dtype=dtype, device=device)
        err = lib.skge_segment_outer_sum_f32(
            perm.data_ptr(), offsets.data_ptr(),
            ptrs(*(u.data_ptr() for u in us)),
            ptrs(*(v.data_ptr() for v in vs)),
            rank, out.data_ptr(), t, d, num_rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "segment_outer_sum kernel launch failed: "
            + lib.skge_cuda_error_string(err).decode()
        )
    launches += 1
    return out
