"""The top k of a score tile as a hand-written CUDA kernel: each row's k
largest scores, descending, and their columns, ties broken toward the
lower column (`lax.top_k`'s rule), for every serving engine.

`top_k(scores, k, mask=False)` returns (vals, pos) of the (B, n) tile
`scores` in one launch: vals (B, k) in the tile's type, pos (B, k) the
columns as int64. With `mask` the serving epilogue is folded in: a
winner at or below NEG_INF (-1e30, the filter's mark) becomes (-inf, -1)
and the ids are int32, as `mask_invalid` makes them. Any 1 <= k <= n; the
kernel picks its way from k (`csrc/top_k.cu`). +0.0 and -0.0 tie; NaN is
outside the contract.

`top_k` takes fp32 or fp64 tiles on the card only, contiguous, and raises
on anything else. It replaces no TPU kernel (the JAX package calls
`lax.top_k`). `top_k_reference` is the plain PyTorch version, the route
off the card and the one the card tests hold the kernel to; `mask_invalid`
is its epilogue, which the streamed engine also applies to its gathered
ids. `skge_torch.serving._top_k` routes a tile to one or the other.

`launches` counts the calls that launched the kernel: one a tile.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from skge_torch.ops import _build
from skge_torch.ops.cuda_filter import NEG_INF

launches = 0


def top_k_reference(scores: torch.Tensor, k: int,
                    mask: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, column positions) of each row's k largest scores, descending,
    ties broken toward the lower position (`lax.top_k`'s rule); with `mask`,
    `mask_invalid`'s epilogue on int32 ids.

    `torch.topk` gives the k-th value exactly but promises no order among
    equal values; every column above the k-th value is in the result, and
    the lowest columns equal to it fill the remaining slots.
    """
    kth = torch.topk(scores, k, dim=1).values[:, k - 1 : k]
    above = scores > kth
    room = k - above.sum(dim=1, keepdim=True)
    tied = scores == kth
    take = above | (tied & (torch.cumsum(tied, dim=1, dtype=torch.int32) <= room))
    # the k taken columns, ascending, with no host sync: each taken column
    # keyed n - column (distinct, > 0), every other column 0
    n = scores.shape[1]
    key = take * torch.arange(n, 0, -1, dtype=torch.int32, device=scores.device)
    pos = torch.topk(key, k, dim=1).indices
    vals = torch.gather(scores, 1, pos)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    pos = torch.gather(pos, 1, order)
    return mask_invalid(vals, pos.to(torch.int32)) if mask else (vals, pos)


def mask_invalid(vals: torch.Tensor, ids: torch.Tensor):
    """Filtered winners (score <= NEG_INF) become (-inf, -1): a slot only
    wins when k exceeds the eligible candidates."""
    bad = vals <= NEG_INF
    return (torch.where(bad, torch.full_like(vals, -np.inf), vals),
            torch.where(bad, torch.full_like(ids, -1), ids))


def _lib() -> ctypes.CDLL:
    lib = _build.load("top_k")
    if lib.skge_top_k_f32.argtypes is None:
        for fn in (lib.skge_top_k_f32, lib.skge_top_k_f64):
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def top_k(scores: torch.Tensor, k: int, mask: bool = False):
    """(vals, pos) of the k best of each row of the (B, n) tile `scores`,
    value descending then column ascending; one launch. `mask`: winners at
    or below NEG_INF as (-inf, -1), ids int32; else int64 columns."""
    global launches
    if scores.device.type != "cuda":
        raise ValueError(f"top_k runs on the card only, got {scores.device}")
    if scores.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes fp32 or fp64 scores, got {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"want contiguous (B, n) scores, got {tuple(scores.shape)}")
    b, n = scores.shape
    if not 1 <= k <= n or n >= 2**31:
        raise ValueError(f"want 1 <= k <= n < 2**31, got k={k}, n={n}")
    dev = scores.device
    vals = torch.empty((b, k), dtype=scores.dtype, device=dev)
    pos = torch.empty((b, k), dtype=torch.int32 if mask else torch.int64, device=dev)
    if b == 0:
        return vals, pos
    lib = _lib()
    fn = lib.skge_top_k_f64 if scores.dtype == torch.float64 else lib.skge_top_k_f32
    with torch.cuda.device(dev):
        err = fn(scores.data_ptr(), b, n, k, int(mask), vals.data_ptr(), pos.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("top_k kernel launch failed: "
                           + lib.skge_cuda_error_string(err).decode())
    launches += 1
    return vals, pos
