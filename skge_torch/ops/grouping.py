"""Group occurrences by row: the index preparation of both CUDA scatters.

`group_by_row(indices, num_rows)` gives a stable order of the ids and the
start of each row's run in it. The segment sum's deterministic variant
(ops/cuda_segment.py) and the segment outer sum (ops/cuda_outer.py) walk
those runs, one row a team of threads, each row's occurrences in order.

- A CUDA tensor goes to the hand-written kernels of `csrc/group_by_row.cu`
  (tiles sorted in shared memory, merged by rank, then each row's start
  found).
- A CPU tensor goes to `group_by_row_reference`, the plain PyTorch version,
  which the kernels are checked against, exactly, on the card.

`launches` counts the calls that launched those kernels.

The outputs of these kernels and of the two scatters are written whole,
so they are allocated inside `unfilled()`: PyTorch's NaN fill of new
tensors under deterministic algorithms is suspended for those allocations
only. The flag it clears is process-wide, so an allocation that another
thread makes in that window is not filled either; the port runs one
thread a process.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch
import torch.utils.deterministic

from skge_torch.ops import _build

launches = 0


@contextlib.contextmanager
def unfilled():
    """`torch.empty` as allocated, for outputs a kernel writes whole: under
    deterministic algorithms PyTorch fills new tensors with NaN
    (`torch.utils.deterministic.fill_uninitialized_memory`), a pass over
    every byte and a launch each. Hold it around the allocations alone:
    the flag is process-wide."""
    flag = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = flag


def _sorted_keys(indices: torch.Tensor, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ids clamped to [-1, num_rows] in ascending order, and the stable
    permutation that sorts them. The sort runs on the narrowest integer type
    that holds the keys: a radix sort takes one pass a byte of the key."""
    key = next(t for t in (torch.int8, torch.int16, torch.int32)
               if num_rows <= torch.iinfo(t).max)
    return torch.sort(indices.clamp(-1, num_rows).to(key), stable=True)


def group_by_row_reference(
    indices: torch.Tensor, num_rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `group_by_row`: a stable sort and `searchsorted`."""
    sorted_keys, perm = _sorted_keys(indices, num_rows)
    rows = torch.arange(num_rows + 1, dtype=sorted_keys.dtype, device=indices.device)
    return perm, torch.searchsorted(sorted_keys, rows)


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_by_row")
    fn = lib.skge_group_by_row
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [
            ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def group(
    indices: torch.Tensor, num_rows: int, dtype: torch.dtype = torch.int64
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`(keys, perm, offsets)` of the ids of a CUDA tensor: `keys` (T,) int32
    the ids clamped to [-1, num_rows] in ascending order, `perm` and
    `offsets` as `group_by_row` gives them, in `dtype` (int32 or int64)."""
    global launches
    t = indices.shape[0]
    if indices.device.type != "cuda":
        raise ValueError(f"group takes a CUDA tensor, got {indices.device}")
    if not 0 < num_rows < 2**31 - 1 or t >= 2**31 - 1:
        raise ValueError(f"want 0 < num_rows < 2**31 - 1 and T < 2**31 - 1, got "
                         f"{num_rows} and {t}")
    if dtype not in (torch.int32, torch.int64):
        raise TypeError(f"perm and offsets are int32 or int64, not {dtype}")
    device, idx = indices.device, indices.contiguous()
    lib = _lib()
    with torch.cuda.device(device):
        with unfilled():  # every element is written by the kernels
            offsets = torch.empty(num_rows + 1, dtype=dtype, device=device)
            keys = torch.empty(t, dtype=torch.int32, device=device)
            perm = torch.empty(t, dtype=dtype, device=device)
            scratch = torch.empty(2 * t, dtype=torch.int32, device=device)  # sorted tiles
        err = lib.skge_group_by_row(
            idx.data_ptr(), t, num_rows, keys.data_ptr(),
            perm.data_ptr(), offsets.data_ptr(), scratch.data_ptr(),
            int(dtype == torch.int64), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("group_by_row kernel launch failed: "
                           + lib.skge_cuda_error_string(err).decode())
    launches += 1
    return keys, perm, offsets


def group_by_row(
    indices: torch.Tensor, num_rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group the occurrences by row id: `(perm, offsets)`.

    `perm` (T,) int64 is a stable ascending order of the ids, and `offsets`
    (num_rows + 1,) int64 the start of each row's run in it:
    `perm[offsets[r]:offsets[r + 1]]` are the positions of id r, in order.
    Ids < 0 sort before `offsets[0]` and ids >= num_rows after
    `offsets[num_rows]`, so the runs leave them out.
    """
    if indices.device.type == "cuda" and num_rows > 0:
        _, perm, offsets = group(indices, num_rows)
        return perm, offsets
    return group_by_row_reference(indices, num_rows)
