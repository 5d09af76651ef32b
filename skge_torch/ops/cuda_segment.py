"""Segment sum, the gradient-aggregation scatter, as a hand-written CUDA kernel.

`segment_sum(indices, grads, num_rows)` sums the (T, D) rows of `grads` into
a (num_rows, D) table by `indices`. Ids < 0 or >= num_rows are dropped;
negative ids do not wrap. It is the port of `segment_sum_pallas`
(skge_tpu/ops/pallas_segment.py); the kernel is `csrc/segment_sum.cu`.

- A CUDA tensor goes to the kernel, fp32 only, or the call raises.
- A CPU tensor goes to `segment_sum_reference`, the plain PyTorch version of
  the same function (fp32 or fp64), which the CPU tests run and which the
  kernel is checked against on the card.

Under `torch.use_deterministic_algorithms(True)` a CUDA call takes the
kernel's deterministic variant (PyTorch's own `index_add_` switches the
same way): the ids are grouped by row on the card (ops/grouping.py), and
each row's occurrences are summed in their order, in chunks of `CHUNK`
for a longer row, whose chunk sums are then added in chunk order. A run
repeats bit for bit; `segment_sum_ordered_reference` is the plain version
in that exact order, which the variant equals bit for bit.

`launches` counts kernel launches, so a run can show that its scatters went
through the kernel; `vector_launches` counts those of them that took the
kernel's 16-byte path (D % 4 == 0, grads and out 16-byte aligned), and
`deterministic_launches` those that took the deterministic variant;
`combine_launches` counts the variant's second launch, which adds the
chunk sums of the rows longer than `CHUNK` (made where T > CHUNK).
"""

from __future__ import annotations

import ctypes

import torch

from skge_torch.ops import _build, grouping

launches = 0
vector_launches = 0
deterministic_launches = 0
combine_launches = 0

CHUNK = 128  # the deterministic variant's chunk: kChunk in csrc/segment_sum.cu


def segment_sum_reference(
    indices: torch.Tensor, grads: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain version: `index_add_` after moving dropped ids out of the way
    (`index_add_` raises on ids outside [0, num_rows))."""
    keep = (indices >= 0) & (indices < num_rows)
    out = torch.zeros(
        (num_rows, grads.shape[1]), dtype=grads.dtype, device=grads.device
    )
    return out.index_add_(
        0,
        torch.where(keep, indices, 0),
        torch.where(keep[:, None], grads, 0.0),
    )


def segment_sum_ordered_reference(
    indices: torch.Tensor, grads: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain version in the deterministic variant's exact order: each row's
    occurrences in their order, in chunks of CHUNK from the row's start;
    step k adds the k-th occurrence of every chunk that has one, then each
    row adds its chunk sums in chunk order."""
    perm, offsets = grouping.group_by_row_reference(indices, num_rows)
    device, d = grads.device, grads.shape[1]
    starts, counts = offsets[:-1], offsets[1:] - offsets[:-1]
    nchunks = (counts + CHUNK - 1) // CHUNK
    rows = torch.repeat_interleave(torch.arange(num_rows, device=device), nchunks)
    first = torch.cumsum(nchunks, 0) - nchunks  # each row's chunk 0
    k = torch.arange(rows.shape[0], device=device) - first[rows]
    begin = starts[rows] + k * CHUNK
    length = torch.clamp(counts[rows] - k * CHUNK, max=CHUNK)
    part = grads.new_zeros((rows.shape[0], d))
    for j in range(int(length.max()) if rows.shape[0] else 0):
        live = torch.nonzero(length > j).squeeze(1)
        part[live] += grads[perm[begin[live] + j]]
    out = grads.new_zeros((num_rows, d))
    for j in range(int(nchunks.max()) if num_rows else 0):
        live = torch.nonzero(nchunks > j).squeeze(1)
        out[live] += part[first[live] + j]
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    fn = lib.skge_segment_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        rows = lib.skge_segment_sum_rows_f32
        rows.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p
        ]
        rows.restype = ctypes.c_int
        combine = lib.skge_segment_sum_combine_f32
        combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p
        ]
        combine.restype = ctypes.c_int
        lib.skge_segment_sum_chunk.argtypes = []
        lib.skge_segment_sum_chunk.restype = ctypes.c_int64
        if lib.skge_segment_sum_chunk() != CHUNK:
            raise RuntimeError("csrc/segment_sum.cu's kChunk is not CHUNK "
                               f"({lib.skge_segment_sum_chunk()} != {CHUNK})")
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            "segment_sum kernel launch failed: "
            + lib.skge_cuda_error_string(err).decode()
        )


def segment_sum(
    indices: torch.Tensor, grads: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Sum `grads` (T, D) into a (num_rows, D) table by `indices` (T,).

    On a CUDA tensor the kernel's fp32 atomics sum in no fixed order, so the
    last bits vary from run to run, unless deterministic algorithms are on
    (`torch.use_deterministic_algorithms`): then the deterministic variant
    runs, bit for bit `segment_sum_ordered_reference`. Its output, which
    the kernel writes whole, is allocated with PyTorch's NaN fill of new
    tensors suspended (`grouping.unfilled`, a process-wide flag).
    """
    global launches, vector_launches, deterministic_launches, combine_launches
    if indices.dim() != 1 or grads.dim() != 2:
        raise ValueError(
            f"want indices (T,) and grads (T, D), got {tuple(indices.shape)} "
            f"and {tuple(grads.shape)}"
        )
    if indices.shape[0] != grads.shape[0]:
        raise ValueError(
            f"{indices.shape[0]} indices for {grads.shape[0]} gradient rows"
        )
    if indices.dtype != torch.int64:
        raise TypeError(f"indices must be int64, got {indices.dtype}")
    if indices.device != grads.device:
        raise ValueError(
            f"indices on {indices.device}, grads on {grads.device}"
        )
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0, got {num_rows}")
    if grads.device.type == "cpu":
        if grads.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"fp32 or fp64 only, got {grads.dtype}")
        return segment_sum_reference(indices, grads, num_rows)
    if grads.device.type != "cuda":
        raise ValueError(f"no segment_sum for device {grads.device}")
    if grads.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel is fp32-only, got {grads.dtype}")
    if not (indices.is_contiguous() and grads.is_contiguous()):
        raise ValueError("indices and grads must be contiguous")
    t, d = grads.shape
    if t == 0 or d == 0 or num_rows == 0:
        return torch.zeros((num_rows, d), dtype=grads.dtype, device=grads.device)
    lib = _lib()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        if torch.are_deterministic_algorithms_enabled():
            # every row is written by the kernel: no zero-fill (and no NaN fill)
            keys, perm, offsets = grouping.group(indices, num_rows, torch.int32)
            with grouping.unfilled():
                out = torch.empty((num_rows, d), dtype=grads.dtype, device=grads.device)
                scratch = torch.empty(((t + CHUNK - 1) // CHUNK if t > CHUNK else 0, d),
                                      dtype=grads.dtype, device=grads.device)
            vector = _vector(d, grads, out)
            _raise(lib, lib.skge_segment_sum_rows_f32(
                keys.data_ptr(), perm.data_ptr(), offsets.data_ptr(), grads.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), t, d, num_rows, int(vector), stream,
            ))
            launches += 1
            vector_launches += vector
            deterministic_launches += 1
            if t > CHUNK:
                _raise(lib, lib.skge_segment_sum_combine_f32(
                    keys.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), t, d, num_rows, int(vector), stream,
                ))
                combine_launches += 1
            return out
        out = torch.zeros((num_rows, d), dtype=grads.dtype, device=grads.device)
        vector = _vector(d, grads, out)
        _raise(lib, lib.skge_segment_sum_f32(
            indices.data_ptr(), grads.data_ptr(), out.data_ptr(),
            t, d, num_rows, int(vector), stream,
        ))
    launches += 1
    vector_launches += vector
    return out


def _vector(d: int, grads: torch.Tensor, out: torch.Tensor) -> bool:
    """The 16-byte path: D % 4 == 0, grads and out 16-byte aligned."""
    return d % 4 == 0 and grads.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
