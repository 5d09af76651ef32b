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
kernel's deterministic variant: the ids are stable-sorted on the card and
each row's occurrences are summed in their order, so a run repeats bit for
bit (PyTorch's own `index_add_` switches the same way).

`launches` counts kernel launches, so a run can show that its scatters went
through the kernel; `vector_launches` counts those of them that took the
kernel's 16-byte path (D % 4 == 0, grads and out 16-byte aligned), and
`deterministic_launches` those that took the deterministic variant.
"""

from __future__ import annotations

import ctypes

import torch

from skge_torch.ops import _build

launches = 0
vector_launches = 0
deterministic_launches = 0


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    fn = lib.skge_segment_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        det = lib.skge_segment_sum_sorted_f32
        det.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p
        ]
        det.restype = ctypes.c_int
        lib.skge_cuda_error_string.argtypes = [ctypes.c_int]
        lib.skge_cuda_error_string.restype = ctypes.c_char_p
    return lib


def segment_sum(
    indices: torch.Tensor, grads: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Sum `grads` (T, D) into a (num_rows, D) table by `indices` (T,).

    On a CUDA tensor the kernel's fp32 atomics sum in no fixed order, so the
    last bits vary from run to run, unless deterministic algorithms are on
    (`torch.use_deterministic_algorithms`): then the sorted variant runs.
    """
    global launches, vector_launches, deterministic_launches
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
    out = torch.zeros((num_rows, d), dtype=grads.dtype, device=grads.device)
    if t == 0 or d == 0 or num_rows == 0:
        return out
    vector = d % 4 == 0 and grads.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    deterministic = torch.are_deterministic_algorithms_enabled()
    lib = _lib()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        if deterministic:
            ids, order = torch.sort(indices, stable=True)
            err = lib.skge_segment_sum_sorted_f32(
                ids.data_ptr(), order.data_ptr(), grads.data_ptr(),
                out.data_ptr(), t, d, num_rows, int(vector), stream,
            )
        else:
            err = lib.skge_segment_sum_f32(
                indices.data_ptr(), grads.data_ptr(), out.data_ptr(),
                t, d, num_rows, int(vector), stream,
            )
    if err != 0:
        raise RuntimeError(
            "segment_sum kernel launch failed: "
            + lib.skge_cuda_error_string(err).decode()
        )
    launches += 1
    vector_launches += vector
    deterministic_launches += deterministic
    return out
