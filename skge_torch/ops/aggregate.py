"""Duplicate-index gradient aggregation, the `grad_sum_matrix` equivalent.

Per-occurrence row gradients are AVERAGED over duplicate indices (sum
divided by occurrence count), not summed. Rows touched only by masked-out
occurrences (padding or non-violating pairs) get a count of zero, and the
optimizer leaves them untouched.

- `segment_mean_unique`: batch-local, over the unique touched rows.
- `segment_mean_dense`: into full-table arrays; its scatter is the CUDA
  kernel `segment_sum` (ops/cuda_segment.py) on the card.
- `segment_outer_mean_dense`: the same for low-rank factored gradients of
  a matrix-valued row (RESCAL's W); its scatter is the CUDA kernel
  `segment_outer_sum` (ops/cuda_outer.py) on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from skge_torch.ops.cuda_outer import segment_outer_sum
from skge_torch.ops.cuda_segment import segment_sum


class UniqueGrads(NamedTuple):
    """Batch-local averaged gradients.

    uidx:  (U,) unique in-range row ids, ascending.
    grads: (U, ...) averaged gradient per unique row.
    count: (U,) number of unmasked occurrences (0 => row must not be updated).
    """

    uidx: torch.Tensor
    grads: torch.Tensor
    count: torch.Tensor


class DenseGrads(NamedTuple):
    """Full-table averaged gradients.

    grads: same shape as the parameter table; zero rows where untouched.
    count: (num_rows,) unmasked occurrence counts (0 => untouched).
    """

    grads: torch.Tensor
    count: torch.Tensor


class FactoredOcc(NamedTuple):
    """Occurrence list whose per-occurrence gradients are low-rank sums of
    outer products `sum_f us[f][t] (x) vs[f][t]` of a matrix-valued row
    (RESCAL's W: rank 2, `es (x) dq + dr (x) eo`), kept factored so that
    dense aggregation never materializes the (T, d, d) tensor.

    idx:    (T,) int64 row ids (>= num_rows = dropped padding).
    us, vs: tuples of (T, d) left/right factors, one pair per rank term;
            premasked (violation-weighted sums).
    count:  (T,) occurrence counts for the duplicate-index averaging.
    """

    idx: torch.Tensor
    us: Tuple[torch.Tensor, ...]
    vs: Tuple[torch.Tensor, ...]
    count: torch.Tensor


def _bmask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape (T,) mask to broadcast against (T, ...) grads."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


# flattened feature width above which segment_mean_dense scatters grads and
# counts separately instead of through the fused count channel
_WIDE_ROW_THRESHOLD = 4096


def segment_mean_unique(
    indices: torch.Tensor,
    grads: torch.Tensor,
    mask: torch.Tensor,
    num_rows: int,
    premasked: bool = False,
) -> UniqueGrads:
    """Average per-occurrence `grads` over duplicate `indices`.

    indices: (T,) int64 row ids (concatenated over all roles/slots); ids
             outside [0, num_rows) are dropped.
    grads:   (T, ...) per-occurrence gradients.
    mask:    (T,) float; masked-out occurrences contribute neither gradient
             nor count.
    premasked: when True, `grads` are already mask-weighted SUMS and `mask`
             holds the (possibly >1) occurrence COUNTS.
    """
    keep = (indices >= 0) & (indices < num_rows)
    indices, grads, mask = indices[keep], grads[keep], mask[keep]
    uidx, inv = torch.unique(indices, sorted=True, return_inverse=True)
    u = uidx.shape[0]
    m = mask.to(grads.dtype)
    count = torch.zeros(u, dtype=grads.dtype, device=grads.device)
    count.index_add_(0, inv, m)
    g = grads if premasked else grads * _bmask(m, grads.ndim)
    gsum = torch.zeros(
        (u,) + grads.shape[1:], dtype=grads.dtype, device=grads.device
    )
    gsum.index_add_(0, inv, g)
    gavg = gsum / _bmask(torch.clamp(count, min=1.0), gsum.ndim)
    return UniqueGrads(uidx=uidx, grads=gavg, count=count)


def segment_outer_mean_dense(occ: FactoredOcc, num_rows: int) -> DenseGrads:
    """`segment_mean_dense` for factored occurrence gradients.

    Sums the outer products into the (num_rows, d, d) table through
    `segment_outer_sum` and the counts through `segment_sum` (D = 1), then
    divides. The JAX package's `backend` choice and its VMEM fallback have
    no counterpart: on the card this is always the kernel, on the CPU the
    plain version.
    """
    idx = occ.idx.contiguous()  # a column of the (B, 3) batch
    gsum = segment_outer_sum(
        idx,
        tuple(u.contiguous() for u in occ.us),
        tuple(v.contiguous() for v in occ.vs),
        num_rows,
    )
    count = segment_sum(
        idx, occ.count.to(gsum.dtype)[:, None].contiguous(), num_rows
    )[:, 0]
    gavg = gsum / _bmask(torch.clamp(count, min=1.0), gsum.ndim)
    return DenseGrads(grads=gavg, count=count)


def segment_mean_dense(
    indices: torch.Tensor,
    grads: torch.Tensor,
    mask: torch.Tensor,
    num_rows: int,
    premasked: bool = False,
) -> DenseGrads:
    """Same semantics as `segment_mean_unique`, into full-table arrays.

    Gradients and occurrence counts go through ONE scatter, the counts
    riding as an extra trailing channel, padded with zero columns to a
    multiple of 4. Rows at least `_WIDE_ROW_THRESHOLD`
    wide scatter gradients and counts separately instead: the fused channel
    would copy the whole (T, F) block to add one column.

    The JAX package picks among three scatters here (XLA, its Pallas
    kernel, a sorted one-hot matmul); on Hopper all of them are the kernel
    `segment_sum`.
    """
    m = mask.to(grads.dtype)
    g = grads if premasked else grads * _bmask(m, grads.ndim)
    t = indices.shape[0]
    feat_shape = grads.shape[1:]
    flat = g.reshape(t, -1)
    if flat.shape[1] >= _WIDE_ROW_THRESHOLD:
        gsum = segment_sum(indices, flat.contiguous(), num_rows).reshape(
            (num_rows,) + feat_shape
        )
        count = segment_sum(indices, m[:, None].contiguous(), num_rows)[:, 0]
    else:
        # the count channel, then zeros up to a multiple of 4 columns: the
        # kernel's 16-byte path (152 for TransE's 150, 104 for RESCAL's 100)
        f = flat.shape[1]
        pad = flat.new_zeros((t, -(f + 1) % 4))
        aug = torch.cat([flat, m[:, None], pad], dim=1)
        table = segment_sum(indices, aug, num_rows)
        count = table[:, f]
        gsum = table[:, :f].reshape((num_rows,) + feat_shape)
    gavg = gsum / _bmask(torch.clamp(count, min=1.0), gsum.ndim)
    return DenseGrads(grads=gavg, count=count)
