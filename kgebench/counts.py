"""Counts the metrics divide by: work units, K1's bytes and the card's
peaks. Part of the yardstick.

- `train_units`: reference-equivalent scored triples, frozen from
  `skge_torch/bench.py` (`run`): 2 scores per margin-ranked pair; a
  shared pool ranks each positive against its k entities in each mode
  (2k pairs a positive over two modes), iid corruption against its
  negatives in each mode. Counted over the real triples of an epoch, not
  the padding of its last batch.
- `k1_bytes`: one call of K1 (`segment_sum`: (T, D) gradients into a
  table of R rows), each input read once and the output written once:
  T int64 ids, T x D fp32 gradients, and the U rows the call touches,
  U x D fp32. Frozen from `chip_smoke.py` phase 3
  (`nbytes=8 * t + 4 * t * d + 4 * nrows * d`), with the touched rows in
  place of all R: the kernel adds into a table that a separate fill
  kernel zeroed, and writes only the rows its ids name.
- `PEAKS`: NVIDIA's data sheet for the H100 SXM (dense, no sparsity),
  valid at the card's 700 W limit.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}


def peaks(device_name: str):
    """The card's peaks, or None for a card outside the table."""
    return PEAKS.get(device_name)


def pairs_per_positive(traffic: dict) -> int:
    modes = len(traffic["modes"])
    if traffic["sampler"] == "shared":
        return modes * traffic["k"]
    return modes * traffic["negatives"]


def train_units(traffic: dict, n_triples: int) -> int:
    """Scored triples of one epoch over `n_triples` positives."""
    return 2 * pairs_per_positive(traffic) * n_triples


def k1_bytes(t: int, d: int, u: int) -> int:
    return 8 * t + 4 * t * d + 4 * u * d


def train_flops(model, cfg: dict, traffic: dict, n: int) -> float:
    """Model operations of training on `n` positives, forward and
    backward, recomputed work not counted: each positive's score, and for
    each mode its pool sweep (the query and k pairs) or its negatives'
    scores. `model` is the configuration's file under kgebench/models."""
    d, modes = cfg["ncomp"], len(traffic["modes"])
    per = model.triple_flops(d, True)
    if traffic["sampler"] == "shared":
        per += modes * (model.query_flops(d, True) + traffic["k"] * model.pair_flops(d, True))
    else:
        per += modes * traffic["negatives"] * model.triple_flops(d, True)
    return n * per


def serve_flops(model, cfg: dict, n_queries: int) -> float:
    """Forward operations of ranking every entity for `n_queries`."""
    d = cfg["ncomp"]
    return n_queries * (model.query_flops(d, False)
                        + cfg["entities"] * model.pair_flops(d, False))
