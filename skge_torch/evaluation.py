"""Filtered link-prediction ranking of the port (single device).

For each test triple (s, o, p), score ALL entities as object and as
subject; the FILTERED rank masks every known-true triple (train ∪ valid ∪
test by default) except the target. Metrics (MRR, mean rank, Hits@k, raw
and filtered) are pooled over both directions. `ties='mean'` (default)
ranks the target at 1 + #greater + #equal/2; `ties='optimistic'` at
1 + #greater.

The all-entity sweep is the model's `score_all_o/s`. The host builds, once
per eval set, a flat (row, entity) list of known-true pairs per test batch,
and the device writes -inf at those pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from skge_torch.data import true_triple_index
from skge_torch.models.base import KGEModel, Params

NEG_INF = -1e30


@dataclass
class RankingResult:
    """Pooled metrics over both directions (subject + object prediction)."""

    mrr: float
    mrr_raw: float
    mean_rank: float
    mean_rank_raw: float
    hits: Dict[int, float]
    hits_raw: Dict[int, float]
    ranks: np.ndarray       # (2, n_test) filtered ranks [object-dir, subject-dir]
    ranks_raw: np.ndarray
    test: Optional[np.ndarray] = None  # (n_test, 3) triples the ranks belong to

    def summary(self) -> Dict[str, float]:
        out = {
            "mrr": self.mrr,
            "mrr_raw": self.mrr_raw,
            "mean_rank": self.mean_rank,
            "mean_rank_raw": self.mean_rank_raw,
        }
        for k, v in self.hits.items():
            out[f"hits@{k}"] = v
        for k, v in self.hits_raw.items():
            out[f"hits@{k}_raw"] = v
        return out


def ranking_scores(
    ranks: np.ndarray, hits_at: Sequence[int] = (1, 3, 10)
) -> Tuple[float, float, Dict[int, float]]:
    """(MRR, mean rank, {k: Hits@k}) from a flat rank array."""
    r = ranks.astype(np.float64).ravel()
    return (
        float(np.mean(1.0 / r)),
        float(np.mean(r)),
        {k: float(np.mean(r <= k)) for k in hits_at},
    )


def _filter_pairs(batch: np.ndarray, index: dict, direction: str):
    """Flat (row, entity) known-true pairs for one batch, padded to the
    next power of two of the batch's own pair count. Padding rows use
    row id = batch size and are dropped before the write."""
    rows, ents = [], []
    for i, (s, o, p) in enumerate(batch):
        key = (int(s), int(p)) if direction == "o" else (int(o), int(p))
        true_ents = index.get(key)
        if true_ents is not None:
            rows.extend([i] * len(true_ents))
            ents.extend(true_ents.tolist())
    width = 1 if len(rows) <= 1 else 1 << (len(rows) - 1).bit_length()
    pad = width - len(rows)
    rows.extend([batch.shape[0]] * pad)
    ents.extend([0] * pad)
    return (
        np.asarray(rows, np.int32),
        np.asarray(ents, np.int32),
    )


def _ranks(scores, target, frows, fents, ties):
    """(raw, filtered) float32 ranks of `target` in each row of `scores`."""
    b = scores.shape[0]
    tgt = scores[torch.arange(b, device=scores.device), target]

    def rank_of(sc, self_included):
        greater = torch.sum(sc > tgt[:, None], dim=1)
        if ties == "optimistic":
            return (1 + greater).to(torch.float32)
        equal = torch.sum(sc == tgt[:, None], dim=1)
        if self_included:
            equal = equal - 1
        return (1 + greater + torch.clamp(equal, min=0) * 0.5).to(torch.float32)

    raw = rank_of(scores, True)
    keep = frows < b
    filt_scores = scores.clone()
    filt_scores[frows[keep], fents[keep]] = NEG_INF
    return raw, rank_of(filt_scores, False)


class FilteredRankingEval:
    """Precomputes filter indices once; evaluates any params snapshot on
    the device the params live on."""

    def __init__(
        self,
        model: KGEModel,
        test: np.ndarray,
        known: np.ndarray,
        batch_size: int = 1024,
        hits_at: Sequence[int] = (1, 3, 10),
        ties: str = "mean",
    ):
        if ties not in ("mean", "optimistic"):
            raise ValueError(f"ties must be 'mean' or 'optimistic', got {ties!r}")
        self.model = model
        self.ties = ties
        self.hits_at = tuple(hits_at)
        self.batch_size = int(min(batch_size, max(1, len(test))))
        self.test = np.asarray(test, np.int32)
        sp_o, op_s = true_triple_index(np.asarray(known))
        self._index = {"o": sp_o, "s": op_s}

        # batch layout: pad the last batch by repeating row 0 (masked out)
        n = len(self.test)
        bs = self.batch_size
        self.n_batches = -(-n // bs)
        padded = self.n_batches * bs
        idx = np.concatenate([np.arange(n), np.zeros(padded - n, np.int64)])
        self._batches = self.test[idx].reshape(self.n_batches, bs, 3)
        self._valid = (np.arange(padded) < n).reshape(self.n_batches, bs)
        self._pairs = {
            direction: [
                _filter_pairs(self._batches[b], self._index[direction], direction)
                for b in range(self.n_batches)
            ]
            for direction in ("o", "s")
        }

    @torch.no_grad()
    def __call__(self, params: Params) -> RankingResult:
        device = next(iter(params.values())).device
        n = len(self.test)
        ranks = {d: np.zeros(n, np.float64) for d in ("o", "s")}
        ranks_raw = {d: np.zeros(n, np.float64) for d in ("o", "s")}
        pos = 0
        for b in range(self.n_batches):
            batch = torch.as_tensor(self._batches[b], dtype=torch.int64, device=device)
            s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
            nvalid = int(self._valid[b].sum())
            for d in ("o", "s"):
                if d == "o":
                    scores, target = self.model.score_all_o(params, s, p), o
                else:
                    scores, target = self.model.score_all_s(params, o, p), s
                frows, fents = (
                    torch.as_tensor(a, dtype=torch.int64, device=device)
                    for a in self._pairs[d][b]
                )
                raw, filt = _ranks(scores, target, frows, fents, self.ties)
                ranks_raw[d][pos : pos + nvalid] = raw.cpu().numpy()[:nvalid]
                ranks[d][pos : pos + nvalid] = filt.cpu().numpy()[:nvalid]
            pos += nvalid
        all_filt = np.stack([ranks["o"], ranks["s"]])
        all_raw = np.stack([ranks_raw["o"], ranks_raw["s"]])
        mrr, mr, hits = ranking_scores(all_filt, self.hits_at)
        mrr_r, mr_r, hits_r = ranking_scores(all_raw, self.hits_at)
        return RankingResult(
            mrr=mrr,
            mrr_raw=mrr_r,
            mean_rank=mr,
            mean_rank_raw=mr_r,
            hits=hits,
            hits_raw=hits_r,
            ranks=all_filt,
            ranks_raw=all_raw,
            test=self.test,
        )
