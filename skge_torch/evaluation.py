"""Filtered link-prediction ranking of the port (single device).

For each test triple (s, o, p), score ALL entities as object and as
subject; the FILTERED rank masks every known-true triple (train ∪ valid ∪
test by default) except the target. Metrics (MRR, mean rank, Hits@k, raw
and filtered) are pooled over both directions. `ties='mean'` (default)
ranks the target at 1 + #greater + #equal/2; `ties='optimistic'` at
1 + #greater.

The all-entity sweep is the model's `score_all_o/s`. The known triples'
CSR index of both directions is built once per evaluator and put on each
device once; each batch's score tile gives its raw counts, is then masked
in place by `ops/cuda_filter.mask_known` (one `filter_known` launch on the
card, as serving masks its tiles) and gives its filtered counts. The
filter key is the query's own (s, p) or (o, p). `candidate_mask` leaves
entities out of the candidates (the partitioned relabeling's padding
rows). With a `group` (`parallel.distributed.ShardGroup`) the entity
table is row-sharded over its ranks: each rank scores only its own
candidate columns (masked with `base` its first entity) and the greater
and equal counts are summed over the ranks, the ranks of the gathered
table. `mesh` (a `parallel.mesh.Mesh`) does the same over the
mesh's `axis` group ('model' by default). `RankingResult` splits the
metrics by direction, relation and relation category
(`relation_categories`); `ReciprocalEvalWrapper` ranks a model trained on
reciprocal relations through its inverse relations.

Triple classification (Socher et al. 2013 / the TransH protocol):
`classification_negatives` draws one filtered corruption per positive,
`triple_classification` fits per-relation score thresholds on valid and
reports test accuracy. Scores come from the model's `score_triples` on the
params' device; the thresholds are searched on the host, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from skge_torch.data import encode_keys_np
from skge_torch.models.base import KGEModel, Params
from skge_torch.ops.cuda_filter import NEG_INF, known_index, mask_known


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

    def _metrics(self, ranks: np.ndarray, hits_at) -> Dict[str, float]:
        mrr, mr, hits = ranking_scores(ranks, hits_at)
        out = {"mrr": mrr, "mean_rank": mr, "n": int(ranks.size)}
        out.update({f"hits@{k}": v for k, v in hits.items()})
        return out

    def by_direction(self, hits_at=(1, 3, 10)) -> Dict[str, Dict[str, float]]:
        """Filtered metrics of 'object' (tail, ranks[0]) and 'subject'
        (head, ranks[1]) prediction."""
        return {
            "object": self._metrics(self.ranks[0], hits_at),
            "subject": self._metrics(self.ranks[1], hits_at),
        }

    def _test(self) -> np.ndarray:
        if self.test is None:
            raise ValueError("the breakdown needs the test triples "
                             "(RankingResult.test is None)")
        return self.test

    def by_relation(self, hits_at=(1, 3, 10)) -> Dict[int, Dict[str, float]]:
        """Filtered metrics per relation id, both directions pooled."""
        rel = self._test()[:, 2]
        return {int(p): self._metrics(self.ranks[:, rel == p], hits_at)
                for p in np.unique(rel)}

    def by_category(
        self, categories: Dict[int, str], hits_at=(1, 3, 10)
    ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Filtered metrics per relation category (`relation_categories`)
        and direction: {category: {'object': ..., 'subject': ...}}.
        Relations missing from `categories` go to 'uncategorized'."""
        cats = np.array([categories.get(int(p), "uncategorized")
                         for p in self._test()[:, 2]])
        return {
            c: {"object": self._metrics(self.ranks[0, cats == c], hits_at),
                "subject": self._metrics(self.ranks[1, cats == c], hits_at)}
            for c in sorted(set(cats.tolist()))
        }


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


def _rank_of(greater, equal, ties, self_included):
    if ties == "optimistic":
        return (1 + greater).to(torch.float32)
    if self_included:
        equal = equal - 1
    return (1 + greater + torch.clamp(equal, min=0) * 0.5).to(torch.float32)


def _counts(scores, tgt, filtered):
    """(greater, equal) of `scores` against `tgt`, raw, then with the known
    answers masked in place by `filtered(scores)`: a (4, B) int64 stack."""
    raw = [torch.sum(scores > tgt[:, None], dim=1), torch.sum(scores == tgt[:, None], dim=1)]
    scores = filtered(scores)
    return torch.stack(raw + [torch.sum(scores > tgt[:, None], dim=1),
                              torch.sum(scores == tgt[:, None], dim=1)])


def _ranks(scores, target, filtered, ties):
    """(raw, filtered) float32 ranks of `target` in each row of `scores`."""
    tgt = scores[torch.arange(scores.shape[0], device=scores.device), target]
    g, e, gf, ef = _counts(scores, tgt, filtered)
    return _rank_of(g, e, ties, True), _rank_of(gf, ef, ties, False)


class FilteredRankingEval:
    """Builds the filter index once; evaluates any params snapshot on the
    device the params live on.

    `candidate_mask` ((n_e,) bool): the entities that may compete (targets
    are always among them). `group`: the entity table is row-sharded over
    the group's ranks (rank r holds rows [r*S, (r+1)*S) in `params`), and
    every rank calls the evaluator with the same test set. `mesh` with
    `axis`: the group of that mesh axis, the JAX package's `mesh=`/`axis=`
    (params are the rank's part, as `Trainer(mesh=)` holds them, or whole
    tables, of which each rank scores its own rows).
    """

    def __init__(
        self,
        model: KGEModel,
        test: np.ndarray,
        known: np.ndarray,
        batch_size: int = 1024,
        hits_at: Sequence[int] = (1, 3, 10),
        ties: str = "mean",
        group=None,
        candidate_mask: Optional[np.ndarray] = None,
        mesh=None,
        axis: str = "model",
    ):
        if ties not in ("mean", "optimistic"):
            raise ValueError(f"ties must be 'mean' or 'optimistic', got {ties!r}")
        if mesh is not None:
            if group is not None:
                raise ValueError("pass a group or a mesh, not both")
            group = mesh.group(axis)
        self.model = model
        self.ties = ties
        self.group = group
        self.candidate_mask = (None if candidate_mask is None
                               else np.asarray(candidate_mask, bool))
        self.hits_at = tuple(hits_at)
        self.batch_size = int(min(batch_size, max(1, len(test))))
        self.test = np.asarray(test, np.int32)
        known = np.asarray(known, np.int64).reshape(-1, 3)
        # any count above every known relation id keys the index: a query
        # whose relation lies past it has no known answers
        self._n_relations = int(known[:, 2].max(initial=0)) + 1
        self._known = {torch.device("cpu"): known_index(known, self._n_relations, "cpu")}

        # batch layout: pad the last batch by repeating row 0 (masked out)
        n = len(self.test)
        bs = self.batch_size
        self.n_batches = -(-n // bs)
        padded = self.n_batches * bs
        idx = np.concatenate([np.arange(n), np.zeros(padded - n, np.int64)])
        self._batches = self.test[idx].reshape(self.n_batches, bs, 3)
        self._valid = (np.arange(padded) < n).reshape(self.n_batches, bs)

    def _index_on(self, device):
        """The filter index on `device`, put there on its first call."""
        index = self._known.get(device)
        if index is None:
            host = self._known[torch.device("cpu")]
            index = self._known[device] = {d: tuple(t.to(device) for t in host[d])
                                           for d in host}
        return index

    def _sharded_scorer(self, params: Params):
        """(direction, batch) -> (this rank's (B, S) scores, the target
        ids), each query's rows fetched from their owners. A reciprocal
        model asks head queries (o, p) as tail queries of the inverse
        relation."""
        group = self.group
        model, inv = self.model, None
        if isinstance(model, ReciprocalEvalWrapper):
            model = model.model
            half = model.n_relations // 2
            inv = lambda p: torch.where(p < half, p + half, p - half)  # noqa: E731
        elif getattr(model, "reciprocal", False):
            inv = model._inv
        slots = model.slot_spec()
        epname = next(pn for _, pn, r in slots if r == "s")
        from skge_torch.parallel.mesh import row_block

        table = row_block(params[epname], model.n_entities, group)  # or a whole table
        s_rows = table.shape[0]
        lo = group.rank * s_rows
        dense = model.dense_params(params)

        def score(d, batch):
            s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
            if d == "o":
                idx, mode, target = {"s": s, "o": o, "p": p}, 1, o
            elif inv is not None:
                idx, mode, target = {"s": o, "o": s, "p": inv(p)}, 1, s
            else:
                idx, mode, target = {"s": s, "o": o, "p": p}, 0, s
            need = {"p", "s" if mode == 1 else "o"}
            rows = {slot: (group.gather_rows(idx[role], s_rows, table.__getitem__)
                           if pn == epname else params[pn][idx[role]])
                    for slot, pn, role in slots if role in need}
            return model.score_pool(rows, table, dense, mode), target

        return score, lo, s_rows

    def _sharded_ranks(self, score, d, batch, lo, s_rows, cmask, filtered):
        """Ranks from this rank's candidate columns: the target's score from
        its owner, then the greater and equal counts summed over ranks."""
        scores, target = score(d, batch)
        if cmask is not None:
            scores = torch.where(cmask[None, :], scores, NEG_INF)
        b = scores.shape[0]
        local = target - lo
        own = (local >= 0) & (local < s_rows)
        tgt = self.group.all_reduce(torch.where(
            own, scores[torch.arange(b, device=scores.device),
                        torch.clamp(local, 0, s_rows - 1)], 0))
        g, e, gf, ef = self.group.all_reduce(_counts(scores, tgt, filtered))
        return _rank_of(g, e, self.ties, True), _rank_of(gf, ef, self.ties, False)

    @torch.no_grad()
    def __call__(self, params: Params) -> RankingResult:
        device = next(iter(params.values())).device
        n = len(self.test)
        ranks = {d: np.zeros(n, np.float64) for d in ("o", "s")}
        ranks_raw = {d: np.zeros(n, np.float64) for d in ("o", "s")}
        cmask = (None if self.candidate_mask is None
                 else torch.as_tensor(self.candidate_mask, device=device))
        if self.group is not None:
            score, lo, s_rows = self._sharded_scorer(params)
            if cmask is not None:
                cmask = cmask[lo:lo + s_rows]
        else:
            lo = 0
        index = self._index_on(device)
        pos = 0
        for b in range(self.n_batches):
            batch = torch.as_tensor(self._batches[b], dtype=torch.int64, device=device)
            s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
            nvalid = int(self._valid[b].sum())
            for d in ("o", "s"):
                filtered = partial(mask_known, ent=s if d == "o" else o, rel=p,
                                   index=index[d], base=lo, n_relations=self._n_relations)
                if self.group is None:
                    if d == "o":
                        scores, target = self.model.score_all_o(params, s, p), o
                    else:
                        scores, target = self.model.score_all_s(params, o, p), s
                    if cmask is not None:
                        scores = torch.where(cmask[None, :], scores, NEG_INF)
                    raw, filt = _ranks(scores, target, filtered, self.ties)
                else:
                    raw, filt = self._sharded_ranks(score, d, batch, lo, s_rows, cmask,
                                                    filtered)
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


def evaluate(
    model: KGEModel,
    params: Params,
    test: np.ndarray,
    known: Optional[np.ndarray] = None,
    batch_size: int = 1024,
    hits_at: Sequence[int] = (1, 3, 10),
) -> RankingResult:
    """One-shot `FilteredRankingEval`; `known` defaults to `test`."""
    if known is None:
        known = test
    return FilteredRankingEval(model, test, known, batch_size, hits_at)(params)


@dataclass(frozen=True)
class ReciprocalEvalWrapper:
    """Rank a model trained on `data.add_reciprocal_relations` with
    object-direction CE: head queries (o, p) are asked as tail queries of
    the inverse relation. The wrapped model's `n_relations` is the doubled
    count."""

    model: KGEModel

    def __post_init__(self):
        if self.model.n_relations % 2 != 0:
            raise ValueError("reciprocal eval expects the DOUBLED relation count "
                             "(data.add_reciprocal_relations)")

    def score_all_o(self, params: Params, s, p):
        return self.model.score_all_o(params, s, p)

    def score_all_s(self, params: Params, o, p):
        half = self.model.n_relations // 2
        return self.model.score_all_o(params, o, torch.where(p < half, p + half, p - half))


def relation_categories(triples: np.ndarray, threshold: float = 1.5) -> Dict[int, str]:
    """TransE-paper relation typing (Bordes et al. 2013): a side is 'N'
    when its mean multiplicity exceeds `threshold` (hpt = heads per tail,
    tph = tails per head). Returns {relation: '1-1' | '1-N' | 'N-1' |
    'N-N'}; compute over train triples."""
    t = np.asarray(triples)
    out: Dict[int, str] = {}
    for p in np.unique(t[:, 2]):
        tp = t[t[:, 2] == p]
        tph = len(tp) / max(1, len(np.unique(tp[:, 0])))
        hpt = len(tp) / max(1, len(np.unique(tp[:, 1])))
        out[int(p)] = f"{'N' if hpt > threshold else '1'}-{'N' if tph > threshold else '1'}"
    return out


def classification_negatives(
    triples: np.ndarray, n_entities: int, known: np.ndarray, seed: int = 0,
    ntries: int = 100, n_relations: Optional[int] = None,
) -> np.ndarray:
    """One corrupted triple per positive (subject and object corrupted in
    turn), redrawn against `known` so that no negative is a true triple.
    Raises ValueError when `ntries` rounds leave a collision."""
    if n_relations is None:
        n_relations = int(max(np.max(triples[:, 2]), np.max(known[:, 2]))) + 1
    rng = np.random.default_rng(seed)
    known_keys = np.sort(
        encode_keys_np(np.asarray(known, np.int64), n_entities, n_relations))
    neg = np.asarray(triples, np.int32).copy()
    modes = np.arange(len(neg)) % 2
    pending = np.arange(len(neg))
    for _ in range(ntries):
        if len(pending) == 0:
            break
        repl = rng.integers(0, n_entities, len(pending)).astype(np.int32)
        neg[pending, modes[pending]] = repl
        keys = encode_keys_np(neg[pending].astype(np.int64), n_entities, n_relations)
        pos = np.searchsorted(known_keys, keys)
        hit = ((pos < len(known_keys))
               & (known_keys[np.minimum(pos, len(known_keys) - 1)] == keys))
        pending = pending[hit]
    if len(pending):
        # a known-true triple among the negatives would inflate accuracy
        raise ValueError(
            f"{len(pending)} triples still collide with known-true triples "
            f"after {ntries} rejection rounds; raise ntries or drop the "
            "offending (near-universal) relations"
        )
    return neg


def _best_threshold(scores: np.ndarray, labels: np.ndarray) -> float:
    """Threshold tau maximizing the accuracy of (score >= tau -> positive),
    at midpoints between DISTINCT adjacent sorted scores or at the two open
    ends; a cut between two equal scores cannot be realized and is left
    out."""
    order = np.argsort(scores)
    s, y = scores[order], labels[order]
    # cut i predicts items [i:] positive: correct = #neg in [:i] + #pos in [i:]
    neg_below = np.concatenate([[0], np.cumsum(y <= 0)])
    pos_at_or_above = np.concatenate([np.cumsum((y > 0)[::-1])[::-1], [0]])
    correct = neg_below + pos_at_or_above
    realizable = np.concatenate([[True], s[1:] > s[:-1], [True]])
    correct = np.where(realizable, correct, -1)
    i = int(np.argmax(correct))
    if i == 0:
        return -np.inf
    if i == len(s):
        return np.inf
    return float((s[i - 1] + s[i]) / 2.0)


@torch.no_grad()
def triple_classification(
    model: KGEModel,
    params: Params,
    valid_pos: np.ndarray,
    valid_neg: np.ndarray,
    test_pos: np.ndarray,
    test_neg: np.ndarray,
    batch_size: int = 8192,
) -> Dict[str, Any]:
    """Per-relation score thresholds fit on valid, accuracy on test.
    Relations absent from valid take the global threshold. Scores are
    `model.score_triples` in batches of `batch_size` on the params'
    device; the threshold search is exact, on the host.

    Returns {'accuracy', 'thresholds' {p: tau}, 'global_threshold',
    'per_relation' {p: accuracy}}.
    """
    device = next(iter(params.values())).device

    def score(tr: np.ndarray) -> np.ndarray:
        out = np.empty(len(tr), np.float64)
        for i in range(0, len(tr), batch_size):
            chunk = torch.as_tensor(np.asarray(tr[i:i + batch_size]),
                                    dtype=torch.int64, device=device)
            out[i:i + len(chunk)] = model.score_triples(params, chunk).cpu().numpy()
        return out

    v_tr = np.concatenate([valid_pos, valid_neg])
    v_y = np.concatenate([np.ones(len(valid_pos)), -np.ones(len(valid_neg))])
    v_s = score(v_tr)
    global_tau = _best_threshold(v_s, v_y)
    thresholds: Dict[int, float] = {}
    for p in np.unique(v_tr[:, 2]):
        sel = v_tr[:, 2] == p
        thresholds[int(p)] = _best_threshold(v_s[sel], v_y[sel])

    t_tr = np.concatenate([test_pos, test_neg])
    t_y = np.concatenate([np.ones(len(test_pos)), -np.ones(len(test_neg))])
    t_s = score(t_tr)
    taus = np.array([thresholds.get(int(p), global_tau) for p in t_tr[:, 2]])
    pred = np.where(t_s >= taus, 1.0, -1.0)
    per_rel = {}
    for p in np.unique(t_tr[:, 2]):
        sel = t_tr[:, 2] == p
        per_rel[int(p)] = float(np.mean(pred[sel] == t_y[sel]))
    return {
        "accuracy": float(np.mean(pred == t_y)),
        "thresholds": thresholds,
        "global_threshold": global_tau,
        "per_relation": per_rel,
    }
