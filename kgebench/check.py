"""The numbers that decide `correct`: what the timed path produced against
the plain reference (`reference.py`). Part of the yardstick.

Training, over the first three steps of the run's first epoch, each
number taken by the worst of the tables ("leaves", E and R):

- `loss_gap`: |loss - reference loss| / |reference loss|, the worst step;
- `grad_gap`: the gap between the norm of the first step's gradient, as
  AdaGrad got it (sqrt of its accumulator after one step from zero), and
  the reference's, over the larger of the reference's norm of that leaf
  and of the median leaf;
- `grad_max_gap`: the largest elementwise gap of that gradient's
  magnitude, over the leaf's largest reference magnitude;
- `change_gap`: as `grad_gap`, for the norm of the tables' change after
  the three steps. Leaves whose reference gradient norm is under a
  thousandth of the median leaf's are left out of it: their change is
  round-off.

Serving, over a sample of the window's answered queries:

- `rank_gap`: the widest gap by which the reference score of a returned
  entity lies below the reference's own score at that rank;
- `score_gap`: the widest gap between a returned score and the
  reference's score of that entity;
- `filtered`: returned entities that are known triples (limit 0);
- `invalid`: ids out of range or repeated in a row, scores not
  descending, or equal scores whose ids do not ascend (the lower-id tie
  rule) (limit 0);
- `missing`: sampled queries without k answers (limit 0);
- `ties`: adjacent returned entities with equal scores, which the
  lower-id rule orders (a count, not compared).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch


def _norms(tables: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in tables.items()}


def _gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def train_numbers(prog: dict, ref: dict, p0: dict) -> dict:
    """`prog` and `ref`: {"loss": [...], "p2_1": {leaf: p2}, "params":
    {leaf: table after the steps}}; `p0` the tables before them."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    g_prog = {k: torch.sqrt(v.to(torch.float64)) for k, v in prog["p2_1"].items()}
    g_ref = {k: torch.sqrt(v.to(torch.float64)) for k, v in ref["p2_1"].items()}
    gn_prog, gn_ref = _norms(g_prog), _norms(g_ref)
    med = statistics.median(gn_ref.values())
    moved = [k for k in gn_ref if gn_ref[k] >= 1e-3 * med]

    def change(tables):
        return _norms({k: tables[k].to(torch.float64) - p0[k].to(torch.float64)
                       for k in tables})

    return {
        "loss_gap": max(losses) if len(losses) == len(ref["loss"]) else float("inf"),
        "grad_gap": _gap(gn_prog, gn_ref, gn_ref),
        "grad_max_gap": max(float(torch.max(torch.abs(g_prog[k] - g_ref[k])))
                            / max(float(torch.max(g_ref[k])), 1e-300) for k in g_ref),
        "change_gap": _gap(change(prog["params"]), change(ref["params"]), moved),
    }


def serve_numbers(ids: np.ndarray, scores: np.ndarray, ref_top: torch.Tensor,
                  ref_scores: torch.Tensor, n_e: int, k: int) -> dict:
    """`ids`, `scores`: (Q, k) answers of the sampled queries (-1 where
    none); `ref_top`: (Q, k) the reference's k best filtered scores;
    `ref_scores`: (Q, n_e) its filtered scores (known answers -inf)."""
    dev = ref_scores.device
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    sc = torch.as_tensor(scores, dtype=torch.float64, device=dev)
    in_range = (ids_t >= 0) & (ids_t < n_e)
    got = torch.gather(ref_scores, 1, torch.where(in_range, ids_t, 0)).to(torch.float64)
    known = in_range & torch.isinf(got)
    ok = in_range & ~known
    srt = torch.sort(torch.where(in_range, ids_t, -1 - torch.arange(k, device=dev)), dim=1).values
    repeated = torch.sum(srt[:, 1:] == srt[:, :-1], dim=1)
    desc = sc[:, 1:] <= sc[:, :-1]
    ties_ascend = (sc[:, 1:] != sc[:, :-1]) | (ids_t[:, 1:] > ids_t[:, :-1])
    bad_rows = repeated + torch.sum(~desc | ~ties_ascend, dim=1)
    finite_top = torch.isfinite(ref_top)
    missing = torch.sum((ids_t < 0) & finite_top, dim=1) > 0
    ref_top = ref_top.to(torch.float64)
    rank = torch.where(ok & finite_top, ref_top - got, torch.zeros_like(got))
    score = torch.where(ok, torch.abs(sc - got), torch.zeros_like(got))
    return {
        "rank_gap": float(torch.max(rank)),
        "score_gap": float(torch.max(score)),
        "filtered": int(torch.sum(known)),
        "invalid": int(torch.sum(bad_rows) + torch.sum((ids_t >= n_e) | (ids_t < -1))),
        "missing": int(torch.sum(missing)),
        "ties": int(torch.sum((sc[:, 1:] == sc[:, :-1]) & ok[:, 1:] & ok[:, :-1])),
    }


def judge(numbers: dict, limits: dict) -> bool:
    """Every limited number within its limit (a missing or NaN one is not)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
