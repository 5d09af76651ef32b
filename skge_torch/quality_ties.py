"""A quality-suite row ranked again under the optimistic tie rule.

The JAX package's filtered ranking counted rank = 1 + #(strictly greater
scores) until mean tie-breaking became its default; a RESULTS.md row
written before then reads higher wherever the model's scores tie with
the target's. This runs `skge_torch.quality_suite` with the same flags
(its rows, JSON lines and `--out` lines unchanged), then ranks each row's
checkpoint again with `ties="optimistic"` and counts, over the test
triples' object queries, the candidates whose score equals the target's.
One JSON line a row:

    python -m skge_torch.quality_ties --k 8192 --models ER-MLP --epochs 400
"""

from __future__ import annotations

import json
from typing import List

import numpy as np
import torch

from skge_torch import quality_suite
from skge_torch.evaluation import FilteredRankingEval


class TieSuite(quality_suite.Suite):
    """The suite, keeping the (eval model, params) its last row was ranked
    with on the test split."""

    ranked = None

    def get_eval(self, eval_model, which):
        ev = super().get_eval(eval_model, which)
        if which != "test":
            return ev

        def rank(params):
            self.ranked = (eval_model, params)
            return ev(params)
        return rank


@torch.no_grad()
def tied_with_target(model, params, test: np.ndarray, batch: int = 1024) -> np.ndarray:
    """For each test triple's object query, the number of other candidates
    whose score equals the target's exactly."""
    device = next(iter(params.values())).device
    out = []
    for lo in range(0, len(test), batch):
        q = torch.as_tensor(test[lo:lo + batch], dtype=torch.int64, device=device)
        scores = model.score_all_o(params, q[:, 0], q[:, 2])
        target = scores[torch.arange(len(q), device=device), q[:, 1]]
        out.append(((scores == target[:, None]).sum(1) - 1).cpu().numpy())
    return np.concatenate(out)


def main(argv=None) -> List[dict]:
    args = quality_suite.parse_args(argv)
    device = quality_suite.run_device(args)
    ds = quality_suite.load_kg(args, device)
    suite = TieSuite(args, ds, device)
    lines = []
    for config in quality_suite.configs(args, ds.n_entities, ds.n_relations):
        row = suite.run(*config)
        model, params = suite.ranked
        r = FilteredRankingEval(model, ds.test, suite.all_triples, batch_size=1024,
                                ties="optimistic")(params)
        tied = tied_with_target(model, params, ds.test)
        line = {
            "model": row["model"], "ties": "optimistic",
            "mrr": round(float(r.mrr), 4), "hits1": round(float(r.hits[1]), 3),
            "hits10": round(float(r.hits[10]), 3), "mr": round(float(r.mean_rank), 1),
            "queries_with_ties": round(float(np.mean(tied > 0)), 4),
            "tied_mean": round(float(tied.mean()), 1), "tied_max": int(tied.max()),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
