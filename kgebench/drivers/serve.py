"""Serving cells: `skge_torch.serving.LinkPredictor.top_k`, one batch of
queries at a time, host to host (query ids in, entity ids and scores
out), the filter lookup included.

Set-up makes the graph (the filter's known triples) and the weights from
the seed, copies `tie_rows` entity rows over others so that some
candidates tie exactly, builds the predictor and runs `warmup_batches`
batches. The window offers a backlog: each batch starts when the last
one has returned, and the window closes at the first batch end at or
after `seconds`. Every answer is kept for the check.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from kgebench import check, counts, gen, profiling, reference
from skge_torch.models import MODELS
from skge_torch.serving import LinkPredictor


class Session:
    def __init__(self, spec, seed: int, device: torch.device):
        cfg, traffic = spec.config, spec.traffic
        self.spec, self.seed, self.device = spec, seed, device
        t0 = time.perf_counter()
        self.known = gen.kg(cfg, seed)
        params = gen.weights(spec.model.tables(cfg), seed, device)
        rng = np.random.default_rng(gen.sub_seed(seed, gen.WEIGHTS))
        pick = rng.choice(cfg["entities"], 2 * traffic["tie_rows"], replace=False)
        src, dst = (torch.as_tensor(a, device=device) for a in np.split(pick, 2))
        params["E"][dst] = params["E"][src]
        self.params = params
        model = MODELS[cfg["model"]](cfg["entities"], cfg["relations"], cfg["ncomp"],
                                     **cfg.get("model_args", {}))
        self.pred = LinkPredictor(model, params, known=self.known,
                                  batch_size=traffic["batch"], device=device)
        self.batch = traffic["batch"]
        self.queries = gen.queries(cfg, seed, self.batch * traffic["distinct_batches"])
        self.nbatches = traffic["distinct_batches"]
        t1 = time.perf_counter()
        for i in range(traffic["warmup_batches"]):
            self._top_k(i)
        self.phases = {"inputs and predictor": t1 - t0, "warm-up": time.perf_counter() - t1}

    def _top_k(self, i: int):
        b = i % self.nbatches
        t = self.spec.traffic
        return self.pred.top_k(self.queries[b * self.batch:(b + 1) * self.batch],
                               t["top_k"], direction=t["direction"])

    def window(self, seconds: float) -> dict:
        lat, self.answers = [], []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            res = self._top_k(len(lat))
            lat.append(time.perf_counter() - t)
            self.answers.append(res)
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        self.latency_ms = [1e3 * x for x in lat]
        return {
            "metrics": {"queries_per_s": self.batch * len(lat) / dt},
            "attempted": self.batch * len(lat),
            "failed": int(sum(np.sum(r.entities[:, 0] < 0) for r in self.answers)),
        }

    def window_figures(self) -> dict:
        """The window's per-batch latency tail: the 95th of 100 quantiles."""
        return {"query_p95_ms": statistics.quantiles(self.latency_ms, n=100)[94]}

    def traced(self) -> profiling.Span:
        n = self.spec.traffic["traced_batches"]
        with profiling.traced(self.device, "serve", "kgebench.serve_batches") as span:
            for i in range(n):
                self._top_k(i)
        span.model_flops = counts.serve_flops(self.spec.model, self.spec.config,
                                              n * self.batch)
        return span

    def release(self) -> None:
        self.pred = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(queries, ids, scores) of `sample_queries` answered queries drawn
        from the seed."""
        n = self.batch * len(self.answers)
        rng = np.random.default_rng(gen.sub_seed(self.seed, gen.SAMPLE))
        pick = np.sort(rng.choice(n, min(n, self.spec.traffic["sample_queries"]),
                                  replace=False))
        b, row = pick // self.batch, pick % self.batch
        ids = np.stack([self.answers[i].entities[r] for i, r in zip(b, row)])
        scores = np.stack([self.answers[i].scores[r] for i, r in zip(b, row)])
        q = self.queries[(b % self.nbatches) * self.batch + row]
        return q, ids, scores

    def reference_top(self, queries: np.ndarray, prec: str):
        """The reference's filtered scores of `queries` and its k best."""
        cfg, t = self.spec.config, self.spec.traffic
        index = reference.known_index(self.known, cfg["relations"], t["direction"])
        full = torch.cat([s for _, s in reference.rank_scores(
            self.spec.model, self.params, queries, index, t["direction"],
            reference.PRECISIONS[prec])])
        top = torch.topk(full, t["top_k"], dim=1)
        return full, top

    def check(self, prec: str = "fp64") -> dict:
        q, ids, scores = self.sample()
        full, top = self.reference_top(q, prec)
        return check.serve_numbers(ids, scores, top.values, full,
                                   self.spec.config["entities"], self.spec.traffic["top_k"])
