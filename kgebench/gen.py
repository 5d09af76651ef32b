"""Inputs of a run, made from `--seed`: the knowledge graph, the query
stream and the weights. Part of the yardstick: later changes to the
program do not touch it.

- `kg`: a synthetic graph at a configuration's published counts. Subject,
  object and relation ids are drawn from truncated Zipf laws (rank r has
  weight r^-a), ranks mapped to ids through a permutation drawn from the
  seed, so every seed has the same degree profile with other ids hot. The
  triples are de-duplicated to exactly the configuration's train count.
  Frozen from `skge_torch.data.synthetic_kg` (uniform ids, de-duplicated
  and topped up the same way), reworked with skew.
- `queries`: (s, p) link-prediction queries from the same laws and the
  same permutations as the graph, so hot queries carry long filter lists.
  Frozen from `skge_torch.serving_bench.query_stream` (uniform ids),
  reworked with skew.
- `weights`: each table uniform in (-b, b), b = sqrt(6 / (rows + cols))
  (scikit-kge's `init_nunif`), drawn on the device by one generator from
  the seed, one call a table.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    words = np.random.SeedSequence([seed % 2**64, tag]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


# tags of the seed's uses
GRAPH, QUERIES, WEIGHTS, DRAWS, SAMPLE = range(5)


class Zipf:
    """Ids 0..n-1 with P(rank r) proportional to r^-a, the ranks assigned
    to ids by `perm`."""

    def __init__(self, n: int, a: float, perm: np.ndarray):
        w = np.arange(1, n + 1, dtype=np.float64) ** -a
        self.cdf = np.cumsum(w) / w.sum()
        self.perm = perm

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        r = np.searchsorted(self.cdf, rng.random(size), side="right")
        return self.perm[np.minimum(r, self.perm.shape[0] - 1)]


def laws(cfg: dict, seed: int):
    """(entity law, relation law) of the configuration for this seed."""
    rng = np.random.default_rng(sub_seed(seed, GRAPH))
    ent = Zipf(cfg["entities"], cfg["entity_zipf"], rng.permutation(cfg["entities"]))
    rel = Zipf(cfg["relations"], cfg["relation_zipf"], rng.permutation(cfg["relations"]))
    return ent, rel


def kg(cfg: dict, seed: int) -> np.ndarray:
    """(train, 3) int64 distinct (s, o, p) triples."""
    ent, rel = laws(cfg, seed)
    n_e, n_r, n = cfg["entities"], cfg["relations"], cfg["train"]
    rng = np.random.default_rng(sub_seed(seed, GRAPH) + 1)
    triples = np.empty((0, 3), np.int64)
    while triples.shape[0] < n:
        m = int(1.25 * (n - triples.shape[0])) + 1024
        more = np.stack([ent.draw(rng, m), ent.draw(rng, m), rel.draw(rng, m)], axis=1)
        triples = np.concatenate([triples, more])
        keys = (triples[:, 0] * n_e + triples[:, 1]) * n_r + triples[:, 2]
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    return triples[:n]


def queries(cfg: dict, seed: int, count: int) -> np.ndarray:
    """(count, 2) int64 (s, p) queries."""
    ent, rel = laws(cfg, seed)
    rng = np.random.default_rng(sub_seed(seed, QUERIES))
    return np.stack([ent.draw(rng, count), rel.draw(rng, count)], axis=1)


def weights(shapes: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: (rows, cols) table} drawn on `device`, in `shapes`' order."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    out = {}
    for name, (rows, cols) in shapes.items():
        b = math.sqrt(6.0) / math.sqrt(rows + cols)
        u = torch.rand((rows, cols), generator=g, device=device, dtype=dtype)
        out[name] = u * (2.0 * b) - b
    return out


def draw_generator(seed: int, device) -> torch.Generator:
    """The generator of the training draws (epoch order, negatives)."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, DRAWS))
