"""Datasets and host-side index building for the PyTorch port.

NumPy copies of the few `skge_tpu.data` helpers the port needs. They are
copied rather than imported because importing `skge_tpu.data` imports the
JAX package. The generators give the same triples as `skge_tpu.data` for the
same arguments and seed.

All triples are (N, 3) int32 arrays in (s, o, p) column order; the training
code moves them to the device as int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class Dataset:
    train: np.ndarray  # (N, 3) int32 (s, o, p)
    valid: np.ndarray
    test: np.ndarray
    n_entities: int
    n_relations: int

    def all_triples(self) -> np.ndarray:
        return np.concatenate([self.train, self.valid, self.test])


def synthetic_kg(
    n_entities: int,
    n_relations: int,
    n_train: int,
    n_valid: int = 0,
    n_test: int = 0,
    seed: int = 0,
    clustered: bool = True,
) -> Dataset:
    """Deterministic synthetic KG with mild relational structure.

    `clustered=True` gives each relation preferred subject/object entity
    blocks; otherwise subjects, objects and relations are uniform. Triples
    are de-duplicated across the whole set, so train/valid/test are
    disjoint.
    """
    rng = np.random.default_rng(seed)
    total = n_train + n_valid + n_test

    if clustered and n_relations > 1:
        p = rng.integers(0, n_relations, total)
        block = max(2, n_entities // n_relations)
        s_lo = (p * 7919) % max(1, n_entities - block)
        o_lo = (p * 104729) % max(1, n_entities - block)
        s = s_lo + rng.integers(0, block, total)
        o = o_lo + rng.integers(0, block, total)
    else:
        p = rng.integers(0, n_relations, total)
        s = rng.integers(0, n_entities, total)
        o = rng.integers(0, n_entities, total)

    triples = np.stack([s, o, p], axis=1).astype(np.int32)
    keys = encode_keys_np(triples, n_entities, n_relations)
    _, first = np.unique(keys, return_index=True)
    triples = triples[np.sort(first)]
    while triples.shape[0] < total:  # top up after dedup
        extra = np.stack(
            [
                rng.integers(0, n_entities, total),
                rng.integers(0, n_entities, total),
                rng.integers(0, n_relations, total),
            ],
            axis=1,
        ).astype(np.int32)
        triples = np.concatenate([triples, extra])
        keys = encode_keys_np(triples, n_entities, n_relations)
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    triples = triples[:total]
    return Dataset(
        train=triples[:n_train],
        valid=triples[n_train : n_train + n_valid],
        test=triples[n_train + n_valid :],
        n_entities=n_entities,
        n_relations=n_relations,
    )


def encode_keys_np(triples: np.ndarray, n_entities: int, n_relations: int):
    t = triples.astype(np.int64)
    return (t[..., 0] * n_entities + t[..., 1]) * n_relations + t[..., 2]


def true_triple_index(triples: np.ndarray):
    """Known-true lookup for filtered evaluation.

    Returns dicts: (s, p) -> sorted int32 array of true objects, and
    (o, p) -> sorted int32 array of true subjects.
    """
    sp_o: Dict[Tuple[int, int], list] = {}
    op_s: Dict[Tuple[int, int], list] = {}
    for s, o, p in triples:
        sp_o.setdefault((int(s), int(p)), []).append(int(o))
        op_s.setdefault((int(o), int(p)), []).append(int(s))
    return (
        {k: np.unique(v).astype(np.int32) for k, v in sp_o.items()},
        {k: np.unique(v).astype(np.int32) for k, v in op_s.items()},
    )
