"""Datasets and host-side index building for the PyTorch port.

NumPy copies of the few `skge_tpu.data` helpers the port needs: the
synthetic generator, the key encoding, the samplers' index helpers
(`sorted_train_keys`, `type_index_arrays`, `bernoulli_probs`) and the
filter index. They are copied rather than imported because importing
`skge_tpu.data` imports the JAX package. They give the same arrays as
`skge_tpu.data` for the same arguments and seed.

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


def sorted_train_keys(ds: Dataset) -> np.ndarray:
    """Sorted int64 train-triple keys for LCWA membership tests."""
    return np.sort(encode_keys_np(ds.train, ds.n_entities, ds.n_relations))


def type_index_arrays(triples: np.ndarray, n_relations: int):
    """Per-relation observed subjects/objects as flat CSR-like arrays.

    For each relation p, the sets of entities seen as subject and as
    object. Returns (sub_flat, sub_off, sub_cnt, obj_flat, obj_off,
    obj_cnt), all int32; `flat[off[p] : off[p] + cnt[p]]` are relation p's
    entities.
    """

    def build(col):
        lists = [np.array([], np.int32)] * n_relations
        for p in range(n_relations):
            m = triples[:, 2] == p
            lists[p] = np.unique(triples[m, col]).astype(np.int32)
        cnt = np.array([len(x) for x in lists], np.int32)
        off = np.zeros(n_relations, np.int32)
        if n_relations > 1:
            off[1:] = np.cumsum(cnt)[:-1]
        flat = (
            np.concatenate(lists).astype(np.int32)
            if cnt.sum() > 0
            else np.zeros(1, np.int32)
        )
        return flat, off, cnt

    return (*build(0), *build(1))


def bernoulli_probs(triples: np.ndarray, n_relations: int) -> np.ndarray:
    """Per-relation P(corrupt subject) = tph / (tph + hpt) (TransH)."""
    probs = np.full(n_relations, 0.5, np.float32)
    for p in range(n_relations):
        t = triples[triples[:, 2] == p]
        if t.shape[0] == 0:
            continue
        _, hc = np.unique(t[:, 0], return_counts=True)
        _, tc = np.unique(t[:, 1], return_counts=True)
        tph = hc.mean()  # avg #objects per subject
        hpt = tc.mean()  # avg #subjects per object
        probs[p] = tph / (tph + hpt)
    return probs


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
