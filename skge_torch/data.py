"""Datasets and host-side index building for the PyTorch port.

NumPy copies of the `skge_tpu.data` helpers the port needs: the
reference-format pickle (`load_dataset`, `save_dataset`), raw triple files
(`load_tsv`, through the native loader of `native/` or in Python), the
synthetic generator, the key encoding, the samplers' index helpers
(`sorted_train_keys`, `type_index_arrays`, `bernoulli_probs`,
`unigram_logits`), reciprocal relations and the filter index. They are
copied rather than imported because importing `skge_tpu.data` imports the
JAX package. They give the same arrays as `skge_tpu.data` for the same
arguments and seed.

All triples are (N, 3) int32 arrays in (s, o, p) column order; the training
code moves them to the device as int64.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Dataset:
    train: np.ndarray  # (N, 3) int32 (s, o, p)
    valid: np.ndarray
    test: np.ndarray
    n_entities: int
    n_relations: int
    entities: Optional[List[str]] = None
    relations: Optional[List[str]] = None

    def all_triples(self) -> np.ndarray:
        return np.concatenate([self.train, self.valid, self.test])


def _to_array(subs: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    a = np.asarray(list(subs), dtype=np.int32)
    if a.size == 0:
        return np.zeros((0, 3), np.int32)
    return a.reshape(-1, 3)


def load_dataset(path: str) -> Dataset:
    """Load a reference-format pickle: `train_subs`/`valid_subs`/`test_subs`
    lists of (s, o, p) tuples and `entities`/`relations` name lists."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    entities = list(data["entities"])
    relations = list(data["relations"])
    return Dataset(
        train=_to_array(data["train_subs"]),
        valid=_to_array(data.get("valid_subs", [])),
        test=_to_array(data.get("test_subs", [])),
        n_entities=len(entities),
        n_relations=len(relations),
        entities=entities,
        relations=relations,
    )


def save_dataset(ds: Dataset, path: str) -> None:
    """Write the reference pickle format."""
    data = {
        "train_subs": [tuple(map(int, t)) for t in ds.train],
        "valid_subs": [tuple(map(int, t)) for t in ds.valid],
        "test_subs": [tuple(map(int, t)) for t in ds.test],
        "entities": ds.entities or [f"e{i}" for i in range(ds.n_entities)],
        "relations": ds.relations or [f"r{i}" for i in range(ds.n_relations)],
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_tsv(
    train_path: str,
    valid_path: str,
    test_path: str,
    order: str = "spo",
    use_native: bool = True,
) -> Dataset:
    """Load whitespace-separated triple files (the FB15k/WN18 raw format).

    `order` gives the file column order; storage is always (s, o, p). The
    three files share one vocabulary, ids in order of first appearance.
    Uses the native C++ loader (`skge_torch.native`) when it builds, else
    reads in Python; both give the same arrays and names.
    """
    if use_native:
        from skge_torch import native

        out = native.load_triple_files([train_path, valid_path, test_path], order)
        if out is not None:
            (train, valid, test), entities, relations = out
            return Dataset(train=train, valid=valid, test=test,
                           n_entities=len(entities), n_relations=len(relations),
                           entities=entities, relations=relations)
    ent: Dict[str, int] = {}
    rel: Dict[str, int] = {}
    cols = {c: i for i, c in enumerate(order)}

    def read(path):
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) != 3:
                    continue
                s = ent.setdefault(parts[cols["s"]], len(ent))
                p = rel.setdefault(parts[cols["p"]], len(rel))
                o = ent.setdefault(parts[cols["o"]], len(ent))
                rows.append((s, o, p))
        return _to_array(rows)

    train, valid, test = read(train_path), read(valid_path), read(test_path)
    return Dataset(train=train, valid=valid, test=test,
                   n_entities=len(ent), n_relations=len(rel),
                   entities=list(ent), relations=list(rel))


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


def unigram_logits(
    triples: np.ndarray, n_entities: int,
    alpha: float = 0.75, smoothing: float = 1.0,
) -> np.ndarray:
    """Log-probabilities for degree-weighted negative sampling (word2vec /
    DGL-KE unigram^alpha): entity e is drawn with probability proportional
    to (deg(e) + smoothing)^alpha, deg counting subject and object slots of
    `triples`. Feed to `SharedNegativeSampler(logits=...)`."""
    deg = np.bincount(
        np.concatenate([triples[:, 0], triples[:, 1]]), minlength=n_entities
    ).astype(np.float64)
    return (alpha * np.log(deg + smoothing)).astype(np.float32)


def add_reciprocal_relations(ds: Dataset) -> Dataset:
    """Reciprocal-relation augmentation: n_relations doubled, relation p's
    inverse is p + n_relations, and train also holds (o, s, p_inv) for each
    train triple (s, o, p). Valid and test are unchanged, so filtered
    ranking stays comparable; train with object-direction CE and evaluate
    through `evaluation.ReciprocalEvalWrapper`."""
    t = ds.train
    inv = np.stack([t[:, 1], t[:, 0], t[:, 2] + ds.n_relations], axis=1)
    relations = None
    if ds.relations is not None:
        relations = list(ds.relations) + [f"{r}_inv" for r in ds.relations]
    return Dataset(
        train=np.concatenate([t, inv.astype(t.dtype)]),
        valid=ds.valid,
        test=ds.test,
        n_entities=ds.n_entities,
        n_relations=2 * ds.n_relations,
        entities=ds.entities,
        relations=relations,
    )
