"""Datasets and host-side index building for the PyTorch port.

NumPy copies of the `skge_tpu.data` helpers the port needs: the
reference-format pickle (`load_dataset`, `save_dataset`), raw triple files
(`load_tsv`, through the native loader of `native/` or in Python), the
synthetic generator, the key encoding, the samplers' index helpers
(`sorted_train_keys`, `type_index_arrays`, `bernoulli_probs`,
`unigram_logits`), reciprocal relations, the filter index and the
entity partition of the bucketed trainer (`greedy_entity_partition`,
`partition_edges`). They are
copied rather than imported because importing `skge_tpu.data` imports the
JAX package. They give the same arrays as `skge_tpu.data` for the same
arguments and seed.

`latent_kg` builds the learnable synthetic KGs: NumPy draws as in the JAX
package, and the nearest-object sweep in PyTorch on `device` (the card by
default). It equals the JAX package's dataset wherever no query's best two
candidates lie within fp32 rounding of each other.

All triples are (N, 3) int32 arrays in (s, o, p) column order; the training
code moves them to the device as int64.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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


# latent_kg switches its object-assignment sweep from one (chunk, n_e)
# matmul to a blocked running-argmax scan above this entity count (device
# memory: the full score matrix stops fitting). Module-level so tests can
# lower it and pin blocked == single-matmul at CPU-sized vocabularies.
_BLOCKED_SWEEP_THRESHOLD = 1 << 21

LATENT_KINDS = ("translational", "bilinear", "rotational", "lattice")


def latent_tables(rng: np.random.Generator, n_entities: int, n_relations: int,
                  latent_dim: int, kind: str, rank: Optional[int] = None):
    """The latent points Z (n_e, latent_dim) and relation parameters Rel of
    `latent_kg`'s swept kinds, fp32, drawn from `rng` in its order."""
    Z = rng.normal(size=(n_entities, latent_dim)).astype(np.float32)
    if kind == "bilinear":
        # the unit sphere: the bilinear argmax is then direction-only
        Z /= np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1e-12)
        r = rank or max(2, latent_dim // 2)
        A = rng.normal(size=(n_relations, latent_dim, r))
        B = rng.normal(size=(n_relations, latent_dim, r))
        Rel = (A @ B.transpose(0, 2, 1) / np.sqrt(r)).astype(np.float32)
    else:
        Z /= np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1.0)
        if kind == "translational":
            Rel = (rng.normal(size=(n_relations, latent_dim)) * 0.5).astype(
                np.float32)
        else:  # rotational: per-dimension phases in (-pi, pi]
            Rel = rng.uniform(-np.pi, np.pi,
                              size=(n_relations, latent_dim // 2)).astype(np.float32)
    return Z, Rel


def latent_queries(kind: str, Z: torch.Tensor, Rel: torch.Tensor,
                   s: torch.Tensor, p: torch.Tensor, eps: torch.Tensor):
    """(B, latent_dim) queries of the (s, p) pairs, noise `eps` added."""
    if kind == "translational":
        return Z[s] + Rel[p] + eps
    if kind == "rotational":
        h = Z.shape[1] // 2
        a, b = Z[s, :h], Z[s, h:]
        c, sn = torch.cos(Rel[p]), torch.sin(Rel[p])
        return torch.cat([a * c - b * sn, a * sn + b * c], dim=1) + eps
    # bilinear: query = z_s^T W_p, scored by dot
    return torch.einsum("bd,bde->be", Z[s], Rel[p]) + eps


def latent_scores(kind: str, q: torch.Tensor, Z: torch.Tensor,
                  zn: torch.Tensor) -> torch.Tensor:
    """(B, n) scores of every candidate row of `Z` (squared norms `zn`):
    the query's object is their first argmax. Bilinear: the dot;
    otherwise minus the squared distance less |q|^2, -(|z|^2 - 2 q.z)."""
    dots = q @ Z.T
    if kind == "bilinear":
        return dots
    return -(zn[None, :] - 2.0 * dots)


def latent_assign(kind: str, Z: torch.Tensor, Rel: torch.Tensor, zn: torch.Tensor,
                  s, p, eps, block: Optional[int]) -> np.ndarray:
    """Objects of the (s, p) queries: the argmax of `latent_scores`, over
    every entity at once, or (`block`) a running argmax over blocks of
    entities that keeps the earlier block on a tie (strict >), as argmax
    keeps the first maximum. The last block is the remainder, so no padded
    entity takes part."""
    dev = Z.device
    q = latent_queries(kind, Z, Rel, torch.as_tensor(s, device=dev).long(),
                       torch.as_tensor(p, device=dev).long(),
                       torch.as_tensor(eps, device=dev))
    if block is None:
        o = torch.argmax(latent_scores(kind, q, Z, zn), dim=1)
    else:
        best_val = torch.full((q.shape[0],), -torch.inf, device=dev)
        o = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
        for lo in range(0, Z.shape[0], block):
            sc = latent_scores(kind, q, Z[lo:lo + block], zn[lo:lo + block])
            loc = torch.argmax(sc, dim=1)
            val = torch.gather(sc, 1, loc[:, None])[:, 0]
            better = val > best_val
            best_val = torch.where(better, val, best_val)
            o = torch.where(better, lo + loc, o)
    return o.to(torch.int32).cpu().numpy()


def latent_kg(
    n_entities: int,
    n_relations: int,
    n_train: int,
    n_valid: int = 0,
    n_test: int = 0,
    latent_dim: int = 16,
    noise: float = 0.0,
    seed: int = 0,
    kind: str = "translational",
    rank: Optional[int] = None,
    device="cuda",
) -> Dataset:
    """Learnable synthetic KG with a chosen latent geometry, the JAX
    package's `latent_kg`:

    - ``'translational'``: entities are latent points z_e (unit ball),
      relations translations t_p; o = the nearest entity to z_s + t_p
      (TransE geometry);
    - ``'bilinear'``: unit-vector entities, relations random low-rank
      matrices W_p = A B^T / sqrt(rank) (``rank`` defaults to
      latent_dim // 2); o = argmax_o (z_s^T W_p) . z_o (RESCAL, TuckER,
      DistMult geometry);
    - ``'rotational'``: complex latents ([re | im], latent_dim even),
      per-dimension phases theta_p; o = the nearest entity to z_s rotated
      by e^{i theta_p} (RotatE, ComplEx, HolE geometry);
    - ``'lattice'``: entities are the points of a b^latent_dim integer
      lattice (n_entities = b**latent_dim), relations continuous
      translations of up to ~3 lattice steps; o = the exact nearest lattice
      point, in closed form on the host, no sweep.

    Gaussian `noise` is added to the query before the argmax. The draws
    are NumPy's from `seed`, in the JAX package's order; the sweep is one
    (16,384, n_e) fp32 matmul a chunk on `device` ("cuda" unless the caller
    asks for the CPU), or above `_BLOCKED_SWEEP_THRESHOLD` entities a
    running argmax over blocks of 131,072 entities, 4,096 queries a chunk.
    Triples are int32, deduplicated, and permuted.
    """
    if kind not in LATENT_KINDS:
        raise ValueError(f"unknown latent kind {kind!r}")
    if kind == "rotational" and latent_dim % 2 != 0:
        raise ValueError("rotational geometry needs an even latent_dim")
    if kind == "lattice":
        return _lattice_kg(n_entities, n_relations, n_train, n_valid, n_test,
                           latent_dim, noise, seed)

    rng = np.random.default_rng(seed)
    Z, Rel = latent_tables(rng, n_entities, n_relations, latent_dim, kind, rank)
    total = n_train + n_valid + n_test
    if noise == 0.0 and total > 0.9 * n_entities * n_relations:
        # with noise=0, o is a function of (s, p): at most n_e * n_r unique
        # triples exist, and drawing the last few is coupon-collector slow
        raise ValueError(
            f"total={total} exceeds 90% of the {n_entities * n_relations} "
            "unique noise-free triples; lower the split sizes or set noise>0"
        )
    device = torch.device(device)
    Zd = torch.as_tensor(Z, device=device)
    Rd = torch.as_tensor(Rel, device=device)
    zn = torch.sum(Zd * Zd, dim=1)
    chunk = 16384
    big = n_entities > _BLOCKED_SWEEP_THRESHOLD
    block = None
    if big:
        block = min(1 << 17, -(-n_entities // 2))
        chunk = 4096  # a (chunk, block) fp32 tile is 2 GB at the full block

    triples = np.zeros((0, 3), np.int32)
    while triples.shape[0] < total:
        # the small regime redraws the FULL total each round (the JAX
        # package's rng stream); the big regime only the dedup shortfall
        draw = total if not big else min(
            total, max(chunk, int((total - triples.shape[0]) * 1.1)))
        s = rng.integers(0, n_entities, draw).astype(np.int32)
        p = rng.integers(0, n_relations, draw).astype(np.int32)
        o = np.zeros(draw, np.int32)
        for lo in range(0, draw, chunk):
            eps = ((rng.normal(size=(chunk, latent_dim)) * noise).astype(np.float32)
                   if noise > 0.0 else np.zeros((1, latent_dim), np.float32))
            hi = min(lo + chunk, draw)
            if big and (lo // chunk) % 512 == 0:
                logging.getLogger(__name__).info(
                    "latent_kg sweep: %d/%d queries assigned", lo, draw)
            o[lo:hi] = latent_assign(kind, Zd, Rd, zn, s[lo:hi], p[lo:hi],
                                      eps[:hi - lo], block)
        cand = np.stack([s, o, p], axis=1)
        triples = np.concatenate([triples, cand])
        keys = encode_keys_np(triples, n_entities, n_relations)
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    triples = triples[rng.permutation(triples.shape[0])][:total]
    return Dataset(
        train=triples[:n_train],
        valid=triples[n_train : n_train + n_valid],
        test=triples[n_train + n_valid :],
        n_entities=n_entities,
        n_relations=n_relations,
    )


def _lattice_kg(
    n_entities: int,
    n_relations: int,
    n_train: int,
    n_valid: int,
    n_test: int,
    latent_dim: int,
    noise: float,
    seed: int,
) -> Dataset:
    """Closed-form lattice geometry (`latent_kg(kind='lattice')`), host
    NumPy only, bit-equal to the JAX package's.

    Entity e <-> digits(e) in base b (little-endian), latent point
    z_e = (digits(e) + 0.5) / b in [0, 1]^dl. The Euclidean-nearest
    lattice point to a query q is componentwise clamp(round(q*b - 0.5)),
    exact for an axis-aligned box lattice."""
    b = int(round(n_entities ** (1.0 / latent_dim)))
    if b ** latent_dim != n_entities:
        raise ValueError(
            f"kind='lattice' needs n_entities == b**latent_dim for integer "
            f"b; {n_entities} is not a perfect {latent_dim}-th power "
            f"(nearest: {b ** latent_dim} = {b}**{latent_dim})"
        )
    rng = np.random.default_rng(seed)
    # translations of up to ~3 lattice steps, continuous (non-integer)
    Rel = (rng.uniform(-3.0, 3.0, size=(n_relations, latent_dim)) / b
           ).astype(np.float32)
    total = n_train + n_valid + n_test
    if noise == 0.0 and total > 0.9 * n_entities * n_relations:
        raise ValueError(
            f"total={total} exceeds 90% of the {n_entities * n_relations} "
            "unique noise-free triples; lower the split sizes or set noise>0"
        )
    powers = b ** np.arange(latent_dim, dtype=np.int64)

    def assign(s: np.ndarray, p: np.ndarray) -> np.ndarray:
        digs = (s[:, None].astype(np.int64) // powers[None, :]) % b
        q = (digs + 0.5) / b + Rel[p]
        if noise > 0.0:
            q = q + rng.normal(size=q.shape).astype(np.float32) * noise
        od = np.clip(np.round(q * b - 0.5), 0, b - 1).astype(np.int64)
        return (od @ powers).astype(np.int64)

    triples = np.zeros((0, 3), np.int64)
    while triples.shape[0] < total:
        draw = min(total, max(4096, int((total - triples.shape[0]) * 1.1)))
        s = rng.integers(0, n_entities, draw).astype(np.int64)
        p = rng.integers(0, n_relations, draw).astype(np.int64)
        o = assign(s, p)
        cand = np.stack([s, o, p], axis=1)
        triples = np.concatenate([triples, cand])
        keys = encode_keys_np(triples, n_entities, n_relations)
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    triples = triples[rng.permutation(triples.shape[0])][:total]
    triples = triples.astype(np.int32)
    return Dataset(
        train=triples[:n_train],
        valid=triples[n_train : n_train + n_valid],
        test=triples[n_train + n_valid :],
        n_entities=n_entities,
        n_relations=n_relations,
    )


def greedy_entity_partition(
    triples: np.ndarray, n_entities: int, n_parts: int, seed: int = 0,
    backend: str = "auto",
) -> np.ndarray:
    """Degree-descending greedy entity->part assignment (METIS-lite).

    Entities are placed, highest degree first, on the part where they have
    the most already-placed neighbors, subject to a +-12.5% balance cap on
    assigned DEGREE; then up to 3 refinement sweeps move an entity to its
    strict neighbor-majority part when the cap allows. `seed` is unused,
    as in the JAX package (the assignment is deterministic).

    `backend='auto'` runs the native C++ implementation
    (`native/src/partitioner.cpp`, bit-identical output) when g++ can build
    it, else this NumPy+Python reference; 'python' / 'native' force one.
    Returns (n_entities,) int32 part ids.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python":
        from skge_torch.native import greedy_partition

        out = greedy_partition(triples, n_entities, n_parts)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native partitioner unavailable (no toolchain)")
    t = np.asarray(triples)
    deg = np.bincount(t[:, 0], minlength=n_entities) + np.bincount(
        t[:, 1], minlength=n_entities
    )
    # adjacency in CSR form over the undirected entity graph
    src = np.concatenate([t[:, 0], t[:, 1]])
    dst = np.concatenate([t[:, 1], t[:, 0]])
    order_e = np.argsort(src, kind="stable")
    src, dst = src[order_e], dst[order_e]
    starts = np.searchsorted(src, np.arange(n_entities))
    ends = np.searchsorted(src, np.arange(n_entities) + 1)

    part = np.full(n_entities, -1, np.int32)
    load = np.zeros(n_parts, np.int64)
    cap = max(1.0, deg.sum() / n_parts * 1.125)
    for e in np.argsort(-deg, kind="stable"):
        nbr_parts = part[dst[starts[e] : ends[e]]]
        nbr_parts = nbr_parts[nbr_parts >= 0]
        open_parts = load + deg[e] <= cap
        if not open_parts.any():
            open_parts[:] = True  # all full: fall back to least-loaded
        score = np.zeros(n_parts, np.int64)
        if nbr_parts.size:
            np.add.at(score, nbr_parts, 1)
        score = np.where(open_parts, score, -1)
        best = score.max()
        cands = np.flatnonzero(score == best)
        p = cands[np.argmin(load[cands])] if cands.size > 1 else cands[0]
        part[e] = p
        load[p] += deg[e]

    for _ in range(3):
        moved = 0
        for e in range(n_entities):
            nbrs = part[dst[starts[e] : ends[e]]]
            if nbrs.size == 0:
                continue
            tally = np.bincount(nbrs, minlength=n_parts)
            p_new = int(np.argmax(tally))
            p_old = part[e]
            if p_new == p_old or tally[p_new] <= tally[p_old]:
                continue
            if load[p_new] + deg[e] > cap:
                continue
            part[e] = p_new
            load[p_old] -= deg[e]
            load[p_new] += deg[e]
            moved += 1
        if moved == 0:
            break
    return part


def partition_edges(
    triples: np.ndarray, entity_part: np.ndarray, n_parts: int
):
    """Group triples by their SUBJECT's part, padded to equal length.

    Returns (batches, mask, stats): batches (P, L, 3) int32 with each part's
    triples padded by repeating its first row; mask (P, L) float32 zeroing
    the padding; stats with the per-part counts, their balance and the
    fraction of triples whose object lies in the subject's part.
    """
    t = np.asarray(triples, np.int32)
    owner = entity_part[t[:, 0]]
    counts = np.bincount(owner, minlength=n_parts)
    length = int(counts.max())
    batches = np.zeros((n_parts, length, 3), np.int32)
    mask = np.zeros((n_parts, length), np.float32)
    for p in range(n_parts):
        rows = t[owner == p]
        if rows.shape[0] == 0:
            continue
        batches[p, : rows.shape[0]] = rows
        batches[p, rows.shape[0] :] = rows[0]
        mask[p, : rows.shape[0]] = 1.0
    obj_local = float(np.mean(entity_part[t[:, 1]] == owner))
    stats = {
        "counts": counts,
        "balance": float(counts.min() / max(1, counts.max())),
        "object_locality": obj_local,
    }
    return batches, mask, stats


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


def _group_unique(key_ent: np.ndarray, key_rel: np.ndarray, vals: np.ndarray):
    """{(key_ent, key_rel): sorted unique int32 vals}, sorted in NumPy."""
    if key_ent.size == 0:
        return {}
    width = int(key_rel.max()) + 1
    keys = key_ent * width + key_rel
    order = np.lexsort((vals, keys))
    keys, vals = keys[order], vals[order]
    keep = np.ones(keys.size, bool)
    keep[1:] = (keys[1:] != keys[:-1]) | (vals[1:] != vals[:-1])
    keys, vals = keys[keep], vals[keep].astype(np.int32)
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    groups = np.split(vals, starts[1:])
    ents, rels = np.divmod(keys[starts], width)
    return {(e, r): g for e, r, g in zip(ents.tolist(), rels.tolist(), groups)}


def true_triple_index(triples: np.ndarray):
    """Known-true lookup for filtered evaluation.

    Returns dicts: (s, p) -> sorted int32 array of true objects, and
    (o, p) -> sorted int32 array of true subjects.
    """
    t = np.asarray(triples, np.int64).reshape(-1, 3)
    return (_group_unique(t[:, 0], t[:, 2], t[:, 1]),
            _group_unique(t[:, 1], t[:, 2], t[:, 0]))


def known_csr(triples: np.ndarray, n_relations: int, direction: str):
    """The known-true lookup of one direction as a CSR index: (s, p) -> o
    for direction 'o', (o, p) -> s for 's'.

    Returns (keys, offsets, answers): `keys` the sorted distinct int64
    entity * n_relations + relation of the query side, `offsets` int64
    (len(keys) + 1), and `answers[offsets[i]:offsets[i + 1]]` the int32
    answers of key i, sorted and distinct: `true_triple_index`'s list for
    that key. Relations must lie in [0, n_relations) and entities be >= 0.
    """
    if direction not in ("o", "s"):
        raise ValueError(f"direction must be 'o' or 's', got {direction!r}")
    t = np.asarray(triples, np.int64).reshape(-1, 3)
    ent, ans = (t[:, 0], t[:, 1]) if direction == "o" else (t[:, 1], t[:, 0])
    rel = t[:, 2]
    if t.size and (rel.min() < 0 or rel.max() >= n_relations or min(ent.min(), ans.min()) < 0):
        raise ValueError(f"known triples need relations in [0, {n_relations}) and entities "
                         ">= 0")
    keys = ent * n_relations + rel
    order = np.lexsort((ans, keys))
    keys, ans = keys[order], ans[order]
    keep = np.ones(keys.size, bool)
    keep[1:] = (keys[1:] != keys[:-1]) | (ans[1:] != ans[:-1])
    keys, ans = keys[keep], ans[keep]
    first = np.ones(keys.size, bool)
    first[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(first)
    offsets = np.append(starts, keys.size).astype(np.int64)
    return keys[starts], offsets, ans.astype(np.int32)


def cached_dataset(path, n_entities: int, n_relations: int,
                   build: Callable[[], Dataset]) -> Tuple[Dataset, bool]:
    """The train, valid and test splits read from the npz at `path`, or
    `build()`'s, written there whole under a temporary name and renamed, so
    a concurrent run sees the file complete or not at all. Returns
    (dataset, whether it was read)."""
    path = Path(path)
    if path.exists():
        with np.load(path) as z:
            return Dataset(train=z["train"], valid=z["valid"], test=z["test"],
                           n_entities=n_entities, n_relations=n_relations), True
    ds = build()
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, train=ds.train, valid=ds.valid, test=ds.test)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return ds, False


def rows_with_keys(triples: np.ndarray, queries: np.ndarray, col: int) -> np.ndarray:
    """The rows of `triples` whose (column `col`, relation) pair is also
    some row of `queries`' (col 0: the (s, p) keys of object queries, col
    1: the (o, p) keys of subject queries), in their order: the only known
    triples a filtered ranking of `queries` in that direction reads, so
    an index of known answers (`known_csr`, `true_triple_index`) over them
    gives the same ranks as over all of `triples`, in
    O(len(triples) log len(queries)) host work."""
    t = np.asarray(triples).reshape(-1, 3)
    q = np.asarray(queries).reshape(-1, 3)
    if not len(t) or not len(q):
        return t[:0]
    width = int(max(t[:, 2].max(), q[:, 2].max())) + 1
    want = np.unique(q[:, col].astype(np.int64) * width + q[:, 2])
    have = t[:, col].astype(np.int64) * width + t[:, 2]
    at = np.minimum(np.searchsorted(want, have), len(want) - 1)
    return t[want[at] == have]


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
