"""Host-side sampler classes with the reference `skge/sample.py` surface.

Reference signatures (SURVEY.md §2.1 #3): `Sampler(n, modes, ntries=100)`
base with `.sample(xys)`; `RandomModeSampler(n, modes, xs, sz)`;
`LCWASampler(n, modes, xs, sz)` (rejection against the training set);
`CorruptedSampler(n, xs, type_index)`; `type_index(xs)`.

`sample(xys)` takes [( (s,o,p), y ), ...] and returns corrupted negatives
labeled -1.0 — usable as the trainers' `samplef` exactly like the reference.
The port's compat trainers (`skge_torch.compat`) RECOGNIZE these classes
and swap in the equivalent sampler from `skge_torch.sampling`, which draws
on the trainer's device; an arbitrary user callable falls back to the host
loop. The port's own copy of the JAX package's `skge_tpu/sample.py`: the
same signatures and behaviour.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def type_index(xs: Sequence[Tuple[int, int, int]]) -> Dict[int, Dict[int, list]]:
    """Per-relation observed subjects (mode 0) and objects (mode 1)."""
    idx: Dict[int, Dict[int, set]] = defaultdict(lambda: {0: set(), 1: set()})
    for s, o, p in xs:
        idx[p][0].add(s)
        idx[p][1].add(o)
    return {p: {m: sorted(v) for m, v in d.items()} for p, d in idx.items()}


class Sampler:
    def __init__(self, n: int, modes: Sequence[int], ntries: int = 100):
        self.n = n
        self.modes = list(modes)
        self.ntries = ntries
        self.rng = np.random.default_rng()

    def sample(self, xys) -> List[Tuple[Tuple[int, int, int], float]]:
        """One negative per (positive, mode, repeat) with label -1.0."""
        res = []
        for x, _ in xys:
            for _ in range(self.n):
                for mode in self.modes:
                    nex = self._sample(x, mode)
                    if nex is not None:
                        res.append(nex)
        return res

    def _sample(self, x, mode):
        raise NotImplementedError


class RandomModeSampler(Sampler):
    """Uniform corruption of position `mode` (skge/sample.py ~35)."""

    def __init__(self, n, modes, xs, sz):
        super().__init__(n, modes)
        self.xs = xs
        self.sz = sz

    def _sample(self, x, mode):
        nex = list(x)
        nex[mode] = int(self.rng.integers(0, self.sz[mode]))
        return (tuple(nex), -1.0)


class LCWASampler(RandomModeSampler):
    """Rejection-resample while corrupted triple is in the training set
    (skge/sample.py ~60); returns None after `ntries` failures."""

    def __init__(self, n, modes, xs, sz):
        super().__init__(n, modes, xs, sz)
        self.sset = set(map(tuple, xs))

    def _sample(self, x, mode):
        for _ in range(self.ntries):
            nex = list(x)
            nex[mode] = int(self.rng.integers(0, self.sz[mode]))
            t = tuple(nex)
            if t not in self.sset:
                return (t, -1.0)
        return None


class CorruptedSampler(Sampler):
    """Type-compatible corruption via `type_index` (skge/sample.py ~80)."""

    def __init__(self, n, xs, idx, modes=(0, 1)):
        super().__init__(n, modes)
        self.xs = xs
        self.idx = idx

    def _sample(self, x, mode):
        cands = self.idx.get(x[2], {}).get(mode)
        if not cands:
            return None
        nex = list(x)
        nex[mode] = int(cands[int(self.rng.integers(0, len(cands)))])
        return (tuple(nex), -1.0)


class BernoulliSampler(Sampler):
    """Per-relation corrupt-subject probability tph/(tph+hpt) (TransH);
    build-scope addition (BASELINE.json config 4)."""

    def __init__(self, n, xs, sz):
        super().__init__(n, [0, 1])
        self.sz = sz
        from skge_torch.data import bernoulli_probs

        self.probs = bernoulli_probs(np.asarray(xs, np.int64), sz[2])

    def sample(self, xys):
        res = []
        for x, _ in xys:
            for _ in range(self.n):
                mode = 0 if self.rng.uniform() < self.probs[x[2]] else 1
                nex = list(x)
                nex[mode] = int(self.rng.integers(0, self.sz[mode]))
                res.append((tuple(nex), -1.0))
        return res
