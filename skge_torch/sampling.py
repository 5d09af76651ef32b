"""Negative samplers of the port.

Negatives corrupt position `mode` of a positive triple (0 = subject, 1 =
object, in the (s, o, p) column convention); labels are -1.

- `RandomModeSampler`: uniform corruption of each mode in `modes`, no
  membership check.
- `LCWASampler`: draws `ntries` candidates per negative, takes the first
  whose triple is not in the training set (sorted-key binary search), and
  masks the pair out when every candidate collides.
- `CorruptedSampler`: type-compatible corruption; the replacement is drawn
  from the entities seen in that role for the triple's relation, uniform
  when the relation has none.
- `BernoulliSampler`: one negative per positive, the subject corrupted
  with the relation's probability tph/(tph+hpt).
- `SharedNegativeSampler`: K entities drawn ONCE per step, uniform or,
  with `logits`, from softmax(logits) with replacement; every positive is
  ranked against every pool entity, for each mode in `modes`. As in the
  reference's uniform sampler, no false-negative filtering is applied.

The iid samplers split each draw into two parts: `draw(generator, b)`
takes the raw random numbers from the generator, on its device, and
`corrupt(pos, mask, draws)` / `expand(pos, mask, draws)` are pure
functions of them. Philox and JAX's threefry never agree, so the parity
tests hand the pure part the JAX package's raw draws. The train steps read
the `corruptions(generator, pos, mask)` protocol, a list of
(mode, replacement (B,), valid (B,)), or the expanded `__call__` form,
(positives repeated, negatives, pair mask); the shared pool has the
`pool` protocol instead, whose `draw(generator)` is the pool itself
(tests inject pool ids through a `pool`-protocol stand-in).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def encode_keys(triples: torch.Tensor, n_entities: int, n_relations: int):
    """Bijective int64 key: ((s * n_e) + o) * n_r + p."""
    t = triples.to(torch.int64)
    return (t[..., 0] * n_entities + t[..., 1]) * n_relations + t[..., 2]


def _is_member(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(sorted_keys, keys)
    idx = torch.clamp(idx, 0, sorted_keys.shape[0] - 1)
    return sorted_keys[idx] == keys


def _corrupt(pos: torch.Tensor, mode: int, replacement: torch.Tensor):
    out = pos.clone()
    out[:, mode] = replacement.to(pos.dtype)
    return out


def _randint(generator: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device)


def _rand(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


class _IidSampler:
    """The two protocols of an iid sampler over its `draw` and `corrupt`."""

    def expand(self, pos: torch.Tensor, mask: torch.Tensor, draws):
        """(positives repeated, negatives, pair mask), one block per
        corruption."""
        out = self.corrupt(pos, mask, draws)
        return (
            torch.cat([pos] * len(out)),
            torch.cat([_corrupt(pos, mode, repl) for mode, repl, _ in out]),
            torch.cat([valid for _, _, valid in out]),
        )

    def corruptions(self, generator: torch.Generator, pos, mask):
        return self.corrupt(pos, mask, self.draw(generator, pos.shape[0]))

    def __call__(self, generator: torch.Generator, pos, mask):
        return self.expand(pos, mask, self.draw(generator, pos.shape[0]))


@dataclass(frozen=True, eq=False)
class RandomModeSampler(_IidSampler):
    """Uniform corruption of each mode in `modes`."""

    n_entities: int
    modes: Tuple[int, ...] = (0, 1)

    def draw(self, generator: torch.Generator, b: int) -> torch.Tensor:
        """(len(modes), b) replacement ids."""
        return _randint(generator, self.n_entities, (len(self.modes), b))

    def corrupt(self, pos, mask, draws):
        return [(mode, repl, mask) for mode, repl in zip(self.modes, draws)]


@dataclass(frozen=True, eq=False)
class LCWASampler(_IidSampler):
    """Local-closed-world corruption with rejection.

    `sorted_train_keys` is the sorted int64 `encode_keys` of the training
    triples (`data.sorted_train_keys`); a candidate colliding with a
    training triple is rejected and the next of the `ntries` candidates is
    tried. If all collide, the pair is masked out.
    """

    n_entities: int
    n_relations: int
    sorted_train_keys: torch.Tensor
    modes: Tuple[int, ...] = (0, 1)
    ntries: int = 100

    def draw(self, generator: torch.Generator, b: int) -> torch.Tensor:
        """(len(modes), b, ntries) candidate ids."""
        return _randint(generator, self.n_entities,
                        (len(self.modes), b, self.ntries))

    def corrupt(self, pos, mask, draws):
        t = pos.to(torch.int64)
        known = self.sorted_train_keys.to(pos.device)
        out = []
        for mode, cands in zip(self.modes, draws):
            s = cands if mode == 0 else t[:, None, 0]
            o = cands if mode == 1 else t[:, None, 1]
            keys = (s * self.n_entities + o) * self.n_relations + t[:, None, 2]
            ok = ~_is_member(known, keys)                       # (B, ntries)
            # argmax takes no bool; on ties it gives the first index
            first = torch.argmax(ok.to(torch.int32), dim=1)
            chosen = torch.gather(cands, 1, first[:, None])[:, 0]
            out.append((mode, chosen, mask * ok.any(dim=1).to(mask.dtype)))
        return out


@dataclass(frozen=True, eq=False)
class BernoulliSampler(_IidSampler):
    """Corrupt the subject with per-relation probability tph/(tph+hpt).

    One negative per positive. `p_corrupt_subject`: (n_relations,) float
    (`data.bernoulli_probs`).
    """

    n_entities: int
    p_corrupt_subject: torch.Tensor

    def draw(self, generator: torch.Generator, b: int):
        """(uniforms (b,), replacement ids (b,))."""
        return _rand(generator, (b,)), _randint(generator, self.n_entities, (b,))

    def _subject(self, pos, u) -> torch.Tensor:
        return u < self.p_corrupt_subject.to(pos.device)[pos[:, 2]]

    def corrupt(self, pos, mask, draws):
        """Two single-mode slots sharing one replacement, gated by disjoint
        masks: the fused step scores one corrupted role per slot."""
        u, repl = draws
        cs = self._subject(pos, u).to(mask.dtype)
        return [(0, repl, mask * cs), (1, repl, mask * (1.0 - cs))]

    def expand(self, pos, mask, draws):
        """One mixed negative per positive."""
        u, repl = draws
        neg = torch.where(self._subject(pos, u)[:, None],
                          _corrupt(pos, 0, repl), _corrupt(pos, 1, repl))
        return pos, neg, mask


@dataclass(frozen=True, eq=False)
class CorruptedSampler(_IidSampler):
    """Type-compatible corruption through the relation type index
    (`data.type_index_arrays`): `flat[off[p] : off[p] + cnt[p]]` are the
    candidates for relation p. Relations with no candidate fall back to
    uniform corruption."""

    n_entities: int
    sub_flat: torch.Tensor
    sub_off: torch.Tensor
    sub_cnt: torch.Tensor
    obj_flat: torch.Tensor
    obj_off: torch.Tensor
    obj_cnt: torch.Tensor
    modes: Tuple[int, ...] = (0, 1)

    def draw(self, generator: torch.Generator, b: int):
        """(uniforms (len(modes), b), fallback ids (len(modes), b))."""
        n = len(self.modes)
        return _rand(generator, (n, b)), _randint(generator, self.n_entities, (n, b))

    def corrupt(self, pos, mask, draws):
        p = pos[:, 2]
        out = []
        for mode, u, fallback in zip(self.modes, *draws):
            index = ((self.sub_flat, self.sub_off, self.sub_cnt) if mode == 0
                     else (self.obj_flat, self.obj_off, self.obj_cnt))
            flat, off, cnt = (a.to(pos.device, torch.int64) for a in index)
            c = cnt[p]
            pick = off[p] + torch.floor(u * torch.clamp(c, min=1)).to(torch.int64)
            cand = flat[torch.clamp(pick, 0, flat.shape[0] - 1)]
            out.append((mode, torch.where(c > 0, cand, fallback), mask))
        return out


@dataclass(frozen=True, eq=False)
class SharedNegativeSampler:
    """`logits`: optional (n_entities,) unnormalized log-probabilities
    (`data.unigram_logits`); the pool is then drawn from softmax(logits)
    with replacement. JAX's Gumbel-argmax draw and `torch.multinomial` draw
    from the same distribution, never the same ids."""

    n_entities: int
    k: int = 1024
    modes: Tuple[int, ...] = (0, 1)
    logits: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.logits is not None:
            logits = torch.as_tensor(self.logits, dtype=torch.float32)
            if logits.shape != (self.n_entities,):
                raise ValueError(f"logits of shape {tuple(logits.shape)} for "
                                 f"{self.n_entities} entities")
            object.__setattr__(self, "logits", logits)
            object.__setattr__(self, "_probs", {})  # device -> softmax(logits)

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """(k,) int64 entity ids on the generator's device."""
        if self.logits is None:
            return _randint(generator, self.n_entities, (self.k,))
        dev = generator.device
        probs = self._probs.get(dev)
        if probs is None:
            probs = self._probs[dev] = torch.softmax(self.logits.to(dev), dim=0)
        return torch.multinomial(probs, self.k, replacement=True, generator=generator)

    def pool(
        self, generator: torch.Generator, pos: torch.Tensor, mask: torch.Tensor
    ) -> torch.Tensor:
        return self.draw(generator)


SAMPLERS = {
    "random-mode": RandomModeSampler,
    "lcwa": LCWASampler,
    "bernoulli": BernoulliSampler,
    "corrupted": CorruptedSampler,
    "shared": SharedNegativeSampler,
}
