"""Runtime checks, the counterpart of `skge_tpu.utils.debug`; off by
default, turned on per call site:

- `checked_step(step_fn)` wraps a train step (state, batch, mask) ->
  (state, metrics) with `torch.isfinite` checks of every tensor the step
  returns: params, optimizer slots and metrics. The wrapped step returns
  (error, (state, metrics)); `error.get()` gives the first failure's
  message or None and `error.throw()` raises it, as a JAX caller of
  `checkify` expects. The checks read one flag vector back to the host a
  step. Index checks are off by default, as in the JAX package:
  `index_bounds=(n_entities, n_relations)` adds a bounds check of every id
  of the batch before the step runs, masked rows too (a gather gathers
  them all: on the CPU it raises, on the card it stops the device).
- `validate_triples(triples, n_entities, n_relations)`: a host-side bounds
  check of an (N, 3) id array.
- `assert_finite_state(state)`: a host-side audit of every parameter and
  optimizer table (for a `post_epoch` callback).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from skge_torch.training import TrainState


class CheckError:
    """The outcome of one checked step: `get()` is the first failure's
    message or None; `throw()` raises it."""

    def __init__(self, message: Optional[str] = None, exc: type = FloatingPointError):
        self.message, self._exc = message, exc

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise self._exc(self.message)


def _named_tensors(state: TrainState, metrics) -> List[Tuple[str, torch.Tensor]]:
    out = [(f"param {k!r}", v) for k, v in state.params.items()]
    out += [(f"optimizer slot {k!r}/{s!r}", v)
            for k, slots in state.opt_state.items() for s, v in slots.items()]
    for name, v in zip(getattr(metrics, "_fields", ()), metrics):
        if isinstance(v, torch.Tensor):
            out.append((f"metric {name!r}", v))
    return out


def _index_error(batch: torch.Tensor, bounds: Tuple[int, int]) -> Optional[str]:
    ents, rels = batch[:, :2], batch[:, 2]
    bad = torch.stack([((ents < 0) | (ents >= bounds[0])).any(),
                       ((rels < 0) | (rels >= bounds[1])).any()]).tolist()
    if any(bad):
        return (f"out-of-bounds {'entity' if bad[0] else 'relation'} id in the "
                f"batch (n_entities={bounds[0]}, n_relations={bounds[1]})")
    return None


def checked_step(step_fn: Callable,
                 index_bounds: Optional[Tuple[int, int]] = None) -> Callable:
    """Wrap a train step with finiteness checks of its outputs (and, with
    `index_bounds`, a bounds check of its batch). Returns a callable
    (state, batch, mask) -> (CheckError, (state, metrics)). Keep the
    unchecked step for production runs: each check syncs with the host."""

    def checked(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
        if index_bounds is not None:
            message = _index_error(batch, index_bounds)
            if message is not None:
                return CheckError(message, IndexError), (state, None)
        new_state, metrics = step_fn(state, batch, mask)
        named = _named_tensors(new_state, metrics)
        flags = torch.stack([
            torch.stack([torch.isnan(v).any(), torch.isinf(v).any()])
            for _, v in named
        ]).tolist()
        for (name, _), (nan, inf) in zip(named, flags):
            if nan or inf:
                what = "nan" if nan else "inf"
                return CheckError(f"{what} in the step's output {name}"), (
                    new_state, metrics)
        return CheckError(), (new_state, metrics)

    return checked


def validate_triples(triples, n_entities: int, n_relations: int) -> None:
    """Raise ValueError on any out-of-range id in an (N, 3) (s, o, p) array."""
    t = np.asarray(triples)
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"triples must be (N, 3), got {t.shape}")
    bad_e = (t[:, :2] < 0) | (t[:, :2] >= n_entities)
    bad_r = (t[:, 2] < 0) | (t[:, 2] >= n_relations)
    if bad_e.any() or bad_r.any():
        i = int(np.argmax(bad_e.any(axis=1) | bad_r))
        raise ValueError(
            f"triple {i} = {tuple(t[i])} out of range for "
            f"n_entities={n_entities}, n_relations={n_relations}"
        )


def assert_finite_state(state: TrainState) -> None:
    """Raise FloatingPointError naming the first non-finite table."""
    for name, v in state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"param {name!r} contains NaN/Inf")
    for name, slots in state.opt_state.items():
        for sn, v in slots.items():
            if not bool(torch.isfinite(v).all()):
                raise FloatingPointError(
                    f"optimizer slot {name!r}/{sn!r} contains NaN/Inf")
