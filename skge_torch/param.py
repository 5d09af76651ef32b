"""Host-side parameter / optimizer surface mirroring `skge/param.py`.

Provides the reference's names (SURVEY.md §2.1 #2): `Parameter` (ndarray
subclass carrying an init + post-constraint), `ParameterUpdate`, `SGD`,
`AdaGrad`, init fns `normal` / `nunif`, constraint `normless1`. These NumPy
classes make the compat API complete and usable standalone; the port's
training path uses `skge_torch.optim` instead. The port's own copy of the
JAX package's `skge_tpu/param.py`: the same signatures and behaviour.
"""

from __future__ import annotations

import math

import numpy as np

_EPS = 1e-6  # [M] reference value


def normal(sz):
    return np.random.normal(0.0, 1.0, sz)


def nunif(sz):
    """Normalized-uniform (Glorot-style) init ([M] exact reference form)."""
    bnd = math.sqrt(6.0) / math.sqrt(sz[0] + sz[1])
    return np.random.uniform(low=-bnd, high=bnd, size=sz)


def normless1(param, idx=None):
    """Project rows with L2 norm > 1 onto the unit ball (skge/param.py ~110)."""
    if idx is None:
        idx = slice(None)
    rows = param[idx]
    axes = tuple(range(1, rows.ndim))
    norm = np.sqrt(np.sum(rows**2, axis=axes, keepdims=True))
    param[idx] = np.where(norm > 1.0, rows / np.maximum(norm, 1e-30), rows)


INITS = {"normal": normal, "nunif": nunif}
CONSTRAINTS = {"normless1": normless1}


class Parameter(np.ndarray):
    """ndarray subclass with attached init name and post-constraint."""

    def __new__(cls, shape, init="nunif", post=None, value=None):
        if value is not None:
            arr = np.asarray(value, dtype=np.float64)
        else:
            initf = INITS[init] if isinstance(init, str) else init
            if len(shape) == 3:
                # 3-D tensors: init frontal slices then stack
                # (skge/param.py Parameter.__new__ handles 3-D [H])
                arr = np.stack([initf(shape[1:]) for _ in range(shape[0])])
            else:
                arr = initf(shape)
        obj = arr.view(cls)
        obj.post = post
        return obj

    def __array_finalize__(self, obj):
        if obj is not None:
            self.post = getattr(obj, "post", None)


class ParameterUpdate:
    """Applies `_update` then the parameter's post-constraint at idx."""

    def __init__(self, param: Parameter, learning_rate: float):
        self.param = param
        self.learning_rate = learning_rate

    def __call__(self, g, idx=None):
        self._update(g, idx if idx is not None else slice(None))
        if getattr(self.param, "post", None) is not None:
            postf = (
                CONSTRAINTS[self.param.post]
                if isinstance(self.param.post, str)
                else self.param.post
            )
            postf(self.param, idx)

    def reset(self):
        pass

    def _update(self, g, idx):
        raise NotImplementedError


class SGD(ParameterUpdate):
    def _update(self, g, idx):
        self.param[idx] -= self.learning_rate * g


class AdaGrad(ParameterUpdate):
    def __init__(self, param, learning_rate):
        super().__init__(param, learning_rate)
        self.p2 = np.zeros_like(np.asarray(param))

    def _update(self, g, idx):
        self.p2[idx] += g * g
        h = np.maximum(np.sqrt(self.p2[idx]), _EPS)
        self.param[idx] -= self.learning_rate * g / h

    def reset(self):
        self.p2 = np.zeros_like(self.p2)
