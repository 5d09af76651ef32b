"""Activation functions with the reference `skge/actfun.py` surface:
classes with static `f(x)` and `g_given_f(fx)` (derivative expressed in
terms of the forward value) — SURVEY.md §2.1 #5. The port's own copy of
the JAX package's `skge_tpu/actfun.py`: the same signatures and behaviour.
"""

from __future__ import annotations

import numpy as np


class Linear:
    name = "linear"

    @staticmethod
    def f(x):
        return x

    @staticmethod
    def g_given_f(fx):
        return np.ones_like(fx)


class Sigmoid:
    name = "sigmoid"

    @staticmethod
    def f(x):
        return 1.0 / (1.0 + np.exp(-x))

    @staticmethod
    def g_given_f(fx):
        return fx * (1.0 - fx)


class Tanh:
    name = "tanh"

    @staticmethod
    def f(x):
        return np.tanh(x)

    @staticmethod
    def g_given_f(fx):
        return 1.0 - fx**2


class ReLU:
    name = "relu"

    @staticmethod
    def f(x):
        return np.maximum(x, 0.0)

    @staticmethod
    def g_given_f(fx):
        return (fx > 0).astype(np.float64)
