"""TransE (Bordes et al. 2013) with L1 dissimilarity: the plain reference
of its scores and gradients, and its operation counts. Part of the
yardstick; imports nothing of the program.

score(s, o, p) = -||e_s + r_p - e_o||_1. |x| takes the gradient +1 at
x == 0 (the convention of scikit-kge's successor in JAX). Entity rows
carry the unit-ball constraint `normless1` after each update.

A pool or candidate sweep scores a (B, d) query q against entity rows:
mode 1 (object replaced) q = e_s + r_p, mode 0 (subject replaced)
q = e_o - r_p, both as -||q - e_k||_1.
"""

from __future__ import annotations

import torch

AF = "linear"
POST = {"E": "normless1"}


def tables(cfg: dict) -> dict:
    d = cfg["ncomp"]
    return {"E": (cfg["entities"], d), "R": (cfg["relations"], d)}


def _abs(x):
    return torch.where(x >= 0, x, -x)


def score(es, rp, eo, mm=None):
    return -torch.sum(_abs(es + rp - eo), dim=-1)


def query(mode: int, es, rp, eo, mm=None):
    return es + rp if mode == 1 else eo - rp


def pool_scores(q, pool, mm=None, block: int = 64):
    """(B, K) scores of every query against every pool row."""
    return torch.cat([-torch.sum(_abs(q[lo:lo + block, None, :] - pool[None]), dim=-1)
                      for lo in range(0, q.shape[0], block)])


def pool_pass(q, pool, weigh, mm=None, block: int = 64):
    """Scores block by block; `weigh(lo, f)` turns a block's (b, K) scores
    into dL/df. Returns (dL/dq (B, d), dL/dpool (K, d))."""
    gq = torch.zeros_like(q)
    gpool = torch.zeros_like(pool)
    for lo in range(0, q.shape[0], block):
        x = q[lo:lo + block, None, :] - pool[None]
        w = weigh(lo, -torch.sum(_abs(x), dim=-1))
        ws = w[..., None] * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
        gq[lo:lo + block] = -torch.sum(ws, dim=1)
        gpool += torch.sum(ws, dim=0)
    return gq, gpool


# operations, counting each add, subtract, multiply and |x| as one
def triple_flops(d: int, backward: bool) -> float:
    """One triple's score (two adds, |x|, the sum: 4d); its backward: the
    sign and the three rows' gradients (4d)."""
    return 4 * d + (4 * d if backward else 0)


def query_flops(d: int, backward: bool) -> float:
    return d + (2 * d if backward else 0)


def pair_flops(d: int, backward: bool) -> float:
    """One (query, pool row) score (subtract, |x|, sum: 3d); its backward:
    the weighted sign and the two rows' gradients (3d)."""
    return 3 * d + (3 * d if backward else 0)
