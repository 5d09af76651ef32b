"""HolE (Nickel, Rosasco, Poggio, AAAI 2016): the plain reference of its
scores and gradients, and its operation counts. Part of the yardstick;
imports nothing of the program.

score(s, o, p) = sum_k r_p[k] ccorr(e_s, e_o)[k] with
ccorr(a, b)[k] = sum_i a[i] b[(i + k) mod d], computed here from that
definition (no FFT). Pairwise training applies the sigmoid before the
margin test. A pool or candidate sweep scores a (B, d) query against
entity rows by a dot product: mode 1 (object replaced)
q = cconv(e_s, r_p), cconv(a, b)[m] = sum_i a[i] b[(m - i) mod d];
mode 0 (subject replaced) q = ccorr(r_p, e_o).

`mm(a, b)` is the matrix product of the sweep (a @ b); the control
passes one that rounds its operands.
"""

from __future__ import annotations

import math

import torch

AF = "sigmoid"
POST = {}


def tables(cfg: dict) -> dict:
    d = cfg["ncomp"]
    return {"E": (cfg["entities"], d), "R": (cfg["relations"], d)}


def _index(d: int, sign: int, device) -> torch.Tensor:
    """(d, d) ids (k + sign * i) mod d, row k, column i."""
    k = torch.arange(d, device=device)
    return (k[:, None] + sign * k[None, :]) % d


def ccorr(a, b):
    return torch.sum(a[..., None, :] * b[..., _index(a.shape[-1], 1, a.device)], dim=-1)


def cconv(a, b):
    return torch.sum(a[..., None, :] * b[..., _index(a.shape[-1], -1, a.device)], dim=-1)


def score(es, rp, eo, mm=None):
    return torch.sum(rp * ccorr(es, eo), dim=-1)


def query(mode: int, es, rp, eo, mm=None):
    return cconv(es, rp) if mode == 1 else ccorr(rp, eo)


def _mm(mm):
    return mm if mm is not None else torch.matmul


def pool_scores(q, pool, mm=None, block: int = 4096):
    return torch.cat([_mm(mm)(q[lo:lo + block], pool.T)
                      for lo in range(0, q.shape[0], block)])


def pool_pass(q, pool, weigh, mm=None, block: int = 4096):
    """As `transe.pool_pass`: dL/dq and dL/dpool of the dot-product sweep."""
    mm = _mm(mm)
    gq = torch.zeros_like(q)
    gpool = torch.zeros_like(pool)
    for lo in range(0, q.shape[0], block):
        qb = q[lo:lo + block]
        w = weigh(lo, mm(qb, pool.T))
        gq[lo:lo + block] = mm(w, pool)
        gpool += mm(w.T, qb)
    return gq, gpool


def _circulant_flops(d: int) -> float:
    """One circular correlation or convolution as the FFTs compute it:
    three real transforms of 2.5 d log2 d and d / 2 + 1 complex products."""
    return 7.5 * d * math.log2(d) + 6 * (d // 2 + 1)


def triple_flops(d: int, backward: bool) -> float:
    """ccorr, the product with r_p and the sum; the backward: two
    circulant products and the elementwise terms."""
    fwd = _circulant_flops(d) + 2 * d
    return fwd + (2 * _circulant_flops(d) + 3 * d if backward else 0)


def query_flops(d: int, backward: bool) -> float:
    return _circulant_flops(d) + (2 * _circulant_flops(d) if backward else 0)


def pair_flops(d: int, backward: bool) -> float:
    """One (query, pool row) dot product (2d); the backward: the two
    rows' gradients (4d)."""
    return 2 * d + (4 * d if backward else 0)
