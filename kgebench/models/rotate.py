"""RotatE (Sun et al., ICLR 2019) with its published distance, the sum of
complex moduli: the plain reference of its scores and gradients, and its
operation counts. Part of the yardstick; plain `torch`, imports nothing of
the program.

Entity rows are complex vectors of width d, (n_e, 2d) real tables with
the real parts first; relation rows hold d phases theta, r = exp(i theta).

    score(s, o, p) = -sum_i |e_s,i * r_p,i - e_o,i|,

|z| = sqrt(re^2 + im^2) by `torch.linalg.vector_norm`, whose gradient at
|z| == 0 is 0 (the authors' code takes the modulus through `.norm(dim=0)`).
No row constraint. A pool or candidate sweep scores a (B, 2d) rotated
query q against entity rows as -sum_i |q_i - e_k,i|: mode 1 (object
replaced) q = e_s rotated by +theta, mode 0 (subject replaced) q = e_o
rotated by -theta; a rotation keeps each modulus, |e_s r - e_o| =
|e_s - e_o conj(r)|.

Run alone, this file's functions are held to full fp32 products: TF32 is
switched off below (the sweep has no product, the rotation's multiplies
run outside the tensor cores either way).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

AF = "linear"
POST = {}

# elements of the (b, K, 2d) differences a sweep's block holds at most
BLOCK_ELEMENTS = 1 << 24


def tables(cfg: dict) -> dict:
    d = cfg["ncomp"]
    return {"E": (cfg["entities"], 2 * d), "R": (cfg["relations"], d)}


def _rotate(x, theta, sign: float):
    d = x.shape[-1] // 2
    a, b = x[..., :d], x[..., d:]
    c, s = torch.cos(theta), sign * torch.sin(theta)
    return torch.cat([a * c - b * s, a * s + b * c], dim=-1)


def _moduli(x):
    """(..., d) moduli of (..., 2d) complex rows."""
    return torch.linalg.vector_norm(x.unflatten(-1, (2, x.shape[-1] // 2)), dim=-2)


def score(es, rp, eo, mm=None):
    return -torch.sum(_moduli(_rotate(es, rp, 1.0) - eo), dim=-1)


def query(mode: int, es, rp, eo, mm=None):
    return _rotate(es, rp, 1.0) if mode == 1 else _rotate(eo, rp, -1.0)


def _block(q, pool) -> int:
    return max(1, BLOCK_ELEMENTS // max(1, pool.shape[0] * q.shape[1]))


def pool_scores(q, pool, mm=None):
    """(B, K) scores of every query against every pool row."""
    b = _block(q, pool)
    return torch.cat([-torch.sum(_moduli(q[lo:lo + b, None, :] - pool[None]), dim=-1)
                      for lo in range(0, q.shape[0], b)])


def pool_pass(q, pool, weigh, mm=None):
    """Scores block by block; `weigh(lo, f)` turns a block's (b, K) scores
    into dL/df. Returns (dL/dq (B, 2d), dL/dpool (K, 2d)): each difference
    divided by its modulus, 0 where the modulus is 0."""
    gq = torch.zeros_like(q)
    gpool = torch.zeros_like(pool)
    b = _block(q, pool)
    for lo in range(0, q.shape[0], b):
        x = (q[lo:lo + b, None, :] - pool[None]).unflatten(-1, (2, q.shape[-1] // 2))
        m = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
        w = weigh(lo, -torch.sum(m[..., 0, :], dim=-1))
        u = torch.where(m > 0, x / torch.where(m > 0, m, 1.0), 0.0).flatten(-2)
        ws = w[..., None] * u
        gq[lo:lo + b] = -torch.sum(ws, dim=1)
        gpool += torch.sum(ws, dim=0)
    return gq, gpool


# operations, counting each add, subtract, multiply, square root, cosine
# and sine as one; d is the complex width
def triple_flops(d: int, backward: bool) -> float:
    """One triple's score: the rotation (a cosine, a sine, four multiplies,
    two adds: 8d), the difference (2d), the moduli (two squares, an add, a
    square root: 4d) and the sum (d), 15d; its backward: each unit
    difference (a reciprocal, two multiplies: 3d), e_s's gradient (the
    upstream gradient rotated back: 6d) and theta's (two multiplies, an
    add: 3d), 12d; e_o's is the unit difference negated."""
    return 15 * d + (12 * d if backward else 0)


def query_flops(d: int, backward: bool) -> float:
    """The rotation (8d); its backward: the row's gradient rotated back
    (6d) and theta's (3d)."""
    return 8 * d + (9 * d if backward else 0)


def pair_flops(d: int, backward: bool) -> float:
    """One (query, pool row) score: two subtracts, two squares, an add, a
    square root and the sum's add, 7d; its backward: the modulus's
    reciprocal, its product with the upstream gradient, the two parts'
    products (4d) and the two rows' gradients, two adds each (4d), 8d."""
    return 7 * d + (8 * d if backward else 0)
