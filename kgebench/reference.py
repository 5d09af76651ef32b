"""The plain reference a run is judged against: pairwise margin training
with AdaGrad, and filtered top-k ranking. Part of the yardstick; plain
PyTorch on the benchmark's own inputs, importing nothing of the program.

Training follows scikit-kge's semantics, which the program states:

- the draws: an epoch permutation, `torch.randperm(n)`, then for each
  step a shared pool of k ids, `torch.randint(0, n_e, (k,))`, or for iid
  corruption `torch.randint(0, n_e, (len(modes), B))`, all from the
  run's draw generator in that order (`replay_draws`);
- batches of ceil(n / nbatches) rows of the permuted triples, the last
  padded with masked rows;
- the margin test on the activated scores: a pair (pos, neg) violates
  when af(neg) + margin > af(pos); the loss is the sum of
  margin + af(neg) - af(pos) over violating pairs;
- each table row's gradient is the sum of its occurrences' gradients
  divided by their count (a subject counts once for a pair that replaces
  it and twice for one that replaces the object; objects the other way;
  a relation twice; a pool or negative row once per violating pair);
- AdaGrad on the rows with a nonzero count: p2 += g * g,
  row -= lr * g / max(sqrt(p2), eps); then the model's row constraint
  (`normless1`: rows of norm above 1 scaled back to 1) on those rows.

`PRECISIONS` names the arithmetic: the reference runs in float64; the
controls run it in the precision just below the configuration's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    mm: Callable


PRECISIONS = {
    "fp64": Precision(torch.float64, torch.matmul),
    "bf16": Precision(torch.bfloat16, torch.matmul),
    "tf32": Precision(torch.float32, lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))),
}

ACTIVATIONS = {
    "linear": (lambda x: x, torch.ones_like),
    "sigmoid": (torch.sigmoid, lambda fx: fx * (1.0 - fx)),
}


def normless1(rows: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(rows * rows, dim=1, keepdim=True))
    return torch.where(norm > 1.0, rows / torch.clamp(norm, min=1e-30), rows)


POST = {"normless1": normless1}


def batch_layout(n: int, nbatches: int):
    """(batch size, padded length) of an epoch of `n` triples."""
    size = -(-n // nbatches)
    return size, size * nbatches


def replay_draws(traffic: dict, n_e: int, n: int, nbatches: int, steps: int,
                 generator: torch.Generator):
    """(epoch permutation, [each step's negatives]) for the first `steps`
    steps; a step's negatives are ('pool', ids, modes) or
    ('iid', [(mode, ids)])."""
    dev = generator.device
    perm = torch.randperm(n, generator=generator, device=dev)
    size, _ = batch_layout(n, nbatches)
    modes = list(traffic["modes"])
    negs = []
    for _ in range(steps):
        if traffic["sampler"] == "shared":
            negs.append(("pool", torch.randint(0, n_e, (traffic["k"],),
                                               generator=generator, device=dev),
                         tuple(modes)))
        else:
            modes_all = modes * traffic["negatives"]
            ids = torch.randint(0, n_e, (len(modes_all), size), generator=generator, device=dev)
            negs.append(("iid", list(zip(modes_all, ids))))
    return perm, negs


def epoch_batches(xs: torch.Tensor, perm: torch.Tensor, nbatches: int, steps: int):
    """The first `steps` (batch (B, 3), mask (B,)) of the permuted epoch."""
    n = xs.shape[0]
    size, padded = batch_layout(n, nbatches)
    idx = torch.cat([perm, perm.new_zeros(padded - n)])
    pos = torch.arange(padded, device=xs.device)
    return [(xs[idx[b * size:(b + 1) * size]], (pos[b * size:(b + 1) * size] < n))
            for b in range(steps)]


def _add(acc: dict, key, g):
    if g is not None:
        acc[key] = g if acc.get(key) is None else acc[key] + g


def margin_step(model, params: dict, p2: dict, batch, mask, neg, cfg: dict,
                prec: Precision):
    """One step; returns (params, p2, loss). `model` is the configuration's
    file under kgebench/models; tables and p2 are in `prec.dtype`."""
    dt, mm = prec.dtype, prec.mm
    margin = cfg["margin"]
    af, daf = ACTIVATIONS[model.AF]
    E, R = params["E"], params["R"]
    s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
    valid = mask
    leaf = {"es": E[s], "rp": R[p], "eo": E[o]}
    leaf = {k: v.detach().requires_grad_() for k, v in leaf.items()}
    with torch.enable_grad():
        fpos = model.score(leaf["es"], leaf["rp"], leaf["eo"], mm)
    gp = af(fpos.detach())
    loss = torch.zeros((), dtype=dt, device=E.device)
    grads: dict = {}
    m_mode: dict = {}
    ent_occ = []  # (ids, grads, counts) of pool or negative rows

    def pair_terms(gn, gpb, ok):
        fm = ((gn + margin > gpb) & ok).to(dt)
        return fm, torch.sum(fm * (margin + gn - gpb))

    if neg[0] == "pool":
        pool_idx = neg[1]
        pool = E[pool_idx]
        pool_count = torch.zeros(pool_idx.shape[0], dtype=dt, device=E.device)
        for mode in neg[2]:
            with torch.enable_grad():
                q = model.query(mode, leaf["es"], leaf["rp"], leaf["eo"], mm)
            m = torch.zeros(batch.shape[0], dtype=dt, device=E.device)

            def weigh(lo, f):
                nonlocal loss, pool_count
                gn = af(f)
                hi = lo + f.shape[0]
                fm, part = pair_terms(gn, gp[lo:hi, None], valid[lo:hi, None])
                loss = loss + part
                m[lo:hi] = torch.sum(fm, dim=1)
                pool_count = pool_count + torch.sum(fm, dim=0)
                return fm * daf(gn)

            gq, gpool = model.pool_pass(q.detach(), pool, weigh, mm)
            ent_occ.append((pool_idx, gpool, None))
            qg = torch.autograd.grad(q, list(leaf.values()), gq, allow_unused=True)
            for key, g in zip(leaf, qg):
                _add(grads, key, g)
            _add(m_mode, mode, m)
        ent_occ = [(pool_idx, sum(g for _, g, _ in ent_occ), pool_count)]
    else:
        for mode, repl in neg[1]:
            x = E[repl].detach().requires_grad_()
            rows = dict(leaf, **{("es" if mode == 0 else "eo"): x})
            with torch.enable_grad():
                f = model.score(rows["es"], rows["rp"], rows["eo"], mm)
            gn = af(f.detach())
            fm, part = pair_terms(gn, gp, valid)
            loss = loss + part
            w = fm * daf(gn)
            keys = [k for k in ("es", "rp", "eo") if rows[k] is not x] + ["x"]
            got = torch.autograd.grad(f, [rows[k] for k in keys[:-1]] + [x], w)
            for key, g in zip(keys, got):
                if key == "x":
                    ent_occ.append((repl, g, fm))
                else:
                    _add(grads, key, g)
            _add(m_mode, mode, fm)
    m_tot = sum(m_mode.values())
    pg = torch.autograd.grad(fpos, list(leaf.values()), -m_tot * daf(gp))
    for key, g in zip(leaf, pg):
        _add(grads, key, g)

    zero = torch.zeros_like(m_tot)
    cnt_s = sum((m if mode == 0 else 2 * m) for mode, m in m_mode.items()) + zero
    cnt_o = sum((m if mode == 1 else 2 * m) for mode, m in m_mode.items()) + zero
    gE = torch.zeros_like(E)
    cE = torch.zeros(E.shape[0], dtype=dt, device=E.device)
    gE.index_add_(0, s, grads["es"])
    cE.index_add_(0, s, cnt_s)
    gE.index_add_(0, o, grads["eo"])
    cE.index_add_(0, o, cnt_o)
    for ids, g, c in ent_occ:
        gE.index_add_(0, ids, g)
        cE.index_add_(0, ids, c)
    gR = torch.zeros_like(R)
    cR = torch.zeros(R.shape[0], dtype=dt, device=E.device)
    gR.index_add_(0, p, grads["rp"])
    cR.index_add_(0, p, 2 * m_tot)

    new_params, new_p2 = dict(params), dict(p2)
    for name, g, c in (("E", gE, cE), ("R", gR, cR)):
        g = g / torch.clamp(c, min=1.0)[:, None]
        acc = p2[name] + g * g
        rows = params[name] - cfg["lr"] * g / torch.clamp(torch.sqrt(acc), min=cfg["adagrad_eps"])
        post = model.POST.get(name)
        if post is not None:
            rows = POST[post](rows)
        touched = (c > 0)[:, None]
        new_params[name] = torch.where(touched, rows, params[name])
        new_p2[name] = torch.where(touched, acc, p2[name])
    return new_params, new_p2, loss


def train_steps(model, cfg: dict, traffic: dict, p0: dict, xs: torch.Tensor,
                generator: torch.Generator, steps: int, prec: Precision,
                half_batch: bool = False):
    """The first `steps` steps of an epoch from the tables `p0`: returns
    {"loss": [each step's loss], "p2_1": p2 after step 1, "params":
    the tables after the last step} in `prec.dtype`. `half_batch` plants
    a fault: the second half of every batch left out."""
    n = xs.shape[0]
    perm, negs = replay_draws(traffic, cfg["entities"], n, cfg["nbatches"], steps, generator)
    params = {k: v.to(prec.dtype) for k, v in p0.items()}
    p2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": []}
    for i, ((batch, mask), neg) in enumerate(zip(epoch_batches(xs, perm, cfg["nbatches"], steps),
                                                 negs)):
        if half_batch:
            mask = mask & (torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2)
        params, p2, loss = margin_step(model, params, p2, batch, mask, neg, cfg, prec)
        out["loss"].append(float(loss))
        if i == 0:
            out["p2_1"] = p2
    out["params"] = params
    return out


def known_index(triples: np.ndarray, n_r: int, direction: str):
    """Sorted keys entity * n_r + relation of the known triples, and the
    answers in that order, for (s, p) -> o ('o') or (o, p) -> s ('s')."""
    ent, ans = (triples[:, 0], triples[:, 1]) if direction == "o" else (triples[:, 1], triples[:, 0])
    keys = ent * n_r + triples[:, 2]
    order = np.argsort(keys, kind="stable")
    return keys[order], ans[order]


def known_answers(index, n_r: int, queries: np.ndarray):
    """(row, entity) of every known answer of each query."""
    keys, ans = index
    q = queries[:, 0] * n_r + queries[:, 1]
    lo, hi = np.searchsorted(keys, q, "left"), np.searchsorted(keys, q, "right")
    rows = np.repeat(np.arange(q.shape[0]), hi - lo)
    starts = np.repeat(lo - np.cumsum(np.r_[0, (hi - lo)[:-1]]), hi - lo)
    return rows, ans[starts + np.arange(rows.shape[0])]


def rank_scores(model, params: dict, queries: np.ndarray, index, direction: str,
                prec: Precision, block: int = 256):
    """(scores (Q, n_e) with known answers at -inf), in blocks of queries;
    yields (lo, scores) per block."""
    E, R = (params[k].to(prec.dtype) for k in ("E", "R"))
    n_r = R.shape[0]
    mode = 1 if direction == "o" else 0
    for lo in range(0, queries.shape[0], block):
        qb = queries[lo:lo + block]
        ent = torch.as_tensor(qb[:, 0], device=E.device)
        rel = torch.as_tensor(qb[:, 1], device=E.device)
        es, eo = (E[ent], None) if mode == 1 else (None, E[ent])
        q = model.query(mode, es, R[rel], eo, prec.mm)
        scores = model.pool_scores(q, E, prec.mm)
        rows, ents = known_answers(index, n_r, qb)
        scores[torch.as_tensor(rows, device=E.device),
               torch.as_tensor(ents, device=E.device)] = -float("inf")
        yield lo, scores
