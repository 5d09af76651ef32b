"""Training core of the port: margin, logistic, self-adversarial and
cross-entropy gradients, sparse updates, train steps and the epoch loop.

    gather rows -> score -> gradient w.r.t. the gathered rows
    -> duplicate-index segment averaging -> sparse optimizer update

Semantics are those of `skge_tpu.training`:

- pairwise margin ranking on violating pairs only; a batch with zero
  violations performs NO update at all;
- the pairwise margin test applies the model's `pairwise_af` first;
- pointwise logistic loss `sum(logaddexp(0, -y*f))`, negatives appended
  to the batch with y = -1;
- gradients are AVERAGED over duplicate row indices;
- `rparam * row` L2 and `n3` nuclear-3-norm regularization on the
  touched rows of `model.reg_row_params`;
- dense params (ER-MLP's W and C) take the batch's mean gradient.

Three families of margin and logistic gradient functions, chosen by the
sampler's protocol:

- iid negatives, `corruptions` protocol: `pairwise_grads_fused`, the
  reference-exact pairs with each base row gathered and scored once;
- iid negatives, expanded pairs: the generic `pairwise_grads` and
  `pointwise_grads`;
- a shared negative pool, `pool` protocol: `pairwise_grads_shared`,
  `pointwise_grads_shared`, and for models whose pool-pair W gradient is
  low-rank (`factored_pool_grads`, RESCAL) hand-derived paths that keep it
  factored (`FactoredOcc`) for the outer-product scatter.

Row gradients come from autograd over the gathered rows, except on the
factored paths. Beside them: the self-adversarial loss over a shared pool
(`selfadv_grads_shared`), full 1-vs-all cross entropy with full-table
gradients (`ce_grads_all`) and sampled cross entropy over a shared pool
(`sampled_ce_grads_shared`, whose duplicate rows add up: `combine="sum"`).

Batches are padded to a fixed size and masked, as in the JAX package, so
every step of an epoch has the same shapes. Random draws (epoch
permutation, negatives) come from the `torch.Generator` carried in
`TrainState`; they do not reproduce JAX's draws, so the parity tests pass
the JAX package's draws in (`perm=` and samplers that replay them).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from skge_torch.models.base import ACTIVATIONS, KGEModel, Params, acc_dtype
from skge_torch.ops import cuda_l1, cuda_outer, cuda_rotate, cuda_segment, grouping
from skge_torch.ops.aggregate import (
    WIDE_ROW,
    DenseGrads,
    FactoredOcc,
    count_channel,
    mean_of_channels,
    segment_mean_dense,
    segment_mean_unique,
    segment_outer_mean_dense,
)
from skge_torch.ops.cuda_segment import segment_sum
from skge_torch.optim import POST_CONSTRAINTS, Optimizer, OptState
from skge_torch.utils.metrics import span


class TrainState(NamedTuple):
    params: Params
    opt_state: OptState
    generator: torch.Generator
    step: int


def init_state(
    model: KGEModel, opt: Optimizer, generator: torch.Generator
) -> TrainState:
    """Fresh state on the generator's device; the same generator then
    drives the training draws."""
    params = model.init_params(generator)
    return TrainState(
        params=params, opt_state=opt.init(params), generator=generator, step=0
    )


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    nviolations: torch.Tensor


def _row_leaves(model: KGEModel, params: Params, s, o, p,
                gather: Optional[Callable] = None):
    """Each slot's gathered rows as an autograd leaf, so autograd gives one
    gradient row per occurrence. `gather(pname, idx, role)`, when given,
    fetches the rows instead of `params[pname][idx]` (the mesh steps pass
    one that reads a row-sharded table)."""
    idx = {"s": s, "o": o, "p": p}
    if gather is None:
        gather = _plain_gather(params)
    return {
        slot: gather(pname, idx[role], role).detach().requires_grad_()
        for slot, pname, role in model.slot_spec()
    }


def _plain_gather(params: Params) -> Callable:
    """The gather hook's default: `params[pname][idx]`."""
    return lambda pname, idx, role=None: params[pname][idx]


def _dense_leaves(model: KGEModel, params: Params):
    return {
        k: v.detach().requires_grad_()
        for k, v in model.dense_params(params).items()
    }


def _group_occurrences(model: KGEModel, batches):
    """Slot gradients -> {pname: (indices, grads, masks)}, concatenated over
    `batches`, each a (slot grads, (s, o, p), mask (B,))."""
    occ: dict = {}
    for slot, pname, role in model.slot_spec():
        idxs, grads, masks = occ.setdefault(pname, ([], [], []))
        for slot_grads, (s, o, p), mask in batches:
            idxs.append({"s": s, "o": o, "p": p}[role])
            grads.append(slot_grads[slot])
            masks.append(mask)
    return {
        pname: (torch.cat(i), torch.cat(g), torch.cat(m))
        for pname, (i, g, m) in occ.items()
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jnp.logaddexp(0, x)`; `F.softplus` turns linear
    above its threshold and so gives other values."""
    return torch.logaddexp(x.new_zeros(()), x)


def pointwise_grads(
    model: KGEModel,
    params: Params,
    triples: torch.Tensor,  # (B, 3) int64, (s, o, p)
    ys: torch.Tensor,       # (B,) float +-1
    mask: torch.Tensor,     # (B,) float {0, 1}
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Logistic loss over the (positives + appended negatives) batch.
    Returns (loss, occ, g_dense); occ = {pname: (indices, grads, mask)}.
    `gather` as in `_row_leaves`."""
    s, o, p = triples[:, 0], triples[:, 1], triples[:, 2]
    rows = _row_leaves(model, params, s, o, p, gather)
    dense = _dense_leaves(model, params)
    with torch.enable_grad():
        f = model.score_from_rows(rows, dense)
        loss = torch.sum(_softplus(-ys * f) * mask)
        grads = torch.autograd.grad(loss, [*rows.values(), *dense.values()])
    g_rows = dict(zip(rows, grads))
    occ = _group_occurrences(model, [(g_rows, (s, o, p), mask)])
    n_valid = torch.clamp(torch.sum(mask), min=1.0)
    g_dense = {k: g / n_valid for k, g in zip(dense, grads[len(rows):])}
    return loss.detach(), occ, g_dense


def pairwise_grads(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,   # (M, 3) positives, repeated per negative
    neg: torch.Tensor,   # (M, 3) corrupted triples
    mask: torch.Tensor,  # (M,) float {0, 1} pair validity (padding, sampler)
    margin: float,
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Margin ranking loss on violating pairs only, over the expanded pair
    list. Returns (loss, nviol, occ, g_dense); the occurrence mask is the
    violation mask. `gather` as in `_row_leaves`."""
    sop_p = (pos[:, 0], pos[:, 1], pos[:, 2])
    sop_n = (neg[:, 0], neg[:, 1], neg[:, 2])
    rows_p = _row_leaves(model, params, *sop_p, gather=gather)
    rows_n = _row_leaves(model, params, *sop_n, gather=gather)
    dense = _dense_leaves(model, params)
    af = ACTIVATIONS[model.pairwise_af][0]
    with torch.enable_grad():
        gp = af(model.score_from_rows(rows_p, dense))
        gn = af(model.score_from_rows(rows_n, dense))
        fm = ((gn + margin > gp) & (mask > 0)).to(gp.dtype).detach()
        loss = torch.sum(fm * (margin + gn - gp))
        grads = torch.autograd.grad(
            loss, [*rows_p.values(), *rows_n.values(), *dense.values()]
        )
    n = len(rows_p)
    occ = _group_occurrences(model, [
        (dict(zip(rows_p, grads[:n])), sop_p, fm),
        (dict(zip(rows_n, grads[n:2 * n])), sop_n, fm),
    ])
    nviol = torch.sum(fm)
    g_dense = {
        k: g / torch.clamp(nviol, min=1.0) for k, g in zip(dense, grads[2 * n:])
    }
    return loss.detach(), nviol, occ, g_dense


def pairwise_grads_fused(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,   # (B, 3) int64 positives, NOT repeated
    corruptions,         # [(mode, replacement (B,), valid (B,)), ...]
    mask: torch.Tensor,  # (B,) batch validity
    margin: float,
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Structurally fused pairwise gradients: the reference's pairs, each
    base row gathered and the positive scored once.

    Every sampler corrupts ONE role per negative, so a (positive,
    corruption) pair shares the positive's rows and score. The per-pair
    gradients that hit the same row are pre-summed, and the reference's
    duplicate-index AVERAGING is kept by carrying the structural occurrence
    COUNTS into the `premasked` aggregation (m_c = pair c's violation mask):

        cnt(s)   = sum_c m_c + sum_{c: mode_c != 0} m_c
        cnt(o)   = sum_c m_c + sum_{c: mode_c != 1} m_c
        cnt(rel) = 2 * sum_c m_c
        cnt(corrupted entity of c) = m_c

    All replacement rows come from ONE gather. The corruptions of one mode
    are scored as one (n_mode, B, ·) stack, so the number of scoring ops
    does not grow with the number of negatives; only the summation order of
    the base rows' gradients differs from the JAX package's loop.
    """
    b = pos.shape[0]
    # one mode's corruptions next to each other: its rows are one view of
    # the fused gather
    corr = sorted(corruptions, key=lambda c: c[0])
    n_by_mode = Counter(mode for mode, _, _ in corr)  # in sorted order
    all_repl = torch.cat([repl for _, repl, _ in corr])
    role_idx, epname, rows, crows, dense = _leaves(model, params, pos, all_repl,
                                                   gather, "corr")
    slot_of_mode = {mode: next(slot for slot, _, role in model.slot_spec()
                               if role == {0: "s", 1: "o"}[mode]) for mode in n_by_mode}
    ok = torch.stack([valid > 0 for _, _, valid in corr]) & (mask > 0)
    af = ACTIVATIONS[model.pairwise_af][0]

    fms = {}  # mode -> (n_mode, B) violation masks
    with torch.enable_grad():
        gp = af(model.score_from_rows(rows, dense))  # (B,)
        loss = 0.0
        lo = 0
        for mode, n in n_by_mode.items():
            stack = crows[lo * b:(lo + n) * b].reshape(n, b, *crows.shape[1:])
            gn = af(model.score_from_rows({**rows, slot_of_mode[mode]: stack}, dense))
            fm = ((gn + margin > gp) & ok[lo:lo + n]).to(gp.dtype).detach()
            fms[mode] = fm
            loss = loss + torch.sum(fm * (margin + gn - gp))
            lo += n
        grads = torch.autograd.grad(loss, [*rows.values(), crows, *dense.values()])

    m_by_mode = {mode: torch.sum(fm, dim=0) for mode, fm in fms.items()}
    m_sum = sum(m_by_mode.values())
    nviol = torch.sum(m_sum)
    counts = {
        role: m_sum + sum(m for mode, m in m_by_mode.items() if mode != mode_of_role)
        for role, mode_of_role in (("s", 0), ("o", 1))
    }
    counts["p"] = 2.0 * m_sum
    occ = _group_slots(
        model, role_idx, epname, dict(zip(rows, grads)), counts,
        all_repl, grads[len(rows)], torch.cat(list(fms.values())).reshape(-1),
    )
    g_dense = {
        k: g / torch.clamp(nviol, min=1.0)
        for k, g in zip(dense, grads[len(rows) + 1:])
    }
    return loss.detach(), nviol, occ, g_dense


def _leaves(model: KGEModel, params: Params, pos: torch.Tensor,
            ent_idx: torch.Tensor, gather: Optional[Callable] = None,
            ent_role: str = "pool"):
    """The rows of each slot, the entity rows `ent_idx` (a shared pool, or
    every corruption's replacement) and the dense params as autograd
    leaves. Returns (role -> ids, entity param name, rows, entity rows,
    dense).

    `gather(pname, idx, role)`, when given, fetches every row instead of
    `params[pname][idx]`: the slots' with their role ('s', 'o', 'p') and
    the entity rows with `ent_role` ('pool' or 'corr'). The partitioned
    step passes one that reaches rows other ranks own."""
    role_idx = {"s": pos[:, 0], "o": pos[:, 1], "p": pos[:, 2]}
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    if epname != slot_by_role["o"][1]:
        raise ValueError("subjects and objects must share one entity table")
    if gather is None:
        gather = _plain_gather(params)
    rows = _row_leaves(model, params, role_idx["s"], role_idx["o"], role_idx["p"],
                       gather)
    ent_rows = gather(epname, ent_idx, ent_role).detach().requires_grad_()
    return role_idx, epname, rows, ent_rows, _dense_leaves(model, params)


def _group_slots(model: KGEModel, role_idx, epname, g_rows, counts,
                 ent_idx, g_ent, ent_counts):
    """{pname: (ids, grads, counts)} over the slots, then the entity rows
    of `_leaves` appended to the entity table's list; `counts` maps
    role -> (B,)."""
    occ: dict = {}
    for slot, pname, role in model.slot_spec():
        idxs, gs, cs = occ.setdefault(pname, ([], [], []))
        idxs.append(role_idx[role])
        gs.append(g_rows[slot])
        cs.append(counts[role])
    idxs, gs, cs = occ[epname]
    idxs.append(ent_idx)
    gs.append(g_ent)
    cs.append(ent_counts)
    return {
        k: (torch.cat(i), torch.cat(g), torch.cat(c))
        for k, (i, g, c) in occ.items()
    }


def pairwise_grads_shared(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    margin: float,
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Shared-negative-pool pairwise gradients (PBG/DGL-KE scheme).

    Every positive b is ranked against every pool entity k substituted into
    each role in `modes`, with the reference's per-pair semantics, without
    materializing the B*K*|modes| pair list.

    Occurrence counts for the duplicate averaging (m_mode[b] = number of
    violating pairs of that mode for positive b):

        cnt(s_b)    = 2*m_o[b] + m_s[b]
        cnt(o_b)    = m_o[b] + 2*m_s[b]
        cnt(rel_b)  = 2*(m_o[b] + m_s[b])
        cnt(pool_k) = sum_b fm_o[b,k] + fm_s[b,k]

    Returns (loss, nviol, occ, g_dense) with occ = {pname: (indices, grads,
    counts)}; the grads are already weighted by the violation mask.
    `gather` as in `_leaves` (the pool's role is 'pool').
    """
    role_idx, epname, rows, pool_rows, dense = _leaves(
        model, params, pos, pool_idx, gather
    )
    af = ACTIVATIONS[model.pairwise_af][0]
    valid = (mask > 0)[:, None]

    with torch.enable_grad():
        gp = af(model.score_from_rows(rows, dense))  # (B,)
        loss = 0.0
        fms = []
        f_negs = model.score_pool_modes(rows, pool_rows, dense, tuple(modes))
        for f_neg in f_negs:
            gn = af(f_neg)  # (B, K)
            fm = ((gn + margin > gp[:, None]) & valid).to(gp.dtype).detach()
            fms.append(fm)
            loss = loss + torch.sum(fm * (margin + gn - gp[:, None]))
        leaves = [*rows.values(), pool_rows, *dense.values()]
        grads = torch.autograd.grad(loss, leaves)
    g_rows = dict(zip(rows, grads))
    g_pool = grads[len(rows)]
    g_dense = dict(zip(dense, grads[len(rows) + 1:]))
    loss = loss.detach()

    m = [torch.sum(fm, dim=1) for fm in fms]  # per-positive violation counts
    m_total = sum(m)
    nviol = torch.sum(m_total)

    counts = {
        role: sum(mm * (1.0 if mode == mode_of_role else 2.0)
                  for mode, mm in zip(modes, m))
        for role, mode_of_role in (("s", 0), ("o", 1))
    }
    counts["p"] = 2.0 * m_total
    occ = _group_slots(
        model, role_idx, epname, g_rows, counts,
        pool_idx, g_pool, sum(torch.sum(fm, dim=0) for fm in fms),
    )
    g_dense = {k: v / torch.clamp(nviol, min=1.0) for k, v in g_dense.items()}
    return loss, nviol, occ, g_dense


def _bilinear_rows(params: Params, pos: torch.Tensor, pool_idx: torch.Tensor,
                   gather: Optional[Callable] = None):
    """RESCAL's gathered rows in the accumulation dtype, and its (B, d)
    queries q = e_s W_p (object pool) and r = W_p e_o (subject pool).
    `gather` as in `_leaves` (the pool's role is 'pool')."""
    g = _plain_gather(params) if gather is None else gather
    acc = acc_dtype(params["E"])
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    es, eo, wp, pool = (x.to(acc) for x in (
        g("E", s, "s"), g("E", o, "o"), g("W", p, "p"), g("E", pool_idx, "pool")))
    q = torch.einsum("bi,bij->bj", es, wp)
    r = torch.einsum("bij,bj->bi", wp, eo)
    return (s, o, p), (es, eo, wp, pool), q, r


def pairwise_grads_shared_bilinear(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    margin: float,
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """RESCAL shared-pool gradients with the W cotangent kept FACTORED.

    The same result as `pairwise_grads_shared`, derived by hand so the
    (B, d, d) per-positive W gradient never materializes. It is rank-2 per
    positive:

        score(s, e, p) = q_b . e   with  q_b = e_s W_p       (object pool)
        score(e, o, p) = r_b . e   with  r_b = W_p e_o       (subject pool)
        =>  dL/dW_{p_b} = e_s (x) dL/dq_b  +  dL/dr_b (x) e_o

    so W's occurrences come back as a `FactoredOcc` of (u, v) factor pairs
    for `segment_outer_mean_dense`. Occurrence counts are those of
    `pairwise_grads_shared`; W's is 2 per violating pair. `gather` as in
    `_leaves`.
    """
    if model.pairwise_af != "linear":
        raise ValueError("the factored path needs raw (linear) pair scores")
    (s, o, p), (es, eo, wp, pool), q, r = _bilinear_rows(params, pos, pool_idx, gather)
    acc = q.dtype
    gp = torch.sum(q * eo, dim=-1)  # (B,)
    valid = (mask > 0)[:, None]

    loss = torch.zeros((), dtype=acc, device=q.device)
    m_by_mode = {}
    fm_colsum = torch.zeros(pool.shape[0], dtype=acc, device=q.device)
    dq = torch.zeros_like(q)
    dr = torch.zeros_like(r)
    dpool = torch.zeros_like(pool)
    for mode in modes:
        query = q if mode == 1 else r
        gn = model.mxu(query, pool.T)  # (B, K)
        fm = ((gn + margin > gp[:, None]) & valid).to(acc)
        loss = loss + torch.sum(fm * (margin + gn - gp[:, None]))
        m_by_mode[mode] = torch.sum(fm, dim=1)
        fm_colsum = fm_colsum + torch.sum(fm, dim=0)
        # dL/dgn = fm  =>  d(query) += fm @ pool ; dpool += fm^T @ query
        dquery = fm @ pool
        dpool = dpool + fm.T @ query
        if mode == 1:
            dq = dq + dquery
        else:
            dr = dr + dquery
    m_total = sum(m_by_mode.values())
    nviol = torch.sum(m_total)
    # dL/dgp_b = -(violations of b), through gp = q . eo
    dq = dq - m_total[:, None] * eo
    des = torch.einsum("bij,bj->bi", wp, dq)
    deo = -m_total[:, None] * q + torch.einsum("bij,bi->bj", wp, dr)

    cnt_s = sum(mm * (1.0 if mode == 0 else 2.0) for mode, mm in m_by_mode.items())
    cnt_o = sum(mm * (1.0 if mode == 1 else 2.0) for mode, mm in m_by_mode.items())
    occ = {
        "E": (
            torch.cat([s, o, pool_idx]),
            torch.cat([des, deo, dpool]),
            torch.cat([cnt_s, cnt_o, fm_colsum]),
        ),
        # the relation row sits in both triples of a violating pair
        "W": FactoredOcc(idx=p, us=(es, dr), vs=(dq, eo), count=2.0 * m_total),
    }
    return loss, nviol, occ, {}


def pointwise_grads_shared(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Shared-pool POINTWISE (logistic) gradients.

    The batch is the positives (y = +1) plus every (positive, pool entity,
    mode) corruption (y = -1); loss `sum(logaddexp(0, -y*f))`, gradients
    averaged over duplicate occurrences. Occurrence counts per valid
    positive b (K = pool size):

        cnt(s_b)    = 1 + K*|{m in modes: m != 0}|
        cnt(o_b)    = 1 + K*|{m in modes: m != 1}|
        cnt(rel_b)  = 1 + K*|modes|
        cnt(pool_k) = |modes| * sum_b mask_b

    Returns (loss, occ, g_dense), occ as in `pairwise_grads_shared`.
    `gather` as in `_leaves`.
    """
    role_idx, epname, rows, pool_rows, dense = _leaves(
        model, params, pos, pool_idx, gather
    )
    mask = mask.to(acc_dtype(pool_rows))

    with torch.enable_grad():
        f_pos = model.score_from_rows(rows, dense)             # (B,)
        loss = torch.sum(_softplus(-f_pos) * mask)             # y = +1
        for f_neg in model.score_pool_modes(rows, pool_rows, dense, tuple(modes)):
            loss = loss + torch.sum(_softplus(f_neg) * mask[:, None])  # y = -1
        grads = torch.autograd.grad(loss, [*rows.values(), pool_rows, *dense.values()])
    occ, g_dense = _pool_element_occurrences(
        model, role_idx, epname, rows, dense, grads, pool_idx, mask, modes)
    return loss.detach(), occ, g_dense


def _pool_element_occurrences(model: KGEModel, role_idx, epname, rows, dense,
                              grads, pool_idx, mask, modes):
    """(occ, g_dense) of a loss over every (positive, pool entity, mode)
    element of a shared pool, `grads` being autograd's over (rows, pool
    rows, dense). ELEMENT counts: each expanded element is one occurrence,
    whatever its weight in the loss."""
    k = pool_idx.shape[0]
    counts = {
        role: (1.0 + k * sum(1 for m in modes if m != mode_of_role)) * mask
        for role, mode_of_role in (("s", 0), ("o", 1))
    }
    counts["p"] = (1.0 + k * len(modes)) * mask
    occ = _group_slots(
        model, role_idx, epname, dict(zip(rows, grads)), counts, pool_idx,
        grads[len(rows)],
        torch.full((k,), float(len(modes)), dtype=mask.dtype,
                   device=mask.device) * torch.sum(mask),
    )
    n_elems = torch.clamp(torch.sum(mask) * (1.0 + k * len(modes)), min=1.0)
    g_dense = {kk: v / n_elems for kk, v in zip(dense, grads[len(rows) + 1:])}
    return occ, g_dense


def selfadv_grads_shared(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    margin: float,
    alpha: float = 1.0,
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Shared-pool self-adversarial gradients (Sun et al. 2019, RotatE).
    Per valid positive b, with pool scores f[b, k] per corruption mode:

        L_b = softplus(-(f_b + margin))
              + sum_mode sum_k w[b,k] * softplus(f[b,k] + margin)
        w[b,k] = softmax_k(alpha * f[b,k])        (detached)

    alpha = 0 is the unweighted mean pool logistic loss. Occurrence counts
    are element counts, as in `pointwise_grads_shared`. Returns (loss, occ,
    g_dense). `gather` as in `_leaves`.
    """
    role_idx, epname, rows, pool_rows, dense = _leaves(
        model, params, pos, pool_idx, gather
    )
    mask = mask.to(acc_dtype(pool_rows))

    with torch.enable_grad():
        f_pos = model.score_from_rows(rows, dense)             # (B,)
        loss = torch.sum(_softplus(-(f_pos + margin)) * mask)
        for f_neg in model.score_pool_modes(rows, pool_rows, dense, tuple(modes)):
            w = torch.softmax(alpha * f_neg, dim=1).detach()  # (B, K)
            loss = loss + torch.sum(w * _softplus(f_neg + margin) * mask[:, None])
        grads = torch.autograd.grad(loss, [*rows.values(), pool_rows, *dense.values()])
    occ, g_dense = _pool_element_occurrences(
        model, role_idx, epname, rows, dense, grads, pool_idx, mask, modes)
    return loss.detach(), occ, g_dense


def ce_grads_all(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    mask: torch.Tensor,       # (B,) batch validity
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
):
    """Full cross-entropy (1-vs-all) loss and FULL-TABLE gradients.

    Each positive is scored against every entity in the corrupted role
    (`score_all_o` / `score_all_s`), with the true entity as the label:

        L = mean_valid [ logZ(s,p) - f(s,p,o) ]        (direction 'o')
          + mean_valid [ logZ(o,p) - f(s,p,o) ]        (direction 's')

    With `label_smoothing` = ls the target is (1-ls)*onehot + ls/n_e. The
    partition function touches every entity row, so there is no occurrence
    scatter: returns (loss, {pname: full-table gradient}).
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    n_valid = torch.clamp(torch.sum(mask), min=1.0)
    barange = torch.arange(pos.shape[0], device=pos.device)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        total = 0.0
        for d in directions:
            if d == "o":
                logits, labels = model.score_all_o(leaves, s, p), o
            elif d == "s":
                logits, labels = model.score_all_s(leaves, o, p), s
            else:
                raise ValueError(f"direction {d!r} (want 'o'/'s')")
            logp = torch.log_softmax(logits, dim=1)
            nll = -logp[barange, labels]
            if label_smoothing:
                nll = ((1.0 - label_smoothing) * nll
                       - label_smoothing * torch.mean(logp, dim=1))
            total = total + torch.sum(nll * mask)
        loss = total / n_valid
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def sampled_ce_grads_shared(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared candidate entity ids
    mask: torch.Tensor,       # (B,) batch validity
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    log_q: Optional[torch.Tensor] = None,  # (K,) proposal log-probs
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
    n_domain: Optional[int] = None,  # candidate-domain size, n_e by default
):
    """Sampled softmax cross entropy over a shared candidate pool.

    The partition function is estimated with the importance-corrected
    EXCLUSION form (q = the pool's proposal, uniform 1/n_e without `log_q`):

        Zhat_b = exp(f_pos_b)
               + sum_k [pool_k != label_b] * exp(f[b,k] - log(K*q_k))
        nll_b  = log Zhat_b - f_pos_b

    A pool entity equal to the label gets a -inf logit, whose gradient is
    0. With K = n_e and the pool `arange(n_e)` the correction vanishes and
    this is `ce_grads_all`. Label smoothing uses the same estimator of the
    mean logit. `n_domain` replaces n_e in the default uniform proposal and
    the smoothing denominator (the out-of-core trainer's resident rows). The gradients are plain sums of the mean-over-valid loss:
    apply them with `premasked=True, combine="sum"`. Returns (loss, occ,
    g_dense); the counts only gate validity. `gather` as in `_leaves`.
    """
    role_idx, epname, rows, pool_rows, dense = _leaves(
        model, params, pos, pool_idx, gather
    )
    k = pool_idx.shape[0]
    n_e = model.n_entities if n_domain is None else n_domain
    ls = float(label_smoothing)
    n_valid = torch.clamp(torch.sum(mask), min=1.0)
    if log_q is None:
        log_q = -torch.log(torch.full((k,), float(n_e), dtype=mask.dtype,
                                      device=mask.device))
    corr = -(math.log(float(k)) + log_q)          # (K,) importance correction
    mode_of = {"o": 1, "s": 0}
    with torch.enable_grad():
        f_pos = model.score_from_rows(rows, dense)             # (B,)
        total = 0.0
        f_pools = model.score_pool_modes(
            rows, pool_rows, dense, tuple(mode_of[d] for d in directions))
        for d, f_pool in zip(directions, f_pools):            # (B, K) each
            hit = pool_idx[None, :] == role_idx[d][:, None]
            logits = torch.where(hit, -math.inf, f_pool + corr[None, :])
            logz = torch.logsumexp(torch.cat([f_pos[:, None], logits], dim=1), dim=1)
            nll = logz - f_pos
            if ls:
                # (f_label + sum_k [k != label] f_k / (K q_k)) / n_e - logZhat
                wsum = torch.where(hit, 0.0, f_pool * torch.exp(corr)[None, :]).sum(dim=1)
                nll = (1.0 - ls) * nll - ls * ((f_pos + wsum) / n_e - logz)
            total = total + torch.sum(nll * mask)
        loss = total / n_valid
        grads = torch.autograd.grad(loss, [*rows.values(), pool_rows, *dense.values()])
    counts = dict.fromkeys(("s", "o", "p"), mask)
    occ = _group_slots(
        model, role_idx, epname, dict(zip(rows, grads)), counts, pool_idx,
        grads[len(rows)], torch.ones(k, dtype=mask.dtype, device=mask.device),
    )
    return loss.detach(), occ, dict(zip(dense, grads[len(rows) + 1:]))


def pointwise_grads_shared_bilinear(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """RESCAL shared-pool POINTWISE gradients, W cotangent factored.

    Same contract as `pointwise_grads_shared`, through the algebra of
    `pairwise_grads_shared_bilinear`:

        dL/df_pos = -sigmoid(-f_pos) * mask          (y = +1)
        dL/df_neg =  sigmoid(f_neg) * mask           (y = -1)
        dW_{p_b}  = e_s (x) dq_b + dr_b (x) e_o

    `gather` as in `_leaves`.
    """
    (s, o, p), (es, eo, wp, pool), q, r = _bilinear_rows(params, pos, pool_idx, gather)
    mask = mask.to(q.dtype)
    k = pool_idx.shape[0]
    f_pos = torch.sum(q * eo, dim=-1)

    loss = torch.sum(_softplus(-f_pos) * mask)
    c_pos = -torch.sigmoid(-f_pos) * mask  # (B,)
    dq = c_pos[:, None] * eo
    dr = torch.zeros_like(r)
    dpool = torch.zeros_like(pool)
    for mode in modes:
        query = q if mode == 1 else r
        f_neg = model.mxu(query, pool.T)  # (B, K)
        loss = loss + torch.sum(_softplus(f_neg) * mask[:, None])
        c_neg = torch.sigmoid(f_neg) * mask[:, None]
        dquery = c_neg @ pool
        dpool = dpool + c_neg.T @ query
        if mode == 1:
            dq = dq + dquery
        else:
            dr = dr + dquery
    des = torch.einsum("bij,bj->bi", wp, dq)
    deo = c_pos[:, None] * q + torch.einsum("bij,bi->bj", wp, dr)

    n_other = {role: sum(1 for m in modes if m != role) for role in (0, 1)}
    occ = {
        "E": (
            torch.cat([s, o, pool_idx]),
            torch.cat([des, deo, dpool]),
            torch.cat([
                (1.0 + k * n_other[0]) * mask,
                (1.0 + k * n_other[1]) * mask,
                torch.full((k,), float(len(modes)), dtype=mask.dtype,
                           device=mask.device) * torch.sum(mask),
            ]),
        ),
        "W": FactoredOcc(idx=p, us=(es, dr), vs=(dq, eo),
                         count=(1.0 + k * len(modes)) * mask),
    }
    return loss, occ, {}


def regularized(model: KGEModel, pname: str, grads: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """`grads` of the param rows `rows` plus the row regularizers of
    `model.reg_row_params`: `rparam * row` (L2) and `3 * n3 * n3_grad_rows`
    (the nuclear 3-norm), each only where its coefficient is nonzero."""
    if pname not in model.reg_row_params:
        return grads
    reg, reg3 = model.regularization, model.regularization_n3
    if reg != 0.0:
        grads = grads + reg * model.reg_grad_rows(pname, rows)
    if reg3 != 0.0:
        grads = grads + (3.0 * reg3) * model.n3_grad_rows(pname, rows)
    return grads


# the JAX package's dense aggregate modes; here all scatter through the
# CUDA kernels
_DENSE_MODES = ("dense", "dense_pallas", "dense_sorted")


def _summed(grads: torch.Tensor, count: torch.Tensor, combine: str) -> torch.Tensor:
    """Averaged rows as they are (`combine="mean"`), or multiplied back by
    their counts (`"sum"`)."""
    if combine == "mean":
        return grads
    return grads * count.reshape((-1,) + (1,) * (grads.dim() - 1))


def _grouped(model: KGEModel, occ):
    """[(tables, ids, grads, counts, rows)]: the tables of `occ` other than
    a `FactoredOcc`'s, grouped by feature shape, each group's occurrences
    offset into one stacked table of `rows` rows."""
    groups: dict = {}
    for pname, o in occ.items():
        if not isinstance(o, FactoredOcc):
            groups.setdefault(o[1].shape[1:], []).append(pname)
    out = []
    for names in groups.values():
        offsets, total = {}, 0
        for pname in names:
            offsets[pname] = total
            total += model.num_rows(pname)
        out.append((tuple(names), torch.cat([occ[p][0] + offsets[p] for p in names]),
                    torch.cat([occ[p][1] for p in names]),
                    torch.cat([occ[p][2] for p in names]), total))
    return out


def _dense_aggregate(model: KGEModel, occ, premasked: bool):
    """The dense modes' scatters: [(tables, DenseGrads)], one entry a
    scatter. A `FactoredOcc` table takes `segment_outer_mean_dense` alone;
    each `_grouped` group takes one `segment_mean_dense` (TransE's E and R:
    one `segment_sum` a step)."""
    units = [((pname,), segment_outer_mean_dense(o, model.num_rows(pname)))
             for pname, o in occ.items() if isinstance(o, FactoredOcc)]
    for names, cidx, cg, cm, total in _grouped(model, occ):
        units.append((names, segment_mean_dense(cidx, cg, cm, total, premasked)))
    return units


def _dense_update(model: KGEModel, opt: Optimizer, params: Params,
                  opt_state: OptState, units, g_dense: Params,
                  step: Optional[int], combine: str) -> Tuple[Params, OptState]:
    """The dense modes' updates: each table of each `_dense_aggregate` unit
    (a stacked group split back by rows) through `regularized` and
    `apply_dense_masked`, then each dense param through `apply_full`.
    Returns new dicts; the inputs are left as they were."""
    params, opt_state = dict(params), dict(opt_state)
    for names, dg in units:
        lo = 0
        for pname in names:
            hi = lo + model.num_rows(pname)
            count = dg.count[lo:hi]
            grads = regularized(model, pname, _summed(dg.grads[lo:hi], count, combine),
                                params[pname])
            params[pname], opt_state[pname] = opt.apply_dense_masked(
                params[pname], opt_state[pname], DenseGrads(grads=grads, count=count),
                model.post_constraints.get(pname), step=step,
            )
            lo = hi
    for pname, g in g_dense.items():
        params[pname], opt_state[pname] = opt.apply_full(
            params[pname], opt_state[pname], g, step=step
        )
    return params, opt_state


def apply_gradients(
    model: KGEModel,
    opt: Optimizer,
    params: Params,
    opt_state: OptState,
    occ,                      # {pname: (indices, grads, mask_or_counts) | FactoredOcc}
    g_dense: Params,
    aggregate: str = "unique",  # 'unique' | 'dense' | 'dense_pallas' | 'dense_sorted'
    premasked: bool = False,    # occ grads pre-weighted, mask = counts
    step: Optional[int] = None,  # the global step, for lr schedules
    combine: str = "mean",      # 'mean' (duplicate averaging) | 'sum'
) -> Tuple[Params, OptState]:
    """Aggregate the occurrence gradients and update the touched rows.

    The three dense modes keep the JAX package's names and all scatter
    through the CUDA kernels: `segment_sum`, and `segment_outer_sum` for a
    `FactoredOcc` (RESCAL's W). Row params with the same feature shape
    (TransE's E and R) share ONE scatter into a stacked table, split after,
    so a TransE step launches `segment_sum` once (`_dense_aggregate`, then
    `_dense_update`). Under 'unique' a
    `FactoredOcc`'s outer products are materialized batch-locally, as in
    the JAX package. `rparam` adds `rparam * row`, and `n3` adds
    `3 * n3 * model.n3_grad_rows(row)`, to the averaged gradient of each
    touched row of `model.reg_row_params` (per table, after a grouped
    scatter is split; under the dense modes over the whole table, which
    the optimizer's mask then limits to the touched rows). `combine="sum"`
    multiplies each averaged row back by its count, so duplicate
    occurrences add up (sampled cross entropy); on the dense modes that is
    the kernel's atomic fp32 sum divided and multiplied again, not a plain
    sum bit for bit.
    """
    if aggregate != "unique" and aggregate not in _DENSE_MODES:
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    if combine not in ("mean", "sum"):
        raise ValueError(f"unknown combine {combine!r}")
    if aggregate in _DENSE_MODES:
        with span("skge_torch.train.aggregate"):
            units = _dense_aggregate(model, occ, premasked)
        with span("skge_torch.train.update"):
            return _dense_update(model, opt, params, opt_state, units, g_dense, step,
                                 combine)
    params = dict(params)
    opt_state = dict(opt_state)
    for pname, f in list(occ.items()):
        if isinstance(f, FactoredOcc):
            outers = sum(u[:, :, None] * v[:, None, :] for u, v in zip(f.us, f.vs))
            occ = {**occ, pname: (f.idx, outers, f.count)}
    for pname, (idx, g, m) in occ.items():
        with span("skge_torch.train.aggregate"):
            ug = segment_mean_unique(idx, g, m, model.num_rows(pname), premasked)
        with span("skge_torch.train.update"):
            ug = ug._replace(grads=regularized(
                model, pname, _summed(ug.grads, ug.count, combine), params[pname][ug.uidx]))
            params[pname], opt_state[pname] = opt.apply_unique(
                params[pname], opt_state[pname], ug,
                model.post_constraints.get(pname), step=step,
            )
    for pname, g in g_dense.items():
        with span("skge_torch.train.update"):
            params[pname], opt_state[pname] = opt.apply_full(
                params[pname], opt_state[pname], g, step=step
            )
    return params, opt_state


def select_shared_pairwise_fn(model: KGEModel):
    """Shared-pool pairwise gradient dispatch: models whose pool-pair W
    gradient is low-rank (RESCAL) take the hand-derived factored path, the
    rest the generic autograd path."""
    if getattr(model, "factored_pool_grads", False) and model.pairwise_af == "linear":
        return pairwise_grads_shared_bilinear
    return pairwise_grads_shared


def select_shared_pointwise_fn(model: KGEModel):
    """Shared-pool pointwise gradient dispatch (see above)."""
    if getattr(model, "factored_pool_grads", False):
        return pointwise_grads_shared_bilinear
    return pointwise_grads_shared


def draw_corruptions(sampler, generator: torch.Generator, batch: torch.Tensor,
                     mask: torch.Tensor, rows: Optional[int] = None):
    """`sampler.corruptions` for the batch, drawn for its first `rows` rows
    only (all of them by default) and padded with masked entries (id 0,
    validity 0) to the batch's length, so a padded batch takes the draws of
    the unpadded one (`make_epoch_fn(pad_to=)`)."""
    b = batch.shape[0]
    if rows is None or rows == b:
        return sampler.corruptions(generator, batch, mask)
    pad = b - rows
    return [(mode, torch.cat([repl, repl.new_zeros(pad)]),
             torch.cat([valid, valid.new_zeros(pad)]))
            for mode, repl, valid in sampler.corruptions(generator, batch[:rows],
                                                         mask[:rows])]


def draw_expanded(sampler, generator: torch.Generator, batch: torch.Tensor,
                  mask: torch.Tensor, rows: Optional[int] = None):
    """The sampler's expanded pairs (positives repeated, negatives, pair
    mask) of the batch's first `rows` rows (all by default): the padding
    rows of a padded batch, masked, have no pairs."""
    if rows is not None:
        batch, mask = batch[:rows], mask[:rows]
    return sampler(generator, batch, mask)


def make_pairwise_update(
    model: KGEModel, opt: Optimizer, margin: float, aggregate: str = "unique"
):
    """Pre-sampled pairwise update: (state, pos_rep, neg, pair_mask) ->
    (state, metrics), through the generic `pairwise_grads`."""

    def update(state: TrainState, pos_rep, neg, pair_mask):
        loss, nviol, occ, g_dense = pairwise_grads(
            model, state.params, pos_rep, neg, pair_mask, margin
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense, aggregate,
            step=state.step,
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=nviol)

    return update


def make_pointwise_update(model: KGEModel, opt: Optimizer, aggregate: str = "unique"):
    """Pre-sampled pointwise update: (state, triples, ys, mask) -> (state,
    metrics), through the generic `pointwise_grads`."""

    def update(state: TrainState, triples, ys, mask):
        loss, occ, g_dense = pointwise_grads(model, state.params, triples, ys, mask)
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense, aggregate,
            step=state.step,
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=torch.zeros_like(loss))

    return update


def make_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,
    margin: float,
    aggregate: str = "unique",
    fused: bool = True,
    graphs: bool = True,
):
    """One pairwise step: sample negatives, rank, update on violations.

    With `fused` set, a sampler with the `pool` protocol
    (`SharedNegativeSampler`) takes the shared-pool path and one with the
    `corruptions` protocol (every iid sampler) the fused path,
    `pairwise_grads_fused`. `fused=False`, or a sampler with neither
    protocol, takes the generic path over the sampler's expanded pairs: the
    same math, more gathers and scatters.

    The step is `step(state, batch, mask, rows=None)`; `rows` (given by
    `make_epoch_fn(pad_to=)` for a padded batch) draws the iid negatives
    for the first `rows` rows only, as for the unpadded batch. Every step
    factory of this module takes `rows`; the shared pool's draw does not
    depend on the batch.

    Where `graphs_eligible` holds (the shared-pool path on a dense
    aggregate mode, an optimizer without a schedule), the step is a
    `PoolStepGraphs`: on the card it replays CUDA graphs from its second
    call on, and the state it returns holds its own buffers, which its
    next call updates in place. A caller that keeps a returned state
    across later steps clones it. `graphs=False` keeps the eager step.
    """
    if fused and hasattr(sampler, "pool"):
        shared_fn = select_shared_pairwise_fn(model)

        def grads_fn(state, batch, mask, rows):
            with span("skge_torch.train.sample"):
                pool_idx = sampler.pool(state.generator, batch, mask)
            with span("skge_torch.train.score"):
                return shared_fn(model, state.params, batch, pool_idx, mask, margin,
                                 modes=sampler.modes)
    elif fused and hasattr(sampler, "corruptions"):
        def grads_fn(state, batch, mask, rows):
            with span("skge_torch.train.sample"):
                corr = draw_corruptions(sampler, state.generator, batch, mask, rows)
            with span("skge_torch.train.score"):
                return pairwise_grads_fused(model, state.params, batch, corr, mask,
                                            margin)
    else:
        update = make_pairwise_update(model, opt, margin, aggregate)

        def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
                 rows: Optional[int] = None):
            return update(state, *draw_expanded(sampler, state.generator, batch,
                                                mask, rows))

        return step

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        with span("skge_torch.train.step"):
            loss, nviol, occ, g_dense = grads_fn(state, batch, mask, rows)
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                aggregate, premasked=True, step=state.step,
            )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=nviol)

    if graphs and graphs_eligible(model, opt, sampler, aggregate, fused):
        return PoolStepGraphs(model, opt, sampler, margin, step)
    return step


def graphs_eligible(model: KGEModel, opt: Optimizer, sampler, aggregate: str,
                    fused: bool = True) -> bool:
    """Whether `make_pairwise_step` gives a `PoolStepGraphs`: the
    shared-pool path (`fused`, a `pool`-protocol sampler) through autograd
    (not RESCAL's factored gradients) on a dense aggregate mode, with an
    optimizer without a schedule (its lr is then a constant of the graph).
    The graphs themselves run on the card only, and for tables narrower
    than `WIDE_ROW`."""
    return (fused and hasattr(sampler, "pool") and aggregate in _DENSE_MODES
            and opt.schedule is None
            and select_shared_pairwise_fn(model) is pairwise_grads_shared)


# the kernels' launch counters: a capture counts the launches it records
# and takes them back; each replay adds them
_COUNTERS = tuple((mod, name) for mod, names in (
    (cuda_l1, ("launches", "backward_launches")),
    (cuda_rotate, ("launches", "backward_launches")),
    (cuda_segment, ("launches", "vector_launches", "deterministic_launches",
                    "combine_launches")),
    (cuda_outer, ("launches",)),
    (grouping, ("launches",)),
) for name in names)


def _counts() -> list:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def _add_counts(delta) -> None:
    for (mod, name), d in zip(_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


class PoolStepGraphs:
    """The shared-pool pairwise step as CUDA graph replays, one a layer, so
    that the host enqueues a few copies, replays and K1 instead of the
    eager step's ~130 kernels:

    - sample: eager, `sampler.pool` on the state's generator, so the draws
      are the eager step's and no graph holds a generator;
    - score: one graph over static inputs (the batch, mask and pool are
      copied in): `pairwise_grads_shared`, forward and backward, then each
      `_grouped` group's ids and `count_channel` block;
    - aggregate: eager, `segment_sum` of each group, called from Python on
      a copy of the step's ids, as the eager step calls it;
    - update: one graph over the sums copied in: `mean_of_channels` and
      `_dense_update`, its results written into the static tables and
      accumulators.

    The first call on the card runs the eager step: the warm-up (kernels
    built, libraries and autograd initialised). The second captures each
    graph before its first replay; later calls replay. A call off the card,
    with tables of rows at least `WIDE_ROW` wide, or whose batch, mask or
    tables do not fit the captured ones, runs the eager step. The launch
    counters of the kernels count the replays' launches.

    The incoming state's tensors are copied into the static buffers unless
    they are those buffers, and the returned state holds the buffers
    themselves: the next call updates them in place, so a state kept across
    later steps changes with them. Each step's `StepMetrics` are its own
    tensors.

    `capture=False` runs the same pieces directly instead of capturing and
    replaying them, on any device.
    """

    def __init__(self, model: KGEModel, opt: Optimizer, sampler, margin: float,
                 eager: Callable, capture: bool = True):
        self.model, self.opt, self.sampler, self.margin = model, opt, sampler, margin
        self.eager, self.capture = eager, capture
        self.warm = False
        self.params = self.opt_state = self.sums = None  # bound at the first replay
        self.graphs: dict = {}  # piece -> (CUDAGraph, launches a replay)

    def __call__(self, state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
                 rows: Optional[int] = None):
        if (self.capture and not batch.is_cuda) or not self._fits(state, batch, mask):
            return self.eager(state, batch, mask, rows)
        if not self.warm:
            self.warm = True
            return self.eager(state, batch, mask, rows)
        with span("skge_torch.train.step"):
            with span("skge_torch.train.sample"):
                pool_idx = self.sampler.pool(state.generator, batch, mask)
            with span("skge_torch.train.score"):
                self._load(state, batch, mask, pool_idx)
                self._run("score", self._score)
            with span("skge_torch.train.aggregate"):
                sums = [segment_sum(cidx.clone(), block, num_rows)
                        for _, cidx, block, num_rows, _ in self.groups]
            with span("skge_torch.train.update"):
                self._load_sums(sums)
                self._run("update", self._update)
        new_state = TrainState(dict(self.params),
                               {k: dict(v) for k, v in self.opt_state.items()},
                               state.generator, state.step + 1)
        return new_state, StepMetrics(loss=self.loss.clone(),
                                      nviolations=self.nviol.clone())

    def _fits(self, state: TrainState, batch: torch.Tensor, mask: torch.Tensor) -> bool:
        """Whether the call's tensors match the static buffers; before they
        are bound, whether the slots' tables are narrower than `WIDE_ROW`."""
        if self.params is None:
            return all(state.params[p].shape[1:].numel() < WIDE_ROW
                       for _, p, _ in self.model.slot_spec())
        if state.params.keys() != self.params.keys():
            return False
        pairs = [(batch, self.batch), (mask, self.mask)]
        for k, v in state.params.items():
            pairs.append((v, self.params[k]))
            slots = state.opt_state.get(k, {})
            if slots.keys() != self.opt_state[k].keys():
                return False
            pairs += [(x, self.opt_state[k][s]) for s, x in slots.items()]
        return all(x is y or (x.shape == y.shape and x.dtype == y.dtype
                              and x.device == y.device) for x, y in pairs)

    def _load(self, state: TrainState, batch, mask, pool_idx) -> None:
        """The step's inputs into the static buffers (bound, as copies, on
        the first call)."""
        if self.params is None:
            self.params = {k: v.clone() for k, v in state.params.items()}
            self.opt_state = {k: {s: v.clone() for s, v in slots.items()}
                              for k, slots in state.opt_state.items()}
            self.batch, self.mask, self.pool = batch.clone(), mask.clone(), pool_idx.clone()
            return
        if pool_idx.shape != self.pool.shape:
            raise ValueError(f"a pool of {tuple(pool_idx.shape)} after one of "
                             f"{tuple(self.pool.shape)}: make the step with graphs=False")
        self.batch.copy_(batch)
        self.mask.copy_(mask)
        self.pool.copy_(pool_idx)
        self._store(state.params, state.opt_state)

    def _store(self, params: Params, opt_state: OptState) -> None:
        """Tables and accumulators into the static buffers, each that is
        not already its buffer."""
        for k, v in params.items():
            if v is not self.params[k]:
                self.params[k].copy_(v)
            for s, x in opt_state[k].items():
                if x is not self.opt_state[k][s]:
                    self.opt_state[k][s].copy_(x)

    def _load_sums(self, sums) -> None:
        """The aggregate's sums into the update's static inputs."""
        if self.sums is None:
            self.sums = [t.clone() for t in sums]
            return
        for mine, t in zip(self.sums, sums):
            mine.copy_(t)

    def _score(self) -> None:
        self.loss, self.nviol, occ, self.g_dense = pairwise_grads_shared(
            self.model, self.params, self.batch, self.pool, self.mask, self.margin,
            modes=self.sampler.modes)
        self.groups = [(names, cidx, count_channel(cg, cm, premasked=True), num_rows,
                        cg.shape[1:])
                       for names, cidx, cg, cm, num_rows in _grouped(self.model, occ)]

    def _update(self) -> None:
        units = [(names, mean_of_channels(table, feat_shape))
                 for (names, *_, feat_shape), table in zip(self.groups, self.sums)]
        self._store(*_dense_update(self.model, self.opt, self.params, self.opt_state,
                                   units, self.g_dense, None, "mean"))

    def _run(self, name: str, piece: Callable) -> None:
        """Replay the piece's graph, captured at its first run; or, without
        `capture`, run the piece."""
        if not self.capture:
            piece()
            return
        if name not in self.graphs:
            self.graphs[name] = self._captured(name, piece)
        graph, launched = self.graphs[name]
        graph.replay()
        _add_counts(launched)

    def _captured(self, name: str, piece: Callable):
        """(graph, launches a replay) of `piece`, captured in the memory
        pool of the graphs before it (they replay in capture order)."""
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        pool = next(iter(self.graphs.values()))[0].pool() if self.graphs else None
        try:
            with torch.cuda.graph(graph, pool=pool):
                piece()
        except RuntimeError as e:
            raise RuntimeError(f"the step's {name} could not be captured as a CUDA "
                               "graph; make the step with graphs=False") from e
        launched = [b - a for a, b in zip(before, _counts())]
        _add_counts([-n for n in launched])  # recorded, not launched
        return graph, launched


def make_pointwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,
    aggregate: str = "unique",
):
    """One pointwise step, logistic loss. A `pool`-protocol sampler takes
    the shared-pool path; any other sampler's expanded negatives are
    appended to the batch with y = -1. `nviolations` is 0 (smooth loss)."""
    if not hasattr(sampler, "pool"):
        update = make_pointwise_update(model, opt, aggregate)

        def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
                 rows: Optional[int] = None):
            _, neg, pair_mask = draw_expanded(sampler, state.generator, batch, mask,
                                              rows)
            ys = torch.ones(batch.shape[0] + neg.shape[0], dtype=model.tdtype,
                            device=batch.device)
            ys[batch.shape[0]:] = -1.0
            return update(state, torch.cat([batch, neg]), ys,
                          torch.cat([mask, pair_mask]))

        return step

    grads_fn = select_shared_pointwise_fn(model)

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        pool_idx = sampler.pool(state.generator, batch, mask)
        loss, occ, g_dense = grads_fn(
            model, state.params, batch, pool_idx, mask, modes=sampler.modes,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True, step=state.step,
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=torch.zeros_like(loss))

    return step


def _need_pool(sampler, what: str) -> None:
    if not hasattr(sampler, "pool"):
        raise ValueError(f"{what} needs a shared-pool sampler "
                         "(SharedNegativeSampler); iid samplers have no pool")


def make_selfadv_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,
    margin: float,
    alpha: float = 1.0,
    aggregate: str = "unique",
):
    """One self-adversarial step over a shared pool (`selfadv_grads_shared`).
    `nviolations` is 0 (smooth loss)."""
    _need_pool(sampler, "make_selfadv_step")

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        pool_idx = sampler.pool(state.generator, batch, mask)
        loss, occ, g_dense = selfadv_grads_shared(
            model, state.params, batch, pool_idx, mask, margin, alpha,
            modes=sampler.modes,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True, step=state.step,
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=torch.zeros_like(loss))

    return step


def make_ce_step(
    model: KGEModel,
    opt: Optimizer,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
):
    """One full cross-entropy step (`ce_grads_all`), no sampler. Every table
    takes `apply_full`: every entity row is in the partition function, and a
    zero gradient row is an exact no-op of AdaGrad and SGD. `rparam`, `n3`
    and the post-constraint (TransE's normless1) apply to the whole table.
    `nviolations` is 0."""

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        loss, grads = ce_grads_all(model, state.params, batch, mask, directions,
                                   label_smoothing)
        params, opt_state = dict(state.params), dict(state.opt_state)
        for pname, g in grads.items():
            params[pname], opt_state[pname] = opt.apply_full(
                params[pname], opt_state[pname],
                regularized(model, pname, g, params[pname]), step=state.step
            )
            post = model.post_constraints.get(pname)
            if post is not None:
                params[pname] = POST_CONSTRAINTS[post](params[pname])
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=torch.zeros_like(loss))

    return step


def make_sampled_ce_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    aggregate: str = "unique",
):
    """One sampled cross-entropy step (`sampled_ce_grads_shared`). A sampler
    with `logits` (a unigram pool) feeds the proposal correction."""
    _need_pool(sampler, "make_sampled_ce_step")
    logits = getattr(sampler, "logits", None)
    log_q_tables: dict = {}  # device -> (n_e,) proposal log-probs

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        pool_idx = sampler.pool(state.generator, batch, mask)
        log_q = None
        if logits is not None:
            table = log_q_tables.get(pool_idx.device)
            if table is None:
                table = log_q_tables[pool_idx.device] = torch.log_softmax(
                    logits.to(pool_idx.device), dim=0)
            log_q = table[pool_idx]
        loss, occ, g_dense = sampled_ce_grads_shared(
            model, state.params, batch, pool_idx, mask, directions,
            label_smoothing, log_q,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True, step=state.step, combine="sum",
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=torch.zeros_like(loss))

    return step


def make_epoch_fn(step_fn: Callable, n_triples: int, nbatches: int, pad_to: int = 1):
    """Epoch: shuffle, split into `nbatches` masked minibatches of one size
    (the last padded with masked rows), run `step_fn` over them.

    The returned `epoch(state, xs, perm=None)` takes xs as an (n_triples, 3)
    int64 tensor; `perm` replaces the generator's permutation (parity tests
    pass the JAX package's). Metrics are stacked over the steps.

    `pad_to` (the mesh steps, whose batch must divide the 'data' axis) pads
    EVERY batch with masked rows up to a multiple of it; the batch
    membership of real rows does not change. A padded batch's step is
    called with `rows=` its unpadded size, so its iid draws are those of
    the unpadded batch (torch's generators are not position-stable over a
    longer draw), and masked rows add exact zeros: the trajectory is the
    `pad_to=1` one.
    """
    batch_size = -(-n_triples // nbatches)
    padded = nbatches * batch_size
    extra = (-batch_size) % pad_to
    kw = {"rows": batch_size} if extra else {}

    def epoch(state: TrainState, xs: torch.Tensor,
              perm: Optional[torch.Tensor] = None):
        with span("skge_torch.train.shuffle"):
            if perm is None:
                perm = torch.randperm(
                    n_triples, generator=state.generator, device=xs.device
                )
            perm = perm.to(xs.device)
            pad_idx = torch.cat([perm, perm.new_zeros(padded - n_triples)])
            masks = (
                torch.arange(padded, device=xs.device) < n_triples
            ).to(torch.float32).reshape(nbatches, batch_size)
            b_idx = pad_idx.reshape(nbatches, batch_size)
            if extra:
                b_idx = torch.nn.functional.pad(b_idx, (0, extra))
                masks = torch.nn.functional.pad(masks, (0, extra))
            batches = xs[b_idx]
        metrics = []
        for b in range(nbatches):
            state, m = step_fn(state, batches[b], masks[b], **kw)
            metrics.append(m)
        return state, StepMetrics(
            loss=torch.stack([m.loss for m in metrics]),
            nviolations=torch.stack([m.nviolations for m in metrics]),
        )

    return epoch
