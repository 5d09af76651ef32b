"""Training core of the port: shared-pool margin and logistic gradients,
sparse updates, train steps and the epoch loop.

    gather rows -> score -> gradient w.r.t. the gathered rows
    -> duplicate-index segment averaging -> sparse optimizer update

Semantics are those of `skge_tpu.training`:

- pairwise margin ranking on violating pairs only; a batch with zero
  violations performs NO update at all;
- the pairwise margin test applies the model's `pairwise_af` first;
- pointwise logistic loss `sum(logaddexp(0, -y*f))` over the positives
  and every (positive, pool entity, mode) corruption;
- gradients are AVERAGED over duplicate row indices;
- `rparam * row` L2 regularization on the touched rows of
  `model.reg_row_params`.

The generic paths take row gradients from autograd. Models whose pool-pair
W gradient is low-rank (`factored_pool_grads`, RESCAL) take hand-derived
paths that keep it factored (`FactoredOcc`) for the outer-product scatter.

Batches are padded to a fixed size and masked, as in the JAX package, so
every step of an epoch has the same shapes. Random draws (epoch
permutation, negative pools) come from the `torch.Generator` carried in
`TrainState`; they do not reproduce JAX's draws, so the parity tests pass
the JAX package's draws in (`perm=` and a sampler with a `pool` method).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from skge_torch.models.base import ACTIVATIONS, KGEModel, Params, acc_dtype
from skge_torch.ops.aggregate import (
    DenseGrads,
    FactoredOcc,
    segment_mean_dense,
    segment_mean_unique,
    segment_outer_mean_dense,
)
from skge_torch.optim import Optimizer, OptState


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


def _shared_leaves(model: KGEModel, params: Params, pos: torch.Tensor,
                   pool_idx: torch.Tensor):
    """The rows of each slot, the pool rows and the dense params as
    autograd leaves, so autograd gives one gradient row per occurrence.
    Returns (role -> ids, entity param name, rows, pool rows, dense)."""
    role_idx = {"s": pos[:, 0], "o": pos[:, 1], "p": pos[:, 2]}
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    if epname != slot_by_role["o"][1]:
        raise ValueError("the shared pool needs one entity table")
    rows = {
        slot: params[pname][role_idx[role]].detach().requires_grad_()
        for slot, pname, role in model.slot_spec()
    }
    pool_rows = params[epname][pool_idx].detach().requires_grad_()
    dense = {
        k: v.detach().requires_grad_()
        for k, v in model.dense_params(params).items()
    }
    return role_idx, epname, rows, pool_rows, dense


def _group_shared(model: KGEModel, role_idx, epname, g_rows, counts,
                  pool_idx, g_pool, pool_counts):
    """{pname: (ids, grads, counts)} over the slots, then the pool rows
    appended to the entity table's list; `counts` maps role -> (B,)."""
    occ: dict = {}
    for slot, pname, role in model.slot_spec():
        idxs, gs, cs = occ.setdefault(pname, ([], [], []))
        idxs.append(role_idx[role])
        gs.append(g_rows[slot])
        cs.append(counts[role])
    idxs, gs, cs = occ[epname]
    idxs.append(pool_idx)
    gs.append(g_pool)
    cs.append(pool_counts)
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
    """
    role_idx, epname, rows, pool_rows, dense = _shared_leaves(
        model, params, pos, pool_idx
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
    occ = _group_shared(
        model, role_idx, epname, g_rows, counts,
        pool_idx, g_pool, sum(torch.sum(fm, dim=0) for fm in fms),
    )
    g_dense = {k: v / torch.clamp(nviol, min=1.0) for k, v in g_dense.items()}
    return loss, nviol, occ, g_dense


def _bilinear_rows(params: Params, pos: torch.Tensor, pool_idx: torch.Tensor):
    """RESCAL's gathered rows in the accumulation dtype, and its (B, d)
    queries q = e_s W_p (object pool) and r = W_p e_o (subject pool)."""
    E, W = params["E"], params["W"]
    acc = acc_dtype(E)
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    es, eo, wp, pool = (x.to(acc) for x in (E[s], E[o], W[p], E[pool_idx]))
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
    `pairwise_grads_shared`; W's is 2 per violating pair.
    """
    if model.pairwise_af != "linear":
        raise ValueError("the factored path needs raw (linear) pair scores")
    (s, o, p), (es, eo, wp, pool), q, r = _bilinear_rows(params, pos, pool_idx)
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


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jnp.logaddexp(0, x)`; `F.softplus` turns linear
    above its threshold and so gives other values."""
    return torch.logaddexp(x.new_zeros(()), x)


def pointwise_grads_shared(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    modes: Tuple[int, ...] = (0, 1),
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
    """
    role_idx, epname, rows, pool_rows, dense = _shared_leaves(
        model, params, pos, pool_idx
    )
    mask = mask.to(acc_dtype(pool_rows))
    k = pool_idx.shape[0]

    with torch.enable_grad():
        f_pos = model.score_from_rows(rows, dense)             # (B,)
        loss = torch.sum(_softplus(-f_pos) * mask)             # y = +1
        for f_neg in model.score_pool_modes(rows, pool_rows, dense, tuple(modes)):
            loss = loss + torch.sum(_softplus(f_neg) * mask[:, None])  # y = -1
        leaves = [*rows.values(), pool_rows, *dense.values()]
        grads = torch.autograd.grad(loss, leaves)
    g_rows = dict(zip(rows, grads))
    g_pool = grads[len(rows)]
    g_dense = dict(zip(dense, grads[len(rows) + 1:]))

    counts = {
        role: (1.0 + k * sum(1 for m in modes if m != mode_of_role)) * mask
        for role, mode_of_role in (("s", 0), ("o", 1))
    }
    counts["p"] = (1.0 + k * len(modes)) * mask
    occ = _group_shared(
        model, role_idx, epname, g_rows, counts, pool_idx, g_pool,
        torch.full((k,), float(len(modes)), dtype=mask.dtype,
                   device=mask.device) * torch.sum(mask),
    )
    n_elems = torch.clamp(torch.sum(mask) * (1.0 + k * len(modes)), min=1.0)
    g_dense = {kk: v / n_elems for kk, v in g_dense.items()}
    return loss.detach(), occ, g_dense


def pointwise_grads_shared_bilinear(
    model: KGEModel,
    params: Params,
    pos: torch.Tensor,        # (B, 3) int64 positives
    pool_idx: torch.Tensor,   # (K,) int64 shared negative entity ids
    mask: torch.Tensor,       # (B,) batch validity
    modes: Tuple[int, ...] = (0, 1),
):
    """RESCAL shared-pool POINTWISE gradients, W cotangent factored.

    Same contract as `pointwise_grads_shared`, through the algebra of
    `pairwise_grads_shared_bilinear`:

        dL/df_pos = -sigmoid(-f_pos) * mask          (y = +1)
        dL/df_neg =  sigmoid(f_neg) * mask           (y = -1)
        dW_{p_b}  = e_s (x) dq_b + dr_b (x) e_o
    """
    (s, o, p), (es, eo, wp, pool), q, r = _bilinear_rows(params, pos, pool_idx)
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


# the JAX package's dense aggregate modes; here all scatter through the
# CUDA kernels
_DENSE_MODES = ("dense", "dense_pallas", "dense_sorted")


def apply_gradients(
    model: KGEModel,
    opt: Optimizer,
    params: Params,
    opt_state: OptState,
    occ,                      # {pname: (indices, grads, mask_or_counts) | FactoredOcc}
    g_dense: Params,
    aggregate: str = "unique",  # 'unique' | 'dense' | 'dense_pallas' | 'dense_sorted'
    premasked: bool = False,    # occ grads pre-weighted, mask = counts
) -> Tuple[Params, OptState]:
    """Aggregate the occurrence gradients and update the touched rows.

    The three dense modes keep the JAX package's names and all scatter
    through the CUDA kernels: `segment_sum`, and `segment_outer_sum` for a
    `FactoredOcc` (RESCAL's W). Row params with the same feature shape
    (TransE's E and R) share ONE scatter into a stacked table, split after,
    so a TransE step launches `segment_sum` once. Under 'unique' a
    `FactoredOcc`'s outer products are materialized batch-locally, as in
    the JAX package. `rparam` adds `rparam * row` to the averaged gradient
    of each touched row of `model.reg_row_params`.
    """
    if aggregate != "unique" and aggregate not in _DENSE_MODES:
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    params = dict(params)
    opt_state = dict(opt_state)
    reg = model.regularization

    def apply_dense_grads(pname, dg: DenseGrads):
        if reg != 0.0 and pname in model.reg_row_params:
            dg = dg._replace(
                grads=dg.grads + reg * model.reg_grad_rows(pname, params[pname])
            )
        params[pname], opt_state[pname] = opt.apply_dense_masked(
            params[pname], opt_state[pname], dg,
            model.post_constraints.get(pname),
        )

    factored = {p: f for p, f in occ.items() if isinstance(f, FactoredOcc)}
    occ = {p: o for p, o in occ.items() if p not in factored}
    for pname, f in factored.items():
        if aggregate in _DENSE_MODES:
            apply_dense_grads(
                pname, segment_outer_mean_dense(f, model.num_rows(pname))
            )
        else:
            outers = sum(u[:, :, None] * v[:, None, :] for u, v in zip(f.us, f.vs))
            occ[pname] = (f.idx, outers, f.count)

    if aggregate == "unique":
        for pname, (idx, g, m) in occ.items():
            ug = segment_mean_unique(idx, g, m, model.num_rows(pname), premasked)
            if reg != 0.0 and pname in model.reg_row_params:
                ug = ug._replace(
                    grads=ug.grads
                    + reg * model.reg_grad_rows(pname, params[pname][ug.uidx])
                )
            params[pname], opt_state[pname] = opt.apply_unique(
                params[pname], opt_state[pname], ug,
                model.post_constraints.get(pname),
            )
    else:
        groups: dict = {}
        for pname in occ:
            groups.setdefault(occ[pname][1].shape[1:], []).append(pname)
        for names in groups.values():
            offsets, total = {}, 0
            for pname in names:
                offsets[pname] = total
                total += model.num_rows(pname)
            cidx = torch.cat([occ[p][0] + offsets[p] for p in names])
            cg = torch.cat([occ[p][1] for p in names])
            cm = torch.cat([occ[p][2] for p in names])
            dg_all = segment_mean_dense(cidx, cg, cm, total, premasked)
            for pname in names:
                lo = offsets[pname]
                hi = lo + model.num_rows(pname)
                apply_dense_grads(
                    pname,
                    DenseGrads(grads=dg_all.grads[lo:hi], count=dg_all.count[lo:hi]),
                )
    for pname, g in g_dense.items():
        params[pname], opt_state[pname] = opt.apply_full(
            params[pname], opt_state[pname], g
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


def _need_pool(sampler, maker: str) -> None:
    if not hasattr(sampler, "pool"):
        raise ValueError(f"{maker} needs a sampler with a pool method")


def make_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,  # has .pool(generator, pos, mask) -> (K,) ids and .modes
    margin: float,
    aggregate: str = "unique",
):
    """One pairwise step against a shared negative pool: draw the pool,
    rank, update on violations. Only `pool`-protocol samplers so far."""
    _need_pool(sampler, "make_pairwise_step")
    grads_fn = select_shared_pairwise_fn(model)

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
        pool_idx = sampler.pool(state.generator, batch, mask)
        loss, nviol, occ, g_dense = grads_fn(
            model, state.params, batch, pool_idx, mask, margin,
            modes=sampler.modes,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True,
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=nviol)

    return step


def make_pointwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,  # has .pool(generator, pos, mask) -> (K,) ids and .modes
    aggregate: str = "unique",
):
    """One pointwise step against a shared negative pool: draw the pool,
    logistic loss over the positives and every pool corruption. Only
    `pool`-protocol samplers so far. `nviolations` is 0 (smooth loss)."""
    _need_pool(sampler, "make_pointwise_step")
    grads_fn = select_shared_pointwise_fn(model)

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
        pool_idx = sampler.pool(state.generator, batch, mask)
        loss, occ, g_dense = grads_fn(
            model, state.params, batch, pool_idx, mask, modes=sampler.modes,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True,
        )
        new_state = TrainState(params, opt_state, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=torch.zeros_like(loss))

    return step


def make_epoch_fn(step_fn: Callable, n_triples: int, nbatches: int):
    """Epoch: shuffle, split into `nbatches` masked minibatches of one size
    (the last padded with masked rows), run `step_fn` over them.

    The returned `epoch(state, xs, perm=None)` takes xs as an (n_triples, 3)
    int64 tensor; `perm` replaces the generator's permutation (parity tests
    pass the JAX package's). Metrics are stacked over the steps.
    """
    batch_size = -(-n_triples // nbatches)
    padded = nbatches * batch_size

    def epoch(state: TrainState, xs: torch.Tensor,
              perm: Optional[torch.Tensor] = None):
        if perm is None:
            perm = torch.randperm(
                n_triples, generator=state.generator, device=xs.device
            )
        perm = perm.to(xs.device)
        pad_idx = torch.cat([perm, perm.new_zeros(padded - n_triples)])
        masks = (
            torch.arange(padded, device=xs.device) < n_triples
        ).to(torch.float32).reshape(nbatches, batch_size)
        batches = xs[pad_idx.reshape(nbatches, batch_size)]
        metrics = []
        for b in range(nbatches):
            state, m = step_fn(state, batches[b], masks[b])
            metrics.append(m)
        return state, StepMetrics(
            loss=torch.stack([m.loss for m in metrics]),
            nviolations=torch.stack([m.nviolations for m in metrics]),
        )

    return epoch
