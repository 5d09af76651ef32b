"""Training core of the port: shared-pool margin gradients, sparse updates,
train steps and the epoch loop.

    gather rows -> score -> autograd w.r.t. the gathered rows
    -> duplicate-index segment averaging -> sparse optimizer update

Semantics are those of `skge_tpu.training`:

- pairwise margin ranking on violating pairs only; a batch with zero
  violations performs NO update at all;
- the pairwise margin test applies the model's `pairwise_af` first;
- gradients are AVERAGED over duplicate row indices.

Batches are padded to a fixed size and masked, as in the JAX package, so
every step of an epoch has the same shapes. Random draws (epoch
permutation, negative pools) come from the `torch.Generator` carried in
`TrainState`; they do not reproduce JAX's draws, so the parity tests pass
the JAX package's draws in (`perm=` and a sampler with a `pool` method).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from skge_torch.models.base import ACTIVATIONS, KGEModel, Params
from skge_torch.ops.aggregate import (
    DenseGrads,
    segment_mean_dense,
    segment_mean_unique,
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
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    role_idx = {"s": s, "o": o, "p": p}
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    if epname != slot_by_role["o"][1]:
        raise ValueError("the shared pool needs one entity table")
    # leaf tensors: autograd gives one gradient row per occurrence
    rows = {
        slot: params[pname][role_idx[role]].detach().requires_grad_()
        for slot, pname, role in model.slot_spec()
    }
    pool_rows = params[epname][pool_idx].detach().requires_grad_()
    dense = {
        k: v.detach().requires_grad_()
        for k, v in model.dense_params(params).items()
    }
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

    occ: dict = {}
    role_mode = {"s": 0, "o": 1}
    for slot, pname, role in model.slot_spec():
        idxs, gs, counts = occ.setdefault(pname, ([], [], []))
        if role == "p":
            cnt = 2.0 * m_total
        else:
            cnt = sum(
                mm * (1.0 if mode == role_mode[role] else 2.0)
                for mode, mm in zip(modes, m)
            )
        idxs.append(role_idx[role])
        gs.append(g_rows[slot])
        counts.append(cnt)
    idxs, gs, counts = occ[epname]
    idxs.append(pool_idx)
    gs.append(g_pool)
    counts.append(sum(torch.sum(fm, dim=0) for fm in fms))
    occ = {
        k: (torch.cat(i), torch.cat(g), torch.cat(c))
        for k, (i, g, c) in occ.items()
    }
    g_dense = {k: v / torch.clamp(nviol, min=1.0) for k, v in g_dense.items()}
    return loss, nviol, occ, g_dense


# the JAX package's dense aggregate modes; here all scatter through K1
_DENSE_MODES = ("dense", "dense_pallas", "dense_sorted")


def apply_gradients(
    model: KGEModel,
    opt: Optimizer,
    params: Params,
    opt_state: OptState,
    occ,                      # {pname: (indices, grads, mask_or_counts)}
    g_dense: Params,
    aggregate: str = "unique",  # 'unique' | 'dense' | 'dense_pallas' | 'dense_sorted'
    premasked: bool = False,    # occ grads pre-weighted, mask = counts
) -> Tuple[Params, OptState]:
    """Aggregate the occurrence gradients and update the touched rows.

    The three dense modes keep the JAX package's names and all scatter
    through the CUDA kernel `segment_sum`. Row params with the same feature
    shape (TransE's E and R) share ONE scatter into a stacked table, split
    after, so a TransE step launches the kernel once.
    """
    params = dict(params)
    opt_state = dict(opt_state)

    def apply_dense_grads(pname, dg: DenseGrads):
        params[pname], opt_state[pname] = opt.apply_dense_masked(
            params[pname], opt_state[pname], dg,
            model.post_constraints.get(pname),
        )

    if aggregate == "unique":
        for pname, (idx, g, m) in occ.items():
            ug = segment_mean_unique(idx, g, m, model.num_rows(pname), premasked)
            params[pname], opt_state[pname] = opt.apply_unique(
                params[pname], opt_state[pname], ug,
                model.post_constraints.get(pname),
            )
    elif aggregate in _DENSE_MODES:
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
    else:
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    for pname, g in g_dense.items():
        params[pname], opt_state[pname] = opt.apply_full(
            params[pname], opt_state[pname], g
        )
    return params, opt_state


def make_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler,  # has .pool(generator, pos, mask) -> (K,) ids and .modes
    margin: float,
    aggregate: str = "unique",
):
    """One pairwise step against a shared negative pool: draw the pool,
    rank, update on violations. Only `pool`-protocol samplers so far."""
    if not hasattr(sampler, "pool"):
        raise ValueError("make_pairwise_step needs a sampler with a pool method")

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
        pool_idx = sampler.pool(state.generator, batch, mask)
        loss, nviol, occ, g_dense = pairwise_grads_shared(
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
