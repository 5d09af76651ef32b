"""Explicit-SPMD train steps over the ('data', 'model') mesh,
`skge_tpu.parallel.shardmap_step`'s counterpart on `torch.distributed`.

Every rank calls `step(state, batch, mask)` with the GLOBAL (B, 3) batch
and (B,) mask, the same on every rank, and its own part of the state
(`shard_state_shardmap`). Each step:

- draws the shared pool or the iid corruptions for the global batch, from
  the state's generator, which every rank holds in the same state, then
  takes its data slice of the draws: a mesh run's trajectory is the
  single-device one, whatever the mesh shape;
- scores its data slice of the batch; the batch is replicated over
  'model', so every member of a model group scores the same pairs;
- gathers entity rows (and relation rows with `shard_relations`)
  masked-locally: each rank reads the rows it owns, zeros elsewhere, and
  one all-reduce over 'model' assembles them. The sum adds zeros to one
  owner's row, so every member of a model group holds the same rows bit
  for bit, and so the same gradients;
- scatters the occurrence rows it owns, with their count channel, into
  its (S, F+1) table through `ops.cuda_segment.segment_sum` (the CUDA
  kernel K1 on the card): ids outside the block become -1, which the
  kernel drops, and tables of one row width (E's block and a replicated
  R) share one launch. RESCAL's factored W occurrences go through
  `ops.cuda_outer.segment_outer_sum` (K2) with the same remap. The tables
  are summed over 'data', then averaged by their counts (summed for
  sampled CE), regularized and applied (`apply_dense_masked`);
- reduces the loss, the violation count and the dense params' gradients
  over 'data'. Dense gradients come back as local sums, and the global
  denominator is clamped once, after the reduction, so a fully masked data
  shard does not inflate it.

`make_shardmap_ce_step` is the vocab-parallel full cross entropy: each
rank scores its slice of the queries against its own (S, d) candidate
block, and the log-sum-exp is assembled across 'model' (the row max by
all-gather, logZ, the label's logit and the smoothing sum by all-reduce).
Its cotangent is formed directly, then back-propagated through
`score_pool` locally, and the query rows' partials are completed over
'model'.

A row count that 'model' does not divide raises (pad the count; embedding
rows are free). A (1, 1) mesh runs the same code over groups of one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from skge_torch.models.base import KGEModel, entity_param
from skge_torch.ops.aggregate import DenseGrads, FactoredOcc
from skge_torch.ops.cuda_outer import segment_outer_sum
from skge_torch.ops.cuda_segment import segment_sum
from skge_torch.optim import POST_CONSTRAINTS, Optimizer, _bcast
from skge_torch.parallel.mesh import MODEL_AXIS, Mesh, data_slice, shard_state
from skge_torch.parallel.partitioned import _augment, _scatter_tables
from skge_torch.training import (StepMetrics, TrainState, draw_corruptions,
                                 pairwise_grads_fused, regularized,
                                 sampled_ce_grads_shared, select_shared_pairwise_fn,
                                 select_shared_pointwise_fn, selfadv_grads_shared)


def _sharded_row_tables(model: KGEModel, m_size: int,
                        shard_relations: bool) -> Dict[str, int]:
    """{pname: global rows} of every table split over 'model'; raises on a
    row count that 'model' does not divide."""
    tables = {entity_param(model): model.n_entities}
    if shard_relations:
        tables.update({pname: model.n_relations
                       for _, pname, role in model.slot_spec() if role == "p"})
    for pname, rows in tables.items():
        if rows % m_size != 0:
            raise ValueError(
                f"{pname}: {rows} rows not divisible by model axis {m_size}; pad "
                "the row count (embedding row count is free)")
    return tables


def _local_rows(model, mesh: Mesh, shard_relations: bool) -> Dict[str, int]:
    m_size = mesh.shape[MODEL_AXIS]
    return {k: rows // m_size
            for k, rows in _sharded_row_tables(model, m_size, shard_relations).items()}


def _owned(idx: torch.Tensor, off: int, s_rows: int) -> torch.Tensor:
    """Local ids of the rows this rank owns, -1 elsewhere (K1 and K2 drop
    ids outside [0, S); negative ids do not wrap)."""
    local = idx - off
    return torch.where((local >= 0) & (local < s_rows), local, -1)


def _make_gather(params, local_rows: Dict[str, int], mesh: Mesh) -> Callable:
    """The masked-local row gather over 'model' (`ShardGroup.gather_rows`)
    for the tables of `local_rows`, the same on every member of the group.
    Replicated tables index directly."""

    def gather(pname, idx, role=None):
        if pname not in local_rows:
            return params[pname][idx]
        return mesh.model.gather_rows(idx, local_rows[pname], params[pname].__getitem__)

    return gather


def _apply_row_occurrences(model: KGEModel, opt: Optimizer, mesh: Mesh, step: int,
                           new_params, new_opt, occ, local_rows: Dict[str, int],
                           combine: str = "mean", scale=None):
    """The owned-rows scatter, the sum over 'data' and the optimizer apply
    for every row table of `occ`. `combine='mean'` divides the summed
    gradients by their counts; 'sum' keeps the sums (sampled CE; the counts
    only gate which rows update). `scale` multiplies the gradients first
    (sampled CE's local-to-global mean)."""
    me = mesh.model.rank
    blocks, factored = [], {}
    for pname, entry in occ.items():
        if isinstance(entry, FactoredOcc):
            factored[pname] = entry
            continue
        idx, grads, counts = entry
        if scale is not None:
            grads = grads * scale
        if pname in local_rows:
            s = local_rows[pname]
            blocks.append((pname, _owned(idx, me * s, s), _augment(grads, counts), s,
                           "all_reduce"))
        else:
            blocks.append((pname, idx, _augment(grads, counts), model.num_rows(pname),
                           "all_reduce"))
    sums = {}
    for pname, t in _scatter_tables(mesh.data, blocks).items():
        feat = tuple(occ[pname][1].shape[1:])
        f = math.prod(feat)
        sums[pname] = (t[:, :f].reshape((t.shape[0],) + feat), t[:, f])
    for pname, f in factored.items():
        n = local_rows.get(pname, model.num_rows(pname))
        idx = _owned(f.idx, me * n, n) if pname in local_rows else f.idx
        us = tuple(u * scale for u in f.us) if scale is not None else f.us
        gsum = segment_outer_sum(idx.contiguous(), tuple(u.contiguous() for u in us),
                                 tuple(v.contiguous() for v in f.vs), n)
        count = segment_sum(idx.contiguous(), f.count.to(gsum.dtype)[:, None].contiguous(),
                            n)[:, 0]
        # one all-reduce for both
        buf = mesh.data.all_reduce_(torch.cat([gsum.reshape(-1), count]))
        gsum, count = buf[:gsum.numel()].reshape(gsum.shape), buf[gsum.numel():]
        sums[pname] = (gsum, count)
    for pname, (g, count) in sums.items():
        if combine == "mean":
            g = g / _bcast(torch.clamp(count, min=1.0), g.dim())
        g = regularized(model, pname, g, new_params[pname])
        new_params[pname], new_opt[pname] = opt.apply_dense_masked(
            new_params[pname], new_opt[pname], DenseGrads(grads=g, count=count),
            model.post_constraints.get(pname), step=step)
    return new_params, new_opt


def _need_pool(sampler, what: str, extra: str = "") -> None:
    if not hasattr(sampler, "pool"):
        raise ValueError(f"{what} needs a shared-pool sampler (SharedNegativeSampler)"
                         + extra)


def _mesh_step(model, opt, mesh: Mesh, local_rows: Dict[str, int], grads_of,
               sampled_ce: bool = False):
    """The frame of every occurrence-scatter step: `grads_of(state, batch,
    mask, rows, gather)` draws for the global batch and returns this data
    slice's (loss, violations, occurrences, dense gradients, n), n being
    the unclamped count the dense gradients are means over (violations,
    scored elements or valid rows). Then one all-reduce over 'data' of the
    loss, violations and n, the owned-row scatters and the update.
    `sampled_ce`: the loss and the occurrence gradients are means over the
    local valid rows, rescaled to the global mean, and duplicates add up."""

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        gather = _make_gather(state.params, local_rows, mesh)
        loss, nviol, occ, g_dense, n_raw = grads_of(state, batch, mask, rows, gather)
        n_raw = n_raw.to(loss.dtype)
        summed = mesh.data.all_reduce(torch.stack(
            [loss * n_raw if sampled_ce else loss, nviol.to(loss.dtype), n_raw]))
        n_local = torch.clamp(n_raw, min=1.0)
        n_global = torch.clamp(summed[2], min=1.0)  # clamped once, after the sum
        loss_all = summed[0] / n_global if sampled_ce else summed[0]
        new_params, new_opt = _apply_row_occurrences(
            model, opt, mesh, state.step, dict(state.params), dict(state.opt_state), occ,
            local_rows, combine="sum" if sampled_ce else "mean",
            scale=n_local / n_global if sampled_ce else None)
        # dense params: each shard's mean back to a sum, summed over 'data',
        # over the global count
        for pname, g in g_dense.items():
            gsum = mesh.data.all_reduce(g * n_local)
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], gsum / n_global, step=state.step)
        return (TrainState(new_params, new_opt, state.generator, state.step + 1),
                StepMetrics(loss=loss_all, nviolations=summed[1]))

    return step


def _pool_step(model, opt, sampler, mesh: Mesh, shard_relations: bool, grads_fn,
               per: str):
    """A shared-pool step: the pool drawn for the global batch (the same on
    every rank), `grads_fn(params, batch, pool, mask, gather)` on this data
    slice. `per`: what the dense gradients are means over, 'violation',
    'element' (every scored element: selfadv, pointwise) or 'row' (sampled
    CE)."""
    n_modes = len(getattr(sampler, "modes", ()))

    def grads_of(state, batch, mask, rows, gather):
        pool = sampler.pool(state.generator, batch, mask)
        lm = data_slice(mask, mesh)
        out = grads_fn(state.params, data_slice(batch, mesh), pool, lm, gather)
        if len(out) == 3:  # the smooth losses: no violations
            out = (out[0], torch.zeros_like(out[0]), *out[1:])
        n = {"violation": out[1], "row": lm.sum(),
             "element": lm.sum() * (1.0 + pool.shape[0] * n_modes)}[per]
        return (*out, n)

    return _mesh_step(model, opt, mesh, _local_rows(model, mesh, shard_relations),
                      grads_of, sampled_ce=per == "row")


def make_shardmap_pairwise_step(
    model: KGEModel, opt: Optimizer, sampler, margin: float, mesh: Mesh,
    shard_relations: bool = False,
):
    """Explicit-SPMD pairwise margin step: `step(state, batch, mask,
    rows=None)` with the global batch and mask on every rank and this
    rank's state (`shard_state_shardmap` with the same `shard_relations`).
    Takes the `pool` (shared-negative) and `corruptions` (iid) sampler
    protocols. `rows` (from `make_epoch_fn(pad_to=)`) draws the iid
    corruptions for the batch's first `rows` rows, as the single-device
    step draws them for the unpadded batch.

    `shard_relations` row-shards the relation tables over 'model' too: a
    rank stores n_r / M rows of them, at the cost of one more masked-local
    gather a relation table; their gradient still needs no collective but
    the sum over 'data'."""
    if hasattr(sampler, "pool"):
        shared_fn = select_shared_pairwise_fn(model)
        return _pool_step(
            model, opt, sampler, mesh, shard_relations,
            lambda params, lb, pool, lm, gather: shared_fn(
                model, params, lb, pool, lm, margin, modes=sampler.modes, gather=gather),
            "violation")
    if not hasattr(sampler, "corruptions"):
        raise ValueError("make_shardmap_pairwise_step takes the pool or the corruptions "
                         "sampler protocol; route expanded-pair samplers to "
                         "make_sharded_pairwise_step")

    def grads_of(state, batch, mask, rows, gather):
        corr = [(m, data_slice(r, mesh), data_slice(v, mesh)) for m, r, v in
                draw_corruptions(sampler, state.generator, batch, mask, rows)]
        out = pairwise_grads_fused(model, state.params, data_slice(batch, mesh), corr,
                                   data_slice(mask, mesh), margin, gather=gather)
        return (*out, out[1])

    return _mesh_step(model, opt, mesh, _local_rows(model, mesh, shard_relations),
                      grads_of)


def make_shardmap_selfadv_step(
    model: KGEModel, opt: Optimizer, sampler, margin: float, mesh: Mesh,
    alpha: float = 1.0, shard_relations: bool = False,
):
    """Explicit-SPMD self-adversarial step over the shared pool: the
    pairwise shared step's collectives; the dense gradients' per-shard
    means recombine by scored-element counts. `nviolations` is 0."""
    _need_pool(sampler, "make_shardmap_selfadv_step")
    return _pool_step(
        model, opt, sampler, mesh, shard_relations,
        lambda params, lb, pool, lm, gather: selfadv_grads_shared(
            model, params, lb, pool, lm, margin, alpha, modes=sampler.modes,
            gather=gather),
        "element")


def make_shardmap_pointwise_step(
    model: KGEModel, opt: Optimizer, sampler, mesh: Mesh, shard_relations: bool = False,
):
    """Explicit-SPMD pointwise (logistic) step over the shared pool, with
    the single-device dispatch (RESCAL's factored W path). iid samplers
    route to `sharded.make_sharded_pointwise_step`. `nviolations` is 0."""
    _need_pool(sampler, "make_shardmap_pointwise_step",
               "; iid samplers route to make_sharded_pointwise_step")
    grads_fn = select_shared_pointwise_fn(model)
    return _pool_step(
        model, opt, sampler, mesh, shard_relations,
        lambda params, lb, pool, lm, gather: grads_fn(
            model, params, lb, pool, lm, modes=sampler.modes, gather=gather),
        "element")


def make_shardmap_sampled_ce_step(
    model: KGEModel, opt: Optimizer, sampler, mesh: Mesh,
    directions: Tuple[str, ...] = ("o", "s"), label_smoothing: float = 0.0,
    shard_relations: bool = False,
):
    """Explicit-SPMD sampled-softmax CE step: the selfadv step's
    collectives over a small global pool. Occurrence gradients keep the
    sampled CE's sum semantics, rescaled from the local batch's mean to the
    global one before the owned-row scatter. A sampler with unigram
    `logits` feeds the proposal correction, read at the global pool."""
    _need_pool(sampler, "make_shardmap_sampled_ce_step")
    logits = getattr(sampler, "logits", None)
    log_q_tables: dict = {}

    def grads_fn(params, lb, pool, lm, gather):
        log_q = None
        if logits is not None:
            lq = log_q_tables.get(pool.device)
            if lq is None:
                lq = log_q_tables[pool.device] = torch.log_softmax(
                    torch.as_tensor(logits).to(pool.device), dim=0)
            log_q = lq[pool]
        return sampled_ce_grads_shared(model, params, lb, pool, lm, directions,
                                       label_smoothing, log_q, gather=gather)

    return _pool_step(model, opt, sampler, mesh, shard_relations, grads_fn, "row")


def make_shardmap_ce_step(
    model: KGEModel, opt: Optimizer, mesh: Mesh,
    directions: Tuple[str, ...] = ("o", "s"), label_smoothing: float = 0.0,
):
    """Vocab-parallel full cross entropy (a Megatron-style softmax): E is
    row-sharded over 'model', and each rank scores its data slice of the
    queries against ONLY its (S, d) candidate block, so no rank holds the
    (B, n_e) logits. The softmax is assembled with per-row collectives over
    'model':

        m    = max over 'model' of the local row maxima (all-gather)
        logZ = log(sum over 'model' of sum_j exp(local_j - m)) + m
        f_y  = sum over 'model' of the label's local logit (0 if not owned)

    and the label-smoothing term from the sum of the local row sums. The
    cotangent of the local logits is formed directly, softmax minus the
    (smoothed) label, weighted by mask / (global valid count), and
    back-propagated through `score_pool`. The candidate block's gradient
    is complete for its rows; the query rows' partials are summed over
    'model' and scattered, owned rows only, through K1. Every table is then
    summed over 'data' and takes `apply_full` and its post-constraint, as
    `make_ce_step`. `nviolations` is 0."""
    epname = entity_param(model)
    n_e = model.n_entities
    m_size = mesh.shape[MODEL_AXIS]
    if n_e % m_size != 0:
        raise ValueError(f"n_entities={n_e} not divisible by model axis {m_size}; pad "
                         "the entity count (embedding row count is free)")
    s_rows = n_e // m_size
    row_off = mesh.model.rank * s_rows
    ls = float(label_smoothing)
    for d in directions:
        if d not in ("o", "s"):
            raise ValueError(f"direction {d!r} (want 'o'/'s')")
    need = {"p"} | ({"s"} if "o" in directions else set()) | (
        {"o"} if "s" in directions else set())
    col = {"s": 0, "o": 1, "p": 2}
    slots = [(slot, pname, role) for slot, pname, role in model.slot_spec()
             if role in need]
    local_rows = {epname: s_rows}

    def step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
             rows: Optional[int] = None):
        params = state.params
        table = params[epname]
        gather = _make_gather(params, local_rows, mesh)
        lb, lm = data_slice(batch, mesh), data_slice(mask, mesh)
        q_rows = {slot: gather(pname, lb[:, col[role]], role).detach().requires_grad_()
                  for slot, pname, role in slots}
        cand = table.detach().requires_grad_()
        dense = {k: v.detach().requires_grad_()
                 for k, v in model.dense_params(params).items()}
        denom = torch.clamp(mesh.data.all_reduce(lm.sum().to(table.dtype)), min=1.0)
        barange = torch.arange(lb.shape[0], device=lb.device)
        w = (lm.to(table.dtype) / denom)[:, None]
        with torch.enable_grad():
            outs = [model.score_pool(q_rows, cand, dense, {"o": 1, "s": 0}[d])
                    for d in directions]
        total, couts = 0.0, []
        for d, lg in zip(directions, outs):
            x = lg.detach()
            mrow = mesh.model.all_gather(x.max(dim=1).values).max(dim=0).values
            se = mesh.model.all_reduce(torch.exp(x - mrow[:, None]).sum(dim=1))
            logz = torch.log(se) + mrow
            ll = lb[:, col[d]] - row_off
            own = (ll >= 0) & (ll < s_rows)
            llc = torch.clamp(ll, 0, s_rows - 1)
            f_label = mesh.model.all_reduce(torch.where(own, x[barange, llc], 0))
            nll = logz - f_label
            gl = torch.exp(x - logz[:, None])
            onehot = torch.zeros_like(x)
            onehot[barange, llc] = own.to(x.dtype)
            if ls:
                sum_logits = mesh.model.all_reduce(x.sum(dim=1))
                nll = (1.0 - ls) * nll - ls * (sum_logits / n_e - logz)
                gl = gl - (1.0 - ls) * onehot - ls / n_e
            else:
                gl = gl - onehot
            total = total + torch.sum(nll * lm)
            couts.append(w * gl)
        loss = mesh.data.all_reduce(total / denom)
        leaves = [*q_rows.values(), cand, *dense.values()]
        grads = torch.autograd.grad(outs, leaves, couts, allow_unused=True,
                                    materialize_grads=True)
        n = len(q_rows)
        g_rows = {k: mesh.model.all_reduce(g) for k, g in zip(q_rows, grads[:n])}
        g_dense = {k: mesh.model.all_reduce(g) for k, g in zip(dense, grads[n + 1:])}

        # the completed query-row gradients into this rank's owned rows and
        # the replicated tables, one K1 launch a row width, zero columns up
        # to a multiple of 4 (the kernel's 16-byte path)
        merged: Dict[str, list] = {}
        for slot, pname, role in slots:
            ids = lb[:, col[role]]
            gr = g_rows[slot].reshape(ids.shape[0], -1)
            gr = torch.cat([gr, gr.new_zeros((gr.shape[0], -gr.shape[1] % 4))], dim=1)
            if pname == epname:
                merged.setdefault(pname, []).append((_owned(ids, row_off, s_rows), gr))
            else:
                merged.setdefault(pname, []).append((ids, gr))
        tables = _scatter_tables(mesh.data, [
            (pn, torch.cat([i for i, _ in bs]), torch.cat([g for _, g in bs]),
             s_rows if pn == epname else model.num_rows(pn), "local")
            for pn, bs in merged.items()])
        g_tables = {epname: grads[n]}
        for pname, t in tables.items():  # less the zero columns
            t = t[:, :math.prod(params[pname].shape[1:])].reshape(params[pname].shape)
            g_tables[pname] = g_tables[pname] + t if pname in g_tables else t
        g_tables.update(g_dense)

        new_params, new_opt = dict(params), dict(state.opt_state)
        for pname, gt in g_tables.items():
            gt = regularized(model, pname, mesh.data.all_reduce(gt), new_params[pname])
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], gt, step=state.step)
            post = model.post_constraints.get(pname)
            if post is not None:
                new_params[pname] = POST_CONSTRAINTS[post](new_params[pname])
        return (TrainState(new_params, new_opt, state.generator, state.step + 1),
                StepMetrics(loss=loss.detach(), nviolations=torch.zeros_like(loss)))

    return step


def shard_state_shardmap(state: TrainState, model: KGEModel, mesh: Mesh,
                         shard_relations: bool = False) -> TrainState:
    """This rank's part of a full state for the shard_map steps: E's row
    block, and the relation tables' with `shard_relations` (match the
    step's flag), with their optimizer slots."""
    _sharded_row_tables(model, mesh.shape[MODEL_AXIS], shard_relations)
    return shard_state(state, model, mesh, shard_relations)
