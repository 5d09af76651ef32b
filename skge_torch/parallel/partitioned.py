"""Partition-aligned training over `torch.distributed`, one process per
shard: `skge_tpu.parallel.partitioned`'s counterpart.

Entities are partitioned (`data.greedy_entity_partition`) and relabeled so
rank r owns the contiguous rows [r*S, (r+1)*S) of the entity table
(`relabel_entities`); rank r trains on exactly the triples whose SUBJECT it
owns (`data.partition_edges`). Each step:

- subject rows are local, no communication;
- object rows: every rank all-gathers the object ids, answers with its
  owned rows (zeros elsewhere), and one all-to-all returns each rank the
  answers to its requests. With `boundary_cap=C` (shared-pool samplers)
  each rank requests only its <= C non-local object ids, valid rows first;
- the shared pool is drawn identically on every rank (the same generator
  state), so its rows assemble with one all-reduce of the owned rows;
- entity gradients: without a cap every rank scatters into an
  (n_pad, F+1) table (the gradient, its count channel, zero columns up to
  a multiple of 4) and `reduce_scatter_tensor` leaves each rank its summed
  (S, F+1) rows. With a cap the owned occurrence rows scatter straight
  into the (S, F+1) shard table and the <= C+K non-owned rows go to their
  owners by one of three exchanges: `dense` (an all-gather, then an
  owner-filtered scatter), `ragged` (`all_to_all_single` with uneven
  splits, routed by owner; the splits are host ints, so this waits for the
  host twice a step) or `emulate` (the ragged layout in fixed-size blocks
  of one all-to-all). All three give the same values;
- relation tables are replicated: scattered locally, then all-reduced.

Every scatter of occurrence rows goes through `ops.cuda_segment.
segment_sum` (the CUDA kernel on the card, its plain version on the CPU),
one launch per step for all tables of one row width. The update is the
single-device one: duplicate-occurrence averaging (sums for sampled CE),
violation filtering, the global normalizer of the dense gradients, the
optimizer with its post-constraint (`normless1`), `rparam` and `n3`.

The full-CE step all-gathers the queries, takes the log-sum-exp over the
column-sharded vocabulary and sums the query-row and dense gradients
across ranks; each rank updates its own rows.

Each rank runs the same collectives in the same order; a rank that
stops, stops the others at the process group's timeout.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from skge_torch.data import greedy_entity_partition, partition_edges
from skge_torch.evaluation import FilteredRankingEval, ReciprocalEvalWrapper
from skge_torch.models.base import KGEModel, entity_param
from skge_torch.ops.aggregate import DenseGrads
from skge_torch.ops.cuda_segment import segment_sum
from skge_torch.optim import POST_CONSTRAINTS, Optimizer, _bcast
from skge_torch.parallel.distributed import (ShardGroup, host_replicate,
                                             make_global_batches, make_shard_mesh)
from skge_torch.training import (StepMetrics, TrainState, pairwise_grads_fused,
                                 pairwise_grads_shared, regularized,
                                 sampled_ce_grads_shared, selfadv_grads_shared)

SHARD_AXIS = "shard"  # the JAX package's mesh axis; the ShardGroup's one axis
EXCHANGES = ("dense", "ragged", "emulate")

# host waits of the ragged exchange (its split sizes are read on the host)
host_waits = 0


# ---------------------------------------------------------------------------
# Exchange choice (`exchange='auto'`): the JAX package's cost model in
# seconds. The dense exchange moves P*C*d (the object rows' all-to-all) +
# P*(C+k)*d (the gradient return of the boundary and non-owned pool rows)
# + 2*k*d (the pool rows' all-reduce) bytes a rank and step; the ragged one
# routes the first two terms by owner (P-fold fewer bytes), keeps the
# all-reduce, and waits for the host twice a step (a fixed latency). The
# dense transfer may hide behind the pool dots' compute where the
# collectives overlap it; the port's do not (below).
# ---------------------------------------------------------------------------

# `ExchangeCosts`' card defaults, as `chip_smoke.py` 11g read them on one NVIDIA
# H100 80GB HBM3 at a 700 W power limit: the median of 4 rounds of 50 fp32 (TF32
# off) `torch.mm` calls at (4,832 x 150) @ (150 x 1,024) (2.868826e13-2.886859e13
# FLOP/s), and the ragged trainer's median step less the dense one's at P=1 over
# NCCL, 4 epochs of 20 steps each (rounds 4.3260-5.0806 ms apart). Four runs on
# such cards read 2.817636e13-2.918426e13 FLOP/s and 4.9199-7.6015 ms.
FP32_FLOPS_PER_S = 2.880138e13
RAGGED_LATENCY_S = 4.9199e-3


@dataclass(frozen=True)
class ExchangeCosts:
    """The constants of `choose_exchange`, in seconds and bytes a second.

    `link_bytes_per_s`, the collective rate between cards, has no default:
    one card cannot measure it, so the caller states it. The pool-dot rate
    and the ragged latency default to what `chip_smoke.py` 11g measured on
    one H100. The hiding terms default to no overlap: the port's exchanges
    are blocking collectives on the step's stream (this module issues no
    `async_op`), so no compute hides them.
    """

    link_bytes_per_s: float
    fp32_flops_per_s: float = FP32_FLOPS_PER_S  # the pool dots' rate
    ragged_latency_s: float = RAGGED_LATENCY_S  # the ragged exchange's cost a step
    compute_fudge: float = 1.0  # compute the schedule hides per pool-dot flop
    overlap_eff: float = 0.0    # the share of it that overlaps a collective
    hide_saturation_s: float = math.inf  # the most a step can hide


def choose_exchange(
    d: int,
    cap: int,
    k: int,
    batch_per_shard: int,
    p: int,
    costs: ExchangeCosts,
    n_modes: int = 2,
    dtype_bytes: int = 4,
):
    """'dense' or 'ragged' for the boundary exchange, from the bytes each
    moves, the compute that can hide the dense transfer, and the ragged
    exchange's fixed latency: `skge_tpu.parallel.partitioned.
    choose_exchange` with `costs` in place of its TPU constants, in the
    same order of arithmetic. The byte terms are the same for every
    cap-based loss; `n_modes` is the number of pool-scoring directions (2
    for pairwise and selfadv, len(directions) for sampled CE). Ragged wins
    only on a strictly smaller exposed time.

    Returns (choice, report): the report has the JAX package's keys with
    seconds (`_s`) in place of its cycles.
    """
    cap = min(cap, batch_per_shard)
    dot_flops = 6.0 * n_modes * batch_per_shard * k * d  # pool dots, fwd+bwd
    hide = min(
        costs.overlap_eff * costs.compute_fudge * dot_flops / costs.fp32_flops_per_s,
        costs.hide_saturation_s,
    )
    psum = 2.0 * k * d * dtype_bytes                 # pool rows, both modes
    dense_bytes = (p * cap + p * (cap + k)) * d * dtype_bytes + psum
    ragged_bytes = (cap + (cap + k)) * d * dtype_bytes + psum
    dense_s = dense_bytes / costs.link_bytes_per_s
    exposed_dense = max(0.0, dense_s - hide)
    exposed_ragged = ragged_bytes / costs.link_bytes_per_s + costs.ragged_latency_s
    choice = "ragged" if exposed_ragged < exposed_dense else "dense"
    return choice, {
        "n_modes": n_modes,
        "dense_bytes": round(dense_bytes),
        "ragged_bytes": round(ragged_bytes),
        "dense_transfer_s": dense_s,
        "hideable_compute_s": hide,
        "exposed_dense_s": exposed_dense,
        "exposed_ragged_s": exposed_ragged,
        "choice": choice,
    }


def relabel_entities(
    triples: np.ndarray, entity_part: np.ndarray, n_parts: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Renumber entities so part p owns the contiguous rows [p*S, (p+1)*S).

    S = max part size; smaller parts leave unused padding rows. Returns
    (relabeled int32 triples, int64 new_of_old, n_padded = n_parts * S);
    raises when the padded id space overflows int32.
    """
    entity_part = np.asarray(entity_part)
    n_e = entity_part.shape[0]
    sizes = np.bincount(entity_part, minlength=n_parts)
    s = int(sizes.max())
    if n_parts * s >= 2**31:
        raise ValueError(
            f"relabeled id space n_parts*S = {n_parts}*{s} = "
            f"{n_parts * s} overflows int32; use more/better-balanced "
            "partitions"
        )
    order = np.argsort(entity_part, kind="stable")
    within = np.arange(n_e) - np.concatenate(
        [[0], np.cumsum(sizes)]
    )[entity_part[order]]
    new_of_old = np.empty(n_e, np.int64)
    new_of_old[order] = entity_part[order].astype(np.int64) * s + within
    t = np.asarray(triples)
    out = np.stack(
        [new_of_old[t[:, 0]], new_of_old[t[:, 1]], t[:, 2]], axis=1
    ).astype(np.int32)
    return out, new_of_old, n_parts * s


def object_boundary_cap(
    batches: np.ndarray, s_rows: int, mask: Optional[np.ndarray] = None
) -> int:
    """Exact max count, over shards, of NON-local object ids in `batches`,
    the (P, L, 3) output of `data.partition_edges` on relabeled triples.
    Use it (or more) as `boundary_cap`. With `mask`, only valid rows count
    (the request compaction puts valid rows first)."""
    b = np.asarray(batches)
    caps = []
    for p in range(b.shape[0]):
        obj = b[p, :, 1]
        nonlocal_ = (obj < p * s_rows) | (obj >= (p + 1) * s_rows)
        if mask is not None:
            nonlocal_ = nonlocal_ & (np.asarray(mask)[p] > 0)
        caps.append(int(np.sum(nonlocal_)))
    return max(caps) if caps else 0


def _owned(idx: torch.Tensor, row_off: int, s_rows: int):
    """(local ids, owned mask) of global ids for the rank at `row_off`."""
    local = idx - row_off
    return local, (local >= 0) & (local < s_rows)


def _first(flags: torch.Tensor) -> torch.Tensor:
    """Positions with `flags` set first, each group in its order (a stable
    argsort of ~flags, `jnp.argsort(~flags)`)."""
    return torch.argsort((~flags).to(torch.int32), stable=True)


def _counts(dst: torch.Tensor, p_sz: int) -> torch.Tensor:
    """(P,) int64 counts of `dst` values, without a host wait."""
    return torch.zeros(p_sz, dtype=torch.int64, device=dst.device).scatter_add_(
        0, dst, torch.ones_like(dst))


def _host_splits(counts: torch.Tensor, me: int) -> Tuple[List[int], List[int]]:
    """(rows I send to each rank, rows I receive from each) from the
    all-gathered (sender, receiver) count matrix: one host wait."""
    global host_waits
    host_waits += 1
    c = counts.cpu()
    return c[me].tolist(), c[:, me].tolist()


def _ragged_send(group: ShardGroup, payload, in_off, sizes, out_off, recv_sizes,
                 out_len: int, emulate: bool, fill=0, splits=None):
    """One owner-routed hop. `payload` holds the rows for rank q at
    [in_off[q], in_off[q] + sizes[q]); they land at [out_off[q], ...) of
    rank q's output, and this rank receives recv_sizes[s] rows from rank s.
    Both callers lay the blocks out in rank order from 0 on each side.

    Not emulated: `all_to_all_single` with the host `splits` (send,
    receive); the output is the received rows. Emulated: the same layout in
    (P, out_len) fixed blocks of one even all-to-all, summed by the
    receiver (one nonzero block per row); untouched tail rows hold `fill`.
    """
    if not emulate:
        send, recv = splits
        out = payload.new_full((sum(recv),) + tuple(payload.shape[1:]), fill)
        group.all_to_all_uneven(out, payload[:sum(send)], recv, send)
        return out
    p_sz = group.size
    n = payload.shape[0]
    j = torch.arange(p_sz * out_len, device=payload.device)
    dest, slot = j // out_len, j % out_len
    src = torch.clamp(in_off[dest] + (slot - out_off[dest]), 0, n - 1)
    val = (slot >= out_off[dest]) & (slot < out_off[dest] + sizes[dest])
    rows = torch.where(_bcast(val, payload.dim()), payload[src], 0)
    out = group.all_to_all(rows).reshape(
        (p_sz, out_len) + tuple(payload.shape[1:])).sum(dim=0)
    if fill != 0:
        tail = torch.arange(out_len, device=payload.device) >= recv_sizes.sum()
        out = torch.where(_bcast(tail, out.dim()), fill, out)
    return out


def _warn_if_cap_exceeded(n_needed: torch.Tensor, cap: int, what: str) -> None:
    """Opt-in guard (`debug_checks=True`, one host wait): rows beyond the
    cap contribute zero gradient, so say so."""
    n = int(n_needed)
    if n > cap:
        warnings.warn(
            f"skge_torch PARTITIONED WARNING: {n} valid non-local rows but "
            f"{what}={cap}; the excess rows are DROPPED and gradients are "
            "wrong; size the cap with object_boundary_cap", RuntimeWarning)


def _scatter_tables(group: ShardGroup, blocks) -> Dict[str, torch.Tensor]:
    """Sum occurrence rows into tables, one `segment_sum` per row width.

    `blocks`: [(pname, ids, rows, n_rows, kind)], ids outside [0, n_rows)
    dropped (`.at[].add(mode="drop")`). `kind`
    is "local" (the block's sum is final), "reduce_scatter" (summed over
    the ranks, this rank keeps its n_rows / P rows) or "all_reduce"
    (summed over the ranks; one all-reduce for all such blocks of a
    width). Returns {pname: table}.
    """
    by_width: Dict[int, list] = {}
    for b in blocks:
        by_width.setdefault(b[2].shape[1], []).append(b)
    out = {}
    for bs in by_width.values():
        bs = sorted(bs, key=lambda b: b[4] == "all_reduce")  # stable
        ids, rows, offs, total = [], [], [], 0
        for _, i, r, n, _ in bs:
            ids.append(torch.where((i >= 0) & (i < n), i + total, -1))
            rows.append(r)
            offs.append(total)
            total += n
        table = segment_sum(torch.cat(ids), torch.cat(rows), total)
        first_ar = next((o for b, o in zip(bs, offs) if b[4] == "all_reduce"), None)
        if first_ar is not None:
            group.all_reduce_(table[first_ar:])
        for (pname, _, _, n, kind), lo in zip(bs, offs):
            block = table[lo:lo + n]
            out[pname] = group.reduce_scatter(block) if kind == "reduce_scatter" else block
    return out


def _augment(grads: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(T, F) gradient rows, their count channel, then zero columns up to a
    multiple of 4 (the kernel's 16-byte path)."""
    t = grads.shape[0]
    flat = grads.reshape(t, -1)
    f = flat.shape[1]
    return torch.cat([flat, counts.to(flat.dtype)[:, None],
                      flat.new_zeros((t, -(f + 1) % 4))], dim=1)


def partitioned_state_specs(model: KGEModel, opt: Optimizer):
    """(entity param name, {pname: SHARD_AXIS or None}, TrainState of
    specs): the entity table and its optimizer slots are row-sharded,
    everything else replicated."""
    epname = entity_param(model)
    specs = {pname: (SHARD_AXIS if pname == epname else None)
             for _, pname, _ in model.slot_spec()}
    specs.update({pname: None for pname in model.dense_param_names})
    return epname, specs, state_specs(specs, opt)


def state_specs(specs: Dict[str, Optional[str]], opt: Optimizer) -> TrainState:
    """A TrainState of specs from the params' `specs`: every optimizer slot
    of `opt` split as its table (axis 0 keeps the row split, whatever the
    slot's rank: Adam's per-row `t` is 1-D)."""
    slot_names = tuple(opt.init({"x": torch.zeros(1)})["x"])
    return TrainState(params=dict(specs),
                      opt_state={k: {sn: specs[k] for sn in slot_names} for k in specs},
                      generator=None, step=None)


def _prep(model, group: ShardGroup, sampler, boundary_cap, ragged):
    """Shared validation: (entity param name, S, shared pool?)."""
    epname = entity_param(model)
    n_e = model.n_entities
    if n_e % group.size != 0:
        raise ValueError(
            f"n_entities={n_e} must be {group.size}*S; relabel with "
            "relabel_entities and build the model with its n_padded")
    shared = hasattr(sampler, "pool")
    if boundary_cap is not None and not shared:
        raise ValueError(
            "boundary_cap requires a shared-pool sampler (the iid corruption "
            "gather is ~uniformly non-local; compaction only pays when most "
            "object rows are shard-local)")
    if ragged and boundary_cap is None:
        raise ValueError("ragged exchange requires boundary_cap")
    if ragged not in (False, True, "emulate"):
        raise ValueError(f"ragged must be False, True or 'emulate', got {ragged!r}")
    return epname, n_e // group.size, shared


def _build_local_step(
    model, opt, sampler, margin, group: ShardGroup, epname, s_rows, shared,
    boundary_cap, ragged=False, debug_checks=False, loss_kind="margin",
    alpha=1.0, directions=("o", "s"), label_smoothing=0.0,
):
    """This rank's step: (state, (L, 3) batch, (L,) mask) -> (state,
    StepMetrics summed over the ranks)."""
    me, p_sz = group.rank, group.size
    row_off = me * s_rows
    emulate = ragged == "emulate"
    logits = getattr(sampler, "logits", None) if loss_kind == "sampled_ce" else None
    log_q_tables: dict = {}

    def local_step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
        params = state.params
        table = params[epname]

        def local_rows(idx):
            """Owned rows for any global ids, zeros elsewhere."""
            local, own = _owned(idx, row_off, s_rows)
            rows = table[torch.clamp(local, 0, s_rows - 1)]
            return torch.where(_bcast(own, rows.dim()), rows, 0)

        def exchange(answers):
            """(P*T, ...) answer blocks, one owner per row -> (T, ...) rows
            for this rank's requests."""
            recv = group.all_to_all(answers)
            return recv.reshape((p_sz, -1) + tuple(answers.shape[1:])).sum(dim=0)

        def gather(pname, idx, role=None):
            if pname != epname:
                return params[pname][idx]
            if role == "s":  # subjects are local by construction
                return table[idx - row_off]
            return exchange(local_rows(group.all_gather(idx).reshape(-1)))

        def ragged_exchange(req_ids):
            """Owner-routed fetch: each answer row travels once, from its
            owner to the requester. Returns the rows in request order."""
            c = req_ids.shape[0]
            owner = torch.clamp(req_ids // s_rows, 0, p_sz - 1)
            o_perm = torch.argsort(owner, stable=True)
            counts = _counts(owner, p_sz)
            all_req = group.all_gather(req_ids[o_perm])           # (P, C)
            all_counts = group.all_gather(counts)                 # (P, P)
            starts = torch.cumsum(all_counts, dim=1) - all_counts
            flat_req = all_req.reshape(-1)
            mine = torch.clamp(flat_req // s_rows, 0, p_sz - 1) == me
            send_ids = flat_req[_first(mine)]   # mine first, in (q, within-q) order
            send_rows = table[torch.clamp(send_ids - row_off, 0, s_rows - 1)]
            sizes = all_counts[:, me]
            splits = None if emulate else _host_splits(all_counts.T, me)
            recv = _ragged_send(group, send_rows, torch.cumsum(sizes, 0) - sizes,
                                sizes, starts[:, me], counts, c, emulate,
                                splits=splits)                     # owner order
            inv = torch.empty_like(o_perm).scatter_(
                0, o_perm, torch.arange(c, device=o_perm.device))
            return recv[inv]

        def gather_compact(idx):
            """Only the <= C valid non-local ids cross ranks; surplus
            slots re-request other rows, whose answers are their own."""
            local, own = _owned(idx, row_off, s_rows)
            needed = ~own & (mask > 0)
            if debug_checks:
                _warn_if_cap_exceeded(needed.sum(), boundary_cap, "boundary_cap")
            req_pos = _first(needed)[:boundary_cap]
            if ragged:
                got = ragged_exchange(idx[req_pos])
            else:
                got = exchange(local_rows(group.all_gather(idx[req_pos]).reshape(-1)))
            rows = table[torch.clamp(local, 0, s_rows - 1)]
            rows = torch.where(_bcast(own, rows.dim()), rows, 0)
            return rows.index_copy(0, req_pos, got)

        pool_idx = None
        dnorm_raw = None
        if shared:
            # identical on every rank: the generators share one state
            pool_idx = sampler.pool(state.generator, batch, mask)

            def g(pname, idx, role=None):
                if role == "pool":
                    return (group.all_reduce(local_rows(idx)) if pname == epname
                            else params[pname][idx])
                if role == "s" and pname == epname:
                    return table[idx - row_off]
                if boundary_cap is not None and pname == epname:
                    return gather_compact(idx)
                return gather(pname, idx, role)

            if loss_kind == "selfadv":
                loss, occ, g_dense = selfadv_grads_shared(
                    model, params, batch, pool_idx, mask, margin, alpha,
                    modes=sampler.modes, gather=g)
                nviol = torch.zeros_like(loss)
                # dense grads are means over scored ELEMENTS; the raw count
                # (unclamped) makes the global denominator
                dnorm_raw = mask.sum() * (1.0 + pool_idx.shape[0] * len(sampler.modes))
            elif loss_kind == "sampled_ce":
                log_q = None
                if logits is not None:
                    lq = log_q_tables.get(pool_idx.device)
                    if lq is None:
                        lq = log_q_tables[pool_idx.device] = torch.log_softmax(
                            torch.as_tensor(logits).to(pool_idx.device), dim=0)
                    log_q = lq[pool_idx]
                loss, occ, g_dense = sampled_ce_grads_shared(
                    model, params, batch, pool_idx, mask, directions,
                    label_smoothing, log_q, gather=g)
                nviol = torch.zeros_like(loss)
                # occurrence grads are SUMS of the mean over the LOCAL valid
                # rows: rescale them, and the loss, to the global mean
                dnorm_raw = mask.sum()
                g_all = torch.clamp(group.all_reduce(dnorm_raw.to(loss.dtype)), min=1.0)
                scale = torch.clamp(dnorm_raw, min=1.0) / g_all
                occ = {pn: (i, gr * scale, c) for pn, (i, gr, c) in occ.items()}
                loss = loss * dnorm_raw / g_all
            else:
                loss, nviol, occ, g_dense = pairwise_grads_shared(
                    model, params, batch, pool_idx, mask, margin,
                    modes=sampler.modes, gather=g)
        else:
            corr = sampler.corruptions(state.generator, batch, mask)
            loss, nviol, occ, g_dense = pairwise_grads_fused(
                model, params, batch, corr, mask, margin, gather=gather)

        # loss, violations and the dense normalizer in one all-reduce
        parts = [loss, nviol.to(loss.dtype)]
        if dnorm_raw is not None:
            parts.append(dnorm_raw.to(loss.dtype))
        summed = group.all_reduce(torch.stack(parts))
        loss_all, nviol_all = summed[0], summed[1]
        if dnorm_raw is None:  # margin losses normalize by violations
            dnorm_local = torch.clamp(nviol, min=1.0)
            dnorm_global = torch.clamp(nviol_all, min=1.0)
        else:
            dnorm_local = torch.clamp(dnorm_raw, min=1.0)
            dnorm_global = torch.clamp(summed[2], min=1.0)

        blocks = []
        for pname, (idx, grads, counts) in occ.items():
            aug = _augment(grads, counts)
            if pname == epname and boundary_cap is not None:
                # owned rows straight into the (S, F+1) shard table; the
                # <= C+K non-owned rows CARRYING gradient to their owners
                local, own = _owned(idx, row_off, s_rows)
                gcap = boundary_cap + pool_idx.shape[0]
                needed = ~own & torch.any(aug != 0, dim=1)
                if debug_checks:
                    _warn_if_cap_exceeded(needed.sum(), gcap, "gradient-return cap")
                npos = _first(needed)[:gcap]
                # zero the surplus slots (owned rows are already counted)
                nb_aug = aug[npos] * needed[npos].to(aug.dtype)[:, None]
                if ragged:
                    rid = idx[npos]
                    dst = torch.clamp(rid // s_rows, 0, p_sz - 1)
                    dperm = torch.argsort(dst, stable=True)  # keeps add order
                    cnt = _counts(dst, p_sz)
                    allc = group.all_gather(cnt)              # (sender, receiver)
                    in_off = torch.cumsum(cnt, 0) - cnt
                    out_off = (torch.cumsum(allc, 0) - allc)[me]
                    recv_sz = allc[:, me]
                    splits = None if emulate else _host_splits(allc, me)
                    n_out = p_sz * npos.shape[0]
                    all_aug = _ragged_send(group, nb_aug[dperm], in_off, cnt, out_off,
                                           recv_sz, n_out, emulate, splits=splits)
                    all_ids = _ragged_send(group, rid[dperm], in_off, cnt, out_off,
                                           recv_sz, n_out, emulate, fill=-1,
                                           splits=splits)
                else:
                    all_ids = group.all_gather(idx[npos]).reshape(-1)
                    all_aug = group.all_gather(nb_aug).reshape(-1, aug.shape[1])
                lcl, owng = _owned(all_ids, row_off, s_rows)
                blocks.append((pname,
                               torch.cat([torch.where(own, local, -1),
                                          torch.where(owng, lcl, -1)]),
                               torch.cat([aug, all_aug]), s_rows, "local"))
            elif pname == epname:
                blocks.append((pname, idx, aug, p_sz * s_rows, "reduce_scatter"))
            else:
                blocks.append((pname, idx, aug, model.num_rows(pname), "all_reduce"))
        tables = _scatter_tables(group, blocks)

        new_params = dict(params)
        new_opt = dict(state.opt_state)
        for pname, (_, grads, _) in occ.items():
            t = tables[pname]
            feat = tuple(grads.shape[1:])
            f = math.prod(feat)
            count = t[:, f]
            gsum = t[:, :f].reshape((t.shape[0],) + feat)
            # sampled CE keeps SUM semantics over duplicates; counts gate
            gavg = gsum if loss_kind == "sampled_ce" else gsum / _bcast(
                torch.clamp(count, min=1.0), gsum.dim())
            gavg = regularized(model, pname, gavg, new_params[pname])
            new_params[pname], new_opt[pname] = opt.apply_dense_masked(
                new_params[pname], new_opt[pname], DenseGrads(grads=gavg, count=count),
                model.post_constraints.get(pname), step=state.step)
        for pname, g_d in g_dense.items():
            gsum = group.all_reduce(g_d * dnorm_local)
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], gsum / dnorm_global, step=state.step)
        new_state = TrainState(new_params, new_opt, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss_all, nviolations=nviol_all)

    return local_step


def _make_step(model, opt, sampler, margin, group, boundary_cap, ragged,
               debug_checks, **kw):
    epname, s_rows, shared = _prep(model, group, sampler, boundary_cap, ragged)
    return _build_local_step(model, opt, sampler, margin, group, epname, s_rows,
                             shared, boundary_cap, ragged, debug_checks, **kw)


def make_partitioned_pairwise_step(
    model: KGEModel, opt: Optimizer, sampler, margin: float, group: ShardGroup,
    boundary_cap: Optional[int] = None, ragged=False, debug_checks: bool = False,
):
    """Partition-aligned pairwise margin step, called on every rank as
    `step(state, batch, mask)` with this rank's (L, 3) int64 triples and
    (L,) mask (row r of `data.partition_edges` on RELABELED triples) and
    its state (`shard_state_partitioned`, `init_state_partitioned`).
    Requires model.n_entities == P * S. Takes the `pool` and `corruptions`
    sampler protocols (iid draws come from the state's generator).

    `boundary_cap` (shared pools only) turns on the compacted exchange; C
    must be at least `object_boundary_cap`, since rows beyond it add no
    gradient. `ragged`: False (the dense return), True (owner-routed
    `all_to_all_single`) or "emulate" (the ragged layout in fixed blocks).
    `debug_checks` warns, at one host wait a check, when a cap is short.
    """
    return _make_step(model, opt, sampler, margin, group, boundary_cap, ragged,
                      debug_checks)


def make_partitioned_selfadv_step(
    model: KGEModel, opt: Optimizer, sampler, margin: float, group: ShardGroup,
    alpha: float = 1.0, boundary_cap: Optional[int] = None, ragged=False,
    debug_checks: bool = False,
):
    """Partition-aligned self-adversarial step: the pairwise step's inputs
    and exchanges; the dense gradients normalize by scored elements."""
    if not hasattr(sampler, "pool"):
        raise ValueError("make_partitioned_selfadv_step needs a shared-pool sampler")
    return _make_step(model, opt, sampler, margin, group, boundary_cap, ragged,
                      debug_checks, loss_kind="selfadv", alpha=alpha)


def make_partitioned_sampled_ce_step(
    model: KGEModel, opt: Optimizer, sampler, group: ShardGroup,
    directions: Tuple[str, ...] = ("o", "s"), label_smoothing: float = 0.0,
    boundary_cap: Optional[int] = None, ragged=False, debug_checks: bool = False,
):
    """Partition-aligned sampled-softmax CE step: each rank scores its own
    batch against the shared pool; occurrence gradients keep the sampled
    CE's sum semantics, rescaled from the local to the global mean. A
    sampler with unigram `logits` feeds the proposal correction."""
    if not hasattr(sampler, "pool"):
        raise ValueError("make_partitioned_sampled_ce_step needs a shared-pool sampler")
    return _make_step(model, opt, sampler, 0.0, group, boundary_cap, ragged,
                      debug_checks, loss_kind="sampled_ce", directions=directions,
                      label_smoothing=label_smoothing)


def make_partitioned_ce_step(
    model: KGEModel, opt: Optimizer, group: ShardGroup,
    directions: Tuple[str, ...] = ("o", "s"), label_smoothing: float = 0.0,
):
    """Partition-aligned full cross entropy. Every rank all-gathers the
    queries of all ranks and scores them against its own (S, ·) candidate
    rows, so the logit work is split P ways; the log-sum-exp, the label's
    logit and (with label smoothing) the logit sum are reduced across the
    ranks. The candidate-block gradient is complete on its owner; the
    query-row and dense gradients are summed across the ranks. Each table
    takes `apply_full` and its post-constraint, as `make_ce_step`: the
    relabeling's padding rows sit in the partition function, as in a
    single-device run on the padded model, and are masked out of the
    candidates at evaluation. With `directions=('o',)` no entity row
    crosses ranks in the forward gather."""
    epname = entity_param(model)
    if model.n_entities % group.size != 0:
        raise ValueError(
            f"n_entities={model.n_entities} must be {group.size}*S; relabel with "
            "relabel_entities and build the model with its n_padded")
    return _build_ce_local_step(model, opt, group, epname,
                                model.n_entities // group.size, directions,
                                label_smoothing)


def _build_ce_local_step(model, opt, group: ShardGroup, epname, s_rows, directions,
                         label_smoothing):
    n_e = model.n_entities
    me, p_sz = group.rank, group.size
    row_off = me * s_rows
    ls = float(label_smoothing)
    need = {"p"} | ({"s"} if "o" in directions else set()) | (
        {"o"} if "s" in directions else set())
    col = {"s": 0, "o": 1, "p": 2}
    slots = [(slot, pname, role) for slot, pname, role in model.slot_spec()
             if role in need]
    for d in directions:
        if d not in ("o", "s"):
            raise ValueError(f"direction {d!r} (want 'o'/'s')")

    def local_step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor):
        params = state.params
        table = params[epname]

        def rows_of(pname, idx, role):
            if pname != epname:
                return params[pname][idx]
            if role == "s":
                return table[idx - row_off]
            local, own = _owned(group.all_gather(idx).reshape(-1), row_off, s_rows)
            answers = table[torch.clamp(local, 0, s_rows - 1)]
            answers = torch.where(_bcast(own, answers.dim()), answers, 0)
            recv = group.all_to_all(answers)
            return recv.reshape((p_sz, -1) + tuple(answers.shape[1:])).sum(dim=0)

        def ag(x):  # every rank's batch-aligned rows, rank-major
            g = group.all_gather(x)
            return g.reshape((-1,) + tuple(g.shape[2:]))

        rows_all = {slot: ag(rows_of(pname, batch[:, col[role]], role))
                    .detach().requires_grad_()
                    for slot, pname, role in slots}
        batch_all = ag(batch)
        mask_all = ag(mask)
        cand = table.detach().requires_grad_()
        dense = {k: v.detach().requires_grad_()
                 for k, v in model.dense_params(params).items()}
        denom = torch.clamp(mask_all.sum(), min=1.0)
        barange = torch.arange(batch_all.shape[0], device=batch.device)
        w = (mask_all / denom)[:, None]
        total = 0.0
        outs, couts = [], []
        with torch.enable_grad():
            for d in directions:
                lg = model.score_pool(rows_all, cand, dense, {"o": 1, "s": 0}[d])
                outs.append(lg)
        for d, lg in zip(directions, outs):
            x = lg.detach()
            mrow = group.all_reduce(x.max(dim=1).values, op=dist.ReduceOp.MAX)
            se = group.all_reduce(torch.exp(x - mrow[:, None]).sum(dim=1))
            logz = torch.log(se) + mrow
            ll, own = _owned(batch_all[:, col[d]], row_off, s_rows)
            llc = torch.clamp(ll, 0, s_rows - 1)
            f_label = group.all_reduce(torch.where(own, x[barange, llc], 0))
            nll = logz - f_label
            gl = torch.exp(x - logz[:, None])
            onehot = torch.zeros_like(x)
            onehot[barange, llc] = own.to(x.dtype)
            if ls:
                sum_logits = group.all_reduce(x.sum(dim=1))
                nll = (1.0 - ls) * nll - ls * (sum_logits / n_e - logz)
                gl = gl - (1.0 - ls) * onehot - ls / n_e
            else:
                gl = gl - onehot
            total = total + torch.sum(nll * mask_all)
            couts.append(w * gl)
        loss = total / denom
        leaves = [*rows_all.values(), cand, *dense.values()]
        grads = torch.autograd.grad(outs, leaves, couts, allow_unused=True,
                                    materialize_grads=True)
        n = len(rows_all)
        g_rows = {k: group.all_reduce(g) for k, g in zip(rows_all, grads[:n])}
        g_cand = grads[n]
        g_dense = {k: group.all_reduce(g) for k, g in zip(dense, grads[n + 1:])}

        # the query-row gradients, complete on every rank, into the tables:
        # this rank's owned entity rows and every replicated table, with
        # zero columns up to a multiple of 4 (the kernel's 16-byte path)
        blocks = []
        for slot, pname, role in slots:
            ids = batch_all[:, col[role]]
            gr = g_rows[slot].reshape(ids.shape[0], -1)
            gr = torch.cat([gr, gr.new_zeros((gr.shape[0], -gr.shape[1] % 4))], dim=1)
            if pname == epname:
                local, own = _owned(ids, row_off, s_rows)
                blocks.append((pname, torch.where(own, local, -1), gr, s_rows, "local"))
            else:
                blocks.append((pname, ids, gr, model.num_rows(pname), "local"))
        merged: Dict[str, list] = {}
        for b in blocks:  # one block per table
            merged.setdefault(b[0], []).append(b)
        tables = _scatter_tables(group, [
            (pn, torch.cat([b[1] for b in bs]), torch.cat([b[2] for b in bs]),
             bs[0][3], "local") for pn, bs in merged.items()])
        g_tables = {epname: g_cand}
        for pname, t in tables.items():  # less the zero columns
            t = t[:, :math.prod(params[pname].shape[1:])].reshape(params[pname].shape)
            g_tables[pname] = g_tables[pname] + t if pname in g_tables else t
        g_tables.update(g_dense)

        new_params, new_opt = dict(params), dict(state.opt_state)
        for pname, gt in g_tables.items():
            gt = regularized(model, pname, gt, new_params[pname])
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], gt, step=state.step)
            post = model.post_constraints.get(pname)
            if post is not None:
                new_params[pname] = POST_CONSTRAINTS[post](new_params[pname])
        new_state = TrainState(new_params, new_opt, state.generator, state.step + 1)
        return new_state, StepMetrics(loss=loss.detach(), nviolations=torch.zeros_like(loss))

    return local_step


def _shuffle_seed(seed: int, step: int, rank: int) -> int:
    """The seed of a rank's epoch permutation: from the run's seed, the
    epoch's first step and the rank."""
    mixed = np.random.SeedSequence([seed, step, rank]).generate_state(1, np.uint64)[0]
    return int(mixed) & ((1 << 63) - 1)


def make_partitioned_epoch(
    model: KGEModel, opt: Optimizer, sampler, margin: float, group: ShardGroup,
    length: int, nbatches: int, boundary_cap: Optional[int] = None, ragged=False,
    debug_checks: bool = False, loss: str = "margin", adv_alpha: float = 1.0,
    directions: Tuple[str, ...] = ("o", "s"), label_smoothing: float = 0.0,
    seed: int = 0,
):
    """Epoch over this rank's partitioned batch: its own shuffle, padded to
    nbatches x ceil(length / nbatches) masked rows, then the step over the
    minibatches. `loss` is 'margin', 'selfadv', 'sampled_ce' (pool
    samplers) or 'ce' (no sampler; `boundary_cap` unused).

    `epoch(state, batch, mask, perm=None)` with this rank's (L, 3) batch
    and (L,) mask; `perm` replaces the rank's permutation, which is drawn
    from (`seed`, the state's step, the rank) and so differs by rank while
    the pool generator stays the same on every rank. `boundary_cap` is
    clamped to the minibatch size: valid non-local rows are requested
    first, and a minibatch holds no more of them than the whole batch.
    """
    if loss not in ("margin", "selfadv", "ce", "sampled_ce"):
        raise ValueError(f"unknown partitioned loss {loss!r}")
    if loss in ("selfadv", "sampled_ce") and not hasattr(sampler, "pool"):
        raise ValueError(f"loss={loss!r} needs a shared-pool sampler (the softmax "
                         "terms are defined over a candidate pool)")
    batch_size = -(-length // nbatches)
    padded = nbatches * batch_size
    if loss == "ce":
        step = make_partitioned_ce_step(model, opt, group, directions, label_smoothing)
    else:
        cap = None if boundary_cap is None else min(boundary_cap, batch_size)
        step = _make_step(model, opt, sampler, margin, group, cap, ragged,
                          debug_checks, loss_kind=loss, alpha=adv_alpha,
                          directions=directions, label_smoothing=label_smoothing)

    def epoch(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
              perm: Optional[torch.Tensor] = None):
        dev = batch.device
        if perm is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_shuffle_seed(seed, state.step, group.rank))
            perm = torch.randperm(length, generator=gen, device=dev)
        perm = perm.to(dev)
        pad_idx = torch.cat([perm, perm.new_zeros(padded - length)])
        mflat = (torch.arange(padded, device=dev) < length).to(mask.dtype) * mask[pad_idx]
        mbs = batch[pad_idx].reshape(nbatches, batch_size, batch.shape[1])
        mms = mflat.reshape(nbatches, batch_size)
        metrics = []
        for b in range(nbatches):
            state, m = step(state, mbs[b], mms[b])
            metrics.append(m)
        return state, StepMetrics(loss=torch.stack([m.loss for m in metrics]),
                                  nviolations=torch.stack([m.nviolations for m in metrics]))

    return epoch


def shard_state_partitioned(state: TrainState, model: KGEModel, group: ShardGroup,
                            generator: Optional[torch.Generator] = None) -> TrainState:
    """This rank's part of a full state (tensors or arrays on any device,
    e.g. one converted from the JAX package): rows [r*S, (r+1)*S) of the
    entity table and its optimizer slots, every other leaf whole, on the
    group's device. The generator is `generator`, else the state's, which
    must then be on the group's device type: a generator's position cannot
    move between device types, and a reseeded one would repeat its draws
    (load a checkpoint on the group's device instead)."""
    epname = entity_param(model)
    s_rows = model.n_entities // group.size
    lo, hi = group.rank * s_rows, (group.rank + 1) * s_rows

    def put(pname, v):
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if pname == epname:
            v = v[lo:hi]
        return v.to(group.device).clone()

    gen = state.generator if generator is None else generator
    if gen is None or gen.device.type != group.device.type:
        raise ValueError(
            f"the state's generator is on {getattr(gen, 'device', None)}, the group "
            f"runs on {group.device.type}: pass a generator on the group's device, or "
            "give the state one (load_checkpoint(path, device) restores it there)")
    params = {k: put(k, v) for k, v in state.params.items()}
    opt_state = {k: {sn: put(k, v) for sn, v in slots.items()}
                 for k, slots in state.opt_state.items()}
    return TrainState(params, opt_state, gen, int(state.step))


def init_state_partitioned(model: KGEModel, opt: Optimizer, seed: int,
                           group: ShardGroup) -> TrainState:
    """A fresh state in the partitioned placement: the same values on the
    host as `training.init_state` with a CPU generator seeded `seed`, of
    which this rank's device gets only its own entity rows. The training
    draws then continue that generator on the CPU; on the card they come
    from a CUDA generator seeded `seed`, the same on every rank."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = model.init_params(gen)
    state = TrainState(params, opt.init(params), gen, 0)
    if group.device.type != "cpu":
        gen = torch.Generator(device=group.device)
        gen.manual_seed(seed)
    return shard_state_partitioned(state, model, group, generator=gen)


class RelabeledPoolSampler:
    """Shared negative pool over REAL entities in the relabeled id space:
    original ids drawn uniformly and mapped through `new_of_old`, so the
    relabeling's padding rows are never drawn. Identical on every rank
    when the generators are."""

    modes = (0, 1)

    def __init__(self, new_of_old: np.ndarray, k: int = 1024):
        self._map_host = torch.as_tensor(np.asarray(new_of_old), dtype=torch.int64)
        self._maps: dict = {}
        self.k = int(k)

    def pool(self, generator: torch.Generator, pos, mask) -> torch.Tensor:
        dev = generator.device
        m = self._maps.get(dev)
        if m is None:
            m = self._maps[dev] = self._map_host.to(dev)
        u = torch.randint(0, m.shape[0], (self.k,), generator=generator, device=dev)
        return m[u]


class PartitionedTrainer:
    """The partitioned path behind one object, `OutOfCoreTrainer`'s in/out
    contract across processes instead of host memory.

    Takes the triples in ORIGINAL entity ids on every rank, partitions the
    entities (community-aware), relabels them so each rank owns a
    contiguous row range, and keeps this rank's batch (every rank computes
    the same layout: the partition is deterministic NumPy). `params()`
    returns the tables in original ids, all-gathered.

    `loss`: 'margin', 'selfadv', 'ce' or 'sampled_ce'. `reciprocal=True`
    (the CE losses) expects triples from `data.add_reciprocal_relations`
    and a model with the doubled relation count; it trains the object
    direction only and `evaluate` asks head queries through the inverse
    relation. `exchange`: 'dense', 'ragged' (owner-routed,
    `all_to_all_single` with uneven splits), 'emulate' (the ragged layout
    in fixed blocks), 'auto', or '' (the legacy `ragged` argument decides);
    the three exchanges give the same values. 'auto' picks dense or ragged
    by `choose_exchange` with `exchange_costs` (required: the link rate
    between cards is the caller's to state) at this trainer's d, cap, pool,
    batch a step and shard count, and records the choice and the model's
    numbers, with the loss, in `stats['exchange']`. `ragged` (False, True
    or 'emulate') is the JAX package's legacy argument, exclusive with
    `exchange`; True (and 'ragged', chosen or given) is the real uneven
    `all_to_all_single` on gloo and NCCL alike, where the JAX package's
    'ragged' runs its dense emulation on every backend but the TPU. The
    boundary cap is the exact one (`object_boundary_cap`).
    """

    def __init__(
        self,
        model: KGEModel,
        opt: Optimizer,
        triples: np.ndarray,
        group: Optional[ShardGroup] = None,
        margin: float = 1.0,
        k: int = 1024,
        nbatches: int = 100,
        seed: int = 0,
        loss: str = "margin",
        adv_alpha: float = 1.0,
        reciprocal: bool = False,
        label_smoothing: float = 0.0,
        exchange: str = "",
        exchange_costs: Optional[ExchangeCosts] = None,
        ragged=False,
    ):
        if exchange and ragged:
            raise ValueError("pass either `exchange` or legacy `ragged`")
        if exchange not in ("", "auto") + EXCHANGES:
            raise ValueError(f"unknown exchange mode {exchange!r}")
        if ragged not in (False, True, "emulate"):
            raise ValueError(f"ragged must be False, True or 'emulate', got {ragged!r}")
        if exchange == "auto" and exchange_costs is None:
            raise ValueError(
                "exchange='auto' needs exchange_costs=ExchangeCosts(link_bytes_per_s=...): "
                "the link rate between cards is not measured on one card, so give it")
        if reciprocal and loss not in ("ce", "sampled_ce"):
            raise ValueError("reciprocal=True requires loss='ce' or 'sampled_ce'")
        self.group = group = group if group is not None else make_shard_mesh()
        n_shards = group.size
        t = np.asarray(triples, np.int32)
        part = (greedy_entity_partition(t, model.n_entities, n_shards, seed=seed)
                if n_shards > 1 else np.zeros(model.n_entities, np.int32))
        rel, self.new_of_old, n_pad = relabel_entities(t, part, n_shards)
        s = n_pad // n_shards
        owner = (np.arange(n_pad) // s).astype(np.int32)
        batches, mask, self.stats = partition_edges(rel, owner, n_shards)
        self.cap = max(1, object_boundary_cap(batches, s, mask))
        self.full_model = model
        self.model = replace(model, n_entities=n_pad)
        self.opt = opt
        self.reciprocal = reciprocal
        self.seed = seed
        self.sampler = RelabeledPoolSampler(self.new_of_old, k=k)
        length = batches.shape[1]
        self.nbatches = max(1, min(nbatches, length))
        if exchange == "auto":
            per_batch = max(1, length // self.nbatches)
            # the hideable pool compute scales with the scoring directions: 2
            # for pairwise and selfadv, len(directions) for sampled CE
            n_modes = (1 if reciprocal else 2) if loss == "sampled_ce" else 2
            exchange, report = choose_exchange(
                d=model.ncomp, cap=min(self.cap, per_batch), k=k,
                batch_per_shard=per_batch, p=n_shards, costs=exchange_costs,
                n_modes=n_modes)
            report["loss"] = loss
            self.stats["exchange"] = report
        self.exchange = exchange or {False: "dense", True: "ragged",
                                     "emulate": "emulate"}[ragged]
        self._epoch = make_partitioned_epoch(
            self.model, opt, self.sampler, margin, group, length=length,
            nbatches=self.nbatches, boundary_cap=self.cap,
            ragged={"dense": False, "ragged": True, "emulate": "emulate"}[self.exchange],
            loss=loss, adv_alpha=adv_alpha,
            directions=("o",) if reciprocal else ("o", "s"),
            label_smoothing=label_smoothing, seed=seed)
        self._state = init_state_partitioned(self.model, opt, seed, group)
        self._batches, self._mask = make_global_batches(
            batches[group.rank], mask[group.rank], group, dtype=self.model.tdtype)
        self._metrics: list = []

    def _fit_epoch(self, perm: Optional[torch.Tensor] = None) -> dict:
        """One epoch (`perm` replaces this rank's permutation); its metrics,
        read with one host wait."""
        self._state, m = self._epoch(self._state, self._batches, self._mask, perm)
        sums = torch.stack([m.loss.sum(), m.nviolations.sum()]).tolist()
        self._metrics.append({"epoch": len(self._metrics), "loss": float(sums[0]),
                              "nviolations": float(sums[1])})
        return self._metrics[-1]

    def fit(self, epochs: int = 1, verbose: bool = False) -> "PartitionedTrainer":
        for _ in range(epochs):
            m = self._fit_epoch()
            if verbose:
                print(m, flush=True)
        return self

    @property
    def metrics(self):
        return list(self._metrics)

    def _sharded(self):
        return (entity_param(self.model),)

    def save(self, dirpath: str) -> "PartitionedTrainer":
        """Sharded checkpoint in the JAX package's layout: each rank writes
        its own rows, rank 0 the manifest and the replicated leaves."""
        from skge_torch.utils.checkpoint import save_sharded_checkpoint

        save_sharded_checkpoint(
            dirpath, self._state,
            meta={"metrics": self._metrics,
                  "n_entities": int(self.full_model.n_entities)},
            group=self.group, sharded=self._sharded())
        return self

    def restore(self, dirpath: str) -> "PartitionedTrainer":
        """Resume from `save` (either package's): this rank reads its own
        row range, whatever the saving run's shard count; the metrics
        continue. Without the port's generator state in the files (a JAX
        checkpoint) the generator is a fresh one, seeded from the seed and
        the step."""
        from skge_torch.utils.checkpoint import load_sharded_checkpoint

        self._state, meta = load_sharded_checkpoint(
            dirpath, self.group, sharded=self._sharded(), seed=self.seed)
        self._metrics = list(meta.get("metrics", []))
        return self

    def evaluate(self, test: np.ndarray, known: Optional[np.ndarray] = None,
                 batch_size: int = 1024, hits_at=(1, 3, 10), ties: str = "mean"):
        """Filtered ranking on the sharded, relabeled state: each rank
        scores its own candidate columns, the relabeling's padding rows
        masked out; the greater and equal counts are summed over the ranks.
        The ranks are those of the gathered table in original ids."""
        test = np.asarray(test, np.int64)
        known = test if known is None else np.asarray(known, np.int64)

        def remap(t):
            return np.stack([self.new_of_old[t[:, 0]], self.new_of_old[t[:, 1]],
                             t[:, 2]], axis=1).astype(np.int32)

        cmask = np.zeros(self.model.n_entities, bool)
        cmask[self.new_of_old] = True
        eval_model = ReciprocalEvalWrapper(self.model) if self.reciprocal else self.model
        ev = FilteredRankingEval(eval_model, remap(test), remap(known), batch_size,
                                 hits_at, ties=ties, group=self.group,
                                 candidate_mask=cmask)
        res = ev(self._state.params)
        res.test = np.asarray(test, np.int32)
        return res

    def params(self) -> Dict[str, np.ndarray]:
        """Host params with the entity table in ORIGINAL ids (all-gathered
        from every rank), for the original-size model."""
        epname = entity_param(self.model)
        out = {}
        for name, v in self._state.params.items():
            if name == epname:
                out[name] = host_replicate(v, self.group)[self.new_of_old]
            else:
                out[name] = v.detach().cpu().numpy()
        return out
