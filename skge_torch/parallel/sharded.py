"""SPMD train steps and all-entity scoring on the ('data', 'model') mesh,
`skge_tpu.parallel.sharded`'s counterpart.

The JAX module lets GSPMD place the collectives of the single-device step
('dense' aggregation) from the parameters' shardings; its contract is that
the result equals the single-device step. Torch has no GSPMD, so the same
names and signatures are built on `shardmap_step`'s explicit helpers: the
masked-local row gather over 'model', the owned-row scatter through K1 and
the sum over 'data'. The shared-pool and `corruptions` (fused iid) samplers
take `shardmap_step`'s steps; a sampler with only the expanded form
(positives repeated, negatives, pair mask) takes the generic route here,
whose pairs are drawn for the global batch and split evenly over 'data'
(padded with masked pairs to a multiple of its size).

Every rank calls a step with the global batch and mask and its own part
of the state (`mesh.shard_state`).
"""

from __future__ import annotations

import torch

from skge_torch.models.base import KGEModel, entity_param
from skge_torch.optim import Optimizer
from skge_torch.parallel.mesh import Mesh, data_slice
from skge_torch.parallel.shardmap_step import (_local_rows, _make_gather, _mesh_step,
                                               make_shardmap_pairwise_step,
                                               make_shardmap_pointwise_step)
from skge_torch.training import draw_expanded, pairwise_grads, pointwise_grads


def _split(mesh: Mesh, *xs: torch.Tensor):
    """This data rank's even share of per-pair arrays, padded with zeros
    (masked pairs: the last array is the mask) to a multiple of 'data'."""
    n = xs[0].shape[0]
    pad = (-n) % mesh.data.size
    if pad:
        xs = tuple(torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) for x in xs)
    return tuple(data_slice(x, mesh) for x in xs)


def make_sharded_pairwise_step(model: KGEModel, opt: Optimizer, sampler, margin: float,
                               mesh: Mesh):
    """Mesh pairwise step, `step(state, batch, mask, rows=None)`, equal to
    the single-device step with 'dense' aggregation. Shared pools and
    `corruptions` samplers run `make_shardmap_pairwise_step`; other
    samplers the generic expanded pairs (`pairwise_grads`)."""
    if hasattr(sampler, "pool") or hasattr(sampler, "corruptions"):
        return make_shardmap_pairwise_step(model, opt, sampler, margin, mesh)

    def grads_of(state, batch, mask, rows, gather):
        pos, neg, pm = _split(mesh, *draw_expanded(sampler, state.generator, batch,
                                                   mask, rows))
        out = pairwise_grads(model, state.params, pos, neg, pm, margin, gather=gather)
        return (*out, out[1])

    return _mesh_step(model, opt, mesh, _local_rows(model, mesh, False), grads_of)


def make_sharded_pointwise_step(model: KGEModel, opt: Optimizer, sampler, mesh: Mesh):
    """Mesh pointwise (logistic) step, equal to the single-device
    `make_pointwise_step` with 'dense' aggregation: a shared pool runs
    `make_shardmap_pointwise_step`; an iid sampler's negatives are appended
    to the global batch with y = -1 and the triples split over 'data'."""
    if hasattr(sampler, "pool"):
        return make_shardmap_pointwise_step(model, opt, sampler, mesh)

    def grads_of(state, batch, mask, rows, gather):
        _, neg, pm = draw_expanded(sampler, state.generator, batch, mask, rows)
        ys = torch.ones(batch.shape[0] + neg.shape[0], dtype=model.tdtype,
                        device=batch.device)
        ys[batch.shape[0]:] = -1.0
        triples, ys, mm = _split(mesh, torch.cat([batch, neg]), ys,
                                 torch.cat([mask, pm]))
        loss, occ, g_dense = pointwise_grads(model, state.params, triples, ys, mm,
                                             gather=gather)
        return loss, torch.zeros_like(loss), occ, g_dense, mm.sum()

    return _mesh_step(model, opt, mesh, _local_rows(model, mesh, False), grads_of)


def make_sharded_score_all_o(model: KGEModel, mesh: Mesh):
    """All-entity object scoring on the mesh: `score(params, s, p)` with
    this rank's params and the global (B,) queries returns this data
    rank's (B/D, n_e) rows of the (B, n_e) score matrix. Each 'model' rank
    scores its (S,) candidate block against the masked-local gathered query
    rows, and the blocks are all-gathered over 'model', in entity order."""
    epname = entity_param(model)
    local_rows = _local_rows(model, mesh, False)  # raises on an indivisible count

    @torch.no_grad()
    def score(params, s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        gather = _make_gather(params, local_rows, mesh)
        s, p = data_slice(s, mesh), data_slice(p, mesh)
        idx = {"s": s, "o": torch.zeros_like(s), "p": p}
        q = {slot: gather(pname, idx[role], role) for slot, pname, role in model.slot_spec()}
        block = model.score_pool(q, params[epname], model.dense_params(params), 1)
        blocks = mesh.model.all_gather(block.contiguous())        # (M, B/D, S)
        return blocks.permute(1, 0, 2).reshape(block.shape[0], -1)

    return score
