"""The 2-D ('data', 'model') mesh on `torch.distributed`,
`skge_tpu.parallel.mesh`'s counterpart.

One process per device, world size D * M, ranks laid out as JAX's
`make_mesh` reshapes its devices, row-major: rank = d * M + m.

- axis 'data': the batch. Data rank d takes rows [d * B/D, (d+1) * B/D) of
  every global batch; the `'data'` group holds the ranks with the same m.
- axis 'model': entity-table rows. Model rank m holds rows
  [m * S, (m+1) * S), S = n_e / M, of the entity table and of its
  optimizer slots; the `'model'` group holds the ranks with the same d.
  Relation tables and dense params are replicated.

Each group is a `distributed.ShardGroup`, so the partitioned trainer's
collectives serve both axes. On the card every process drives
`cuda:LOCAL_RANK` over NCCL; with `device="cpu"` the processes run on the
CPU over gloo. A (1, 1) mesh is one process with two groups of one; its
collectives run as on any other shape.

Torch has no GSPMD: where the JAX module returns `NamedSharding`s, this
one returns the axis a table is split over (or None) and the slicing
helpers that place a full state or batch onto this rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from skge_torch.models.base import KGEModel, entity_param
from skge_torch.optim import Optimizer
from skge_torch.parallel import distributed
from skge_torch.parallel.distributed import ShardGroup
from skge_torch.parallel.partitioned import state_specs
from skge_torch.training import TrainState

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the ('data', 'model') mesh: `shape` maps
    each axis to its size, `data` and `model` are its two groups (their
    `rank` is this process's index along the axis), `rank` its world rank
    and `device` its device."""

    shape: Dict[str, int]
    data: ShardGroup
    model: ShardGroup
    rank: int
    device: torch.device

    def group(self, axis: str) -> ShardGroup:
        """The group along `axis` ('data' or 'model')."""
        if axis == DATA_AXIS:
            return self.data
        if axis == MODEL_AXIS:
            return self.model
        raise ValueError(f"unknown mesh axis {axis!r}")


def make_mesh(shape: Optional[Tuple[int, int]] = None, device=None) -> Mesh:
    """The (D, M) mesh over the world, initializing the process group first
    when needed (`distributed.initialize(device=device)`). `shape=None`:
    'model' gets 2 when the world size is even, else 1. Every rank builds
    every group, in the same order."""
    if not dist.is_initialized():
        distributed.initialize(device=device)
    n = dist.get_world_size()
    if shape is None:
        m = 2 if n % 2 == 0 and n >= 2 else 1
        shape = (n // m, m)
    d_size, m_size = (int(x) for x in shape)
    if d_size * m_size != n:
        raise ValueError(f"mesh {tuple(shape)} != {n} processes")
    rank = dist.get_rank()
    d, m = divmod(rank, m_size)
    dev = distributed.world_device()
    groups = {}
    for i in range(d_size):  # 'model' groups: the ranks of one data index
        g = dist.new_group([i * m_size + j for j in range(m_size)])
        if i == d:
            groups[MODEL_AXIS] = ShardGroup(group=g, rank=m, size=m_size, device=dev)
    for j in range(m_size):  # 'data' groups: the ranks of one model index
        g = dist.new_group([i * m_size + j for i in range(d_size)])
        if j == m:
            groups[DATA_AXIS] = ShardGroup(group=g, rank=d, size=d_size, device=dev)
    return Mesh(shape={DATA_AXIS: d_size, MODEL_AXIS: m_size}, data=groups[DATA_AXIS],
                model=groups[MODEL_AXIS], rank=rank, device=dev)


def param_specs(model: KGEModel, shard_relations: bool = False) -> Dict[str, Optional[str]]:
    """{pname: MODEL_AXIS or None}: the entity table row-sharded over
    'model' (relation tables too with `shard_relations`), everything else
    replicated."""
    epname = entity_param(model)
    specs = {pname: (MODEL_AXIS if pname == epname or (shard_relations and role == "p")
                     else None)
             for _, pname, role in model.slot_spec()}
    specs.update({pname: None for pname in model.dense_param_names})
    return specs


def state_shardings(model: KGEModel, mesh: Mesh, opt: Optional[Optimizer] = None,
                    shard_relations: bool = False) -> TrainState:
    """A TrainState of specs (`param_specs`), every optimizer slot split as
    its table (`partitioned.state_specs`). Slot names come from `opt`
    (AdaGrad's by default)."""
    from skge_torch.optim import AdaGrad

    return state_specs(param_specs(model, shard_relations), opt or AdaGrad())


def row_block(x, n_rows: int, group: ShardGroup):
    """This rank's row block of a table split over `group`: `x` itself when
    it already holds n_rows / group.size rows, else rows
    [r * S, (r+1) * S) of the full table."""
    if n_rows % group.size != 0:
        raise ValueError(f"{n_rows} rows not divisible by the axis size {group.size}")
    s = n_rows // group.size
    if x.shape[0] == s:
        return x
    if x.shape[0] != n_rows:
        raise ValueError(f"a table of {x.shape[0]} rows; want {n_rows} or {s}")
    return x[group.rank * s:(group.rank + 1) * s]


def _tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))


def shard_state(state: TrainState, model: KGEModel, mesh: Mesh,
                shard_relations: bool = False) -> TrainState:
    """This rank's part of a full state (tensors or arrays on any device):
    row block m of every table split over 'model' and of each of its
    optimizer slots, every other leaf whole, on the mesh's device. The
    state's generator is kept, and must be on the mesh's device type: a
    generator's position cannot move between device types, and a reseeded
    one would repeat its draws (load a checkpoint on the mesh's device
    instead). Every rank must hold the same generator state, since every
    rank draws the global batch's negatives."""
    specs = param_specs(model, shard_relations)

    def put(pname, v):
        v = _tensor(v)
        if specs.get(pname) == MODEL_AXIS:
            v = row_block(v, model.num_rows(pname), mesh.model)
        return v.to(mesh.device).clone()

    params = {k: put(k, v) for k, v in state.params.items()}
    opt_state = {k: {sn: put(k, v) for sn, v in slots.items()}
                 for k, slots in state.opt_state.items()}
    gen = state.generator
    if gen is None or gen.device.type != mesh.device.type:
        raise ValueError(
            f"the state's generator is on {getattr(gen, 'device', None)}, the mesh "
            f"runs on {mesh.device.type}: give the state a generator on the mesh's "
            "device (load_checkpoint(path, device) restores it there)")
    return TrainState(params, opt_state, gen, int(state.step))


def unshard_state(state: TrainState, model: KGEModel, mesh: Mesh,
                  shard_relations: bool = False) -> TrainState:
    """The full state from this rank's part: every table split over
    'model', and its slots, all-gathered in rank order (a collective: every
    rank calls it)."""
    specs = param_specs(model, shard_relations)

    def full(pname, v):
        if specs.get(pname) != MODEL_AXIS:
            return v
        g = mesh.model.all_gather(v.contiguous())
        return g.reshape((-1,) + tuple(v.shape[1:]))

    return TrainState(
        params={k: full(k, v) for k, v in state.params.items()},
        opt_state={k: {sn: full(k, v) for sn, v in slots.items()}
                   for k, slots in state.opt_state.items()},
        generator=state.generator, step=state.step)


def data_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's rows [d * B/D, (d+1) * B/D) of a global batch (or
    mask, or any per-row array)."""
    b, d_size = x.shape[0], mesh.data.size
    if b % d_size != 0:
        raise ValueError(f"a batch of {b} rows does not divide the 'data' axis "
                         f"({d_size}); pad it (make_epoch_fn(pad_to=))")
    n = b // d_size
    return x[mesh.data.rank * n:(mesh.data.rank + 1) * n]


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The batch's placement: a function taking a global (B, 3) batch to
    this data rank's rows (`data_slice`)."""
    return lambda x: data_slice(x, mesh)


mask_sharding = batch_sharding  # a (B,) mask splits as its batch
