"""The port's scale-out layer on `torch.distributed`, one process per
device: process-group bootstrap (`distributed`), the partition-aligned
trainer (`partitioned`) and the 2-D ('data', 'model') mesh (`mesh`, the
explicit-SPMD steps of `shardmap_step` and the single-device-equal steps of
`sharded`). Names follow `skge_tpu.parallel`; where the JAX package takes a
`('shard',)` mesh, the port takes a `ShardGroup`, and where it takes a
('data', 'model') `jax.sharding.Mesh`, a `mesh.Mesh`."""

from skge_torch.parallel import distributed
from skge_torch.parallel.distributed import ShardGroup, initialize, make_shard_mesh
from skge_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    data_slice,
    make_mesh,
    mask_sharding,
    param_specs,
    shard_state,
    state_shardings,
    unshard_state,
)
from skge_torch.parallel.partitioned import (
    SHARD_AXIS,
    ExchangeCosts,
    PartitionedTrainer,
    RelabeledPoolSampler,
    choose_exchange,
    init_state_partitioned,
    make_partitioned_ce_step,
    make_partitioned_epoch,
    make_partitioned_pairwise_step,
    make_partitioned_sampled_ce_step,
    make_partitioned_selfadv_step,
    object_boundary_cap,
    partitioned_state_specs,
    relabel_entities,
    shard_state_partitioned,
)
from skge_torch.parallel.sharded import (
    make_sharded_pairwise_step,
    make_sharded_pointwise_step,
    make_sharded_score_all_o,
)
from skge_torch.parallel.shardmap_step import (
    make_shardmap_ce_step,
    make_shardmap_pairwise_step,
    make_shardmap_pointwise_step,
    make_shardmap_sampled_ce_step,
    make_shardmap_selfadv_step,
    shard_state_shardmap,
)

__all__ = [
    "DATA_AXIS",
    "ExchangeCosts",
    "MODEL_AXIS",
    "Mesh",
    "SHARD_AXIS",
    "PartitionedTrainer",
    "RelabeledPoolSampler",
    "ShardGroup",
    "batch_sharding",
    "choose_exchange",
    "data_slice",
    "distributed",
    "init_state_partitioned",
    "initialize",
    "make_mesh",
    "make_partitioned_ce_step",
    "make_partitioned_epoch",
    "make_partitioned_pairwise_step",
    "make_partitioned_sampled_ce_step",
    "make_partitioned_selfadv_step",
    "make_shard_mesh",
    "make_sharded_pairwise_step",
    "make_sharded_pointwise_step",
    "make_sharded_score_all_o",
    "make_shardmap_ce_step",
    "make_shardmap_pairwise_step",
    "make_shardmap_pointwise_step",
    "make_shardmap_sampled_ce_step",
    "make_shardmap_selfadv_step",
    "mask_sharding",
    "object_boundary_cap",
    "param_specs",
    "partitioned_state_specs",
    "relabel_entities",
    "shard_state",
    "shard_state_partitioned",
    "shard_state_shardmap",
    "state_shardings",
    "unshard_state",
]
