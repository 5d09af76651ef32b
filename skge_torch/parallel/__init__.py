"""The port's scale-out layer on `torch.distributed`, one process per
shard: process-group bootstrap (`distributed`) and the partition-aligned
trainer (`partitioned`). Names follow `skge_tpu.parallel`; where the JAX
package takes a `('shard',)` mesh, the port takes a `ShardGroup`."""

from skge_torch.parallel import distributed
from skge_torch.parallel.distributed import ShardGroup, initialize, make_shard_mesh
from skge_torch.parallel.partitioned import (
    SHARD_AXIS,
    PartitionedTrainer,
    RelabeledPoolSampler,
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

__all__ = [
    "SHARD_AXIS",
    "PartitionedTrainer",
    "RelabeledPoolSampler",
    "ShardGroup",
    "distributed",
    "init_state_partitioned",
    "initialize",
    "make_partitioned_ce_step",
    "make_partitioned_epoch",
    "make_partitioned_pairwise_step",
    "make_partitioned_sampled_ce_step",
    "make_partitioned_selfadv_step",
    "make_shard_mesh",
    "object_boundary_cap",
    "partitioned_state_specs",
    "relabel_entities",
    "shard_state_partitioned",
]
