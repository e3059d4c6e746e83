"""Data-parallel losses over a ``torch.distributed`` device mesh
(``sharding``): each rank computes its shard's costs with the port's loss,
and one ``all_reduce`` over the mesh axis reduces them."""
from .sharding import (DATA_AXIS, auto_sharded_rnnt_loss, data_parallel_fused_joint_loss,
                       data_parallel_multiblank_fused_loss, data_parallel_multiblank_loss,
                       data_parallel_pruned_fused_loss, data_parallel_rnnt_loss,
                       data_parallel_tdt_fused_loss, data_parallel_tdt_loss,
                       initialize_distributed, make_mesh)

__all__ = [
    "DATA_AXIS", "auto_sharded_rnnt_loss", "data_parallel_fused_joint_loss",
    "data_parallel_multiblank_fused_loss", "data_parallel_multiblank_loss",
    "data_parallel_pruned_fused_loss", "data_parallel_rnnt_loss", "data_parallel_tdt_fused_loss",
    "data_parallel_tdt_loss", "initialize_distributed", "make_mesh",
]
