"""Multi-device paths of the port over torch.distributed, one process per
device: data-parallel training and the sharded test_step
(`data_parallel`), multi-process bring-up and the hybrid mesh
(`multihost`), and point-sharded forward and training for long clouds
(`point_parallel`).  `collectives` holds the all-reduces, broadcasts and
autograd-aware gathers they are written on.

The names are hpcs_tpu.parallel's, less make_data_parallel_epoch_fn (the
fused lax.scan epoch, a TPU dispatch device the port leaves out).
"""
from .data_parallel import (
    make_data_parallel_test_step,
    make_data_parallel_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
from .point_parallel import (
    make_mesh_2d,
    make_point_sharded_forward,
    make_point_sharded_train_step,
    shard_points_batch,
)

__all__ = [
    "make_data_parallel_test_step",
    "make_data_parallel_train_step",
    "make_mesh",
    "make_mesh_2d",
    "make_point_sharded_forward",
    "make_point_sharded_train_step",
    "shard_points_batch",
    "replicate",
    "shard_batch",
]
