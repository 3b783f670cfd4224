"""Data-, task- and tensor-parallel training and dp and tp serving over
``torch.distributed`` (counterpart of ``msa_tts_tpu/parallel/``, without
its ``jit_with_mesh``)."""

from .mesh import make_mesh, single_device_mesh
from .shard_meta import (
    episode_sharding_2d,
    make_sharded_maml_step,
    make_sharded_reptile_step,
    shard_task_batch_2d,
)
from .tp import gather_tree_tp, shard_tree_tp, tp_leaf_spec, tp_shardings
from .sharding import (
    batch_sharding,
    replicate_state,
    replicated,
    shard_batch,
    shard_task_batch,
    task_batch_sharding,
)

__all__ = [
    "make_mesh",
    "single_device_mesh",
    "batch_sharding",
    "episode_sharding_2d",
    "make_sharded_maml_step",
    "make_sharded_reptile_step",
    "replicate_state",
    "replicated",
    "shard_batch",
    "shard_task_batch",
    "shard_task_batch_2d",
    "gather_tree_tp",
    "shard_tree_tp",
    "task_batch_sharding",
    "tp_leaf_spec",
    "tp_shardings",
]
