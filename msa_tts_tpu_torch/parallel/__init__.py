"""Data- and task-parallel training and dp serving over
``torch.distributed`` (counterpart of ``msa_tts_tpu/parallel/``, without
its tensor parallelism and ``jit_with_mesh``)."""

from .mesh import make_mesh, single_device_mesh
from .shard_meta import (
    episode_sharding_2d,
    make_sharded_maml_step,
    make_sharded_reptile_step,
    shard_task_batch_2d,
)
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
    "task_batch_sharding",
]
