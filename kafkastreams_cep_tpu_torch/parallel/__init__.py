"""Key-axis parallelism: the batched multi-key engine, the stacked
multi-query engine, their controllers, and the key mesh."""

from .batched import BatchedDeviceNFA
from .drain_sched import AdmissionPacer, CapacityAutosizer, DrainController
from .key_shard import (
    KEY_AXIS,
    KeyMesh,
    build_batched_advance,
    gather_state,
    global_stats,
    init_batched_pool,
    init_batched_state,
    key_mesh,
    merge_shard_tree,
    shard_state,
    shard_stats,
    shard_xs,
    slice_shard_tree,
)
from .stacked import StackedQueryEngine

__all__ = [
    "AdmissionPacer",
    "BatchedDeviceNFA",
    "CapacityAutosizer",
    "DrainController",
    "StackedQueryEngine",
    "KEY_AXIS",
    "KeyMesh",
    "build_batched_advance",
    "gather_state",
    "global_stats",
    "init_batched_pool",
    "init_batched_state",
    "key_mesh",
    "merge_shard_tree",
    "shard_state",
    "shard_stats",
    "shard_xs",
    "slice_shard_tree",
]
