"""Key-axis parallelism: the batched multi-key engine, the stacked
multi-query engine and their controllers."""

from .batched import BatchedDeviceNFA
from .drain_sched import AdmissionPacer, CapacityAutosizer, DrainController
from .stacked import StackedQueryEngine

__all__ = [
    "AdmissionPacer", "BatchedDeviceNFA", "CapacityAutosizer", "DrainController",
    "StackedQueryEngine",
]
