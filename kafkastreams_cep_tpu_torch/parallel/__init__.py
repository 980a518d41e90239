"""Key-axis parallelism: the batched multi-key engine and its controllers."""

from .batched import BatchedDeviceNFA
from .drain_sched import AdmissionPacer, CapacityAutosizer, DrainController

__all__ = ["AdmissionPacer", "BatchedDeviceNFA", "CapacityAutosizer", "DrainController"]
