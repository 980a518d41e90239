"""Fault-injection harness + failure-policy primitives (a copy of the JAX
package's `faults/`, without its soak harness and CLI).

Deterministic, seeded chaos for the crash-consistent pipeline: named
injection hooks across all four layers (driver commit boundaries, the
device engine's advance/drain, the checkpoint store, the record log),
typed fault/overflow exceptions, and the transient-retry wrapper. See
faults/injection.py for the site catalog and tests/test_torch_driver.py
for a chaos run of the port's driver.
"""
from .injection import (
    ALL_SITES,
    CRASH_SITES,
    TRANSIENT_SITES,
    CEPOverflowError,
    FaultInjector,
    FaultPoint,
    FaultSchedule,
    InjectedCrash,
    PoisonRecords,
    TransientFault,
    arm,
    armed,
    disarm,
    with_retry,
)

__all__ = [
    "ALL_SITES",
    "CRASH_SITES",
    "TRANSIENT_SITES",
    "CEPOverflowError",
    "FaultInjector",
    "FaultPoint",
    "FaultSchedule",
    "InjectedCrash",
    "PoisonRecords",
    "TransientFault",
    "arm",
    "armed",
    "disarm",
    "with_retry",
]
