"""Fault-injection harness + failure-policy primitives (the JAX package's
`faults/`: injection copied, the soak and its CLI mirrored).

Deterministic, seeded chaos for the crash-consistent pipeline: named
injection hooks across all four layers (driver commit boundaries, the
device engine's advance/drain, the checkpoint store, the record log and
its wire transport), typed fault/overflow exceptions, and the
transient-retry wrapper. See faults/injection.py for the site catalog,
faults/harness.py for the chaos sweep's golden-vs-chaos harness,
faults/soak.py for the SLO-gated soak, and `python -m
kafkastreams_cep_tpu_torch.faults --help` for the CLI.
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
