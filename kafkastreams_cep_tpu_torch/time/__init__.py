"""Event-time subsystem: bounded reorder buffer, watermarks, late policy.

A copy of the JAX package's `time/` (gate, reorder buffer, watermark
generators), fronting the port's `runtime="cuda"` processor.

The engine's `Event` contract assumes per-partition in-order offsets and
window expiry advances on arrival order -- the SASE in-order stream model
(Agrawal et al., SIGMOD'08). Real multi-source traffic interleaves late
and out-of-order records; this package adds the low-watermark / allowed-
lateness model of the Dataflow paper (Akidau et al., VLDB'15) as a layer
between ingestion and the pack step:

  * `ReorderBuffer` -- per-key bounded binary heap on event time, released
    in event-time order as the watermark advances;
  * watermark generators -- `ArrivalOrderWatermark` (arrival parity, the
    bitwise-pinned default), `BoundedOutOfOrderness`, `MinMergeWatermark`
    (per-source min-merge for fan-in), `IdleTimeout` (stalled sources stop
    holding the merged watermark back);
  * `EventTimeGate` -- the composition the stream processors drive: late
    policy (drop | sideoutput | recompute-none), overflow honoring
    `EngineConfig.on_overflow` (with the `time.reorder_overflow` fault
    point), watermark metrics through the obs registry, and checkpointing
    via state/serde.py.

Host-only by design: nothing here imports torch, so the gate can front
the device runtime and tests alike.
"""
from .gate import EventTimeGate
from .reorder import ReorderBuffer
from .watermarks import (
    ArrivalOrderWatermark,
    BoundedOutOfOrderness,
    IdleTimeout,
    MinMergeWatermark,
    WatermarkGenerator,
    WM_MIN_MS,
)

__all__ = [
    "ArrivalOrderWatermark",
    "BoundedOutOfOrderness",
    "EventTimeGate",
    "IdleTimeout",
    "MinMergeWatermark",
    "ReorderBuffer",
    "WatermarkGenerator",
    "WM_MIN_MS",
]
