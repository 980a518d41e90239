"""IoT sensor fan-in with an idle source: the idle-timeout model.

A fleet of sensors reports into one topic family; each sensor's feed is
in order but network paths skew their arrivals, and one sensor goes dark
mid-stream (battery death, partition loss). Without idle handling, a
min-merge watermark would wait on the dark source forever and every
other sensor's records would sit in the reorder buffer until an
end-of-stream flush -- the exact failure the `IdleTimeout` generator
(time/watermarks.py) exists for: once the source has been silent past
the timeout, its watermark contribution jumps forward and the merged
clock resumes.

The query is an overheat-and-recover detector, fold-free (no exact-
replay interaction). `sensors_stream` is the seeded generator; the
record topic names the reporting sensor so per-source watermark tracking
sees the fan-in. `IDLE_SENSOR` stops emitting after `IDLE_AFTER_FRAC` of
the stream.
"""
from __future__ import annotations

import random
from typing import List

import numpy as np

from ..core.event import Event
from ..pattern.builder import QueryBuilder
from ..pattern.expressions import field
from ..pattern.pattern import Pattern, Selected

#: Per-sensor delivery delays (ms) + jitter; sensor 0 goes dark.
SENSOR_DELAYS_MS = (2, 11, 0, 6)
SENSOR_JITTER_MS = 3
REORDER_BOUND_MS = max(SENSOR_DELAYS_MS) - min(SENSOR_DELAYS_MS) + SENSOR_JITTER_MS
IDLE_SENSOR = 0
IDLE_AFTER_FRAC = 0.6

SensorEvent = dict  # {"sensor": str, "temp": float}


def sensor_event(sensor: str, temp: float) -> SensorEvent:
    return {"sensor": sensor, "temp": temp}


def sensors_pattern() -> Pattern:
    """Overheat then recover: warm -> hot spike -> cool-down, 64 ms."""
    return (
        QueryBuilder()
        .select("warm")
        .where(field("temp") > 70)
        .within(ms=64)
        .then()
        .select("hot", Selected.with_skip_til_next_match())
        .where(field("temp") > 85)
        .within(ms=64)
        .then()
        .select("cool", Selected.with_skip_til_next_match())
        .where(field("temp") < 60)
        .within(ms=64)
        .build()
    )


def sensors_schema():
    from ..ops.schema import EventSchema

    return EventSchema({"sensor": np.int32, "temp": np.float32})


def sensors_stream(
    rng: random.Random,
    n: int,
    n_sensors: int = len(SENSOR_DELAYS_MS),
    tick_ms: int = 4,
    key: str = "unit0",
) -> List[Event]:
    """Seeded fan-in feed in ARRIVAL order; sensor IDLE_SENSOR stops
    reporting after IDLE_AFTER_FRAC of the stream (idle-source case)."""
    delays = SENSOR_DELAYS_MS[:n_sensors]
    idle_from = int(n * IDLE_AFTER_FRAC)
    ts = 2_000_000
    staged = []
    for i in range(n):
        ts += rng.choice((tick_ms, tick_ms, 2 * tick_ms))
        live = [
            s for s in range(len(delays))
            if not (s == IDLE_SENSOR and i >= idle_from)
        ]
        sensor = rng.choice(live)
        # Regime-switching temperature so the three stages all fire:
        # mostly nominal, warm ramps, occasional spikes and cool-downs.
        temp = rng.choice((45.0, 55.0, 72.0, 78.0, 88.0, 92.0, 50.0))
        arrival = ts + delays[sensor] + rng.randint(0, SENSOR_JITTER_MS)
        staged.append((arrival, i, sensor, temp, ts))
    staged.sort(key=lambda t: (t[0], t[1]))
    return [
        Event(
            key,
            sensor_event(f"sensor{sensor}", temp),
            t_event,
            topic=f"sensor{sensor}",
            partition=0,
            offset=off,
        )
        for off, (_arr, _i, sensor, temp, t_event) in enumerate(staged)
    ]


def sensors_config():
    """Bench/processor config sized for lossless reorder of the fan-in."""
    from ..ops.engine import EngineConfig

    return EngineConfig(
        lanes=64, nodes=1024, matches=512, matches_per_step=16,
        nodes_per_step=32, strict_windows=True,
        reorder_capacity=256, lateness_ms=REORDER_BOUND_MS,
    )
