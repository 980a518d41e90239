"""Multi-exchange ticker merge: the event-time subsystem's flagship model.

A copy of the JAX package's `models/exchanges.py`.

One symbol trades on several exchanges whose delivery paths carry skewed,
jittered delays (a co-located feed vs. a cross-ocean one), so the merged
arrival stream interleaves out of event-time order even though each
exchange's own feed is in order -- the multi-source fan-in shape. The query is a liquidity-sweep detector: a block trade,
then the price pushing through a level, then the flow drying up, all
within a short window -- fold-free on purpose, so the event-time
differential suite never interacts with the exact-replay machinery.

`exchanges_stream` is the seeded generator: event timestamps are the
exchange-clock truth, arrival order is delivery order (sorted by
timestamp + per-exchange delay + jitter), and each record's topic names
its exchange so per-source watermark tracking (MinMergeWatermark keyed on
(topic, partition)) sees the fan-in structure. `REORDER_BOUND_MS` bounds
the generator's worst-case displacement: a gate with `lateness_ms >=
REORDER_BOUND_MS` reorders this stream losslessly.
"""
from __future__ import annotations

import random
from typing import List

import numpy as np

from ..core.event import Event
from ..pattern.builder import QueryBuilder
from ..pattern.expressions import field
from ..pattern.pattern import Pattern, Selected

#: Per-exchange constant delivery delays (ms) + the jitter ceiling.
EXCHANGE_DELAYS_MS = (0, 18, 7)
DELAY_JITTER_MS = 4
#: Worst-case event-time displacement in the merged arrival stream.
REORDER_BOUND_MS = max(EXCHANGE_DELAYS_MS) - min(EXCHANGE_DELAYS_MS) + DELAY_JITTER_MS

TickEvent = dict  # {"exchange": str, "price": int, "size": int}


def tick_event(exchange: str, price: int, size: int) -> TickEvent:
    return {"exchange": exchange, "price": price, "size": size}


def exchanges_pattern() -> Pattern:
    """Liquidity sweep: block trade -> price push -> flow dry-up, 48 ms."""
    return (
        QueryBuilder()
        .select("block")
        .where(field("size") > 800)
        .within(ms=48)
        .then()
        .select("push", Selected.with_skip_til_next_match())
        .where(field("price") > 120)
        .within(ms=48)
        .then()
        .select("dry", Selected.with_skip_til_next_match())
        .where(field("size") < 200)
        .within(ms=48)
        .build()
    )


def exchanges_schema():
    from ..ops.schema import EventSchema

    return EventSchema(
        {"exchange": np.int32, "price": np.int32, "size": np.int32}
    )


def exchanges_stream(
    rng: random.Random,
    n: int,
    n_exchanges: int = len(EXCHANGE_DELAYS_MS),
    tick_ms: int = 3,
    key: str = "SYM",
) -> List[Event]:
    """Seeded merged ticker feed in ARRIVAL order.

    Event time advances `tick_ms` per trade on a global exchange clock;
    each trade lands on a random exchange and arrives after that
    exchange's delay (+ jitter). Offsets number arrival order -- the log's
    truth -- so `sorted(stream)` is NOT the event-time order; sort by
    `.timestamp` (stable) to build the oracle feed."""
    delays = EXCHANGE_DELAYS_MS[:n_exchanges]
    ts = 1_000_000
    staged = []
    for i in range(n):
        ts += rng.choice((0, tick_ms, tick_ms, 2 * tick_ms))
        ex = rng.randrange(len(delays))
        price = 100 + rng.randint(-15, 35)
        size = rng.choice((50, 120, 400, 650, 900, 1200))
        arrival = ts + delays[ex] + rng.randint(0, DELAY_JITTER_MS)
        staged.append((arrival, i, ex, price, size, ts))
    staged.sort(key=lambda t: (t[0], t[1]))
    return [
        Event(
            key,
            tick_event(f"ex{ex}", price, size),
            t_event,
            topic=f"ex{ex}",
            partition=0,
            offset=off,
        )
        for off, (_arr, _i, ex, price, size, t_event) in enumerate(staged)
    ]


def exchanges_config():
    """Bench/processor config: reorder capacity + lateness sized for the
    generator's worst-case displacement (lossless reorder, zero drops)."""
    from ..ops.engine import EngineConfig

    return EngineConfig(
        lanes=64, nodes=1024, matches=512, matches_per_step=16,
        nodes_per_step=32, strict_windows=True,
        reorder_capacity=256, lateness_ms=REORDER_BOUND_MS,
    )
