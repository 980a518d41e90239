"""The SASE SIGMOD'08 stock-ticker demo query and fixtures.

Re-design of the reference example
(reference: example/.../Patterns.java:11-25, StockEvent.java:20-26,
CEPStockDemoTest.java:44-113): stage-1 selects volume > 1000 and folds the
price into `avg`; stage-2 (skip-till-next, zero-or-more) selects
price > avg, folding `avg = (avg + price) / 2` and `volume = volume`;
stage-3 (skip-till-next) selects volume < 0.8 * volume-register; all within
one hour. The 8 golden input events produce exactly 4 matches
(README.md:375-400).

Both a device-compilable expression form (STOCKS) and a closure form
(STOCKS_HOST, exercising the reference's StatefulMatcher surface) are
provided.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..pattern.builder import QueryBuilder
from ..pattern.expressions import agg, field
from ..pattern.pattern import Pattern, Selected

StockEvent = Dict[str, object]  # {"name": str, "price": int, "volume": int}


def stock_event(name: str, price: int, volume: int) -> StockEvent:
    return {"name": name, "price": price, "volume": volume}


def stocks_pattern() -> Pattern:
    """Expression-form stock query: runs on host and device."""
    return (
        QueryBuilder()
        .select("stage-1")
        .where(field("volume") > 1000)
        .fold("avg", field("price"))
        .then()
        .select("stage-2", Selected.with_skip_til_next_match())
        .zero_or_more()
        .where(field("price") > agg("avg"))
        .fold("avg", (agg("avg") + field("price")) // 2)
        .fold("volume", field("volume"))
        .then()
        .select("stage-3", Selected.with_skip_til_next_match())
        .where(field("volume") < 0.8 * agg("volume", default=0))
        .within(hours=1)
        .build()
    )


def stocks_pattern_host() -> Pattern:
    """Closure-form stock query (StatefulMatcher parity; host-only)."""
    return (
        QueryBuilder()
        .select("stage-1")
        .where(lambda event, states: event.value["volume"] > 1000)
        .fold("avg", lambda k, v, curr: v["price"])
        .then()
        .select("stage-2", Selected.with_skip_til_next_match())
        .zero_or_more()
        .where(lambda event, states: event.value["price"] > states.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v["price"]) // 2)
        .fold("volume", lambda k, v, curr: v["volume"])
        .then()
        .select("stage-3", Selected.with_skip_til_next_match())
        .where(lambda event, states: event.value["volume"] < 0.8 * states.get_or_else("volume", 0))
        .within(hours=1)
        .build()
    )


#: The 8 golden input events (CEPStockDemoTest.java:46-53).
GOLDEN_EVENTS: List[StockEvent] = [
    stock_event("e1", 100, 1010),
    stock_event("e2", 120, 990),
    stock_event("e3", 120, 1005),
    stock_event("e4", 121, 999),
    stock_event("e5", 120, 999),
    stock_event("e6", 125, 750),
    stock_event("e7", 120, 950),
    stock_event("e8", 120, 700),
]

#: The exact golden JSON outputs (CEPStockDemoTest.java:101-109).
GOLDEN_MATCHES: List[str] = [
    '{"events":[{"name":"stage-1","events":["e1"]},{"name":"stage-2","events":["e2","e3","e4","e5"]},{"name":"stage-3","events":["e6"]}]}',
    '{"events":[{"name":"stage-1","events":["e3"]},{"name":"stage-2","events":["e4"]},{"name":"stage-3","events":["e6"]}]}',
    '{"events":[{"name":"stage-1","events":["e1"]},{"name":"stage-2","events":["e2","e3","e4","e5","e6","e7"]},{"name":"stage-3","events":["e8"]}]}',
    '{"events":[{"name":"stage-1","events":["e3"]},{"name":"stage-2","events":["e4","e6"]},{"name":"stage-3","events":["e8"]}]}',
]
