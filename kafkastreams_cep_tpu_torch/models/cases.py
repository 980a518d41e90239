"""The three conformance cases of the JAX package's tests/test_pallas.py:
strict-contiguity letters, stock folds with skip-till-next, and
skip-till-any with strict windows -- one per pattern family the step
kernel must agree on. Each case is (pattern, schema fields, stream,
EngineConfig keywords).

Pattern and stream builders take the package they build with (default:
this one), so a test can build the same case with the JAX package for the
reference side.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List

import numpy as np

TS0 = 1_000_000


def _pkg(dsl: Any) -> Any:
    if dsl is not None:
        return dsl
    import kafkastreams_cep_tpu_torch

    return kafkastreams_cep_tpu_torch


def letters_pattern(dsl: Any = None):
    m = _pkg(dsl)
    return (
        m.QueryBuilder()
        .select("select-A").where(m.value() == "A")
        .then().select("select-B").where(m.value() == "B")
        .then().select("select-C").where(m.value() == "C")
        .build()
    )


def stock_pattern(dsl: Any = None):
    m = _pkg(dsl)
    sel = m.Selected
    return (
        m.QueryBuilder()
        .select("stage-1").where(m.field("volume") > 1000)
        .fold("avg", m.field("price"))
        .then().select("stage-2", sel.with_skip_til_next_match())
        .zero_or_more().where(m.field("price") > m.agg("avg", default=0))
        .fold("avg", (m.agg("avg", default=0) + m.field("price")) // 2)
        .fold("volume", m.field("volume"))
        .then().select("stage-3", sel.with_skip_til_next_match())
        .where(m.field("volume") < 0.8 * m.agg("volume", default=0))
        .within(ms=64)
        .build()
    )


def skip2_pattern(dsl: Any = None):
    m = _pkg(dsl)
    b = m.QueryBuilder().select("s0").where(m.value() == "A").within(ms=16)
    for i, ch in enumerate("BC", start=1):
        b = (
            b.then().select(f"s{i}", m.Selected.with_skip_til_any_match())
            .where(m.value() == ch).within(ms=16)
        )
    return b.build()


def letters_stream(rng: random.Random, n: int, dsl: Any = None) -> List[Any]:
    ev = _pkg(dsl).Event
    return [ev("K", rng.choice("ABCD"), TS0 + i, "t", 0, i) for i in range(n)]


def stock_stream(rng: random.Random, n: int, dsl: Any = None) -> List[Any]:
    ev = _pkg(dsl).Event
    return [
        ev("K", {"name": "s", "price": rng.randint(80, 140),
                 "volume": rng.randint(500, 1500)}, TS0 + i, "t", 0, i)
        for i in range(n)
    ]


STOCK_FIELDS = {"name": np.int32, "price": np.int32, "volume": np.int32}

CASES: Dict[str, tuple] = {
    "letters": (
        letters_pattern, None, letters_stream,
        dict(lanes=8, nodes=128, matches=32, matches_per_step=8, nodes_per_step=4),
    ),
    "stock": (
        stock_pattern, STOCK_FIELDS, stock_stream,
        dict(lanes=32, nodes=512, matches=64, matches_per_step=16, nodes_per_step=16),
    ),
    "skip2": (
        skip2_pattern, None, letters_stream,
        dict(lanes=32, nodes=256, matches=64, matches_per_step=16,
             nodes_per_step=16, strict_windows=True),
    ),
}
