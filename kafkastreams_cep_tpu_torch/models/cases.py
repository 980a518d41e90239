"""The conformance cases of the step kernel: the three of the JAX
package's tests/test_pallas.py -- strict-contiguity letters, stock folds
with skip-till-next, and skip-till-any with strict windows -- and
`repeat`, whose looping stage proceeds straight into a stage of the same
name. Each case is (pattern, schema fields, stream, EngineConfig
keywords).

Beside them, the fold-heavy branchy patterns of the JAX package's
tests/test_differential.py (`branchy_case`), where lanes that share a run
id both fold in one event (`seq_collisions`) and exact replay must
restore the reference's per-run fold semantics.

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


def repeat_pattern(dsl: Any = None):
    """A, B's looping stage "b", a stage also named "b" (C), D's looping
    stage "c", then A and B.

    A lane at a looping stage proceeds straight into the next stage. From
    "b" to "b" the descent crosses no stage name, so the run's Dewey
    version must not grow; from "c" to "d" it crosses one and must grow,
    and the run lives on at "e", so its version is state (the reference
    forwards to a next stage only across a name change). The other cases
    proceed only across a name change, and only into the last stage."""
    m = _pkg(dsl)
    skip_next = m.Selected.with_skip_til_next_match
    return (
        m.QueryBuilder()
        .select("a").where(m.value() == "A")
        .then().select("b", skip_next()).zero_or_more().where(m.value() == "B")
        .then().select("b").where(m.value() == "C")
        .then().select("c", skip_next()).zero_or_more().where(m.value() == "D")
        .then().select("d").where(m.value() == "A")
        .then().select("e", skip_next()).where(m.value() == "B")
        .build()
    )


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
    "repeat": (
        repeat_pattern, None, letters_stream,
        dict(lanes=64, nodes=512, matches=64, matches_per_step=16, nodes_per_step=32),
    ),
}

BRANCHY_ALPHABET = "ABCD"


def branchy_pattern(rng: random.Random, dsl: Any = None):
    """3-4 stages with random strategies and looping stages, each after
    the first folding a counter `cnt`, and stages from the third on
    guarded by it: the JAX package's tests/test_differential.py
    `_branchy_pattern`, draw for draw."""
    m = _pkg(dsl)
    n_stages = rng.randint(3, 4)
    qb = m.QueryBuilder()
    builder = None
    for i in range(n_stages):
        last = i == n_stages - 1
        strategy = (
            None if i == 0
            else rng.choice([None, m.Selected.with_skip_til_next_match(),
                             m.Selected.with_skip_til_any_match()])
        )
        name = f"s{i}"
        sel = qb.select(name) if strategy is None else qb.select(name, strategy)
        if builder is not None:
            sel = (builder.then().select(name) if strategy is None
                   else builder.then().select(name, strategy))
        if not last and i > 0:
            sel = sel.zero_or_more() if rng.random() < 0.5 else sel.one_or_more()
        letter = rng.choice(BRANCHY_ALPHABET[: 2 + i])
        pred = m.value() == letter
        if i >= 2:
            pred = pred & (m.agg("cnt", default=0) <= rng.randint(1, 3))
        builder = sel.where(pred)
        if i >= 1:
            builder = builder.fold("cnt", m.agg("cnt", default=0) + 1)
    return builder.build()


def branchy_case(seed: int, keys: List[Any], n: int = 20, dsl: Any = None):
    """(pattern, {key: events}) of tests/test_differential.py's batched
    replay case: one branchy pattern from `random.Random(50_000 + seed)`,
    then, key after key from the same generator, n letters whose
    timestamps step by 0, 1, 1 or 2 ms from 1000."""
    ev = _pkg(dsl).Event
    rng = random.Random(50_000 + seed)
    pattern = branchy_pattern(rng, dsl)
    streams = {}
    for key in keys:
        ts = 1000
        events = []
        for i in range(n):
            ts += rng.choice([0, 1, 1, 2])
            events.append(ev(key, rng.choice(BRANCHY_ALPHABET), ts, "t", 0, i))
        streams[key] = events
    return pattern, streams
