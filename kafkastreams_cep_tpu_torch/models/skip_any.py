"""The flagship bench workload: the 8-stage skip-till-any SASE pattern
and its seeded stream (copies of the JAX package's bench.py
definitions, `skip_any8_pattern` and `skip_any8_stream`).

Like models/cases.py, the builders take the package they build with
(default: this one), so a test can build the same workload with the JAX
package for the reference side."""
from __future__ import annotations

import random
from typing import Any, List

from .cases import _pkg

TS0 = 1_000_000
SKIP_ANY_STAGES = "ABCDEFGH"   # 8 stage letters
SKIP_ANY_NOISE = "QRSTUV"      # noise letters only the IGNORE edges see


def skip_any8_pattern(dsl: Any = None):
    """8 stages with 16 ms windows, stages 2-8 skip-till-any (the first
    keeps the default strategy: a skip-strategy begin state duplicates the
    begin run every event in the reference itself)."""
    m = _pkg(dsl)
    builder = m.QueryBuilder().select("s0").where(m.value() == SKIP_ANY_STAGES[0]).within(ms=16)
    for i in range(1, 8):
        builder = (
            builder.then()
            .select(f"s{i}", m.Selected.with_skip_til_any_match())
            .where(m.value() == SKIP_ANY_STAGES[i])
            .within(ms=16)
        )
    return builder.build()


def skip_any8_stream(rng: random.Random, n: int, dsl: Any = None) -> List[Any]:
    """Each 16-event block carries the stage letters in order, each
    present with p=0.8 (else noise), then 8 noise events: full chains
    complete inside the 16 ms window only when all 8 letters show."""
    letters: List[str] = []
    while len(letters) < n:
        for stage_letter in SKIP_ANY_STAGES:
            letters.append(
                stage_letter if rng.random() < 0.8 else rng.choice(SKIP_ANY_NOISE)
            )
        letters.extend(rng.choice(SKIP_ANY_NOISE) for _ in range(8))
    ev = _pkg(dsl).Event
    return [ev("K", letters[i], TS0 + i, "t", 0, i) for i in range(n)]


#: The flagship deployment's fixed capacity (the port has no autosizer
#: yet; PERF.md, section 4, says how it was settled): K = 2048 keys,
#: T = 64 events per batch, drained every batch.
FLAGSHIP_CONFIG = dict(
    lanes=320, nodes=8192, matches=2048, matches_per_step=32,
    nodes_per_step=128, strict_windows=True, pin_interval=True,
)
FLAGSHIP_KEYS = 2048
FLAGSHIP_T = 64
