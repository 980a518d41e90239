"""Stacked multi-query workloads (parallel/stacked.py).

* `letter_queries`: BASELINE config 4, "N concurrent Pattern queries over
  one stream" -- the JAX bench's `bench_multi_query` (bench.py:916-990):
  four strict-contiguity letter queries ABC, BCD, ACD, ABD over the
  letters stream of models/cases.py (1024 keys, T = 64 in the bench;
  16 stages and 12 predicates stacked).
* `rotated_skip_any_queries`: eight rotations of the flagship's
  skip-till-any pattern (models/skip_any.py), query i's stage letters
  `SKIP_ANY_STAGES[i:] + SKIP_ANY_STAGES[:i]`: 72 stages and 120
  predicates stacked, past both 64-bit masks of the step kernel, and
  each query distinct, so a match attributed to the wrong query shows.
  The flagship stream feeds it: each 16 ms block carries the letters in
  order, so every rotation completes across two blocks.
  With n > 8 the rotations repeat under new names: seventeen make 153
  stages and 255 predicates, the widest predicate mask the kernel takes.
* `boundary_queries(n_stages)`: strict letter queries stacked to exactly
  n_stages stages -- 64, the last single-word stage mask; 65, the first
  query that straddles the word boundary; 256, the kernel's widest
  stage mask (and 193 predicates).

Builders take the package they build with (default: this one), so a
test can build the same queries with the JAX package for the reference
side.
"""
from __future__ import annotations

import itertools
from typing import Any, List, Tuple

from .cases import _pkg
from .skip_any import SKIP_ANY_STAGES

LETTER_QUERIES = ("ABC", "BCD", "ACD", "ABD")

#: Config 4's deployment (bench.py:1694-1698 and :938-944): 1024 keys,
#: T = 64 events per key and batch, `pin_interval=True`, capacity settled
#: by a `CapacityAutosizer` from the EngineConfig defaults.
CONFIG4_KEYS = 1024
CONFIG4_T = 64


def letters_query(tag: str, seq: str, dsl: Any = None):
    """Strict contiguity over the letters of `seq`, stages `<tag>-<j>`
    (the JAX tests' and bench's `_letters_pattern`)."""
    m = _pkg(dsl)
    b = m.QueryBuilder().select(f"{tag}-0").where(m.value() == seq[0])
    for j, ch in enumerate(seq[1:], start=1):
        b = b.then().select(f"{tag}-{j}").where(m.value() == ch)
    return b.build()


def letter_queries(n: int = len(LETTER_QUERIES), dsl: Any = None) -> List[Tuple[str, Any]]:
    """Config 4's named queries q0..q{n-1}."""
    return [(f"q{i}", letters_query(f"q{i}", LETTER_QUERIES[i % len(LETTER_QUERIES)], dsl))
            for i in range(n)]


def rotated_skip_any(i: int, dsl: Any = None):
    """The flagship pattern with its stage letters rotated by i: stage j
    matches `SKIP_ANY_STAGES[(i + j) % 8]`, 16 ms windows, stages 2-8
    skip-till-any."""
    m = _pkg(dsl)
    r = i % len(SKIP_ANY_STAGES)
    letters = SKIP_ANY_STAGES[r:] + SKIP_ANY_STAGES[:r]
    b = m.QueryBuilder().select(f"r{i}-0").where(m.value() == letters[0]).within(ms=16)
    for j in range(1, len(letters)):
        b = (
            b.then()
            .select(f"r{i}-{j}", m.Selected.with_skip_til_any_match())
            .where(m.value() == letters[j])
            .within(ms=16)
        )
    return b.build()


def rotated_skip_any_queries(n: int = len(SKIP_ANY_STAGES), dsl: Any = None):
    """The wide stack's named queries r0..r{n-1}."""
    return [(f"r{i}", rotated_skip_any(i, dsl)) for i in range(n)]


def boundary_queries(n_stages: int, dsl: Any = None) -> List[Tuple[str, Any]]:
    """Distinct strict letter queries over "ABCD" stacked to exactly
    `n_stages` stages (a query of n letters has n + 1 stages): the sixty
    three-letter queries, then four-letter ones, and a longer last one
    where the stages would not come out even. 64 gives sixteen
    three-letter queries; 65 fifteen and a four-letter one whose final
    stage is stage 64, the first of the second mask word; 256 (the
    kernel's widest masks, 4 words) all sixty, two four-letter queries
    and a five-letter one: 193 predicates, past three words too."""
    seqs = ("".join(p) for n in (3, 4) for p in itertools.product("ABCD", repeat=n)
            if len(set(p)) > 1)
    out: List[Tuple[str, Any]] = []
    left = n_stages
    while left > 0:
        seq = next(seqs)
        if left in (5, 6, 7):  # finish on one query of left - 1 letters
            seq = (seq + "ABCD")[: left - 1]
        out.append((f"b{len(out)}", letters_query(f"b{len(out)}", seq, dsl)))
        left -= len(seq) + 1
    if left != 0:
        raise ValueError(f"cannot stack letter queries to {n_stages} stages")
    return out
