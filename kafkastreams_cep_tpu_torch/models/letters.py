"""The Letters A->B->C demo: the minimum end-to-end slice.

A copy of the JAX package's `models/letters.py`.

Mirrors the reference README quick-start query (README.md:53-78): three
strict-contiguity stages selecting values "A", "B", "C".
"""
from __future__ import annotations

from ..pattern.builder import QueryBuilder
from ..pattern.expressions import value
from ..pattern.pattern import Pattern


def letters_pattern() -> Pattern:
    """Expression form (device-compilable): value() compares against letter codes.

    For the device path, string values are tokenized to integer codes by the
    schema (ops/schema.py); on host, value() compares the raw string.
    """
    return (
        QueryBuilder()
        .select("select-A")
        .where(value() == "A")
        .then()
        .select("select-B")
        .where(value() == "B")
        .then()
        .select("select-C")
        .where(value() == "C")
        .build()
    )
