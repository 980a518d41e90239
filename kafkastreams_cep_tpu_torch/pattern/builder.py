"""Fluent pattern-query DSL.

Same fluent shape as the reference DSL
(reference: core/.../cep/pattern/QueryBuilder.java:25-58,
StageBuilder.java:25-45, PredicateBuilder.java:25-52,
PatternBuilder.java:25-80):

    pattern = (QueryBuilder()
        .select("stage-1")
            .where(field("volume") > 1000)
            .fold("avg", field("price"))
        .then()
        .select("stage-2", Selected.with_skip_til_next_match())
            .zero_or_more()
            .where(field("price") > agg("avg"))
            .fold("avg", (agg("avg") + field("price")) // 2)
        .then()
        .select("stage-3", Selected.with_skip_til_next_match())
            .where(field("volume") < 0.8 * agg("volume", default=0))
        .within(hours=1)
        .build())

`where`/`fold` accept either declarative expressions (device-compilable) or
plain Python callables (host-only), covering the reference's Simple/Stateful/
Sequence matcher families.
"""
from __future__ import annotations

from typing import Any, Optional, Union

from .aggregator import StateAggregator
from .expressions import Expr
from .matcher import coerce_predicate
from .pattern import Cardinality, Pattern, Selected


class QueryBuilder:
    """DSL entry point; creates the first stage (QueryBuilder.java:25-58)."""

    _DEFAULT = Selected.with_strict_contiguity

    def select(
        self, name: Optional[str] = None, selected: Optional[Selected] = None
    ) -> "StageBuilder":
        if isinstance(name, Selected):  # select(Selected) overload
            name, selected = None, name
        return StageBuilder(Pattern(name, selected or QueryBuilder._DEFAULT()))


class PredicateBuilder:
    """Attach the first predicate / optional flag (PredicateBuilder.java:25-52)."""

    def __init__(self, pattern: Pattern) -> None:
        self._pattern = pattern

    def where(self, predicate: Any) -> "PatternBuilder":
        self._pattern.and_predicate(coerce_predicate(predicate))
        return PatternBuilder(self._pattern)

    def optional(self) -> "PredicateBuilder":
        self._pattern.is_optional = True
        return self


class StageBuilder(PredicateBuilder):
    """Stage cardinality modifiers (StageBuilder.java:25-45)."""

    def one_or_more(self) -> PredicateBuilder:
        self._pattern.cardinality = Cardinality.ONE_OR_MORE
        return self

    def zero_or_more(self) -> PredicateBuilder:
        self._pattern.cardinality = Cardinality.ONE_OR_MORE
        self._pattern.is_optional = True
        return self

    def times(self, n: int) -> PredicateBuilder:
        self._pattern.times = n
        return self


class PatternBuilder:
    """Predicate combinators, folds, window, stage chaining (PatternBuilder.java:25-80)."""

    def __init__(self, pattern: Pattern) -> None:
        self._pattern = pattern

    def and_(self, predicate: Any) -> "PatternBuilder":
        self._pattern.and_predicate(coerce_predicate(predicate))
        return self

    def or_(self, predicate: Any) -> "PatternBuilder":
        self._pattern.or_predicate(coerce_predicate(predicate))
        return self

    def fold(self, state: str, update: Union[Expr, Any], initial: Any = None) -> "PatternBuilder":
        self._pattern.add_aggregator(StateAggregator(state, update, initial))
        return self

    def within(
        self,
        ms: Optional[int] = None,
        *,
        seconds: Optional[float] = None,
        minutes: Optional[float] = None,
        hours: Optional[float] = None,
    ) -> "PatternBuilder":
        total = 0.0
        if ms is not None:
            total += ms
        if seconds is not None:
            total += seconds * 1_000
        if minutes is not None:
            total += minutes * 60_000
        if hours is not None:
            total += hours * 3_600_000
        self._pattern.set_window_ms(int(total))
        return self

    def then(self) -> "ChainedQueryBuilder":
        next_pattern = Pattern(level=self._pattern.level + 1, ancestor=self._pattern)
        # The chained stage's Selected defaults to strict until select() names it.
        return ChainedQueryBuilder(next_pattern)

    def build(self) -> Pattern:
        return self._pattern


class ChainedQueryBuilder:
    """`then()` result: a select() that continues the chain (Pattern.java:90-123)."""

    def __init__(self, pattern: Pattern) -> None:
        self._pattern = pattern

    def select(
        self, name: Optional[str] = None, selected: Optional[Selected] = None
    ) -> StageBuilder:
        if isinstance(name, Selected):
            name, selected = None, name
        if name is not None:
            self._pattern._name = name
        if selected is not None:
            self._pattern.selected = selected
        return StageBuilder(self._pattern)
