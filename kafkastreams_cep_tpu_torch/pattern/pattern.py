"""Pattern IR: the linked list of per-stage specifications.

Re-design of the reference pattern model
(reference: core/.../cep/pattern/Pattern.java:27-239, Selected.java:19-66,
Strategy.java:22-37). A `Pattern` is the newest node of a child->ancestor
chain; each node carries a name/level, predicate, cardinality, times,
optional flag, window, folds, and a `Selected` (contiguity strategy +
source-topic filter).
"""
from __future__ import annotations

import enum
from typing import Any, Iterator, List, Optional

from .aggregator import StateAggregator
from .matcher import Predicate, and_, or_


class Strategy(enum.Enum):
    """Event-selection (contiguity) strategies (Strategy.java:22-37)."""

    STRICT_CONTIGUITY = "strict_contiguity"
    SKIP_TIL_NEXT_MATCH = "skip_til_next_match"
    SKIP_TIL_ANY_MATCH = "skip_til_any_match"


class Cardinality(enum.Enum):
    ONE = 1
    ONE_OR_MORE = -1


class Selected:
    """Per-stage options: contiguity strategy + source topic filter."""

    __slots__ = ("strategy", "topic")

    def __init__(self, strategy: Optional[Strategy], topic: Optional[str] = None) -> None:
        self.strategy = strategy
        self.topic = topic

    @staticmethod
    def with_strict_contiguity() -> "Selected":
        return Selected(Strategy.STRICT_CONTIGUITY)

    @staticmethod
    def with_skip_til_any_match() -> "Selected":
        return Selected(Strategy.SKIP_TIL_ANY_MATCH)

    @staticmethod
    def with_skip_til_next_match() -> "Selected":
        return Selected(Strategy.SKIP_TIL_NEXT_MATCH)

    @staticmethod
    def from_topic(topic: str) -> "Selected":
        return Selected(None, topic)

    def with_topic(self, topic: str) -> "Selected":
        return Selected(self.strategy, topic)

    def with_strategy(self, strategy: Strategy) -> "Selected":
        return Selected(strategy, self.topic)

    def __repr__(self) -> str:
        return f"Selected(strategy={self.strategy}, topic={self.topic!r})"


class Pattern:
    """One stage spec in the chain; `ancestor` points to the previous stage."""

    def __init__(
        self,
        name: Optional[str] = None,
        selected: Optional[Selected] = None,
        level: int = 0,
        ancestor: Optional["Pattern"] = None,
    ) -> None:
        self.level = level
        self._name = name
        self.ancestor = ancestor
        self.predicate: Optional[Predicate] = None
        self.window_ms: Optional[int] = None
        self.aggregates: List[StateAggregator] = []
        self.cardinality = Cardinality.ONE
        self.selected = selected if selected is not None else Selected.with_strict_contiguity()
        self.is_optional = False
        self.times = 1

    @property
    def name(self) -> str:
        return self._name if self._name is not None else str(self.level)

    def and_predicate(self, predicate: Predicate) -> None:
        self.predicate = predicate if self.predicate is None else and_(self.predicate, predicate)

    def or_predicate(self, predicate: Predicate) -> None:
        self.predicate = predicate if self.predicate is None else or_(self.predicate, predicate)

    def add_aggregator(self, aggregator: StateAggregator) -> None:
        self.aggregates.append(aggregator)

    def set_window_ms(self, window_ms: int) -> None:
        self.window_ms = window_ms

    def __iter__(self) -> Iterator["Pattern"]:
        """Iterate newest -> oldest over the ancestor chain."""
        current: Optional[Pattern] = self
        while current is not None:
            yield current
            current = current.ancestor

    def __repr__(self) -> str:
        return (
            f"Pattern(name={self.name!r}, cardinality={self.cardinality.name}, "
            f"times={self.times}, optional={self.is_optional}, "
            f"strategy={self.selected.strategy}, level={self.level})"
        )
