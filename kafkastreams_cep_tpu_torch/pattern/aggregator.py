"""Fold aggregates attached to pattern stages.

Re-design of the reference fold machinery
(reference: core/.../cep/pattern/Aggregator.java:27, StateAggregator.java:26-41).
A fold updates a named per-run register each time the stage consumes an
event. Two forms are supported:

  * expression folds (``Expr`` over event fields + the current register via
    ``agg(name)``) -- run on host *and* device;
  * callable folds ``fn(key, value, current) -> new`` -- host-only, exact
    parity with the reference's Aggregator functional interface.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

from .expressions import Expr


class StateAggregator:
    """A named fold: register name + update function/expression."""

    __slots__ = ("name", "fn", "expression", "initial")

    def __init__(
        self,
        name: str,
        update: Union[Expr, Callable[[Any, Any, Any], Any]],
        initial: Optional[Any] = None,
    ) -> None:
        self.name = name
        self.initial = initial
        if isinstance(update, Expr):
            self.expression: Optional[Expr] = update
            self.fn: Optional[Callable] = None
        else:
            self.expression = None
            self.fn = update

    @property
    def device_compilable(self) -> bool:
        return self.expression is not None

    def apply(self, key: Any, value: Any, current: Any, env_factory=None) -> Any:
        """Host-path register update for one consumed event."""
        if self.fn is not None:
            return self.fn(key, value, current)
        assert self.expression is not None
        env = env_factory(current)
        return self.expression.evaluate(env)

    def __repr__(self) -> str:
        body = self.expression if self.expression is not None else self.fn
        return f"StateAggregator({self.name!r}, {body!r})"
