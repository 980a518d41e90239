"""Predicates evaluated on NFA edges.

Host-side counterpart of the reference predicate hierarchy
(reference: core/.../cep/pattern/Matcher.java:30-131, SimpleMatcher.java:32-48,
StatefulMatcher.java:29-46, SequenceMatcher.java:16-26). Predicates come in
two families:

  * ``ExprPredicate`` wraps a declarative ``Expr`` -- runs on both the host
    interpreter and the TPU kernel (the recommended form);
  * callable predicates (``simple``/``stateful``/``sequence``) accept
    arbitrary Python functions -- host-only, mirroring the reference's
    closure-based matchers for full parity.

Combinators (not/and/or) mirror Matcher.not/and/or (Matcher.java:40-50).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from .expressions import Expr, TrueExpr

#: The host interpreter's evaluation context (the port carries no host
#: interpreter; only the device-compilable expression form is lowered).
MatcherContext = Any


class Predicate:
    """Base predicate: boolean test against a MatcherContext."""

    #: True when this predicate (and all children) can compile to the device.
    device_compilable: bool = False

    def accept(self, ctx: "MatcherContext") -> bool:
        raise NotImplementedError

    def expr(self) -> Optional[Expr]:
        """The underlying expression tree, if device-compilable."""
        return None


class ExprPredicate(Predicate):
    """A predicate defined by a declarative expression tree."""

    device_compilable = True

    def __init__(self, expression: Expr) -> None:
        self.expression = expression

    def accept(self, ctx: "MatcherContext") -> bool:
        return bool(self.expression.evaluate(ctx.env()))

    def expr(self) -> Optional[Expr]:
        return self.expression

    def __repr__(self) -> str:
        return f"ExprPredicate({self.expression!r})"


class SimplePredicate(Predicate):
    """Stateless closure over the current event (SimpleMatcher.java:32-48)."""

    def __init__(self, fn: Callable[[Any], bool]) -> None:
        self.fn = fn

    def accept(self, ctx: "MatcherContext") -> bool:
        return bool(self.fn(ctx.current_event))


class StatefulPredicate(Predicate):
    """Closure over (event, fold states) (StatefulMatcher.java:29-46)."""

    def __init__(self, fn: Callable[[Any, Any], bool]) -> None:
        self.fn = fn

    def accept(self, ctx: "MatcherContext") -> bool:
        return bool(self.fn(ctx.current_event, ctx.states))


class SequencePredicate(Predicate):
    """Closure over (event, partial-match sequence, fold states).

    The reference materializes the whole partial match from the shared
    buffer on *every* evaluation (SequenceMatcher.java:22-26); the host path
    reproduces that observable behavior. Device queries should prefer fold
    registers (running reductions) instead -- see SURVEY.md section 7.
    """

    def __init__(self, fn: Callable[[Any, Any, Any], bool]) -> None:
        self.fn = fn

    def accept(self, ctx: "MatcherContext") -> bool:
        sequence = ctx.partial_sequence()
        return bool(self.fn(ctx.current_event, sequence, ctx.states))


class TruePredicate(Predicate):
    """Always true (Matcher.TruePredicate, Matcher.java:122-131)."""

    device_compilable = True

    def accept(self, ctx: "MatcherContext") -> bool:
        return True

    def expr(self) -> Optional[Expr]:
        return TrueExpr()

    def __repr__(self) -> str:
        return "TruePredicate()"


class TopicPredicate(Predicate):
    """Event originates from a topic (Matcher.TopicPredicate, Matcher.java:104-120)."""

    device_compilable = True

    def __init__(self, topic: str) -> None:
        if topic is None:
            raise ValueError("topic cannot be None")
        self.topic = topic

    def accept(self, ctx: "MatcherContext") -> bool:
        return ctx.current_event.topic == self.topic

    def expr(self) -> Optional[Expr]:
        from .expressions import TopicIs

        return TopicIs(self.topic)


class NotPredicate(Predicate):
    def __init__(self, inner: Predicate) -> None:
        self.inner = inner
        self.device_compilable = inner.device_compilable

    def accept(self, ctx: "MatcherContext") -> bool:
        return not self.inner.accept(ctx)

    def expr(self) -> Optional[Expr]:
        e = self.inner.expr()
        return None if e is None else ~e


class AndPredicate(Predicate):
    def __init__(self, left: Predicate, right: Predicate) -> None:
        self.left = left
        self.right = right
        self.device_compilable = left.device_compilable and right.device_compilable

    def accept(self, ctx: "MatcherContext") -> bool:
        return self.left.accept(ctx) and self.right.accept(ctx)

    def expr(self) -> Optional[Expr]:
        le, re_ = self.left.expr(), self.right.expr()
        if le is None or re_ is None:
            return None
        return le & re_


class OrPredicate(Predicate):
    def __init__(self, left: Predicate, right: Predicate) -> None:
        self.left = left
        self.right = right
        self.device_compilable = left.device_compilable and right.device_compilable

    def accept(self, ctx: "MatcherContext") -> bool:
        return self.left.accept(ctx) or self.right.accept(ctx)

    def expr(self) -> Optional[Expr]:
        le, re_ = self.left.expr(), self.right.expr()
        if le is None or re_ is None:
            return None
        return le | re_


def not_(p: Predicate) -> Predicate:
    return NotPredicate(p)


def and_(left: Predicate, right: Predicate) -> Predicate:
    return AndPredicate(left, right)


def or_(left: Predicate, right: Predicate) -> Predicate:
    return OrPredicate(left, right)


def coerce_predicate(p: Any) -> Predicate:
    """Accept an Expr, a Predicate, or a callable (arity decides the family)."""
    if isinstance(p, Predicate):
        return p
    if isinstance(p, Expr):
        return ExprPredicate(p)
    if callable(p):
        import inspect

        try:
            arity = len(inspect.signature(p).parameters)
        except (TypeError, ValueError):
            arity = 1
        if arity <= 1:
            return SimplePredicate(p)
        if arity == 2:
            return StatefulPredicate(p)
        return SequencePredicate(p)
    raise TypeError(f"Cannot interpret {p!r} as a predicate")
