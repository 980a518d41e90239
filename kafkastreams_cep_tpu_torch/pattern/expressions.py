"""Declarative predicate / fold expressions.

The reference evaluates predicates as opaque Java closures
(reference: core/.../cep/pattern/Matcher.java:30-38), which cannot run on an
accelerator. The TPU-native design instead expresses predicates and fold
updates as small expression trees over:

  * event fields            -> ``field("price")``
  * the raw event value/key -> ``value()`` / ``key()``
  * event metadata          -> ``timestamp()``, ``topic_is("t")``
  * per-run fold registers  -> ``agg("avg")``

An expression evaluates against an *environment* (a duck-typed object with
``field/key/value/timestamp/topic_id/agg`` accessors). The same tree
therefore runs in two worlds:

  * torch env: env wraps structure-of-arrays torch columns + the register
    file (ops/tables.py TorchEnv), producing vectorized masks;
  * CUDA env: env wraps C expressions (ops/codegen.py CudaEnv), so the same
    tree emits the per-lane C source of the hand-written step kernel.

This is the design lever that turns the reference's per-edge virtual call
(NFA.java:371-384) into one fused vector op per predicate per micro-batch.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, FrozenSet, Optional, Union

Number = Union[int, float, bool]


class Expr:
    """Base expression node. Immutable; overloads build the tree."""

    def evaluate(self, env: "Env") -> Any:
        raise NotImplementedError

    # --- metadata used by the device compiler -------------------------------
    def fields(self) -> FrozenSet[str]:
        """Names of event fields referenced anywhere in the tree."""
        return frozenset()

    def aggs(self) -> FrozenSet[str]:
        """Names of fold registers referenced anywhere in the tree."""
        return frozenset()

    # --- operator overloads -------------------------------------------------
    def _bin(self, other: Any, op: Callable, sym: str) -> "Expr":
        return BinOp(self, _lift(other), op, sym)

    def _rbin(self, other: Any, op: Callable, sym: str) -> "Expr":
        return BinOp(_lift(other), self, op, sym)

    def __add__(self, o): return self._bin(o, operator.add, "+")
    def __radd__(self, o): return self._rbin(o, operator.add, "+")
    def __sub__(self, o): return self._bin(o, operator.sub, "-")
    def __rsub__(self, o): return self._rbin(o, operator.sub, "-")
    def __mul__(self, o): return self._bin(o, operator.mul, "*")
    def __rmul__(self, o): return self._rbin(o, operator.mul, "*")
    def __truediv__(self, o): return self._bin(o, operator.truediv, "/")
    def __rtruediv__(self, o): return self._rbin(o, operator.truediv, "/")
    def __floordiv__(self, o): return self._bin(o, operator.floordiv, "//")
    def __rfloordiv__(self, o): return self._rbin(o, operator.floordiv, "//")
    def __mod__(self, o): return self._bin(o, operator.mod, "%")
    def __rmod__(self, o): return self._rbin(o, operator.mod, "%")

    def __gt__(self, o): return self._bin(o, operator.gt, ">")
    def __ge__(self, o): return self._bin(o, operator.ge, ">=")
    def __lt__(self, o): return self._bin(o, operator.lt, "<")
    def __le__(self, o): return self._bin(o, operator.le, "<=")
    def __eq__(self, o): return self._bin(o, operator.eq, "==")  # type: ignore[override]
    def __ne__(self, o): return self._bin(o, operator.ne, "!=")  # type: ignore[override]

    def __and__(self, o): return BoolOp(self, _lift(o), "and")
    def __rand__(self, o): return BoolOp(_lift(o), self, "and")
    def __or__(self, o): return BoolOp(self, _lift(o), "or")
    def __ror__(self, o): return BoolOp(_lift(o), self, "or")
    def __invert__(self): return NotOp(self)

    __hash__ = object.__hash__


def _lift(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Const(v)


class Const(Expr):
    __slots__ = ("value",)

    def __init__(self, value: Number) -> None:
        self.value = value

    def evaluate(self, env: "Env") -> Any:
        return self.value

    def __repr__(self) -> str:
        return repr(self.value)


class Field(Expr):
    """A named field of the event value (dict key / attribute / column)."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def evaluate(self, env: "Env") -> Any:
        return env.field(self.name)

    def fields(self) -> FrozenSet[str]:
        return frozenset({self.name})

    def __repr__(self) -> str:
        return f"field({self.name!r})"


class Value(Expr):
    """The raw event value (for scalar-valued streams, e.g. the Letters demo)."""

    def evaluate(self, env: "Env") -> Any:
        return env.value()

    def fields(self) -> FrozenSet[str]:
        return frozenset({""})

    def __repr__(self) -> str:
        return "value()"


class Key(Expr):
    def evaluate(self, env: "Env") -> Any:
        return env.key()

    def __repr__(self) -> str:
        return "key()"


class Timestamp(Expr):
    def evaluate(self, env: "Env") -> Any:
        return env.timestamp()

    def __repr__(self) -> str:
        return "timestamp()"


class TopicIs(Expr):
    """True when the event originates from the given topic.

    The reference ANDs a TopicPredicate into stage predicates when a
    per-stage source topic is selected (StagesFactory.java:95-99); on device
    this becomes a comparison against a tokenized topic-id column.
    """

    __slots__ = ("topic",)

    def __init__(self, topic: str) -> None:
        self.topic = topic

    def evaluate(self, env: "Env") -> Any:
        return env.topic_is(self.topic)

    def __repr__(self) -> str:
        return f"topic_is({self.topic!r})"


class AggRef(Expr):
    """The current run's fold register (reference States.get, States.java:56-60)."""

    __slots__ = ("name", "default")

    def __init__(self, name: str, default: Optional[Number] = None) -> None:
        self.name = name
        self.default = default

    def evaluate(self, env: "Env") -> Any:
        return env.agg(self.name, self.default)

    def aggs(self) -> FrozenSet[str]:
        return frozenset({self.name})

    def __repr__(self) -> str:
        if self.default is None:
            return f"agg({self.name!r})"
        return f"agg({self.name!r}, default={self.default!r})"


class BinOp(Expr):
    __slots__ = ("left", "right", "op", "sym")

    def __init__(self, left: Expr, right: Expr, op: Callable, sym: str) -> None:
        self.left = left
        self.right = right
        self.op = op
        self.sym = sym

    def evaluate(self, env: "Env") -> Any:
        return self.op(self.left.evaluate(env), self.right.evaluate(env))

    def fields(self) -> FrozenSet[str]:
        return self.left.fields() | self.right.fields()

    def aggs(self) -> FrozenSet[str]:
        return self.left.aggs() | self.right.aggs()

    def __repr__(self) -> str:
        return f"({self.left!r} {self.sym} {self.right!r})"


class BoolOp(Expr):
    __slots__ = ("left", "right", "kind")

    def __init__(self, left: Expr, right: Expr, kind: str) -> None:
        self.left = left
        self.right = right
        self.kind = kind

    def evaluate(self, env: "Env") -> Any:
        lhs = self.left.evaluate(env)
        rhs = self.right.evaluate(env)
        if isinstance(lhs, bool) and isinstance(rhs, bool):
            return (lhs and rhs) if self.kind == "and" else (lhs or rhs)
        # jnp path: element-wise logical ops keep everything traceable.
        return (lhs & rhs) if self.kind == "and" else (lhs | rhs)

    def fields(self) -> FrozenSet[str]:
        return self.left.fields() | self.right.fields()

    def aggs(self) -> FrozenSet[str]:
        return self.left.aggs() | self.right.aggs()

    def __repr__(self) -> str:
        return f"({self.left!r} {self.kind} {self.right!r})"


class NotOp(Expr):
    __slots__ = ("inner",)

    def __init__(self, inner: Expr) -> None:
        self.inner = inner

    def evaluate(self, env: "Env") -> Any:
        v = self.inner.evaluate(env)
        if isinstance(v, bool):
            return not v
        return ~v

    def fields(self) -> FrozenSet[str]:
        return self.inner.fields()

    def aggs(self) -> FrozenSet[str]:
        return self.inner.aggs()

    def __repr__(self) -> str:
        return f"(not {self.inner!r})"


class TrueExpr(Expr):
    def evaluate(self, env: "Env") -> Any:
        return env.true()

    def __repr__(self) -> str:
        return "true()"


class Env:
    """Duck-typed evaluation environment contract (documented, not enforced)."""

    def field(self, name: str) -> Any: ...
    def key(self) -> Any: ...
    def value(self) -> Any: ...
    def timestamp(self) -> Any: ...
    def topic_is(self, topic: str) -> Any: ...
    def agg(self, name: str, default: Optional[Number]) -> Any: ...
    def true(self) -> Any:
        return True


# Public factory helpers -- the DSL surface.
def field(name: str) -> Field:
    return Field(name)


def value() -> Value:
    return Value()


def key() -> Key:
    return Key()


def timestamp() -> Timestamp:
    return Timestamp()


def topic_is(topic: str) -> TopicIs:
    return TopicIs(topic)


def agg(name: str, default: Optional[Number] = None) -> AggRef:
    return AggRef(name, default)


def const(v: Number) -> Const:
    return Const(v)
