"""jnp's promotion and division rules, written out for torch tensors.

The predicate and fold closures from `compile_query` evaluate an `Expr`
tree with plain Python operators (pattern/expressions.py). Under the JAX
package those operators are jnp's, and the port must reproduce their
results bit for bit. Torch's own rules differ in three places that
matter here:

  * promotion: jnp treats Python scalars as *weak* (an int32 column
    against `2` stays int32, against `0.5` becomes float32) and keeps the
    default float at float32;
  * integer `//` and `%` follow XLA's division (`x // 0 == -1` before the
    floor adjustment, `x % 0 == 0`), where torch raises;
  * float `//` is CPython's float_divmod rounded half away from zero, and
    float `%` takes the divisor's sign.

`TV` wraps a tensor and applies those rules explicitly, op by op, in IEEE
float32 with no contraction -- the semantics of eager jnp. The CUDA code
generator (ops/codegen.py) shares `result_kind` so the kernel and this
plain version promote identically.

Kinds: "b" bool, "i" int32, "f" float32 (strong, i.e. tensors); Python
scalars are weak and classified by `scalar_kind`.
"""
from __future__ import annotations

from typing import Any

import torch

_INT_MIN = -(2**31)
_RANK = {"b": 0, "i": 1, "f": 2}
_DTYPE = {"b": torch.bool, "i": torch.int32, "f": torch.float32}


def scalar_kind(v: Any) -> str:
    """Weak kind of a Python scalar ("wb", "wi" or "wf")."""
    if isinstance(v, bool):
        return "wb"
    if isinstance(v, int):
        return "wi"
    if isinstance(v, float):
        return "wf"
    raise TypeError(f"unsupported constant {v!r}")


def result_kind(a: str, b: str) -> str:
    """jnp's binary promotion over {b, i, f} plus weak Python scalars."""
    if a.startswith("w") and b.startswith("w"):
        raise TypeError("two Python scalars are combined by Python itself")
    if a.startswith("w"):
        a, b = b, a
    if not b.startswith("w"):
        return a if _RANK[a] >= _RANK[b] else b
    weak = b[1]
    if a == "f" or weak == "f":
        return "f"
    if a == "i" or weak == "i":
        return "i"
    return "b"


def kind_of_dtype(dtype: torch.dtype) -> str:
    if dtype == torch.bool:
        return "b"
    if dtype == torch.int32:
        return "i"
    if dtype == torch.float32:
        return "f"
    raise TypeError(f"unsupported column dtype {dtype}")


def _lax_div_i(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """XLA signed division: truncating, x / 0 == -1, INT_MIN / -1 == INT_MIN."""
    zero = x2 == 0
    ovf = (x1 == _INT_MIN) & (x2 == -1)
    safe = torch.where(zero | ovf, torch.ones_like(x2), x2)
    q = torch.div(x1, safe, rounding_mode="trunc")
    q = torch.where(zero, torch.full_like(q, -1), q)
    return torch.where(ovf, torch.full_like(q, _INT_MIN), q)


def _lax_rem_i(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """XLA signed remainder: sign of the dividend, x % 0 == x."""
    zero = x2 == 0
    minus_one = x2 == -1
    safe = torch.where(zero | minus_one, torch.ones_like(x2), x2)
    r = torch.fmod(x1, safe)
    r = torch.where(zero, x1, r)
    return torch.where(minus_one, torch.zeros_like(r), r)


def floor_divide(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    if x1.dtype == torch.int32:
        q = _lax_div_i(x1, x2)
        adjust = (torch.sign(x1) != torch.sign(x2)) & (_lax_rem_i(x1, x2) != 0)
        return torch.where(adjust, q - 1, q)
    mod = torch.fmod(x1, x2)
    div = (x1 - mod) / x2
    ind = (mod != 0) & (torch.sign(x2) != torch.sign(mod))
    div = torch.where(ind, div - 1, div)
    return round_half_away(div)


def remainder(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    if x1.dtype == torch.int32:
        x2 = torch.where(x2 == 0, torch.ones_like(x2), x2)
        trunc = _lax_rem_i(x1, x2)
    else:
        trunc = torch.fmod(x1, x2)
    do_plus = ((trunc < 0) != (x2 < 0)) & (trunc != 0)
    return torch.where(do_plus, trunc + x2, trunc)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """roundf(): to nearest, ties away from zero (torch.round ties to even)."""
    t = torch.trunc(x)
    return torch.where(torch.abs(x - t) >= 0.5, t + torch.sign(x), t)


class TV:
    """A tensor that promotes and divides the way jnp does."""

    __slots__ = ("t",)
    __array_priority__ = 1000

    def __init__(self, t: torch.Tensor) -> None:
        self.t = t

    @property
    def kind(self) -> str:
        return kind_of_dtype(self.t.dtype)

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _kind(v: Any) -> str:
        return v.kind if isinstance(v, TV) else scalar_kind(v)

    def _as(self, v: Any, kind: str) -> torch.Tensor:
        if isinstance(v, TV):
            return v.t.to(_DTYPE[kind])
        return torch.tensor(v, dtype=_DTYPE[kind], device=self.t.device)

    def _binary(self, other: Any, reflected: bool, kind: str):
        a, b = (other, self) if reflected else (self, other)
        return self._as(a, kind), self._as(b, kind)

    def _arith(self, other: Any, reflected: bool, fn) -> "TV":
        kind = result_kind(self.kind, self._kind(other))
        if kind == "b":
            raise TypeError("arithmetic on booleans is not supported")
        a, b = self._binary(other, reflected, kind)
        return TV(fn(a, b))

    def _compare(self, other: Any, fn) -> "TV":
        kind = result_kind(self.kind, self._kind(other))
        a, b = self._binary(other, False, kind)
        return TV(fn(a, b))

    def _logic(self, other: Any, fn) -> "TV":
        kind = result_kind(self.kind, self._kind(other))
        if kind != "b":
            raise TypeError("& and | combine boolean predicates only")
        a, b = self._binary(other, False, kind)
        return TV(fn(a, b))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o): return self._arith(o, False, torch.add)
    def __radd__(self, o): return self._arith(o, True, torch.add)
    def __sub__(self, o): return self._arith(o, False, torch.sub)
    def __rsub__(self, o): return self._arith(o, True, torch.sub)
    def __mul__(self, o): return self._arith(o, False, torch.mul)
    def __rmul__(self, o): return self._arith(o, True, torch.mul)

    def _truediv(self, other: Any, reflected: bool) -> "TV":
        a, b = self._binary(other, reflected, "f")
        return TV(a / b)

    def __truediv__(self, o): return self._truediv(o, False)
    def __rtruediv__(self, o): return self._truediv(o, True)
    def __floordiv__(self, o): return self._arith(o, False, floor_divide)
    def __rfloordiv__(self, o): return self._arith(o, True, floor_divide)
    def __mod__(self, o): return self._arith(o, False, remainder)
    def __rmod__(self, o): return self._arith(o, True, remainder)

    # -- comparisons (reflection swaps the operator, as Python does) -------
    def __gt__(self, o): return self._compare(o, torch.gt)
    def __ge__(self, o): return self._compare(o, torch.ge)
    def __lt__(self, o): return self._compare(o, torch.lt)
    def __le__(self, o): return self._compare(o, torch.le)
    def __eq__(self, o): return self._compare(o, torch.eq)  # type: ignore[override]
    def __ne__(self, o): return self._compare(o, torch.ne)  # type: ignore[override]

    # -- logic -------------------------------------------------------------
    def __and__(self, o): return self._logic(o, torch.logical_and)
    def __rand__(self, o): return self._logic(o, torch.logical_and)
    def __or__(self, o): return self._logic(o, torch.logical_or)
    def __ror__(self, o): return self._logic(o, torch.logical_or)

    def __invert__(self) -> "TV":
        if self.kind == "b":
            return TV(torch.logical_not(self.t))
        return TV(torch.bitwise_not(self.t))

    __hash__ = object.__hash__


def as_mask(v: Any, shape, device) -> torch.Tensor:
    """`jnp.asarray(v, bool)` broadcast to `shape`."""
    if isinstance(v, TV):
        t = v.t if v.t.dtype == torch.bool else v.t != 0
        return torch.broadcast_to(t, shape)
    return torch.full(shape, bool(v), dtype=torch.bool, device=device)


def as_f32(v: Any, shape, device) -> torch.Tensor:
    """`jnp.asarray(v, jnp.float32)` broadcast to `shape`."""
    if isinstance(v, TV):
        return torch.broadcast_to(v.t.to(torch.float32), shape)
    return torch.full(shape, float(v), dtype=torch.float32, device=device)
