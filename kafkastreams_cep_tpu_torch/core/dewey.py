"""Dewey version numbers for tracking simultaneous NFA runs.

Hierarchical run/version numbering per the SASE NFA^b automaton
(reference: core/.../cep/nfa/DeweyVersion.java:25-105). A version is a
sequence of digits; `add_run(offset)` increments the digit `len-offset`,
`add_stage` appends a 0, and compatibility is prefix-match or same-length
with a greater-or-equal final digit.

Host representation: an immutable tuple of ints. The device engine packs
versions as fixed-width integer lanes (ops/engine.py) with the identical
compare rules, so the two paths agree digit-for-digit.
"""
from __future__ import annotations

from typing import Iterable, Tuple, Union


class DeweyVersion:
    __slots__ = ("digits",)

    def __init__(self, spec: Union[int, str, Iterable[int]] = 1) -> None:
        if isinstance(spec, int):
            digits: Tuple[int, ...] = (spec,)
        elif isinstance(spec, str):
            digits = tuple(int(p) for p in spec.split("."))
        else:
            digits = tuple(int(d) for d in spec)
        if not digits:
            raise ValueError("DeweyVersion requires at least one digit")
        object.__setattr__(self, "digits", digits)

    def __setattr__(self, name: str, value: object) -> None:
        raise AttributeError("DeweyVersion is immutable")

    def __len__(self) -> int:
        return len(self.digits)

    def add_run(self, offset: int = 1) -> "DeweyVersion":
        if not 1 <= offset <= len(self.digits):
            raise ValueError(
                f"add_run offset {offset} out of range for version {self} "
                f"({len(self.digits)} digit(s))"
            )
        digits = list(self.digits)
        digits[len(digits) - offset] += 1
        return DeweyVersion(digits)

    def add_stage(self) -> "DeweyVersion":
        return DeweyVersion(self.digits + (0,))

    def is_compatible(self, that: "DeweyVersion") -> bool:
        """True when `self` descends from (or equals a later sibling of) `that`."""
        if len(self) > len(that):
            return self.digits[: len(that)] == that.digits
        if len(self) == len(that):
            return (
                self.digits[:-1] == that.digits[:-1]
                and self.digits[-1] >= that.digits[-1]
            )
        return False

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DeweyVersion):
            return NotImplemented
        return self.digits == other.digits

    def __hash__(self) -> int:
        return hash(self.digits)

    def __str__(self) -> str:
        return ".".join(str(d) for d in self.digits)

    def __repr__(self) -> str:
        return f"DeweyVersion({str(self)!r})"
