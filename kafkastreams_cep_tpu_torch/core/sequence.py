"""A completed pattern match: ordered per-stage event sets.

Re-design of the reference's match result object
(reference: core/.../cep/Sequence.java:36-225): a `Sequence` is an ordered
collection of `Staged` groups (stage name -> sorted event set), assembled in
reverse while walking the shared versioned buffer backwards from the final
event. On the device path, sequences are decoded from compact
(stage-id, event-slot) match descriptors emitted by the kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Generic, Iterator, List, Optional, Tuple, TypeVar

from .event import Event

K = TypeVar("K")
V = TypeVar("V")


class MatchProvenance:
    """Why this match fired: the lineage of one decoded Sequence.

    The NFA^b design's point (Agrawal et al., SIGMOD'08; NFA.java:51-52)
    is that a match is a traceable pointer chain through the shared
    versioned buffer with a Dewey version path -- this struct is that
    trace, decoded from the already-pulled chain table at no extra device
    cost:

    - `stage_path`: stage names in traversal order (the pointer chain's
      stage walk, oldest first);
    - `chain_depth`: total events on the chain (hops in the buffer walk);
    - `branch_depth`: the Dewey-style version-path depth -- one digit per
      stage the run entered (DeweyVersion.add_stage per transition), i.e.
      len(stage_path);
    - `first_offset`/`last_offset`, `first_timestamp`/`last_timestamp`:
      the window span the match covered, in source-log coordinates;
    - `query`: owning query name; `trigger`: the drain that emitted it
      (drain | ring_full | region_pressure | micro_drain | backpressure).
    """

    __slots__ = (
        "query",
        "trigger",
        "stage_path",
        "chain_depth",
        "branch_depth",
        "first_offset",
        "last_offset",
        "first_timestamp",
        "last_timestamp",
    )

    def __init__(
        self,
        query: str,
        trigger: str,
        stage_path: Tuple[str, ...],
        chain_depth: int,
        branch_depth: int,
        first_offset: int,
        last_offset: int,
        first_timestamp: int,
        last_timestamp: int,
    ) -> None:
        self.query = query
        self.trigger = trigger
        self.stage_path = tuple(stage_path)
        self.chain_depth = chain_depth
        self.branch_depth = branch_depth
        self.first_offset = first_offset
        self.last_offset = last_offset
        self.first_timestamp = first_timestamp
        self.last_timestamp = last_timestamp

    def to_dict(self) -> Dict[str, Any]:
        """JSON-friendly form (the /tracez?kind=match wire shape)."""
        return {
            "query": self.query,
            "trigger": self.trigger,
            "stage_path": list(self.stage_path),
            "chain_depth": self.chain_depth,
            "branch_depth": self.branch_depth,
            "first_offset": self.first_offset,
            "last_offset": self.last_offset,
            "first_timestamp": self.first_timestamp,
            "last_timestamp": self.last_timestamp,
        }

    def __repr__(self) -> str:
        return (
            f"MatchProvenance(query={self.query!r}, trigger={self.trigger!r}, "
            f"stages={'>'.join(self.stage_path)}, depth={self.chain_depth}, "
            f"branch={self.branch_depth}, "
            f"offsets=[{self.first_offset}, {self.last_offset}], "
            f"ts=[{self.first_timestamp}, {self.last_timestamp}])"
        )


class Staged(Generic[K, V]):
    """Events matched by a single stage, kept in stream order."""

    __slots__ = ("stage", "_events")

    def __init__(self, stage: str, events: Optional[List[Event[K, V]]] = None) -> None:
        self.stage = stage
        self._events: List[Event[K, V]] = sorted(set(events or []))

    def add(self, event: Event[K, V]) -> None:
        if event not in self._events:
            self._events.append(event)
            self._events.sort()

    @property
    def events(self) -> Tuple[Event[K, V], ...]:
        return tuple(self._events)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Staged):
            return NotImplemented
        return self.stage == other.stage and self._events == other._events

    def __hash__(self) -> int:
        return hash((self.stage, tuple(self._events)))

    def __repr__(self) -> str:
        return f"{{stage={self.stage!r}, events={self._events!r}}}"


class Sequence(Generic[K, V]):
    """An ordered collection of per-stage matched event groups."""

    #: Sampled lineage (MatchProvenance) attached by the decode path when
    #: provenance sampling is armed; None otherwise. A CLASS default, not
    #: an __init__ assignment: the native decoder (decoder.cc) builds
    #: instances without running Python __init__, and the accessor must
    #: hold there too. Deliberately outside __eq__/__hash__: two equal
    #: matches stay equal whether or not one was sampled.
    provenance: Optional[MatchProvenance] = None

    def __init__(self, matched: List[Staged[K, V]]) -> None:
        self.matched: List[Staged[K, V]] = list(matched)
        self._by_name: Dict[str, Staged[K, V]] = {s.stage: s for s in self.matched}

    def get_by_name(self, stage: str) -> Optional[Staged[K, V]]:
        return self._by_name.get(stage)

    def get_by_index(self, index: int) -> Staged[K, V]:
        return self.matched[index]

    def size(self) -> int:
        return sum(len(s.events) for s in self.matched)

    def __len__(self) -> int:
        return self.size()

    def __iter__(self) -> Iterator[Event[K, V]]:
        for staged in self.matched:
            yield from staged.events

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Sequence):
            return NotImplemented
        return self.matched == other.matched

    def __hash__(self) -> int:
        return hash(tuple(self.matched))

    def __repr__(self) -> str:
        return repr(self.matched)

    def to_dict(self) -> dict:
        """JSON-friendly form used by the egress serde (streams/serde.py)."""
        return {
            "events": [
                {
                    "name": staged.stage,
                    "events": [e.value for e in staged.events],
                }
                for staged in self.matched
            ]
        }

    @staticmethod
    def builder() -> "SequenceBuilder[K, V]":
        return SequenceBuilder()


class SequenceBuilder(Generic[K, V]):
    """Accumulates (stage, event) pairs preserving first-insertion stage order."""

    def __init__(self) -> None:
        self._matched: Dict[str, Staged[K, V]] = {}

    def add(self, stage: str, event: Event[K, V]) -> "SequenceBuilder[K, V]":
        staged = self._matched.get(stage)
        if staged is None:
            staged = Staged(stage)
            self._matched[stage] = staged
        staged.add(event)
        return self

    def build(self, reversed_: bool = False) -> Sequence[K, V]:
        groups = list(self._matched.values())
        if reversed_:
            groups = groups[::-1]
        return Sequence(groups)
