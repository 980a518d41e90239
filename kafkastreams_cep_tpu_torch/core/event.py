"""Stream event record.

TPU-native re-design of the reference's uniquely-identified stream record
(reference: core/.../cep/Event.java:1-123). Identity and ordering are
(topic, partition, offset); cross-partition ordering falls back to the
event timestamp (Event.java:88-99,113-117).

On the device path events are never represented as objects: they are packed
into structure-of-arrays columns (see ops/schema.py). This class is the host
ingress/egress view.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Generic, TypeVar

K = TypeVar("K")
V = TypeVar("V")


@functools.total_ordering
@dataclass(frozen=True)
class Event(Generic[K, V]):
    key: K
    value: V
    timestamp: int
    topic: str = ""
    partition: int = 0
    offset: int = 0

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Event):
            return NotImplemented
        return (
            self.topic == other.topic
            and self.partition == other.partition
            and self.offset == other.offset
        )

    def __hash__(self) -> int:
        return hash((self.topic, self.partition, self.offset))

    def __lt__(self, other: "Event") -> bool:
        # Mirrors the reference ordering contract: same (topic, partition)
        # orders by offset, otherwise by timestamp.
        if self.topic != other.topic or self.partition != other.partition:
            return self.timestamp < other.timestamp
        return self.offset < other.offset

    def __repr__(self) -> str:
        return (
            f"Event(key={self.key!r}, value={self.value!r}, ts={self.timestamp}, "
            f"topic={self.topic!r}, partition={self.partition}, offset={self.offset})"
        )
