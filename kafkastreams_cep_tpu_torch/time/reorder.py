"""Per-key bounded reorder buffer: a binary heap on event time.

The host analog of Flink's event-time sorter ahead of CEP: records buffer
until the watermark passes their timestamp, then release in event-time
order. Ties release in arrival order (a monotone sequence number rides
every entry), so the released stream is exactly the stable sort the host
oracle is fed in the differential suite -- equality is bitwise, not
modulo tie order.

Capacity is bounded (`EngineConfig.reorder_capacity`); overflow POLICY
lives in the gate (time/gate.py), which owns metrics and the
`time.reorder_overflow` fault point -- this class only reports fullness
and supports forced eviction of the globally oldest entry.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Optional, Tuple

from ..core.event import Event


class ReorderBuffer:
    """Bounded min-heap of (timestamp, seq, event); seq = arrival order."""

    __slots__ = ("capacity", "_heap")

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._heap: List[Tuple[int, int, Event]] = []

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.capacity

    def peek_ts(self) -> Optional[int]:
        """Event time of the oldest buffered record (None when empty)."""
        return self._heap[0][0] if self._heap else None

    def push(self, event: Event, seq: int) -> None:
        """Admit one record; the caller enforces the capacity policy."""
        heapq.heappush(self._heap, (int(event.timestamp), int(seq), event))

    def pop_oldest(self) -> Tuple[int, int, Event]:
        """Forced eviction of the globally oldest entry (overflow path)."""
        return heapq.heappop(self._heap)

    def release(self, watermark_ms: int) -> List[Tuple[int, Event]]:
        """Pop every record with ts <= watermark, oldest first.

        Returns [(seq, event)] so the gate can interleave releases from
        several keys' buffers into one globally deterministic order."""
        out: List[Tuple[int, Event]] = []
        while self._heap and self._heap[0][0] <= watermark_ms:
            _ts, seq, ev = heapq.heappop(self._heap)
            out.append((seq, ev))
        return out

    def drain(self) -> List[Tuple[int, Event]]:
        """Pop everything in (ts, seq) order (end-of-stream flush)."""
        out: List[Tuple[int, Event]] = []
        while self._heap:
            _ts, seq, ev = heapq.heappop(self._heap)
            out.append((seq, ev))
        return out

    def entries(self) -> List[Tuple[int, int, Event]]:
        """Snapshot view in (ts, seq) order (checkpointing; non-destructive)."""
        return sorted(self._heap)
