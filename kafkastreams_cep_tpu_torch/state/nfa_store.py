"""Per-key NFA execution-state store (checkpoint contract) and the
emission gate's watermark store.

A copy of the JAX package's `state/nfa_store.py`. Re-design of the
reference durability layer
(reference: core/.../cep/state/NFAStore.java:30-33,
state/internal/NFAStoreImpl.java:60-84, NFAStates.java:33-80,
Runned.java:24). The NFA's execution state -- run queue, runs counter, and
per-topic offset high-water marks -- is externalized after every processed
record and restored on resume; compiled stages are NOT stored, they are
recompiled and re-linked by id (ComputationStageSerde.java:56-101).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, Generic, List, Optional, TypeVar

if TYPE_CHECKING:
    from ..nfa.nfa import ComputationStage

K = TypeVar("K")
V = TypeVar("V")


@dataclass
class NFAStates(Generic[K, V]):
    """Serializable snapshot of one key's NFA (NFAStates.java:33-80)."""

    computation_stages: List["ComputationStage"]
    runs: int
    latest_offsets: Dict[str, int] = field(default_factory=dict)

    def latest_offset_for_topic(self, topic: str) -> Optional[int]:
        return self.latest_offsets.get(topic)


@dataclass
class EmitWatermark:
    """Persisted emitted-match high-watermark for one query.

    `sink_pos` records each sink topic's end offset at the last commit:
    after a crash, the driver re-scans only the tail past these positions
    to learn which matches the sink already saw (exactly-once recovery --
    streams/emission.py). Externalized like every other piece of execution
    state: through the changelogged store stack, at commit time."""

    sink_pos: Dict[str, int] = field(default_factory=dict)


class EmissionStore(Generic[K, V]):
    """Single-value store holding a query's `EmitWatermark` (same KV-stack
    durability toggles as the reference trio)."""

    _KEY = "watermark"

    def __init__(self, backing: Optional[Any] = None) -> None:
        if backing is None:
            from .store import InMemoryKeyValueStore

            backing = InMemoryKeyValueStore("emitted")
        self._kv = backing

    def get(self) -> Optional[EmitWatermark]:
        return self._kv.get(self._KEY)

    def put(self, watermark: EmitWatermark) -> None:
        self._kv.put(self._KEY, watermark)

    def flush(self) -> None:
        self._kv.flush()


class NFAStore(Generic[K, V]):
    """Per-key snapshot store (NFAStoreImpl.java:60-84).

    Dict-backed by default; pass `backing` (a state.store.StateStore, e.g.
    the change-logging/caching stack assembled by state/builders.py) to get
    the reference's durability toggles (AbstractStoreBuilder.java:52-71)."""

    def __init__(self, backing: Optional[Any] = None) -> None:
        if backing is None:
            from .store import InMemoryKeyValueStore

            backing = InMemoryKeyValueStore("nfa-states")
        self._kv = backing

    def find(self, key: Any) -> Optional[NFAStates]:
        return self._kv.get(key)

    def put(self, key: Any, states: NFAStates) -> None:
        self._kv.put(key, states)

    def keys(self):
        return [k for k, _v in self._kv.items()]

    def items(self):
        return self._kv.items()

    def flush(self) -> None:
        self._kv.flush()

    def __len__(self) -> int:
        return self._kv.approximate_num_entries()
