"""Per-run fold-state store.

Re-design of the reference aggregates store
(reference: core/.../cep/state/AggregatesStore.java:29-36,
state/internal/AggregatesStoreImpl.java:55-75, Aggregate.java:21-34,
Aggregated.java:26-40). Registers are addressed by
(record key, aggregate name, run sequence); `branch` copies a register to a
new run id when a run splits. The device equivalent is a register file
addressed by (run lane, slot), where branch is a lane copy (ops/engine.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class AggregatesStore:
    """Fold registers keyed by (key, name, sequence).

    Dict-backed by default; pass `backing` (a state.store.StateStore) to
    assemble the reference's change-logging/caching stack around it
    (state/builders.py, AbstractStoreBuilder.java:52-71)."""

    def __init__(self, backing: Optional[Any] = None) -> None:
        if backing is None:
            from .store import InMemoryKeyValueStore

            backing = InMemoryKeyValueStore("aggregates")
        self._kv = backing

    def find(self, key: Any, name: str, sequence: int) -> Optional[Any]:
        return self._kv.get((key, name, sequence))

    def put(self, key: Any, name: str, sequence: int, value: Any) -> None:
        self._kv.put((key, name, sequence), value)

    def branch(self, key: Any, name: str, from_sequence: int, to_sequence: int) -> None:
        value = self.find(key, name, from_sequence)
        if value is not None:
            self.put(key, name, to_sequence, value)

    def items(self):
        return self._kv.items()

    def flush(self) -> None:
        self._kv.flush()

    def __len__(self) -> int:
        return self._kv.approximate_num_entries()


class States:
    """User-facing read view bound to (store, key, run) (States.java:40-88)."""

    def __init__(self, store: AggregatesStore, key: Any, sequence: int) -> None:
        self._store = store
        self._key = key
        self._sequence = sequence

    def get(self, name: str) -> Any:
        value = self._store.find(self._key, name, self._sequence)
        if value is None:
            raise UnknownAggregateException(name)
        return value

    def get_or_else(self, name: str, default: Any) -> Any:
        value = self._store.find(self._key, name, self._sequence)
        return value if value is not None else default

    # Pythonic aliases
    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def getOrElse(self, name: str, default: Any) -> Any:  # noqa: N802 reference-style alias
        return self.get_or_else(name, default)


class UnknownAggregateException(Exception):
    def __init__(self, name: str) -> None:
        super().__init__(f"No state found for name {name!r}")
