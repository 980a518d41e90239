"""Generic key-value state stores and delegating wrappers.

A copy of the JAX package's `state/store.py` without `CheckpointFile`
(no port runtime checkpoints to a file), plus `restore_store` (the JAX
package's `state/builders.py`, which re-exports it here), the one routine
that replays a store's changelog. Re-design of the reference
store-adapter layer (reference:
core/.../cep/state/internal/WrappedStateStore.java:25-75 and the Kafka
Streams store stack its builders assemble:
AbstractStoreBuilder.java:52-71): a dict-backed `InMemoryKeyValueStore`
at the bottom, `ChangeLoggingKeyValueStore` appending every mutation to
a changelog topic of a `RecordLog` (streams/log.py), and
`CachingKeyValueStore` batching writes until `flush()`.

Live objects stay in memory and serialization happens once, at the
changelog boundary, through the codecs of state/serde.py.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

Serializer = Callable[[Any], bytes]
Deserializer = Callable[[bytes], Any]


class StateStore:
    """Minimal KV store contract (mirrors the reference's StateStore SPI)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._open = True

    # -- lifecycle ---------------------------------------------------------
    @property
    def is_open(self) -> bool:
        return self._open

    def flush(self) -> None:  # pragma: no cover - trivial default
        pass

    def close(self) -> None:
        self.flush()
        self._open = False

    @property
    def persistent(self) -> bool:
        return False

    # -- KV ops ------------------------------------------------------------
    def get(self, key: Any) -> Optional[Any]:
        raise NotImplementedError

    def put(self, key: Any, value: Any) -> None:
        raise NotImplementedError

    def delete(self, key: Any) -> Optional[Any]:
        raise NotImplementedError

    def items(self) -> Iterator[Tuple[Any, Any]]:
        raise NotImplementedError

    def approximate_num_entries(self) -> int:
        return sum(1 for _ in self.items())


class InMemoryKeyValueStore(StateStore):
    """Dict-backed bottom store."""

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self._data: Dict[Any, Any] = {}

    def get(self, key: Any) -> Optional[Any]:
        return self._data.get(key)

    def put(self, key: Any, value: Any) -> None:
        self._data[key] = value

    def delete(self, key: Any) -> Optional[Any]:
        return self._data.pop(key, None)

    def items(self) -> Iterator[Tuple[Any, Any]]:
        return iter(list(self._data.items()))

    def approximate_num_entries(self) -> int:
        return len(self._data)


class WrappedStateStore(StateStore):
    """Delegating base for store decorators (WrappedStateStore.java:25-75)."""

    def __init__(self, inner: StateStore) -> None:
        super().__init__(inner.name)
        self.inner = inner

    @property
    def persistent(self) -> bool:
        return self.inner.persistent

    @property
    def is_open(self) -> bool:
        return self.inner.is_open

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()
        self._open = False

    def get(self, key: Any) -> Optional[Any]:
        return self.inner.get(key)

    def put(self, key: Any, value: Any) -> None:
        self.inner.put(key, value)

    def delete(self, key: Any) -> Optional[Any]:
        return self.inner.delete(key)

    def items(self) -> Iterator[Tuple[Any, Any]]:
        return self.inner.items()

    def approximate_num_entries(self) -> int:
        return self.inner.approximate_num_entries()

    def unwrap(self) -> StateStore:
        """Innermost store (restore paths bypass the decorators)."""
        store: StateStore = self.inner
        while isinstance(store, WrappedStateStore):
            store = store.inner
        return store


def default_serializer(obj: Any) -> bytes:
    """The default wire serde (pickle -- the Kryo-fallback analog,
    KryoSerDe.java:37-121). The single definition shared by changelog,
    sink and source records."""
    import pickle

    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def default_deserializer(data: bytes) -> Any:
    import pickle

    return pickle.loads(data)


class ChangeLoggingKeyValueStore(WrappedStateStore):
    """Appends every mutation to a changelog topic (the durability hook the
    reference gets from Kafka Streams' change-logging layer; changelog topic
    naming per reference README.md:350-355)."""

    def __init__(
        self,
        inner: StateStore,
        log: Any,  # streams.log.RecordLog
        topic: str,
        partition: int = 0,
        key_serde: Optional[Tuple[Serializer, Deserializer]] = None,
        value_serde: Optional[Tuple[Serializer, Deserializer]] = None,
    ) -> None:
        super().__init__(inner)
        self.log = log
        self.topic = topic
        self.partition = partition
        self.key_serde = key_serde or (default_serializer, default_deserializer)
        self.value_serde = value_serde or (default_serializer, default_deserializer)

    @property
    def persistent(self) -> bool:
        return True

    def put(self, key: Any, value: Any) -> None:
        self.inner.put(key, value)
        self.log.append(
            self.topic,
            self.key_serde[0](key),
            self.value_serde[0](value),
            partition=self.partition,
        )

    def delete(self, key: Any) -> Optional[Any]:
        old = self.inner.delete(key)
        # Tombstone, as in a compacted changelog topic.
        self.log.append(
            self.topic, self.key_serde[0](key), None, partition=self.partition
        )
        return old

    def restore(self) -> int:
        """Replay the changelog into the wrapped store (bypassing logging).

        Returns the number of changelog records read. Last write per key
        wins and tombstones delete, so only each key's final value is
        decoded -- values (full per-key buffer/run-queue snapshots) dominate
        decode cost and the changelog holds one snapshot per processed
        record."""
        last: Dict[bytes, Optional[bytes]] = {}
        n = 0
        for rec in self.log.read(self.topic, self.partition):
            last[rec.key] = rec.value
            n += 1
        for key_bytes, value_bytes in last.items():
            key = self.key_serde[1](key_bytes)
            if value_bytes is None:
                self.inner.delete(key)
            else:
                self.inner.put(key, self.value_serde[1](value_bytes))
        return n


class CachingKeyValueStore(WrappedStateStore):
    """Write-back cache: mutations buffer in memory and push down on
    `flush()` (so a change-logged inner store batches its changelog
    appends per flush instead of per record)."""

    _TOMBSTONE = object()

    def __init__(self, inner: StateStore) -> None:
        super().__init__(inner)
        self._cache: Dict[Any, Any] = {}

    def get(self, key: Any) -> Optional[Any]:
        if key in self._cache:
            val = self._cache[key]
            return None if val is self._TOMBSTONE else val
        return self.inner.get(key)

    def put(self, key: Any, value: Any) -> None:
        self._cache[key] = value

    def delete(self, key: Any) -> Optional[Any]:
        old = self.get(key)
        self._cache[key] = self._TOMBSTONE
        return old

    def items(self) -> Iterator[Tuple[Any, Any]]:
        merged: Dict[Any, Any] = dict(self.inner.items())
        for k, v in self._cache.items():
            if v is self._TOMBSTONE:
                merged.pop(k, None)
            else:
                merged[k] = v
        return iter(merged.items())

    def approximate_num_entries(self) -> int:
        return sum(1 for _ in self.items())

    def flush(self) -> None:
        for k, v in self._cache.items():
            if v is self._TOMBSTONE:
                self.inner.delete(k)
            else:
                self.inner.put(k, v)
        self._cache.clear()
        self.inner.flush()


def restore_store(typed_store: Any) -> int:
    """Replay a typed store's changelog (if its KV stack has one) into the
    bottom store; returns records applied. The restore bypasses the
    logging layer so replay does not re-append. A store with its own
    restore protocol (the device runtime's checkpoint store) runs it."""
    restore_cl = getattr(typed_store, "restore_from_changelog", None)
    if restore_cl is not None:
        return restore_cl()
    kv = getattr(typed_store, "_kv", None)
    n = 0
    while kv is not None:
        if isinstance(kv, ChangeLoggingKeyValueStore):
            n += kv.restore()
        kv = kv.inner if isinstance(kv, WrappedStateStore) else None
    return n
