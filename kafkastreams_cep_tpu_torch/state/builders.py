"""Store builders: assemble the typed query stores with durability toggles.

A copy of the JAX package's `state/builders.py`; `changelog_topic` lives
in state/naming.py and `restore_store` in state/store.py (both
re-exported here). Re-design of the reference builder layer
(reference: core/.../cep/state/internal/builder/AbstractStoreBuilder.java:52-71,
BufferStoreBuilder.java:49-53, NFAStoreBuilder.java:58-64,
AggregatesStoreBuilder.java:46-50, and state/QueryStoreBuilders.java:50-96).
Each builder stacks an in-memory KV store with optional change-logging
(appending to a `RecordLog` changelog topic, the Kafka-role transport) and
optional write-back caching, then hands the stack to the typed store
facade. `QueryStoreBuilders` compiles the pattern exactly once
(QueryStoreBuilders.java:50-56) and shares the compiled stages between the
three builders' codecs and the processor.

Changelog topics follow the reference naming
(README.md:350-355): `<app-id>-<store-name>-changelog` where the store name
is `<query>-streamscep-{states,matched,aggregates}`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ..pattern.compiler import ensure_stages
from ..pattern.stages import Stages
from .aggregates import AggregatesStore
from .buffer import BufferStore
from .naming import aggregates_store, changelog_topic, event_buffer_store, nfa_states_store
from .nfa_store import NFAStore
from .serde import CheckpointCodec
from .store import (
    CachingKeyValueStore,
    ChangeLoggingKeyValueStore,
    InMemoryKeyValueStore,
    StateStore,
    restore_store,
)

__all__ = [
    "AbstractStoreBuilder", "AggregatesStoreBuilder", "BufferStoreBuilder",
    "NFAStoreBuilder", "QueryStoreBuilders", "changelog_topic", "restore_store",
]


class AbstractStoreBuilder:
    """Base builder: logging/caching toggles (AbstractStoreBuilder.java:52-71).

    Logging defaults on, caching off -- the reference's defaults
    (AbstractStoreBuilder.java:36)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.logging_enabled = True
        self.caching_enabled = False

    def with_logging_enabled(self) -> "AbstractStoreBuilder":
        self.logging_enabled = True
        return self

    def with_logging_disabled(self) -> "AbstractStoreBuilder":
        self.logging_enabled = False
        return self

    def with_caching_enabled(self) -> "AbstractStoreBuilder":
        self.caching_enabled = True
        return self

    def with_caching_disabled(self) -> "AbstractStoreBuilder":
        self.caching_enabled = False
        return self

    # -- serdes bound by the concrete builders ------------------------------
    def _value_serde(self) -> Optional[Tuple[Callable, Callable]]:
        return None  # pickle default

    def _key_serde(self) -> Optional[Tuple[Callable, Callable]]:
        return None  # pickle default

    def build_kv(
        self, log: Optional[Any] = None, app_id: str = "app"
    ) -> StateStore:
        """The wrapped KV stack: memory [-> change-logging] [-> caching]."""
        store: StateStore = InMemoryKeyValueStore(self.name)
        if self.logging_enabled and log is not None:
            store = ChangeLoggingKeyValueStore(
                store,
                log,
                changelog_topic(app_id, self.name),
                key_serde=self._key_serde(),
                value_serde=self._value_serde(),
            )
        if self.caching_enabled:
            store = CachingKeyValueStore(store)
        return store

    def build(self, log: Optional[Any] = None, app_id: str = "app"):
        raise NotImplementedError


class NFAStoreBuilder(AbstractStoreBuilder):
    """Per-key NFA snapshot store builder (NFAStoreBuilder.java:58-64):
    values are `NFAStates` framed by the run-queue codec (stages re-linked
    by id against the recompiled query)."""

    def __init__(self, query_name: str, codec: CheckpointCodec) -> None:
        super().__init__(nfa_states_store(query_name))
        self.codec = codec

    def _value_serde(self):
        return (self.codec.encode_nfa_states, self.codec.decode_nfa_states)

    def build(self, log: Optional[Any] = None, app_id: str = "app") -> NFAStore:
        return NFAStore(backing=self.build_kv(log, app_id))


class BufferStoreBuilder(AbstractStoreBuilder):
    """Shared versioned buffer store builder (BufferStoreBuilder.java:49-53):
    values are whole per-key lineage buffers framed by the buffer codec."""

    def __init__(self, query_name: str, codec: CheckpointCodec) -> None:
        super().__init__(event_buffer_store(query_name))
        self.codec = codec

    def _value_serde(self):
        return (self.codec.encode_buffer, self.codec.decode_buffer)

    def build(self, log: Optional[Any] = None, app_id: str = "app") -> BufferStore:
        return BufferStore(backing=self.build_kv(log, app_id))


class AggregatesStoreBuilder(AbstractStoreBuilder):
    """Fold-register store builder (AggregatesStoreBuilder.java:46-50):
    keys are (record key, aggregate name, run id) tuples, values opaque
    user fold states (pickle, the Kryo-fallback analog)."""

    def __init__(self, query_name: str) -> None:
        super().__init__(aggregates_store(query_name))

    def build(
        self, log: Optional[Any] = None, app_id: str = "app"
    ) -> AggregatesStore:
        return AggregatesStore(backing=self.build_kv(log, app_id))


class QueryStoreBuilders:
    """Compile the pattern once, hand out the three store builders
    (QueryStoreBuilders.java:50-96)."""

    def __init__(
        self,
        query_name: str,
        pattern_or_stages: Any,
        strict_windows: bool = False,
    ) -> None:
        self.stages: Stages = ensure_stages(pattern_or_stages)
        self.query_name = query_name
        self.codec = CheckpointCodec(self.stages, strict_windows=strict_windows)
        self.nfa = NFAStoreBuilder(query_name, self.codec)
        self.buffer = BufferStoreBuilder(query_name, self.codec)
        self.aggregates = AggregatesStoreBuilder(query_name)

    def build_all(
        self, log: Optional[Any] = None, app_id: str = "app"
    ) -> Dict[str, Any]:
        """The three typed stores keyed by store name."""
        return {
            self.nfa.name: self.nfa.build(log, app_id),
            self.buffer.name: self.buffer.build(log, app_id),
            self.aggregates.name: self.aggregates.build(log, app_id),
        }
