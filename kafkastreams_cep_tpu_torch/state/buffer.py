"""Shared versioned buffer: the SASE partial-match store, exact-lineage form.

Re-design of the reference buffer
(reference: core/.../cep/state/SharedVersionedBufferStore.java:32-77,
state/internal/SharedVersionedBufferStoreImpl.java:45-212,
state/internal/MatchedEvent.java, state/internal/Matched.java). The
reference stores partial matches of all simultaneous runs in one pointer
graph whose nodes are keyed by (stage, event) and whose predecessor pointers
are tagged with Dewey versions; extraction walks backwards choosing the
pointer whose version is Dewey-compatible with the requested one
(SharedVersionedBufferStoreImpl.java:176-201, MatchedEvent.java:90-98).

That routing is ambiguous: two runs can legitimately carry EQUAL version
digits after independent addRun() bumps (e.g. a branch clone parked on an
epsilon stage and an ordinary run, both at version "2.0"), and when both
consume the same event at the same stage the shared node holds two pointers
tagged "2.0" -- extraction then splices one run's prefix onto the other
run's match and silently drops events the run actually consumed. This is
observable in the reference itself; it is a correctness bug, not a
behavior to reproduce.

This store therefore keeps the reference's *sharing* (branch clones share
their prefix chain -- the SASE space optimization) but drops the ambiguous
cross-run node merging: every put appends a fresh node holding an exact
parent index, each run tracks its chain head by node id
(ComputationStage.last_node), and extraction is a plain parent walk --
unambiguous by construction. This is the same scheme as the device engine's
HBM node pool (ops/engine.py: node_pred per slot, per-lane `node` index),
which makes host and device agree on match lineage by design. Refcounts are
replaced by mark-sweep reclamation from the live runs' chain heads (`gc`),
the host analog of the device's batch-boundary compaction
(ops/runtime.py:_compact).
"""
from __future__ import annotations

from typing import Any, Dict, Generic, Iterable, Optional, TypeVar

from ..core.event import Event
from ..core.sequence import Sequence, SequenceBuilder

K = TypeVar("K")
V = TypeVar("V")


class BufferNode(Generic[K, V]):
    """One appended event in a run's lineage chain (MatchedEvent analog)."""

    __slots__ = ("stage_name", "event", "parent")

    def __init__(self, stage_name: str, event: Event[K, V], parent: Optional[int]) -> None:
        self.stage_name = stage_name
        self.event = event
        self.parent = parent

    def __repr__(self) -> str:
        return f"BufferNode(stage={self.stage_name!r}, event={self.event!r}, parent={self.parent})"


class SharedVersionedBuffer(Generic[K, V]):
    """Append-only lineage store with shared prefixes (the host oracle store).

    API shape follows the reference contract
    (SharedVersionedBufferStore.java:32-77) translated to index-linked
    chains: `put` appends and returns the new chain head, `get` materializes
    a chain into a `Sequence`, and reclamation is `gc` over live heads
    instead of per-extraction refcount decrements.
    """

    def __init__(self) -> None:
        self._nodes: Dict[int, BufferNode[K, V]] = {}
        self._next_id = 0

    def __len__(self) -> int:
        return len(self._nodes)

    # -- writes --------------------------------------------------------------
    def put(self, stage_name: str, event: Event[K, V], parent: Optional[int] = None) -> int:
        """Append one consumed event chained to `parent`; returns its node id.

        The root put (parent None) starts a new lineage
        (SharedVersionedBufferStoreImpl.java:149-157); a chained put is the
        reference's predecessor-linked put (:101-126) without the version
        tag -- the parent index IS the (unambiguous) pointer.
        """
        if parent is not None and parent not in self._nodes:
            raise ValueError(f"Cannot find predecessor node {parent}")
        node_id = self._next_id
        self._next_id += 1
        self._nodes[node_id] = BufferNode(stage_name, event, parent)
        return node_id

    # -- reads ---------------------------------------------------------------
    def get(self, head: Optional[int]) -> Sequence[K, V]:
        """Materialize the chain ending at `head`, oldest stage first.

        The analog of peek(remove=false): sequence assembly in reverse while
        walking predecessors (SharedVersionedBufferStoreImpl.java:176-201,
        Sequence.java:211-222).
        """
        builder: SequenceBuilder[K, V] = SequenceBuilder()
        node_id = head
        while node_id is not None:
            node = self._nodes[node_id]
            builder.add(node.stage_name, node.event)
            node_id = node.parent
        return builder.build(reversed_=True)

    # -- reclamation ---------------------------------------------------------
    def gc(self, live_heads: Iterable[Optional[int]]) -> int:
        """Mark-sweep: keep only chains reachable from live runs' heads.

        Replaces the reference's refcount decrements during extraction
        (which, combined with branch() pinning, leak shared chains -- see
        round-2 analysis). Returns the number of reclaimed nodes.
        """
        marked: set = set()
        for head in live_heads:
            node_id = head
            while node_id is not None and node_id not in marked:
                marked.add(node_id)
                node_id = self._nodes[node_id].parent
        dead_ids = [i for i in self._nodes if i not in marked]
        for i in dead_ids:
            del self._nodes[i]
        return len(dead_ids)


class ReadOnlySharedVersionBuffer(Generic[K, V]):
    """Read-only facade handed to sequence predicates (ReadOnlySharedVersionBuffer.java)."""

    def __init__(self, buffer: SharedVersionedBuffer[K, V]) -> None:
        self._buffer = buffer

    def get(self, head: Optional[int]) -> Sequence[K, V]:
        return self._buffer.get(head)


class BufferStore(Generic[K, V]):
    """The query-level buffer state store: one lineage buffer per record key.

    The reference keeps all keys' partial matches in a single KV store
    (SharedVersionedBufferStoreImpl.java:49) -- safe there because node keys
    embed event identity and reclamation is per-chain refcounts. With
    mark-sweep reclamation, sharing one arena across keys would let one
    key's GC see only its own live heads, so the store is partitioned per
    record key (chains never cross keys: each key owns its NFA,
    CEPProcessor.java:111-124). The device engine partitions identically
    (one node pool per key lane, parallel/key_shard.py).
    """

    def __init__(self, backing: Optional[Any] = None) -> None:
        if backing is None:
            from .store import InMemoryKeyValueStore

            backing = InMemoryKeyValueStore("event-buffer")
        self._kv = backing

    def for_key(self, key: Any) -> SharedVersionedBuffer[K, V]:
        buffer = self._kv.get(key)
        if buffer is None:
            buffer = SharedVersionedBuffer()
            self._kv.put(key, buffer)
        return buffer

    def persist(self, key: Any) -> None:
        """Re-put the key's buffer so a change-logging backing captures the
        in-place mutations the NFA made this record (the reference's store
        writes each node mutation individually,
        SharedVersionedBufferStoreImpl.java:117-126; here the changelog
        granularity is the per-key chain store)."""
        buffer = self._kv.get(key)
        if buffer is not None:
            self._kv.put(key, buffer)

    def items(self):
        return self._kv.items()

    def set_for_key(self, key: Any, buffer: SharedVersionedBuffer[K, V]) -> None:
        self._kv.put(key, buffer)

    def flush(self) -> None:
        self._kv.flush()

    def __len__(self) -> int:
        return sum(len(b) for _k, b in self._kv.items())
