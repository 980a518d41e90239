"""Streams API: topology construction for CEP queries on the card.

The port's `ComplexStreamsBuilder` (the JAX package's
`streams/builder.py`, reference: core/.../cep/ComplexStreamsBuilder.java:
61-107, CEPStream.java:37-74). `ComplexStreamsBuilder().stream(topics)`
returns a `CEPStream`; each `query(name, pattern, runtime="cuda")`
registers a `DeviceCEPProcessor` (the batched engine and its step kernel)
plus the query's exactly-once emission gate, and returns an
`OutputStream` whose matches reach `out.records`, `for_each` callbacks
and, through `.to(topic)`, a sink topic of the builder's `RecordLog`.

`runtime="cuda"` is the only runtime: the JAX package's "host", "tpu" and
"auto" raise. `device=`, `engine=`, `config=`, `batch_size=`,
`initial_keys=`, `sink_format=`, `native=` and `auto_drain=` pass
through to the processor and its engine.

Crash consistency, with a builder `log`: each query's
`DeviceStateStore` appends the processor's snapshot to
`<app_id>-<query>-streamscep-devicestate-changelog` and its emission
watermark to its own changelog at `Topology.flush_stores()` (the commit);
after a crash a topology built afresh on the same log runs
`restore_stores()` and replays the input from the committed offsets, and
the emission gate dedupes what the sink already holds.

Left out (ROADMAP.md): ingest stamps and match latency, the tracer and
`explain`, and the event-time gate's `tick_event_time`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence as Seq, Union

from ..pattern.pattern import Pattern
from ..state.naming import (
    changelog_topic,
    device_state_store,
    emitted_store,
    normalize_query_name,
)
from ..state.nfa_store import EmissionStore
from ..state.store import ChangeLoggingKeyValueStore, InMemoryKeyValueStore, restore_store
from .device_processor import DeviceCEPProcessor, DeviceStateStore
from .emission import EmissionGate, encode_sink_key
from .serde import Queried, SinkMatch, sequence_to_json

RUNTIMES = ("cuda",)


class Record:
    __slots__ = ("key", "value", "timestamp", "topic", "partition", "offset")

    def __init__(self, key, value, timestamp=0, topic="", partition=0, offset=0):
        self.key = key
        self.value = value
        self.timestamp = timestamp
        self.topic = topic
        self.partition = partition
        self.offset = offset


class QueryNode:
    """One registered query: device processor + emission gate + sinks.

    Matches surface when a micro-batch of `batch_size` records fills or on
    `Topology.flush()`."""

    def __init__(
        self,
        name: str,
        pattern: Pattern,
        queried: Optional[Queried],
        runtime: str = "cuda",
        log: Optional[Any] = None,
        app_id: str = "app",
        **device_opts: Any,
    ) -> None:
        if runtime not in RUNTIMES:
            raise ValueError(
                f"runtime {runtime!r} is not ported: the port runs queries on "
                f"the card only (runtime='cuda')"
            )
        self.name = normalize_query_name(name)
        self.pattern = pattern
        self.queried = queried
        self.runtime = runtime
        self.downstream: List[Callable] = []
        self.sink_topics: List[str] = []
        registry = device_opts.pop("registry", None)
        self.registry = registry
        #: The processor's options, kept so that a restore rebuilds it.
        self.device_opts = dict(device_opts)
        # Exactly-once emission gate (streams/emission.py): its watermark
        # store rides the changelog when the builder has a log.
        emit_name = emitted_store(self.name)
        emit_kv: Any = InMemoryKeyValueStore(emit_name)
        if log is not None:
            emit_kv = ChangeLoggingKeyValueStore(
                emit_kv, log, changelog_topic(app_id, emit_name)
            )
        self.emission_store = EmissionStore(backing=emit_kv)
        self.gate = EmissionGate(self.name, store=self.emission_store, registry=registry)
        self.processor = DeviceCEPProcessor(
            name,
            pattern,
            schema=queried.schema if queried is not None else None,
            registry=registry,
            **device_opts,
        )
        # The checkpoint changelog (a snapshot at every commit) and the
        # emission watermark, both driven by flush/restore_stores.
        self.stores: Dict[str, Any] = {emit_name: self.emission_store}
        if log is not None:
            ds_name = device_state_store(self.name)
            self.stores[ds_name] = DeviceStateStore(
                self, log, changelog_topic(app_id, ds_name), registry=registry,
            )


class CEPStream:
    """A stream handle supporting `query(...)` (CEPStream.java:37-74)."""

    def __init__(self, builder: "ComplexStreamsBuilder", topics: Seq[str]) -> None:
        self._builder = builder
        self.topics = list(topics)

    def query(
        self,
        name: str,
        pattern: Pattern,
        queried: Optional[Queried] = None,
        runtime: str = "cuda",
        **device_opts: Any,
    ) -> "OutputStream":
        node = QueryNode(
            name, pattern, queried, runtime=runtime, log=self._builder.log,
            app_id=self._builder.app_id, **device_opts,
        )
        out = OutputStream(node)
        self._builder._register(self, node, out)
        return out


class OutputStream:
    """Downstream handle: collects matched sequences; supports sinks."""

    def __init__(self, node: QueryNode) -> None:
        self.node = node
        self.records: List[Record] = []

    def for_each(self, fn: Callable) -> "OutputStream":
        self.node.downstream.append(fn)
        return self

    def to(self, topic: str) -> "OutputStream":
        """Route matches to a sink topic of the builder's RecordLog
        (the reference's `.through("Matches")` egress,
        example/.../CEPStockDemo.java:84-99): key pickled with the match's
        emission digest, value the golden JSON shape."""
        self.node.sink_topics.append(topic)
        return self


class ComplexStreamsBuilder:
    """Framework entry object (ComplexStreamsBuilder.java:61-107).

    Pass `log` (a streams.log.RecordLog) to land `.to(topic)` outputs in
    it and change-log each query's emission watermark to
    `<app_id>-<store-name>-changelog`."""

    def __init__(self, log: Optional[Any] = None, app_id: str = "app") -> None:
        self._queries: List[tuple] = []
        self.log = log
        self.app_id = app_id

    def stream(self, topics: Union[str, Seq[str]]) -> CEPStream:
        if isinstance(topics, str):
            topics = [topics]
        return CEPStream(self, topics)

    def _register(self, stream: CEPStream, node: QueryNode, out: OutputStream) -> None:
        self._queries.append((stream, node, out))

    def build(self) -> "Topology":
        return Topology(self._queries, log=self.log)


class Topology:
    """The built processing graph, drivable record by record."""

    def __init__(self, queries: List[tuple], log: Optional[Any] = None) -> None:
        self.queries = queries
        self.log = log
        self._offsets: Dict[tuple, int] = {}

    def process(
        self, topic: str, key, value, timestamp: int = 0, partition: int = 0,
        offset: Optional[int] = None,
    ) -> List[Record]:
        """Drive one record through every query subscribed to `topic`."""
        if offset is None:
            offset = self._offsets.get((topic, partition), 0)
        # Keep the auto-offset counter ahead of explicit offsets too, so
        # later auto-assigned offsets never collide with used ones (event
        # identity is (topic, partition, offset)).
        self._offsets[(topic, partition)] = max(
            self._offsets.get((topic, partition), 0), offset + 1
        )
        outputs: List[Record] = []
        for stream, node, out in self.queries:
            if topic not in stream.topics:
                continue
            results = node.processor.process(
                key, value, timestamp=timestamp, topic=topic, partition=partition,
                offset=offset,
            )
            outputs.extend(self._emit_device(node, out, results))
        return outputs

    def flush(self) -> List[Record]:
        """Flush every query's pending micro-batch."""
        outputs: List[Record] = []
        for _stream, node, out in self.queries:
            outputs.extend(self._emit_device(node, out, node.processor.flush()))
        return outputs

    def take_poisoned(self) -> List[tuple]:
        """Drain every query's quarantined records: [(query, key, event,
        exception)] for each record whose value its schema could not pack."""
        return [
            (node.name, key, event, exc)
            for _stream, node, _out in self.queries
            for key, event, exc in node.processor.take_poisoned()
        ]

    def flush_stores(self) -> None:
        """The commit: flush every query's stores (the device state store
        appends a processor snapshot to its changelog), then roll the
        emission watermark forward LAST. A crash between the two leaves
        new state with an old watermark -- recovery's sink-tail scan
        over-covers and the gate dedupes harmlessly; the reverse order
        would let replay regenerate matches the scan no longer sees."""
        for _stream, node, _out in self.queries:
            for store in node.stores.values():
                store.flush()
            node.gate.commit(self.log, node.sink_topics)
            node.emission_store.flush()

    def restore_stores(self) -> int:
        """Replay each store's changelog into it (the device state store
        restores its processor from the newest valid snapshot), then
        recover each emission gate from its watermark and the sink tail.
        Returns the changelog records read."""
        n = sum(
            restore_store(store)
            for _stream, node, _out in self.queries
            for store in node.stores.values()
        )
        for _stream, node, _out in self.queries:
            node.gate.recover(self.log, node.sink_topics)
        return n

    def _emit_device(self, node: QueryNode, out: OutputStream, results) -> List[Record]:
        """Route [(key, Sequence | SinkMatch)] results downstream.

        Record metadata comes from the match's completing (last) event. A
        SinkMatch (sink_format="json") is admitted by its ident frames
        (`admit_ident`, bitwise the digest `admit` gives the same match)
        and sinks its pre-serialized payload."""
        emitted: List[Record] = []
        for rkey, seq in results:
            # Dedup gates the durable sink only: in-memory consumers
            # (out.records, for_each callbacks) see every match.
            if isinstance(seq, SinkMatch):
                digest = node.gate.admit_ident(rkey, seq.ident)
                last = seq.last_event
            else:
                digest = node.gate.admit(rkey, seq)
                last = seq.matched[-1].events[-1] if seq.matched else None
            record = Record(
                rkey,
                seq,
                last.timestamp if last else 0,
                last.topic if last else "",
                last.partition if last else 0,
                last.offset if last else 0,
            )
            out.records.append(record)
            emitted.append(record)
            for fn in node.downstream:
                fn(rkey, seq)
            if digest is not None:
                self._sink(node, record, digest)
        return emitted

    def _sink(self, node: QueryNode, record: Record, digest: bytes) -> None:
        """Write a matched record to the node's sink topics in the log.

        The record key carries the match's emission digest
        (streams/emission.py `encode_sink_key`), so the sink topic itself
        is the durable record of what it saw."""
        if self.log is None or not node.sink_topics:
            return
        key_bytes = encode_sink_key(record.key, digest)
        if isinstance(record.value, SinkMatch):
            value_bytes = record.value.payload
        else:
            value_bytes = sequence_to_json(record.value).encode("utf-8")
        for topic in node.sink_topics:
            self.log.append(topic, key_bytes, value_bytes, timestamp=record.timestamp)
