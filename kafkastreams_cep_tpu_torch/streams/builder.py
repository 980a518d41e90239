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
`initial_keys=`, `sink_format=` and `native=` pass through to the
processor and its engine. Left out (ROADMAP.md): ingest stamps and match
latency, the tracer and `explain`, `flush_stores`/`restore_stores` of the
device state, and the event-time gate's `tick_event_time`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence as Seq, Union

from ..pattern.pattern import Pattern
from ..state.naming import changelog_topic, emitted_store, normalize_query_name
from ..state.nfa_store import EmissionStore
from ..state.store import ChangeLoggingKeyValueStore, InMemoryKeyValueStore
from .device_processor import DeviceCEPProcessor
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
