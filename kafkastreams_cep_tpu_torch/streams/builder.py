"""Streams API: topology construction for CEP queries.

The port's `ComplexStreamsBuilder` (the JAX package's
`streams/builder.py`, reference: core/.../cep/ComplexStreamsBuilder.java:
61-107, CEPStream.java:37-74). `ComplexStreamsBuilder().stream(topics)`
returns a `CEPStream`; each `query(name, pattern, runtime=...)` registers
a processor plus the query's exactly-once emission gate, and returns an
`OutputStream` whose matches reach `out.records`, `for_each` callbacks
and, through `.to(topic)`, a sink topic of the builder's `RecordLog`.

Runtimes:
  * "cuda" (the port's default): `DeviceCEPProcessor`, the batched
    engine and its step kernel on the card. `device=`, `engine=`,
    `config=`, `batch_size=`, `initial_keys=`, `sink_format=` ("objects",
    "json" or "arrow"), `drain_mode=` ("flat" or "pool"), `native=`,
    `auto_drain=`, `target_emit_ms=`, `provenance_sample=`,
    `compile_telemetry=` and `watermark_gen=` pass through to the
    processor and its engine, as does every other keyword of
    `BatchedDeviceNFA`; the JAX engine's `mesh=` is not one of them. A
    config with `reorder_capacity > 0` arms the processor's event-time
    gate.
  * "host": the per-record `CEPProcessor` (streams/processor.py) over the
    three host stores (state/builders.py). Its event-time knobs are query
    kwargs (`reorder_capacity`, `lateness_ms`, `late_policy`,
    `reorder_overflow` or its alias `on_overflow`, `watermark_gen`).
  * "auto": the query starts on the host runtime and promotes itself to
    "cuda" once `promote_after` distinct keys were seen
    (streams/auto_router.py; `buffer_max`, `autosize`); the host
    event-time knobs translate into the device `EngineConfig`, and a
    custom `watermark_gen` pins the host for good.
  The JAX package's default is "host" and its device runtime is "tpu";
  the port's default stays "cuda", and "tpu" raises. The host and auto
  runtimes run the host phase under `config.strict_windows` when a
  `config=` is given (the JAX package runs it under reference windows
  whatever the config, so its auto runtime's two phases disagree on a
  strict-window config); without one, both packages agree.

`Topology.tick_event_time`, `flush_event_time` and `event_time_health`
drive and read the event-time gates of every runtime.

Crash consistency, with a builder `log`: at `Topology.flush_stores()`
(the commit) a "cuda" query's `DeviceStateStore` appends the processor's
snapshot to `<app_id>-<query>-streamscep-devicestate-changelog`; a
"host" or "auto" query's three stores append to their own changelogs as
they are written, and `EventTimeStateStore` appends its gate's state;
every query's emission watermark goes last. After a crash a topology
built afresh on the same log runs `restore_stores()` and replays the
input from the committed offsets, and the emission gate dedupes what the
sink already holds.

Observability, as in the JAX package: `stamp_ingest` (the driver's poll)
records each record's ingest wall, read back at sink emission into
`cep_match_latency_seconds{query}`; a record that carried a trace context
lands a stitched "match.emit" span on the tracer `attach_tracer` gave;
and every durably emitted match leaves a bounded lineage entry that
`explain()` returns, newest first.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq, Union

from ..obs.registry import default_registry
from ..obs.trace import TraceContext
from ..ops.engine import EngineConfig
from ..ops.profiling import LATENCY_BUCKETS
from ..pattern.pattern import Pattern
from ..state import serde as state_serde
from ..state.builders import QueryStoreBuilders
from ..state.naming import (
    aggregates_store,
    changelog_topic,
    device_state_store,
    emitted_store,
    event_buffer_store,
    event_time_store,
    nfa_states_store,
    normalize_query_name,
)
from ..state.nfa_store import EmissionStore
from ..state.store import ChangeLoggingKeyValueStore, InMemoryKeyValueStore, restore_store
from .auto_router import AutoRoutingProcessor
from .device_processor import DeviceCEPProcessor, DeviceStateStore
from .emission import EmissionGate, encode_sink_key
from .processor import CEPProcessor
from .serde import Queried, SinkMatch, match_lineage, sequence_to_json

RUNTIMES = ("cuda", "host", "auto")

#: The host runtime's event-time knobs (query kwargs).
HOST_EVENT_TIME_OPTS = (
    "reorder_capacity", "lateness_ms", "late_policy", "reorder_overflow", "watermark_gen",
)


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
    """One registered query: processor + stores + emission gate + sinks.

    runtime="cuda": the micro-batching device driver; matches surface when
    a micro-batch of `batch_size` records fills or on `Topology.flush()`.
    runtime="host": the per-record host driver over the three host
    stores. runtime="auto": host first, promoted to "cuda" on key growth
    (module doc)."""

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
                f"unknown runtime {runtime!r} (the port's runtimes are {RUNTIMES}; "
                "the JAX package's 'tpu' is 'cuda' here)"
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
        # Ingest (the driver's poll stamp) -> sink emission, per match.
        self._m_match_latency = (
            registry if registry is not None else default_registry()
        ).histogram(
            "cep_match_latency_seconds",
            "Ingest (driver poll stamp) -> sink emission wall per match",
            labels=("query",),
            buckets=LATENCY_BUCKETS,
        ).labels(query=self.name)
        schema = queried.schema if queried is not None else None
        if runtime == "cuda":
            self.store_builders = None
            self.processor: Any = DeviceCEPProcessor(
                name, pattern, schema=schema, registry=registry, **device_opts,
            )
            # The checkpoint changelog (a snapshot at every commit) and the
            # emission watermark, both driven by flush/restore_stores.
            self.stores: Dict[str, Any] = {emit_name: self.emission_store}
            if log is not None:
                ds_name = device_state_store(self.name)
                self.stores[ds_name] = DeviceStateStore(
                    self, log, changelog_topic(app_id, ds_name), registry=registry,
                )
            return
        config = device_opts.get("config")
        strict_windows = bool(config.strict_windows) if config is not None else False
        # Compile once; the builders share the compiled stages with the
        # processor (QueryStoreBuilders.java:50-56).
        self.store_builders = QueryStoreBuilders(name, pattern, strict_windows=strict_windows)
        self.stores = self.store_builders.build_all(log, app_id)
        self.stores[emit_name] = self.emission_store
        # The host runtime's event-time knobs ride the query kwargs;
        # `on_overflow` is an alias of `reorder_overflow` (an explicit
        # reorder_overflow wins).
        et_opts = {k: device_opts[k] for k in HOST_EVENT_TIME_OPTS if k in device_opts}
        if "on_overflow" in device_opts:
            et_opts.setdefault("reorder_overflow", device_opts["on_overflow"])
        self.processor = CEPProcessor(
            name,
            self.store_builders.stages,
            nfa_store=self.stores[nfa_states_store(name)],
            buffer=self.stores[event_buffer_store(name)],
            aggregates=self.stores[aggregates_store(name)],
            strict_windows=strict_windows,
            registry=registry,
            **et_opts,
        )
        if runtime == "auto":
            self.processor = self._auto_router(name, pattern, schema, registry, device_opts)
        if log is not None and self.processor.gate is not None:
            et_name = event_time_store(self.name)
            self.stores[et_name] = EventTimeStateStore(
                self, log, changelog_topic(app_id, et_name), registry=registry,
            )

    def _auto_router(self, name, pattern, schema, registry, device_opts) -> AutoRoutingProcessor:
        """Wrap the host processor in the auto router. The host event-time
        knobs translate into the device EngineConfig, so both phases apply
        the same late/reorder policy; a custom `watermark_gen` cannot be
        replayed into the device gate without re-deciding late/admit, so
        it pins the host for the query's lifetime."""
        device_opts = dict(device_opts)
        auto_opts = {
            k: device_opts.pop(k)
            for k in ("promote_after", "buffer_max", "autosize")
            if k in device_opts
        }
        dev_opts = {
            k: v for k, v in device_opts.items()
            if k not in HOST_EVENT_TIME_OPTS + ("on_overflow",)
        }
        base_cfg = dev_opts.pop("config", None) or EngineConfig()
        et_cfg: Dict[str, Any] = {
            k: device_opts[k] for k in ("reorder_capacity", "lateness_ms", "late_policy")
            if k in device_opts
        }
        if "reorder_overflow" in device_opts:
            et_cfg["on_overflow"] = device_opts["reorder_overflow"]
        elif "on_overflow" in device_opts:
            et_cfg["on_overflow"] = device_opts["on_overflow"]
        if et_cfg:
            base_cfg = replace(base_cfg, **et_cfg)
        dev_opts["config"] = base_cfg
        if "watermark_gen" in device_opts:
            auto_opts["promote_after"] = 1 << 62
        return AutoRoutingProcessor(
            name, pattern, self.processor, schema=schema, registry=registry,
            device_opts=dev_opts, **auto_opts,
        )


class EventTimeStateStore:
    """Changelog durability for a host or auto query's event-time gate.

    The host trio's changelogs restore through `restore_stores()`, but an
    EventTimeGate lives outside them -- and its arrival marks must never
    be MORE durable than the buffered records they dedup (a crash would
    then silently lose every buffered record: the mark rejects the replay
    while the buffer restored empty). This store snapshots the
    processor's combined event-time state (gate contents + arrival
    marks, `CEPProcessor.event_time_state()`) into
    `<app>-<query>-streamscep-eventtime-changelog` at every commit flush
    and restores the newest snapshot that validates, CRC-rejected tails
    counted in `cep_checkpoint_corrupt_total`.

    Commit atomicity caveat: like the reference trio itself (three
    separate changelogs per query), a commit's appends are not one
    atomic frame -- a torn flush can land the trio's records without
    this store's snapshot. The store is registered AFTER the trio, so
    iteration order makes the event-time snapshot the LAST append of a
    flush: a tear restores OLDER arrival marks over NEWER run state,
    which re-offers the window's records (duplicate-leaning,
    deduplicated at the sink by the emission gate) instead of the
    loss-leaning inverse. The device runtime does without this store:
    its single-blob snapshot carries gate and engine of one commit."""

    def __init__(self, node: "QueryNode", log: Any, topic: str,
                 registry: Optional[Any] = None) -> None:
        self.name = event_time_store(node.name)
        self.node = node
        self.log = log
        self.topic = topic
        self.metrics = registry if registry is not None else default_registry()
        self._m_corrupt = self.metrics.counter(
            "cep_checkpoint_corrupt_total",
            "Checkpoint payloads rejected by CRC/framing validation",
        )

    @property
    def persistent(self) -> bool:
        return True

    def flush(self) -> None:
        if self.log is None:
            return
        self.log.append(
            self.topic, None,
            state_serde.encode_event_time_state(self.node.processor.event_time_state()),
        )

    def restore_from_changelog(self) -> int:
        if self.log is None:
            return 0
        recs = self.log.read(self.topic)
        for rec in reversed(recs):
            if rec.value is None:
                continue
            try:
                state = state_serde.decode_event_time_state(rec.value)
            except state_serde.CheckpointError:
                # Corrupt bytes: walk back to the previous generation.
                self._m_corrupt.inc()
                continue
            try:
                self.node.processor.restore_event_time(state)
            except (ValueError, KeyError) as exc:
                # A CRC-valid snapshot the configured gate cannot absorb is
                # a configuration mismatch (a changed watermark generator),
                # not corruption: restoring an empty gate over committed
                # offsets would lose every buffered record.
                raise ValueError(
                    f"{self.name}: event-time snapshot does not match the "
                    f"configured watermark generator ({exc}); restore with "
                    "the original event-time config"
                ) from exc
            return len(recs)
        return len(recs)


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

    #: Ingest-stamp map bound: records that never complete a match would
    #: pin their stamp forever; past the bound the oldest stamps evict
    #: (their eventual matches skip the latency observation). A topology
    #: keeps at least twice its largest micro-batch (`ingest_stamps_max`):
    #: a record's stamp must outlive the batch that completes its match.
    INGEST_STAMPS_MAX = 1 << 16

    #: The explain ring: one lineage entry per durably admitted match.
    EXPLAIN_RING = 256

    def __init__(self, queries: List[tuple], log: Optional[Any] = None) -> None:
        self.queries = queries
        self.log = log
        self._offsets: Dict[tuple, int] = {}
        #: (topic, partition, key, offset) -> (ingest wall
        #: [time.perf_counter], trace blob or None, broker or None), in
        #: insertion order, so eviction drops the oldest. An OrderedDict:
        #: evicting a plain dict's first key with `next(iter(d))` scans
        #: every key deleted before it, O(bound) per record.
        self._ingest_stamps: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.ingest_stamps_max = max(
            [self.INGEST_STAMPS_MAX]
            + [2 * max(1, int(node.device_opts.get("batch_size", 64)))
               for _s, node, _o in queries])
        self._tracer: Optional[Any] = None
        self._explain: deque = deque(maxlen=self.EXPLAIN_RING)

    def attach_tracer(self, tracer: Any) -> None:
        """Attach a SpanTracer for the stitched "match.emit" spans (a
        LogDriver attaches its own)."""
        self._tracer = tracer

    def stamp_ingest(
        self, topic: str, partition: int, key, offset: int, t: float,
        trace: Optional[bytes] = None, broker: Optional[int] = None,
    ) -> None:
        """Record one record's ingest wall (the driver's poll), with its
        trace-context blob and source broker when known."""
        stamps = self._ingest_stamps
        stamps[(topic, partition, key, offset)] = (t, trace, broker)
        while len(stamps) > self.ingest_stamps_max:
            stamps.popitem(last=False)

    def _observe_match_latency(
        self, node: QueryNode, topic: str, partition: int, key, offset: int,
        seq: Any = None,
    ) -> Optional[bytes]:
        """For one emitted match, keyed by its completing event's
        identity: observe ingest -> emission latency, land the stitched
        "match.emit" span when that event carried a trace context, and
        record the explain entry. Returns the trace blob for the sink
        append to forward. The stamp stays: several matches may complete
        on one event."""
        stamp = self._ingest_stamps.get((topic, partition, key, offset))
        latency: Optional[float] = None
        trace_blob: Optional[bytes] = None
        broker: Optional[int] = None
        ctx = None
        if stamp is not None:
            t0, trace_blob, broker = stamp
            latency = time.perf_counter() - t0
            node._m_match_latency.observe(latency)
            if trace_blob is not None and self._tracer is not None:
                ctx = TraceContext.decode(trace_blob)
                if ctx is not None:
                    self._tracer.record("match.emit", latency, trace=ctx)
        entry: Dict[str, Any] = {
            "query": node.name,
            "key": str(key),
            "topic": topic,
            "partition": partition,
            "offset": offset,
            "latency_s": latency,
            "trace_id": ctx.trace_id if ctx is not None else None,
            "ingest_unix": ctx.ingest_unix if ctx is not None else None,
            "broker": broker,
        }
        lineage = self._match_lineage(seq)
        if lineage is not None:
            entry.update(lineage)
        self._explain.append(entry)
        return trace_blob

    @staticmethod
    def _match_lineage(seq: Any) -> Optional[Dict[str, Any]]:
        """The bounded lineage of one emitted match: the JSON decode's
        pre-built `SinkMatch.lineage` (sampled matches), else derived from
        an attached Sequence, else the completing event alone."""
        if seq is None:
            return None
        if isinstance(seq, SinkMatch):
            if seq.lineage is not None:
                return dict(seq.lineage)
            if seq.sequence is not None:
                return match_lineage(seq.sequence)
            last = seq.last_event
            if last is None:
                return None
            return {
                "events": [{
                    "stage": None,
                    "topic": getattr(last, "topic", ""),
                    "partition": getattr(last, "partition", 0),
                    "offset": getattr(last, "offset", 0),
                    "timestamp": getattr(last, "timestamp", 0),
                }],
                "truncated_events": 0,
                "stage_path": [],
                "branch_depth": 0,
                "chain_depth": 1,
            }
        if getattr(seq, "matched", None) is not None:
            return match_lineage(seq)
        return None

    def explain(self, limit: int = 64) -> List[Dict[str, Any]]:
        """Recent emitted-match lineage entries, newest first: the
        contributing event identities, run version path, trace id, source
        broker and observed latency."""
        return list(self._explain)[::-1][: max(0, limit)]

    @property
    def source_topics(self) -> List[str]:
        seen: List[str] = []
        for stream, _node, _out in self.queries:
            for t in stream.topics:
                if t not in seen:
                    seen.append(t)
        return seen

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
            if node.runtime == "cuda":
                # Device results span every key of the flushed micro-batch.
                results = node.processor.process(
                    key, value, timestamp=timestamp, topic=topic, partition=partition,
                    offset=offset,
                )
            elif node.runtime == "auto" or node.processor.gate is not None:
                # The auto router speaks the keyed surface in both phases;
                # a gated host query's arrival can release OTHER keys'
                # records, so each match carries its own key.
                results = node.processor.process_keyed(
                    key, value, timestamp=timestamp, topic=topic, partition=partition,
                    offset=offset,
                )
            else:
                outputs.extend(self._emit_host(node, out, key, value, timestamp, topic,
                                               partition, offset))
                continue
            outputs.extend(self._emit_device(node, out, results))
        return outputs

    def _emit_host(self, node: QueryNode, out: OutputStream, key, value, timestamp: int,
                   topic: str, partition: int, offset: int) -> List[Record]:
        """The ungated host runtime: the record's own matches, with the
        record's metadata."""
        emitted: List[Record] = []
        for seq in node.processor.process(
            key, value, timestamp=timestamp, topic=topic, partition=partition, offset=offset,
        ):
            # Dedup gates the durable sink only: in-memory consumers did
            # not survive a crash, so a replayed match still reaches them.
            digest = node.gate.admit(key, seq)
            record = Record(key, seq, timestamp, topic, partition, offset)
            out.records.append(record)
            emitted.append(record)
            for fn in node.downstream:
                fn(key, seq)
            if digest is not None:
                trace = self._observe_match_latency(node, topic, partition, key, offset, seq)
                self._sink(node, record, digest, trace=trace)
        return emitted

    def is_host_poison(self, exc: BaseException) -> bool:
        """Whether `exc` is what a host processor's user predicate or fold
        raised (its `last_error`): a poison record, which `LogDriver`
        dead-letters. Anything else that escapes `process` is not."""
        for _stream, node, _out in self.queries:
            host = node.processor if node.runtime == "host" else getattr(
                node.processor, "host", None)
            if host is not None and host.last_error is exc:
                return True
        return False

    def flush(self) -> List[Record]:
        """Flush every query's pending micro-batch (no-op for host
        queries)."""
        outputs: List[Record] = []
        for _stream, node, out in self.queries:
            flush = getattr(node.processor, "flush", None)
            if flush is not None:
                outputs.extend(self._emit_device(node, out, flush()))
        return outputs

    def tick_event_time(self, now_ms: int) -> List[Record]:
        """Wall-clock tick for the event-time gates (idle-source
        watermark timeouts): emits the matches of whatever the advanced
        watermarks released. No-op for queries without a gate."""
        outputs: List[Record] = []
        for _stream, node, out in self.queries:
            outputs.extend(self._emit_device(node, out, node.processor.tick_event_time(now_ms)))
        return outputs

    def flush_event_time(self) -> List[Record]:
        """End of stream: release every gate's buffered records in
        event-time order and flush them through the engines."""
        outputs: List[Record] = []
        for _stream, node, out in self.queries:
            outputs.extend(self._emit_device(node, out, node.processor.flush_event_time()))
        return outputs

    def event_time_health(self) -> Dict[str, Any]:
        """Event-time liveness for /healthz: per gated query its watermark
        lag and reorder-buffer occupancy, plus the aggregates. Queries
        without a gate are absent."""
        per_query: Dict[str, Any] = {}
        occupancy = 0
        lag_max: Optional[float] = None
        for _stream, node, _out in self.queries:
            gate = node.processor.gate
            if gate is None:
                continue
            lag_ms = gate.watermark_lag_ms
            lag_s = None if lag_ms is None else lag_ms / 1e3
            per_query[node.name] = {
                "watermark_lag_s": lag_s,
                "reorder_occupancy": gate.occupancy,
            }
            occupancy += gate.occupancy
            if lag_s is not None:
                lag_max = lag_s if lag_max is None else max(lag_max, lag_s)
        return {
            "gated_queries": len(per_query),
            "reorder_occupancy": occupancy,
            "watermark_lag_s_max": lag_max,
            "queries": per_query,
        }

    def take_poisoned(self) -> List[tuple]:
        """Drain every query's quarantined records: [(query, key, event,
        exception)] for each record whose value its schema could not pack."""
        return [
            (node.name, key, event, exc)
            for _stream, node, _out in self.queries
            if hasattr(node.processor, "take_poisoned")
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
        SinkMatch (sink_format "json" or "arrow") is admitted by its ident frames
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
                trace: Optional[bytes] = None
                if last is not None:
                    # A match completes at its last event: that event's
                    # ingest stamp anchors the latency sample.
                    trace = self._observe_match_latency(
                        node, last.topic, last.partition, rkey, last.offset, seq)
                self._sink(node, record, digest, trace=trace)
        return emitted

    def _sink(self, node: QueryNode, record: Record, digest: bytes,
              trace: Optional[bytes] = None) -> None:
        """Write a matched record to the node's sink topics in the log.

        The record key carries the match's emission digest
        (streams/emission.py `encode_sink_key`), so the sink topic itself
        is the durable record of what it saw. `trace` forwards the
        completing event's trace context."""
        if self.log is None or not node.sink_topics:
            return
        key_bytes = encode_sink_key(record.key, digest)
        if isinstance(record.value, SinkMatch):
            value_bytes = record.value.payload
        else:
            value_bytes = sequence_to_json(record.value).encode("utf-8")
        for topic in node.sink_topics:
            self.log.append(topic, key_bytes, value_bytes, timestamp=record.timestamp,
                            trace=trace)
