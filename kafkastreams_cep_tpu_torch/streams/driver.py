"""Log pump driver: consume source topics, drive the topology, commit.

A copy of the JAX package's `streams/driver.py` over the port's
topology, adaptive pacing (`pacing=`, parallel/drain_sched.py's
`AdmissionPacer`) included. Poison: a record that does not deserialize,
a record whose value a "cuda" query's schema cannot pack (the processor
quarantines it) and a record on which a host query's user predicate or
fold raised (`Topology.is_host_poison`) are dead-lettered. Unlike the
JAX driver, `poll` dead-letters nothing else that `Topology.process`
raises: such an error is the engine's (a failed build, launch or decode
of a flush the record started) and propagates, with nothing
committed.

The Kafka-Streams-runtime role the reference delegates to its platform
(reference: the poll/process/commit loop of Kafka Streams' StreamThread
driving CEPProcessor.java:111-160, with changelog restore on start and
consumer-group offset commits). Here the transport is the embedded
`RecordLog` (streams/log.py): the driver restores every query store from
its changelog topic, resumes from the committed consumer offsets (stored in
the log's `__consumer_offsets` topic), and pumps records through
`Topology.process`, committing after each poll.

Records in source topics carry pickled keys/values by default; pass
`key_deserializer`/`value_deserializer` for custom wire formats.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..faults import injection as _flt
from ..faults.injection import with_retry
from ..obs.registry import MetricsRegistry, default_registry
from ..obs.trace import SpanTracer
from ..parallel.drain_sched import AdmissionPacer
from ..state.store import default_deserializer, default_serializer
from .builder import Topology
from .log import RecordLog

OFFSETS_TOPIC = "__consumer_offsets"

#: Dead-letter key framing version tag (see LogDriver._dead_letter).
DLQ_KEY_TAG = "kct-dlq-v1"


def dlq_topic(source_topic: str) -> str:
    """`<source>.DLQ`: the dead-letter topic for one source topic."""
    return f"{source_topic}.DLQ"


def produce(
    log: RecordLog,
    topic: str,
    key: Any,
    value: Any,
    timestamp: int = 0,
    partition: int = 0,
    trace: bool = False,
    tracer: Optional[SpanTracer] = None,
) -> int:
    """Producer-side helper: append one (key, value) record, default serde.

    `trace=True` mints a fresh `TraceContext` for the record (the ingest
    end of the end-to-end trace) and rides it on the append;
    with a `tracer` the producer's own "produce" span lands in that
    tracer's ring as the trace's root."""
    blob: Optional[bytes] = None
    if trace or tracer is not None:
        from ..obs.trace import TraceContext

        ctx = TraceContext.new()
        if tracer is not None:
            # Root span: zero-duration marker at mint time, recorded AS
            # the context's own span id; children (broker.append,
            # match.emit, sink hops) parent onto it.
            tracer.record(
                "produce", 0.0, end_unix=ctx.ingest_unix, trace=ctx,
                span_id=ctx.span_id, parent_id="",
            )
        blob = ctx.encode()
    return log.append(
        topic,
        default_serializer(key),
        default_serializer(value),
        timestamp=timestamp,
        partition=partition,
        trace=blob,
    )


class LogDriver:
    """Drives one topology from a RecordLog: restore, poll, commit.

    The Kafka-Streams-metrics surface the reference delegates to the
    framework lives here too: poll/record/commit counters and the restore
    wall land in `registry` (the process default when none is passed).
    `report_every_s` arms a periodic reporter: once the interval has
    elapsed since the last report, `reporter` is called with the
    registry's prom-text exposition (default: the
    `kafkastreams_cep_tpu_torch.obs` logger at INFO). The cadence check runs
    after each poll and -- when `serve_http()` attached the introspection
    plane -- from its clock thread, so idle topics report on time too
    (the poll-gated cadence alone never reported on an idle
    topic). `serve_http()` additionally exposes /metrics, /snapshot,
    /healthz and /tracez over stdlib HTTP."""

    def __init__(
        self,
        topology: Topology,
        log: Optional[RecordLog] = None,
        group: str = "default",
        key_deserializer: Callable[[bytes], Any] = default_deserializer,
        value_deserializer: Callable[[bytes], Any] = default_deserializer,
        restore: bool = True,
        registry: Optional[MetricsRegistry] = None,
        report_every_s: Optional[float] = None,
        reporter: Optional[Callable[[str], None]] = None,
        on_poison: str = "quarantine",
        max_restore_attempts: int = 3,
        partitions: Optional[Mapping[str, Sequence[int]]] = None,
        pacing: Any = None,
    ) -> None:
        self.topology = topology
        self.log = log if log is not None else topology.log
        if self.log is None:
            raise ValueError("LogDriver needs a RecordLog (topology built without one)")
        self.group = group
        self.key_de = key_deserializer
        self.value_de = value_deserializer
        if on_poison not in ("quarantine", "raise"):
            raise ValueError(
                f"on_poison must be quarantine|raise, got {on_poison!r}"
            )
        #: Poison policy: "quarantine" (default) dead-letters records that
        #: fail deserialization or that the processor quarantined (a value
        #: its schema cannot pack) and keeps the pump advancing; "raise"
        #: propagates them (fail-stop). Any other error of the topology (a
        #: failed build, launch or decode, an overflow escalation, an
        #: exhausted transient) propagates under both.
        self.on_poison = on_poison
        self.max_restore_attempts = max(1, max_restore_attempts)
        #: Partition scope (the rebalance layer's task assignment): when a
        #: topic maps to a partition list here, poll() pumps ONLY those
        #: partitions of it -- disjoint scopes let several drivers share
        #: the same source topics on one fleet without double-processing.
        #: Topics absent from the map keep the discover-all default.
        self._partition_scope: Optional[Dict[str, Tuple[int, ...]]] = (
            {t: tuple(int(p) for p in ps) for t, ps in partitions.items()}
            if partitions is not None else None
        )
        self.metrics = registry if registry is not None else default_registry()
        #: Adaptive ingest pacing: when armed, a poll without
        #: `max_records` sizes its own budget from the measured admission
        #: rate (`cep_driver_poll_batch{group}`) instead of draining the
        #: whole backlog. True for the defaults, or an AdmissionPacer.
        if pacing is True:
            pacing = AdmissionPacer(registry=self.metrics, group=group)
        self.pacer = pacing if pacing else None
        # Children bound once to this driver's group (labels() locks per
        # resolution; poll() is the cadence path).
        self._m_polls = self.metrics.counter(
            "cep_driver_polls_total", "poll() calls", labels=("group",)
        ).labels(group=self.group)
        self._m_records = self.metrics.counter(
            "cep_driver_records_total", "Records polled and processed",
            labels=("group",),
        ).labels(group=self.group)
        self._m_commits = self.metrics.counter(
            "cep_driver_commits_total", "Offset commits (dirty positions only)",
            labels=("group",),
        ).labels(group=self.group)
        self._m_restore_s = self.metrics.gauge(
            "cep_driver_restore_seconds", "Changelog restore wall at startup",
            labels=("group",),
        ).labels(group=self.group)
        self._m_restored = self.metrics.gauge(
            "cep_driver_restored_records", "Changelog records replayed at startup",
            labels=("group",),
        ).labels(group=self.group)
        self._m_reports = self.metrics.counter(
            "cep_driver_reports_total", "Periodic metric reports emitted",
            labels=("group",),
        ).labels(group=self.group)
        self._m_dead_letters = self.metrics.counter(
            "cep_driver_dead_letters_total",
            "Poison records quarantined to the dead-letter topic",
            labels=("topic", "reason"),
        )
        self._m_restore_failures = self.metrics.counter(
            "cep_driver_restore_failures_total",
            "Changelog restores that failed after the bounded retries "
            "(a wedged changelog is visible here, not a hang)",
            labels=("group",),
        ).labels(group=self.group)
        self.report_every_s = report_every_s
        self.reporter = reporter
        self._last_report_t = time.perf_counter()
        # maybe_report may now be driven from the HTTP plane's clock
        # thread AND the poll path; the lock keeps a report atomic and the
        # cadence check race-free.
        import threading

        self._report_lock = threading.Lock()
        #: Host span tracer (restore/poll/commit land in /tracez and the
        #: cep_span_seconds histogram of this driver's registry).
        self.tracer = SpanTracer(self.metrics)
        # Stitched match-emission spans + /explainz lineage ride the same
        # tracer.
        if hasattr(self.topology, "attach_tracer"):
            self.topology.attach_tracer(self.tracer)
        #: Liveness wall clocks for /healthz (None until the first event).
        self._t_started = time.time()
        self._last_poll_wall: Optional[float] = None
        self._last_commit_wall: Optional[float] = None
        #: The attached introspection server, if serve_http() was called.
        self.http = None
        #: Set once close() ran: the pump refuses further polls and the
        #: reporter stays quiesced.
        self._closed = False
        self._positions: Dict[Tuple[str, int], int] = {}
        #: positions as last durably committed -- commit() appends only the
        #: deltas, so the offsets topic grows with progress, not with the
        #: commit count (the last-write-wins read tolerates either).
        self._committed: Dict[Tuple[str, int], int] = {}
        self.restored_records = 0
        if restore:
            t0 = time.perf_counter()

            def _restore() -> int:
                if _flt.ACTIVE is not None:
                    _flt.ACTIVE.fire("driver.restore")
                return self.topology.restore_stores()

            # Transient-failure wrapper (cep_retries_total{site}) with a
            # hard cap: a wedged changelog surfaces as a counted failure
            # plus the final exception, never a silent hang or hot loop.
            try:
                with self.tracer.span("restore"):
                    self.restored_records = with_retry(
                        _restore,
                        site="driver.restore",
                        attempts=self.max_restore_attempts,
                        retry_on=(Exception,),
                        registry=self.metrics,
                    )
            except Exception:
                self._m_restore_failures.inc()
                raise
            self._m_restore_s.set(time.perf_counter() - t0)
            self._m_restored.set(self.restored_records)
        #: Each pumped (topic, partition)'s end offset when the emission
        #: gates recovered digests replay has not regenerated; the commit
        #: that finds every position there settles them (`_arm_settle`).
        self._settle_at: Optional[Dict[Tuple[str, int], int]] = None
        self._load_committed()
        self._arm_settle()

    # ------------------------------------------------------------- offsets
    def _load_committed(self) -> None:
        """Latest committed position per (group, topic, partition)."""
        for rec in self.log.read(OFFSETS_TOPIC):
            if rec.key is None or rec.value is None:
                continue
            group, topic, partition = default_deserializer(rec.key)
            if group != self.group:
                continue
            pos = default_deserializer(rec.value)
            self._positions[(topic, partition)] = pos
            self._committed[(topic, partition)] = pos

    def _source_partitions(self, topic: str) -> List[int]:
        """The partitions of `topic` this driver pumps."""
        scoped = (
            self._partition_scope.get(topic)
            if self._partition_scope is not None else None
        )
        return list(scoped) if scoped is not None else (self.log.partitions(topic) or [0])

    def _arm_settle(self) -> None:
        """After a restore or a migration: when the emission gates hold
        recovered digests, note each pumped partition's end offset. Every
        crash-window record lies below it, so once the consumer has passed
        it, replay has regenerated all it will (streams/emission.py)."""
        if not self.topology.emission_outstanding():
            return
        self._settle_at = {
            (topic, partition): self.log.end_offset(topic, partition)
            for topic in self.topology.source_topics
            for partition in self._source_partitions(topic)
        }

    def commit(self) -> None:
        """Durably record consumer positions after making the state they
        cover durable (the reference commits offsets and flushes stores
        together at the commit interval).

        Order matters for at-least-once: the changelog/sink appends are
        fsynced BEFORE the offset record is appended and fsynced, so a crash
        between the two replays the interval (deduped by the HWM) instead of
        silently skipping records whose effects were lost."""
        if self._settle_at is not None and all(
            self._positions.get(tp, 0) >= end for tp, end in self._settle_at.items()
        ):
            self.topology.settle_emission()
            self._settle_at = None
        with self.tracer.span("commit"):
            self.topology.flush_stores()
            self.log.flush()  # changelog + sink records durable first
            dirty = {
                tp: pos
                for tp, pos in self._positions.items()
                if self._committed.get(tp) != pos
            }
            if not dirty:
                self._last_commit_wall = time.time()
                return
            for (topic, partition), pos in dirty.items():
                self.log.append(  # cep: trace-ok(offset commit marker: control-plane record, no trace to carry)
                    OFFSETS_TOPIC,
                    default_serializer((self.group, topic, partition)),
                    default_serializer(pos),
                )
            self.log.flush()
            self._committed.update(dirty)
            self._m_commits.inc()
            self._last_commit_wall = time.time()

    def position(self, topic: str, partition: int = 0) -> int:
        return self._positions.get((topic, partition), 0)

    def positions(self) -> Dict[Tuple[str, int], int]:
        """Snapshot of every consumer position -- what a shard checkpoint
        carries so the successor driver resumes, never replays from zero."""
        return dict(self._positions)

    def seed_positions(self, positions: Mapping[Tuple[str, int], int]) -> None:
        """Adopt checkpointed consumer positions as already-committed.

        The migration path: the successor driver is built with
        `restore=False` (its stores come from the shard checkpoint, not a
        changelog replay) and seeded with the source's committed
        positions, so its first poll() continues exactly where the fenced
        source stopped. Seeded entries count as committed -- they were
        durable under this group before the checkpoint was cut -- so the
        next commit() appends only genuinely new progress."""
        for (topic, partition), pos in positions.items():
            tp = (str(topic), int(partition))
            self._positions[tp] = int(pos)
            self._committed[tp] = int(pos)
        self._arm_settle()

    def drain_event_time(self, commit: bool = True) -> int:
        """End-of-stream drain for event-time gates: force-
        release every buffered record in event-time order, flush the
        resulting micro-batches and commit. Returns how many matches the
        drain emitted. A no-op (0) for topologies without a gate."""
        if self._closed:
            raise RuntimeError("LogDriver is closed")
        emitted = self.topology.flush_event_time()
        emitted.extend(self.topology.flush())
        self._quarantine_flushed()
        if commit:
            self.commit()
        return len(emitted)

    # ---------------------------------------------------------------- poll
    def poll(self, max_records: Optional[int] = None, commit: bool = True) -> int:
        """Consume available records from every source topic, in offset
        order per partition; returns how many were processed."""
        if self._closed:
            raise RuntimeError("LogDriver is closed")
        processed = 0
        budget = max_records
        if budget is None and self.pacer is not None:
            # Paced pump: about target_poll_ms worth of records at the
            # observed admission rate (an explicit max_records wins).
            budget = self.pacer.suggest_batch()
        for topic in self.topology.source_topics:
            for partition in self._source_partitions(topic):
                start = self._positions.get((topic, partition), 0)
                records = self.log.read(topic, partition, start, budget)
                broker_for = getattr(self.log, "broker_for", None)
                broker = (
                    broker_for(topic, partition)
                    if broker_for is not None and records else None
                )
                for rec in records:
                    try:
                        key = (
                            self.key_de(rec.key)
                            if rec.key is not None else None
                        )
                        value = (
                            self.value_de(rec.value)
                            if rec.value is not None else None
                        )
                    except Exception as exc:
                        # Undeserializable record: quarantine (position
                        # still advances -- the pump never wedges on
                        # poison). InjectedCrash is a BaseException, so a
                        # simulated death can never land here.
                        self._dead_letter(
                            topic, partition, rec.offset,
                            rec.key, rec.value, rec.timestamp,
                            "deserialize", exc,
                            trace=getattr(rec, "trace", None),
                        )
                        processed += 1
                        continue
                    # Ingest wall stamp: keyed by the record's
                    # full event identity, read back at sink emission to
                    # observe cep_match_latency_seconds{query}. The
                    # record's wire trace context and source broker
                    # ride the stamp, so emission can stitch its span and
                    # /explainz can name the hop.
                    self.topology.stamp_ingest(
                        topic, partition, key, rec.offset,
                        time.perf_counter(),
                        trace=getattr(rec, "trace", None),
                        broker=broker,
                    )
                    # Only a host query's predicate error is dead-lettered
                    # here: a "cuda" query quarantines the poison its
                    # schema cannot pack (dead-lettered below), so any
                    # other error is the engine's -- a failed build,
                    # launch or decode of a flush this record started --
                    # and dead-lettering it would drop the whole batch that
                    # flush was driving.
                    try:
                        self.topology.process(
                            topic,
                            key,
                            value,
                            timestamp=rec.timestamp,
                            partition=partition,
                            offset=rec.offset,
                        )
                    except Exception as exc:
                        if not self.topology.is_host_poison(exc):
                            raise
                        self._dead_letter(
                            topic, partition, rec.offset,
                            rec.key, rec.value, rec.timestamp,
                            "predicate", exc,
                            trace=getattr(rec, "trace", None),
                        )
                    processed += 1
                if records:
                    self._positions[(topic, partition)] = records[-1].offset + 1
                if budget is not None:
                    budget -= len(records)
                    if budget <= 0:
                        break
            if budget is not None and budget <= 0:
                break
        # Event-time wall tick: idle-source watermark timeouts
        # advance at poll cadence, so a stalled exchange stops holding the
        # merged watermark (and its buffered records) back. No-op for
        # topologies without an event-time gate.
        self.topology.tick_event_time(int(time.time() * 1000))
        self.topology.flush()  # flush device micro-batches
        self._quarantine_flushed()
        if commit and processed:
            if _flt.ACTIVE is not None:
                _flt.ACTIVE.fire("driver.pre_commit")
            self.commit()
            if _flt.ACTIVE is not None:
                _flt.ACTIVE.fire("driver.post_commit")
        if self.pacer is not None:
            self.pacer.observe(processed)
        self._m_polls.inc()
        self._m_records.inc(processed)
        self._last_poll_wall = time.time()
        self.maybe_report()
        return processed

    # -------------------------------------------------------------- poison
    def _dead_letter(
        self,
        topic: str,
        partition: int,
        offset: int,
        key_bytes: Optional[bytes],
        value_bytes: Optional[bytes],
        timestamp: int,
        reason: str,
        exc: Exception,
        trace: Optional[bytes] = None,
    ) -> None:
        """Quarantine one poison record to `<topic>.DLQ` (or re-raise
        under on_poison="raise"). The DLQ record keeps the original value
        bytes verbatim; the key frames provenance:
        (tag, source topic, partition, offset, reason, original key).
        A wire trace context on the poison record rides to the DLQ too,
        so even a quarantined record's story stays stitched."""
        if self.on_poison == "raise":
            raise exc
        self.log.append(
            dlq_topic(topic),
            default_serializer(
                (DLQ_KEY_TAG, topic, partition, offset, reason, key_bytes)
            ),
            value_bytes,
            timestamp=timestamp,
            trace=trace,
        )
        self._m_dead_letters.labels(topic=topic, reason=reason).inc()

    def _quarantine_flushed(self) -> None:
        """Dead-letter records the device runtime quarantined at flush
        time (poison only detectable at pack; the original wire bytes are
        gone by then, so key/value re-serialize through the default
        serde)."""
        for query, _key, event, exc in self.topology.take_poisoned():
            self._dead_letter(
                event.topic or query,
                event.partition,
                event.offset,
                default_serializer(event.key),
                default_serializer(event.value),
                event.timestamp,
                "predicate",
                exc,
            )

    # ---------------------------------------------------------- reporting
    def maybe_report(self) -> bool:
        """Periodic reporter hook: emit the registry's prom-text exposition
        once `report_every_s` has elapsed since the last report.

        Called after each poll AND from the introspection plane's clock
        thread (`serve_http`), so an idle topic still reports on time --
        a poll-gated cadence alone never reports on an idle topic. Thread-safe: one report per elapsed interval, whichever
        caller gets there first. Returns True when a report fired."""
        if self.report_every_s is None:
            return False
        with self._report_lock:
            # Re-check under the lock: a caller that disarms the reporter
            # (report_every_s = None) and then holds this lock once is
            # guaranteed no report lands afterwards (a served-text vs
            # snapshot comparison relies on that barrier).
            if self.report_every_s is None:
                return False
            now = time.perf_counter()
            if now - self._last_report_t < self.report_every_s:
                return False
            self._last_report_t = now
            import logging

            # Best-effort: a failing reporter (push gateway blip) must
            # never break the data path -- records were already processed
            # and offsets committed by the time we get here.
            try:
                text = self.metrics.to_prom_text()
                if self.reporter is not None:
                    self.reporter(text)
                else:
                    logging.getLogger("kafkastreams_cep_tpu_torch.obs").info(
                        "metrics report (group=%s)\n%s", self.group, text
                    )
                self._m_reports.inc()
                return True
            except Exception:
                logging.getLogger("kafkastreams_cep_tpu_torch.obs").warning(
                    "metrics reporter failed (group=%s)",
                    self.group, exc_info=True,
                )
                return False

    # ------------------------------------------------------- introspection
    def health(self) -> Dict[str, Any]:
        """Liveness view for /healthz: poll/commit recency, restore state,
        fault-arm state. Pure host-side reads -- safe from any thread."""
        now = time.time()
        return {
            "group": self.group,
            "uptime_s": now - self._t_started,
            "polls": self._m_polls.value,
            "records": self._m_records.value,
            "commits": self._m_commits.value,
            "last_poll_age_s": (
                now - self._last_poll_wall
                if self._last_poll_wall is not None else None
            ),
            "last_commit_age_s": (
                now - self._last_commit_wall
                if self._last_commit_wall is not None else None
            ),
            "restored_records": self.restored_records,
            "restore_failures": self._m_restore_failures.value,
            "dead_letters": sum(
                child.value
                for _lv, child in self._m_dead_letters._sorted_children()
            ),
            # DLQ-quarantine breakdown: which topic
            # poisoned and why, without parsing prom text.
            "dead_letters_by_reason": {
                f"{topic}/{reason}": child.value
                for (topic, reason), child
                in self._m_dead_letters._sorted_children()
            },
            # The event-time plane: watermark lag + reorder-buffer
            # occupancy per gated query, so operators gate on
            # event-time health from the
            # same JSON the liveness probes already read.
            "event_time": self.topology.event_time_health(),
            # The wire-transport plane: when the log is a socket
            # transport its connection/heartbeat health rides the
            # same /healthz body; None for the embedded file/memory log.
            "transport": (
                self.log.health()
                if callable(getattr(self.log, "health", None))
                else None
            ),
            "faults_armed": _flt.ACTIVE is not None,
            "report_every_s": self.report_every_s,
        }

    def disarm_reporter(self) -> None:
        """Disarm the periodic reporter AND quiesce any in-flight report.

        Setting `report_every_s = None` alone leaves a race: a clock tick
        already past maybe_report's fast-path check can still emit. The
        lock round-trip here is the barrier -- maybe_report re-checks the
        disarm under the same lock, so after this returns no report can
        move a counter (a served-text vs snapshot comparison depends
        on it)."""
        self.report_every_s = None
        with self._report_lock:
            pass

    def match_exemplars(self, limit: int = 64) -> list:
        """Sampled match-provenance exemplars across every device-runtime
        query in the topology (newest-first per processor), the
        /tracez?kind=match source."""
        out: list = []
        for _stream, node, _o in self.topology.queries:
            fn = getattr(node.processor, "provenance_exemplars", None)
            if fn is not None:
                out.extend(fn(limit))
        return out[:limit]

    def explain(self, limit: int = 64) -> list:
        """Recent emitted-match lineage entries (the /explainz source):
        contributing event identities, run version path, trace id, source
        broker, observed latency -- newest first."""
        fn = getattr(self.topology, "explain", None)
        return fn(limit) if fn is not None else []

    def close(self, commit: bool = True) -> None:
        """Orderly shutdown -- the clock-thread race fix.

        `disarm_reporter` only quiesces REPORTS; the introspection
        plane's clock thread keeps running and a tick in flight can call
        `maybe_report()` -- and through `health_fn` read driver state --
        while a caller is tearing the pipeline down (the
        `disarm_reporter` docstring documented the race for
        `report_every_s = None` only). The fix is ordering: stop the
        HTTP plane FIRST (`IntrospectionServer.stop` joins both the
        serve and clock threads), so by the time anything else is torn
        down no tick can be in flight; then disarm the reporter and take
        a final commit so processed-but-uncommitted positions survive.
        Idempotent; `poll()` after close raises."""
        if self._closed:
            return
        if self.http is not None:
            self.http.stop()
            self.http = None
        self.disarm_reporter()
        # Only now is it safe to mark closed and touch shared state: no
        # clock tick can race the final flush/commit.
        self._closed = True
        if commit:
            self.commit()

    def __enter__(self) -> "LogDriver":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def serve_http(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        tick_every_s: Optional[float] = None,
    ):
        """Attach the live introspection plane (obs/http.py) to this
        driver: /metrics and /snapshot expose `self.metrics`, /healthz
        reports `health()`, /tracez serves the driver's spans and the
        topology's sampled match exemplars. The plane's clock thread
        drives `maybe_report` on wall time, so `report_every_s` fires on
        idle topics too. Returns the started IntrospectionServer (also
        kept on `self.http`); `port=0` binds an ephemeral port."""
        from ..obs.http import IntrospectionServer

        if self._closed:
            raise RuntimeError("LogDriver is closed")
        if tick_every_s is None:
            tick_every_s = 0.25
            if self.report_every_s is not None:
                tick_every_s = max(0.01, min(0.25, self.report_every_s / 2))
        self.http = IntrospectionServer(
            registry=self.metrics,
            tracer=self.tracer,
            health_fn=self.health,
            match_exemplars=self.match_exemplars,
            explain_fn=self.explain,
            tick_fns=(self.maybe_report,),
            tick_every_s=tick_every_s,
            host=host,
            port=port,
        ).start()
        return self.http
