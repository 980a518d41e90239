"""Per-record CEP processor: the host runtime's stream driver.

A copy of the JAX package's `streams/processor.py` (`runtime="host"`,
and the first phase of `runtime="auto"`). Re-design of the reference
processor
(reference: core/.../cep/processor/CEPProcessor.java:45-171). Per record it
loads (or creates) the key's NFA from the states store, applies the
high-water-mark idempotence check (skip records whose offset is below the
persisted offset for their topic), runs the match loop, persists the updated
snapshot, and forwards each completed Sequence downstream.

The device runtime replaces the inner `nfa.match_pattern` call with the
micro-batched engine on the card while keeping this store/HWM contract
(parallel/batched.py, streams/device_processor.py).

A raising user predicate or fold is counted in
`cep_processor_errors_total{query}`, kept as `last_error` and re-raised
with the key's stored state untouched; `LogDriver` dead-letters the
record when the topology names the exception as such a poison
(`Topology.is_host_poison`) and lets every other error propagate.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Generic, List, Optional, Tuple, TypeVar

from ..core.event import Event
from ..core.sequence import Sequence
from ..nfa.nfa import NFA, initial_computation_stage
from ..pattern.compiler import ensure_stages
from ..pattern.stages import Stages
from ..state.aggregates import AggregatesStore
from ..state.buffer import BufferStore
from ..state.naming import normalize_query_name
from ..state.nfa_store import NFAStates, NFAStore

K = TypeVar("K")
V = TypeVar("V")


class CEPProcessor(Generic[K, V]):
    """Host per-record driver bound to the three query stores."""

    def __init__(
        self,
        query_name: str,
        pattern_or_stages: Any,
        nfa_store: Optional[NFAStore] = None,
        buffer: Optional[BufferStore] = None,
        aggregates: Optional[AggregatesStore] = None,
        strict_windows: bool = False,
        registry: Optional[Any] = None,
        reorder_capacity: int = 0,
        lateness_ms: int = 0,
        late_policy: str = "drop",
        reorder_overflow: str = "drop",
        watermark_gen: Optional[Any] = None,
    ) -> None:
        from ..obs.registry import default_registry

        self.stages: Stages = ensure_stages(pattern_or_stages)
        self.query_name = normalize_query_name(query_name)
        self.nfa_store = nfa_store if nfa_store is not None else NFAStore()
        self.buffer = buffer if buffer is not None else BufferStore()
        self.aggregates = aggregates if aggregates is not None else AggregatesStore()
        # See NFA(strict_windows=...): False = reference window parity,
        # True = epsilon stages inherit windows (bounded-memory mode).
        self.strict_windows = strict_windows
        # Per-query stream counters (labels bounded by the query count):
        # the always-on host-path telemetry, in the process default
        # registry unless one is passed.
        self.metrics = registry if registry is not None else default_registry()
        # Children bound once: labels() takes a lock per resolution, and
        # this is the per-record hot path (also the vs_baseline denominator).
        self._m_records = self.metrics.counter(
            "cep_processor_records_total",
            "Records processed by the host per-record driver",
            labels=("query",),
        ).labels(query=self.query_name)
        self._m_matches = self.metrics.counter(
            "cep_processor_matches_total",
            "Completed sequences emitted by the host per-record driver",
            labels=("query",),
        ).labels(query=self.query_name)
        self._m_skipped = self.metrics.counter(
            "cep_processor_skipped_total",
            "Records skipped below the high-water mark (at-least-once dedup)",
            labels=("query",),
        ).labels(query=self.query_name)
        #: The last exception a user predicate or fold raised here.
        self.last_error: Optional[BaseException] = None
        self._m_errors = self.metrics.counter(
            "cep_processor_errors_total",
            "Records whose match loop raised (user predicate/fold errors; "
            "the driver quarantines them to the DLQ)",
            labels=("query",),
        ).labels(query=self.query_name)
        # Event-time gate: with reorder_capacity > 0 arriving
        # records route through a bounded per-key reorder buffer and the
        # match loop runs on the watermark's event-time-ordered releases.
        # The host NFA's expiry clock is each record's own timestamp, so
        # the released (sorted) stream gives reference-exact event-time
        # semantics; `recompute-none` late admissions process at their raw
        # (older) timestamp -- the documented best-effort mode.
        self.gate = None
        #: Arrival-side HWM for the gated mode: IN-MEMORY on purpose. A
        #: record below the mark was already offered to the gate, so the
        #: mark must live and die with the gate contents it guards --
        #: both checkpoint atomically (event_time_state / the event-time
        #: changelog store), never through the per-record nfa_store
        #: offsets, whose changelog would make the mark durable while the
        #: buffered record it covers evaporates on crash.
        self._arrival_hwm: Dict[Tuple[Any, str], int] = {}
        self._et_opts = dict(
            reorder_capacity=reorder_capacity, lateness_ms=lateness_ms,
            late_policy=late_policy, reorder_overflow=reorder_overflow,
        )
        if reorder_capacity > 0:
            from ..time import EventTimeGate

            self.gate = EventTimeGate(
                capacity=reorder_capacity,
                lateness_ms=lateness_ms,
                late_policy=late_policy,
                on_overflow=reorder_overflow,
                generator=watermark_gen,
                registry=self.metrics,
                query_name=self.query_name,
            )

    def _load_nfa(self, key: K) -> Tuple[NFA, NFAStates]:
        snapshot = self.nfa_store.find(key)
        key_buffer = self.buffer.for_key(key)
        if snapshot is not None:
            nfa = NFA(
                self.aggregates,
                key_buffer,
                self.stages.defined_states(),
                snapshot.computation_stages,
                snapshot.runs,
                strict_windows=self.strict_windows,
            )
            return nfa, snapshot
        nfa = NFA.build(
            self.stages, self.aggregates, key_buffer,
            strict_windows=self.strict_windows,
        )
        return nfa, NFAStates(list(nfa.computation_stages), nfa.runs)

    def process(
        self,
        key: K,
        value: V,
        timestamp: int = 0,
        topic: str = "",
        partition: int = 0,
        offset: int = 0,
    ) -> List[Sequence[K, V]]:
        """Process one record; returns completed matches for this key.

        With an event-time gate armed, the arriving record is deduped (and
        its high-water mark advanced) at ARRIVAL, then buffered; the match
        loop runs on whatever the watermark released -- possibly other
        keys' earlier records, possibly nothing yet."""
        if key is None or value is None:
            return []
        event = Event(key, value, timestamp, topic, partition, offset)
        if self.gate is None:
            return self._process_event(event)
        return [seq for _k, seq in self._process_gated(event)]

    def process_keyed(
        self,
        key: K,
        value: V,
        timestamp: int = 0,
        topic: str = "",
        partition: int = 0,
        offset: int = 0,
    ) -> List[Tuple[K, Sequence[K, V]]]:
        """Like process(), but every match carries ITS OWN key. With an
        event-time gate armed, one arriving record can release OTHER
        keys' buffered records -- the topology must attribute those
        matches (sink keys, emission-dedup digests) to the key that
        matched, never to the arrival that triggered the release."""
        if key is None or value is None:
            return []
        event = Event(key, value, timestamp, topic, partition, offset)
        if self.gate is None:
            return [(key, s) for s in self._process_event(event)]
        return self._process_gated(event)

    def _process_gated(self, event: Event) -> List[Tuple[K, Sequence[K, V]]]:
        if self._arrival_below_hwm(event):
            self._m_skipped.inc()
            return []
        # Admission first (may raise CEPOverflowError under
        # on_overflow="raise" -- the HWM must stay untouched so a retry
        # of the rejected record is not deduped as a replay), THEN the
        # durable arrival mark, then the released records' match loops.
        released = self.gate.offer(event)
        self._advance_arrival_hwm(event)
        out: List[Tuple[K, Sequence[K, V]]] = []
        for ev, _clk in released:
            out.extend(
                (ev.key, s) for s in self._process_event(ev, check_hwm=False)
            )
        return out

    def _arrival_below_hwm(self, event: Event) -> bool:
        """Arrival-side HWM dedup (gate armed): released records were
        already deduped here, so the match loop skips the re-check -- the
        release-side mark would otherwise reject every buffered record
        behind its own arrival."""
        latest = self._arrival_hwm.get(
            (event.key, f"{event.topic}#{event.partition}")
        )
        return latest is not None and event.offset < latest

    def _advance_arrival_hwm(self, event: Event) -> None:
        """Advance the arrival mark AFTER gate admission succeeded (a
        CEPOverflowError rejection must leave it untouched, or the retry
        would be deduped as a replay)."""
        self._arrival_hwm[
            (event.key, f"{event.topic}#{event.partition}")
        ] = event.offset + 1

    def event_time_state(self) -> Dict[str, Any]:
        """Gate contents + arrival marks as ONE state dict: the two are
        meaningless apart (a durable mark over lost buffer contents is a
        silent record loss), so every durability surface -- snapshot()
        and the event-time changelog store -- carries them together."""
        state = self.gate.snapshot_state()
        state["hwm"] = dict(self._arrival_hwm)
        return state

    def restore_event_time(self, state: Dict[str, Any]) -> None:
        self.gate.restore_state(state)
        self._arrival_hwm = dict(state.get("hwm", {}))

    def _process_event(
        self, event: Event, check_hwm: bool = True
    ) -> List[Sequence[K, V]]:
        nfa, snapshot = self._load_nfa(event.key)

        # The reference keys the HWM by topic only because each of its
        # processor tasks owns exactly one partition; here one processor may
        # see every partition, so the mark is per (topic, partition).
        hwm_key = f"{event.topic}#{event.partition}"
        if check_hwm:
            latest = snapshot.latest_offset_for_topic(hwm_key)
            if latest is not None and event.offset < latest:
                # Replayed record below the high-water mark: at-least-once
                # dedup.
                self._m_skipped.inc()
                return []

        try:
            sequences = nfa.match_pattern(event)
        except Exception as exc:
            # A raising user predicate/fold is poison, not a pipeline bug:
            # count it here (per query) and let the driver quarantine the
            # record to the DLQ with the pump still advancing. The key's
            # stored snapshot is untouched (it persists below only on
            # success), so the next record resumes from pre-poison state.
            self._m_errors.inc()
            self.last_error = exc
            raise
        self._m_records.inc()
        if sequences:
            self._m_matches.inc(len(sequences))

        offsets = dict(snapshot.latest_offsets)
        if check_hwm:
            offsets[hwm_key] = event.offset + 1
        self.nfa_store.put(
            event.key,
            NFAStates(list(nfa.computation_stages), nfa.runs, offsets),
        )
        # Re-put the key's buffer so a change-logging backing captures this
        # record's in-place chain mutations (CEPProcessor.java:144-147
        # persists all three stores every record).
        self.buffer.persist(event.key)
        return sequences

    # ---------------------------------------------------------- event time
    def tick_event_time(self, now_ms: int) -> List[Tuple[K, Sequence[K, V]]]:
        """Wall-clock tick (idle-source watermarks); returns [(key, seq)]
        for matches the released records completed."""
        if self.gate is None:
            return []
        out: List[Tuple[K, Sequence[K, V]]] = []
        for ev, _clk in self.gate.advance_wall(now_ms):
            out.extend(
                (ev.key, s) for s in self._process_event(ev, check_hwm=False)
            )
        return out

    def flush_event_time(self) -> List[Tuple[K, Sequence[K, V]]]:
        """End-of-stream: run the match loop over every buffered record in
        event-time order."""
        if self.gate is None:
            return []
        out: List[Tuple[K, Sequence[K, V]]] = []
        for ev, _clk in self.gate.flush():
            out.extend(
                (ev.key, s) for s in self._process_event(ev, check_hwm=False)
            )
        return out

    def take_late(self) -> List[Event]:
        """Drain the gate's late side output (late_policy=sideoutput)."""
        return self.gate.take_late() if self.gate is not None else []

    # --------------------------------------------------------- checkpointing
    def snapshot(self) -> bytes:
        """Bytes-level checkpoint of the query's three stores (the changelog
        write, reference: CEPProcessor.java:144-147 + store serdes). With
        an event-time gate armed, the gate's reorder buffers + watermark
        state ride a wrapper frame (state/serde.wrap_event_time)."""
        from ..state.serde import (
            CheckpointCodec,
            encode_event_time_state,
            wrap_event_time,
        )

        codec = CheckpointCodec(self.stages, strict_windows=self.strict_windows)
        data = codec.encode_query_stores(
            self.nfa_store, self.buffer, self.aggregates
        )
        if self.gate is not None:
            data = wrap_event_time(
                data, encode_event_time_state(self.event_time_state())
            )
        return data

    @classmethod
    def restore(
        cls,
        query_name: str,
        pattern_or_stages: Any,
        data: bytes,
        strict_windows: bool = False,
        **et_opts: Any,
    ) -> "CEPProcessor":
        """Rebuild a processor from `snapshot()` bytes in a fresh object
        graph: the pattern is recompiled and run-queue stages re-linked by
        id (ComputationStageSerde.java:56-101). Event-time knobs
        (reorder_capacity, lateness_ms, late_policy, reorder_overflow,
        watermark_gen) must match the snapshotting processor's for the
        gate state to restore."""
        from ..state.serde import (
            CheckpointCodec,
            decode_event_time_state,
            split_event_time,
        )

        data, gate_bytes = split_event_time(data)
        proc = cls(
            query_name, pattern_or_stages, strict_windows=strict_windows,
            **et_opts,
        )
        if gate_bytes is not None and proc.gate is None:
            raise ValueError(
                "checkpoint carries event-time gate state but the restored "
                "processor has no gate; pass the original reorder_capacity "
                "(and friends) to restore()"
            )
        codec = CheckpointCodec(proc.stages, strict_windows=strict_windows)
        nfa_store, buffers, aggregates = codec.decode_query_stores(data)
        proc.nfa_store = nfa_store
        proc.buffer = buffers
        proc.aggregates = aggregates
        if gate_bytes is not None:
            proc.restore_event_time(decode_event_time_state(gate_bytes))
        return proc
