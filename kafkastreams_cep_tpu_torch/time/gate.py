"""EventTimeGate: the reorder/watermark/late-policy stage the stream
processors drive.

Sits between ingestion and the pack step (host and device runtimes
alike). Per record key it owns a bounded `ReorderBuffer`; one watermark
generator covers the whole gate (per-source structure lives inside
`MinMergeWatermark`). `offer()` takes one arriving record and returns the
records the watermark just released, each paired with the gate's
event-time CLOCK at its release:

    clock_i = max(clock_{i-1}, released_ts_i)

The released stream is sorted by event time (stable on arrival order for
ties), so on the normal path the clock equals each record's own timestamp
-- feeding the engine `watermarks=[clock_i]` makes window expiry sweep
off event time and the output equals the host oracle fed the pre-sorted
stream. The clock diverges from the raw timestamp exactly where it must:
a `recompute-none` late admission carries the (higher) current clock so
the engine's expiry clock never rewinds, and a forced release under
`on_overflow="block"` advances the clock past the stragglers it outran.

Late records (ts below the watermark at arrival) follow
`EngineConfig.late_policy`:

    drop            discarded, counted in cep_late_dropped_total{query}
    sideoutput      diverted to `take_late()` (never the engine), counted
                    in cep_late_sideoutput_total{query}
    recompute-none  admitted downstream as-is -- no retraction or window
                    recompute -- counted in cep_late_admitted_total{query}

Buffer overflow honors `EngineConfig.on_overflow` exactly like the
engine's pools: "drop" loses the incoming record loudly
(cep_reorder_overflow_dropped_total), "raise" raises CEPOverflowError
(nothing lost; the caller backs off), "block" force-releases the key's
oldest buffered record (backpressure, nothing lost; records older than
the forced release become late). The `time.reorder_overflow` fault point
(faults/injection.py) forces this path deterministically for chaos tests.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.event import Event
from ..faults import injection as _flt
from ..faults.injection import CEPOverflowError, TransientFault
from .reorder import ReorderBuffer
from .watermarks import BoundedOutOfOrderness, WatermarkGenerator, WM_MIN_MS

class EventTimeGate:
    """Per-key reorder buffers + one watermark generator + late policy."""

    def __init__(
        self,
        capacity: int,
        lateness_ms: int = 0,
        late_policy: str = "drop",
        on_overflow: str = "drop",
        generator: Optional[WatermarkGenerator] = None,
        registry: Optional[Any] = None,
        query_name: str = "q",
    ) -> None:
        from ..obs.registry import default_registry

        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if late_policy not in ("drop", "sideoutput", "recompute-none"):
            raise ValueError(f"unknown late_policy {late_policy!r}")
        if on_overflow not in ("drop", "raise", "block"):
            raise ValueError(f"unknown on_overflow {on_overflow!r}")
        self.capacity = int(capacity)
        self.late_policy = late_policy
        self.on_overflow = on_overflow
        self.query_name = query_name
        self.generator: WatermarkGenerator = (
            generator
            if generator is not None
            else BoundedOutOfOrderness(max(int(lateness_ms), 0))
        )
        self._buffers: Dict[Any, ReorderBuffer] = {}
        self._seq = 0          # global arrival sequence (release tiebreak)
        #: Per-KEY monotone release clocks: expiry is per-key NFA state,
        #: so the clock attached to a release must never be dragged
        #: forward by OTHER keys' (faster) streams -- only by this key's
        #: own releases and late-admission clamps.
        self._clocks: Dict[Any, int] = {}
        self._forced_wm = WM_MIN_MS  # overflow-"block" forced floor
        self._max_seen = WM_MIN_MS   # max observed event time (lag gauge)
        self._occupancy = 0
        self._late: List[Event] = []  # side output (late_policy=sideoutput)
        #: forced releases staged by the overflow "block" path, merged
        #: ahead of the next release batch (they are the oldest records).
        self._pending_forced: List[Tuple[Event, int]] = []
        #: Lower bound on the min buffered head timestamp (None = unknown
        #: or empty): lets the common no-release offer skip the O(keys)
        #: buffer scan entirely. Invariant: never ABOVE the true min (a
        #: stale-LOW value only costs one redundant scan; forced
        #: evictions that raise a head leave it stale-low on purpose).
        self._min_head: Optional[int] = None

        self.metrics = registry if registry is not None else default_registry()
        q = {"query": query_name}
        self._m_late_dropped = self.metrics.counter(
            "cep_late_dropped_total",
            "Late records discarded by the event-time gate "
            "(ts below the watermark at arrival, late_policy=drop)",
            labels=("query",),
        ).labels(**q)
        self._m_late_side = self.metrics.counter(
            "cep_late_sideoutput_total",
            "Late records diverted to the gate's side output "
            "(late_policy=sideoutput; drained by take_late())",
            labels=("query",),
        ).labels(**q)
        self._m_late_admitted = self.metrics.counter(
            "cep_late_admitted_total",
            "Late records admitted downstream as-is "
            "(late_policy=recompute-none; no retraction/recompute)",
            labels=("query",),
        ).labels(**q)
        self._m_released = self.metrics.counter(
            "cep_reorder_released_total",
            "Records released by the reorder stage in event-time order",
            labels=("query",),
        ).labels(**q)
        self._m_overflow_dropped = self.metrics.counter(
            "cep_reorder_overflow_dropped_total",
            "Records lost to reorder-buffer overflow "
            "(on_overflow=drop; loud by contract)",
            labels=("query",),
        ).labels(**q)
        self._m_backpressure = self.metrics.counter(
            "cep_reorder_backpressure_total",
            "Forced early releases under on_overflow=block "
            "(nothing lost; stragglers behind the forced watermark go late)",
            labels=("query",),
        ).labels(**q)
        self._m_occupancy = self.metrics.gauge(
            "cep_reorder_occupancy",
            "Records currently buffered across all keys' reorder buffers",
            labels=("query",),
        ).labels(**q)
        self._m_lag = self.metrics.gauge(
            "cep_watermark_lag_seconds",
            "Event-time lag of the watermark behind the max observed "
            "event time (how much reordering slack is currently open)",
            labels=("query",),
        ).labels(**q)

    # ------------------------------------------------------------------ API
    @property
    def watermark_ms(self) -> int:
        """The effective low watermark: generator merged with the gate's
        monotone floor (`_forced_wm` -- overflow-backpressure releases
        raise it, and every read LATCHES it). The latch matters when a
        generator's own mark can regress: an idle-jumped source resuming,
        or a new min-merge source appearing, must not pull the watermark
        back below records already released -- a regressed mark would
        admit truly-late records and break the sorted-release invariant
        the expiry clocks and the differential contract are built on."""
        wm = max(self.generator.current_ms(), self._forced_wm)
        if wm > self._forced_wm:
            self._forced_wm = wm
        return wm

    @property
    def clock_ms(self) -> int:
        """The max per-key release clock (informational)."""
        return max(self._clocks.values(), default=WM_MIN_MS)

    @property
    def occupancy(self) -> int:
        return self._occupancy

    @property
    def watermark_lag_ms(self) -> Optional[int]:
        """Event-time lag of the watermark behind the max observed event
        time (None before the first record)."""
        wm = self.watermark_ms
        if self._max_seen <= WM_MIN_MS or wm <= WM_MIN_MS:
            return None
        return max(0, self._max_seen - wm)

    def offer(
        self, event: Event, source: Any = None
    ) -> List[Tuple[Event, int]]:
        """Admit one arriving record; return [(event, clock_ms)] releases.

        `source` keys per-source watermark tracking (MinMergeWatermark);
        defaults to the record's (topic, partition)."""
        if source is None:
            source = (event.topic, event.partition)
        ts = int(event.timestamp)
        wm = self.watermark_ms
        if wm > WM_MIN_MS and ts < wm:
            return self._late_record(event)
        buf = self._buffers.get(event.key)
        if buf is None:
            buf = self._buffers[event.key] = ReorderBuffer(self.capacity)
        # `time.reorder_overflow` fault point: armed chaos schedules raise
        # TransientFault here, which this site interprets as "the buffer
        # is full NOW" -- the overflow path below runs under the real
        # policy, so tests prove its semantics without filling a buffer.
        forced_overflow = False
        if _flt.ACTIVE is not None:
            try:
                _flt.ACTIVE.fire("time.reorder_overflow")
            except TransientFault:
                forced_overflow = True
        # Overflow resolves BEFORE any watermark mutation (mirrors
        # offer_batch's chunk-atomic contract): a CEPOverflowError
        # rejection must leave the gate untouched -- a never-admitted
        # record advancing the watermark would misclassify the in-bound
        # records behind it as late.
        if buf.full or forced_overflow:
            if not self._overflow(buf, event):
                # drop: the record is intentionally consumed, so its
                # observation still advances event time -- release what
                # it passed rather than holding now-releasable records
                # for a later arrival.
                self._observe_event_time(ts, source)
                out = self._release_upto(self.watermark_ms)
                self._observe_gauges()
                return out
            wm = self.watermark_ms
            if wm > WM_MIN_MS and ts < wm:
                # block's forced release raised the floor past the
                # ARRIVING record (it was older than the key's whole
                # buffer): admitting it now would release behind the
                # forced-out record out of event-time order -- it is
                # late, by the documented "stragglers behind the forced
                # mark go late" contract.
                out = self._release_upto(wm)  # ship the forced release
                out.extend(self._late_record(event))
                self._observe_gauges()
                return out
        self._observe_event_time(ts, source)
        buf.push(event, self._seq)
        if self._min_head is None or ts < self._min_head:
            self._min_head = ts
        self._seq += 1
        self._occupancy += 1
        out = self._release_upto(self.watermark_ms)
        self._observe_gauges()
        return out

    def _observe_event_time(self, ts: int, source: Any) -> None:
        self.generator.observe(ts, source)
        if ts > self._max_seen:
            self._max_seen = ts

    def offer_batch(
        self, events: List[Event], source: Any = None
    ) -> List[Tuple[Event, int]]:
        """Amortized admission for one ingest chunk (the driver/bench fast
        path): one watermark read and one generator observation per
        (chunk, source) instead of per record.

        Semantics vs. per-record `offer()`: lateness is checked against
        the watermark at CHUNK START (a record made late only by a
        later record in the same chunk still admits -- strictly more
        permissive, never lossier), and the shipped generators all track
        a per-source max, so observing the chunk max is equivalent to
        observing every record. Overflow still runs the per-record policy
        path inline; with a fault injector armed the whole chunk falls
        back to per-record offer() (the `time.reorder_overflow` hit
        counts are per-admission by contract)."""
        if not events:
            return []
        if _flt.ACTIVE is not None:
            out: List[Tuple[Event, int]] = []
            for e in events:
                out.extend(self.offer(e, source=source))
            return out
        wm0 = self.watermark_ms
        admit: List[Event] = []
        max_ts = WM_MIN_MS
        late: List[Event] = []
        for e in events:
            ts = e.timestamp
            if wm0 > WM_MIN_MS and ts < wm0:
                late.append(e)
                continue
            admit.append(e)
            if ts > max_ts:
                max_ts = ts
        if self.on_overflow == "raise" and admit:
            # Chunk-ATOMIC admission under "raise": check capacity before
            # ANY mutation (late-record side effects included), so the
            # escalation leaves the gate untouched and the caller can
            # retry the whole chunk without duplicating releases or
            # losing already-staged late admissions. Conservative: a
            # release mid-chunk could have freed space; the retry after a
            # drain will see it.
            per_key: Dict[Any, int] = {}
            for e in admit:
                per_key[e.key] = per_key.get(e.key, 0) + 1
            for k, n in per_key.items():
                have = len(self._buffers[k]) if k in self._buffers else 0
                if have + n > self.capacity:
                    raise CEPOverflowError(
                        f"reorder buffer would overflow for key {k!r} "
                        f"({have} buffered + {n} arriving > capacity "
                        f"{self.capacity}; policy 'raise' -- raise "
                        "EngineConfig.reorder_capacity or drain faster)"
                    )
        out: List[Tuple[Event, int]] = []
        for e in late:
            out.extend(self._late_record(e))
        if admit:
            # One observation per (chunk, SOURCE) -- attributing a mixed-
            # source chunk's max to a single source would advance a
            # min-merge watermark past the slow sources and wrongly drop
            # their in-bound records as late.
            per_src: Dict[Any, int] = {}
            for e in admit:
                src = source if source is not None else (
                    e.topic, e.partition
                )
                prev = per_src.get(src)
                if prev is None or e.timestamp > prev:
                    per_src[src] = int(e.timestamp)
            for src, m in per_src.items():
                self.generator.observe(m, src)
            if max_ts > self._max_seen:
                self._max_seen = int(max_ts)
            for e in admit:
                buf = self._buffers.get(e.key)
                if buf is None:
                    buf = self._buffers[e.key] = ReorderBuffer(self.capacity)
                if buf.full:
                    if not self._overflow(buf, e):
                        continue
                    wm2 = self.watermark_ms
                    if wm2 > WM_MIN_MS and e.timestamp < wm2:
                        # block's forced release raised the floor past
                        # this record: it is late NOW (see offer()).
                        out.extend(self._late_record(e))
                        continue
                buf.push(e, self._seq)
                if self._min_head is None or e.timestamp < self._min_head:
                    self._min_head = int(e.timestamp)
                self._seq += 1
                self._occupancy += 1
        out.extend(self._release_upto(self.watermark_ms))
        self._observe_gauges()
        return out

    def advance_wall(self, now_ms: int) -> List[Tuple[Event, int]]:
        """Wall-clock tick (driver poll cadence): idle-timeout generators
        may advance the watermark with no record arriving; release what
        it passed."""
        self.generator.advance_wall(int(now_ms))
        out = self._release_upto(self.watermark_ms)
        self._observe_gauges()
        return out

    def flush(self) -> List[Tuple[Event, int]]:
        """End-of-stream: release every buffered record in event-time
        order (the watermark is moot -- nothing else is coming)."""
        out: List[Tuple[Event, int]] = []
        if self._pending_forced:
            out.extend(self._pending_forced)
            self._pending_forced.clear()
        entries = []
        for key, buf in self._buffers.items():
            entries.extend(buf.drain())
        entries.sort(key=lambda se: (se[1].timestamp, se[0]))
        self._occupancy = 0
        self._min_head = None
        out.extend(self._emit(ev) for _seq, ev in entries)
        self._observe_gauges()
        return out

    def take_late(self) -> List[Event]:
        """Drain the late side output (late_policy=sideoutput)."""
        out, self._late = self._late, []
        return out

    # --------------------------------------------------------- checkpointing
    def snapshot_state(self) -> Dict[str, Any]:
        """Plain-dict state for state/serde.encode_event_time_state."""
        return {
            "gen_kind": self.generator.kind,
            "gen_state": self.generator.state(),
            "clocks": dict(self._clocks),
            "forced_wm": self._forced_wm,
            "max_seen": self._max_seen,
            "seq": self._seq,
            "buffers": {
                key: buf.entries() for key, buf in self._buffers.items()
            },
            "late": list(self._late),
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Inverse of snapshot_state (generator kind must match the
        configured generator -- the pattern/config is never serialized,
        mirroring the engine checkpoint contract)."""
        kind = state["gen_kind"]
        if kind != self.generator.kind:
            raise ValueError(
                f"checkpoint watermark generator {kind!r} != configured "
                f"{self.generator.kind!r}; rebuild the gate with the "
                "matching generator before restoring"
            )
        self.generator.restore(state["gen_state"])
        self._clocks = dict(state["clocks"])
        self._forced_wm = int(state["forced_wm"])
        self._max_seen = int(state["max_seen"])
        self._seq = int(state["seq"])
        self._buffers = {}
        self._occupancy = 0
        self._min_head = None
        for key, entries in state["buffers"].items():
            buf = self._buffers[key] = ReorderBuffer(self.capacity)
            for ts, seq, ev in entries:
                buf.push(ev, seq)
                if self._min_head is None or ts < self._min_head:
                    self._min_head = int(ts)
                self._occupancy += 1
        self._late = list(state["late"])
        self._observe_gauges()

    # ------------------------------------------------------------ internals
    def _late_record(self, event: Event) -> List[Tuple[Event, int]]:
        if self.late_policy == "drop":
            self._m_late_dropped.inc()
            return []
        if self.late_policy == "sideoutput":
            self._m_late_side.inc()
            self._late.append(event)
            return []
        # recompute-none: admit as-is at the key's CURRENT clock (clamped
        # to the watermark) so the engine's expiry clock never rewinds --
        # no retraction of already-expired windows.
        self._m_late_admitted.inc()
        self._m_released.inc()
        clk = max(
            self._clocks.get(event.key, WM_MIN_MS), self.watermark_ms
        )
        self._clocks[event.key] = clk
        return [(event, clk)]

    def _overflow(self, buf: ReorderBuffer, event: Event) -> bool:
        """Apply the overflow policy; True = admit the incoming record."""
        if self.on_overflow == "raise":
            raise CEPOverflowError(
                f"reorder buffer full for key {event.key!r} "
                f"(capacity {self.capacity}; policy 'raise' -- raise "
                "EngineConfig.reorder_capacity or drain faster)"
            )
        if self.on_overflow == "block":
            # Backpressure: force the key's oldest record out NOW. The
            # forced watermark floor makes any later record older than it
            # late -- loud, ordered, nothing lost.
            if len(buf):
                ts, _seq, oldest = buf.pop_oldest()
                self._occupancy -= 1
                self._m_backpressure.inc()
                self._forced_wm = max(self._forced_wm, ts)
                self._pending_forced.append(self._emit(oldest))
            return True
        # drop: the incoming record is lost, loudly.
        self._m_overflow_dropped.inc()
        return False

    def _release_upto(self, watermark_ms: int) -> List[Tuple[Event, int]]:
        out: List[Tuple[Event, int]] = []
        if self._pending_forced:
            out.extend(self._pending_forced)
            self._pending_forced.clear()
        if watermark_ms == WM_MIN_MS or self._occupancy == 0:
            return out
        if self._min_head is not None and watermark_ms < self._min_head:
            # Nothing buffered is at or below the watermark: the shared-
            # gate hot path stays O(1) per record instead of scanning
            # every key's buffer per offer.
            return out
        entries: List[Tuple[int, Event]] = []
        for buf in self._buffers.values():
            got = buf.release(watermark_ms)
            entries.extend(got)
        heads = [
            h for h in (b.peek_ts() for b in self._buffers.values())
            if h is not None
        ]
        self._min_head = min(heads) if heads else None
        if entries:
            self._occupancy -= len(entries)
            entries.sort(key=lambda se: (se[1].timestamp, se[0]))
            out.extend(self._emit(ev) for _seq, ev in entries)
        return out

    def _emit(self, event: Event) -> Tuple[Event, int]:
        ts = int(event.timestamp)
        clk = max(self._clocks.get(event.key, WM_MIN_MS), ts)
        self._clocks[event.key] = clk
        self._m_released.inc()
        return (event, clk)

    def _observe_gauges(self) -> None:
        self._m_occupancy.set(self._occupancy)
        if self._max_seen > WM_MIN_MS:
            wm = self.watermark_ms
            lag = (self._max_seen - wm) / 1000.0 if wm > WM_MIN_MS else 0.0
            self._m_lag.set(max(lag, 0.0))
