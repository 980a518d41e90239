"""Micro-batching device processor: the `runtime="cuda"` stream driver.

The port's `DeviceCEPProcessor` (the JAX package's
`streams/device_processor.py`), keeping the reference processor's contract
-- per-key NFA state, high-water-mark idempotence, forward completed
Sequences (reference: core/.../cep/processor/CEPProcessor.java:111-160)
-- with the multi-key batched engine (parallel/batched.py) behind it:
records accumulate per key in a pending buffer, and each flush packs one
[T, K] column batch, advances every key's NFA in one step-kernel launch
and decodes the completed matches.

Key lanes are assigned on first sight and the key axis grows
geometrically through `BatchedDeviceNFA.add_keys` (each growth flushes
the engine's GC group, so doubling keeps those early flushes O(log keys)).

Event time (`EngineConfig.reorder_capacity > 0`): arriving records pass
an `EventTimeGate` (time/gate.py) that buffers them per key and releases
them in event-time order as the watermark advances; each release carries
the gate's monotone clock, which the flush threads into the step as its
"wm" column, so window expiry sweeps off event time. `tick_event_time`
advances idle-source watermarks on wall time, `flush_event_time` releases
everything at end of stream, `take_late` drains the late side output.

Crash consistency: `snapshot()` / `restore()` write and read the JAX
processor's frame (engine blob, high-water marks, pending records and,
with a gate, their release clocks; the lane map rides the engine's keys),
wrapped with the gate's frame when a gate is armed,
and `DeviceStateStore` appends a snapshot to a changelog topic at every
commit and restores the newest one that validates.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Generic, List, Optional, Tuple, TypeVar

from ..core.event import Event
from ..native import NativeBuildError
from ..obs.registry import MetricsRegistry
from ..ops.engine import EngineConfig
from ..ops.schema import EventSchema
from ..ops.tables import CompiledQuery, compile_query
from ..parallel.batched import BatchedDeviceNFA
from ..pattern.compiler import compile_pattern
from ..pattern.pattern import Pattern
from ..state import serde
from ..state.naming import device_state_store, normalize_query_name
from ..time import EventTimeGate

K = TypeVar("K")
V = TypeVar("V")


class DeviceCEPProcessor(Generic[K, V]):
    """Batched device driver bound to one compiled query.

    `process()` enqueues and flushes once `batch_size` records are
    pending; `flush()` forces the pending micro-batch through the engine
    and returns [(key, Sequence)] in per-key emission order.
    `**engine_opts` pass through to `BatchedDeviceNFA` (`device=`,
    `engine=`, `drain_mode=`, `sink_format=`, `compile_telemetry=`, ...).
    With `sink_format="json"` or `"arrow"` every flush yields `(key,
    SinkMatch)` pairs instead.
    """

    #: Flush count after which a persistently tiny key population warns:
    #: the engine's parallelism axis is keys.
    LOW_KEY_WARN_FLUSHES = 10

    def __init__(
        self,
        query_name: str,
        pattern_or_query: Any,
        schema: Optional[EventSchema] = None,
        config: Optional[EngineConfig] = None,
        batch_size: int = 64,
        initial_keys: int = 8,
        registry: Optional[MetricsRegistry] = None,
        watermark_gen: Optional[Any] = None,
        **engine_opts: Any,
    ) -> None:
        if isinstance(pattern_or_query, CompiledQuery):
            self.query = pattern_or_query
        elif isinstance(pattern_or_query, Pattern):
            self.query = compile_query(compile_pattern(pattern_or_query), schema)
        else:
            self.query = compile_query(pattern_or_query, schema)
        self.query_name = normalize_query_name(query_name)
        self.config = config if config is not None else EngineConfig()
        self.batch_size = max(1, batch_size)
        self._capacity = max(1, initial_keys)
        #: The engine knobs (device=, engine=, sink_format=, ...), kept so
        #: that a restore rebuilds the same engine. Provenance exemplars
        #: name their query, so the query name rides into the engine.
        engine_opts.setdefault("query_name", self.query_name)
        self._engine_opts = dict(engine_opts)
        # One registry for the processor and its engine.
        self.engine = BatchedDeviceNFA(
            self.query,
            keys=[_Lane(i) for i in range(self._capacity)],
            config=self.config,
            registry=registry,
            **engine_opts,
        )
        self.metrics = self.engine.metrics
        self._m_flushes = self.metrics.counter(
            "cep_device_processor_flushes_total",
            "Micro-batch flushes through the device engine",
            labels=("query",),
        ).labels(query=self.query_name)
        self._m_matches = self.metrics.counter(
            "cep_device_processor_matches_total",
            "Sequences emitted by the device driver",
            labels=("query",),
        ).labels(query=self.query_name)
        #: The event-time gate (module doc), armed by reorder_capacity > 0.
        self.gate: Optional[EventTimeGate] = None
        if self.config.reorder_capacity > 0:
            self.gate = EventTimeGate(
                capacity=self.config.reorder_capacity,
                lateness_ms=self.config.lateness_ms,
                late_policy=self.config.late_policy,
                on_overflow=self.config.on_overflow,
                generator=watermark_gen,
                registry=self.metrics,
                query_name=self.query_name,
            )
        self._lane_of_key: Dict[Any, _Lane] = {}
        self._next_lane = 0
        self._pending: Dict[Any, List[Event]] = {}
        #: Release clocks parallel to `_pending` (gate armed only):
        #: _pending_wm[k][i] is the clock _pending[k][i] was released at.
        self._pending_wm: Dict[Any, List[Optional[int]]] = {}
        self._pending_count = 0
        self._flushes = 0
        self._warned_low_keys = False
        # Per-(key, topic#partition) high-water mark
        # (CEPProcessor.java:152-160).
        self._hwm: Dict[Tuple[Any, str], int] = {}
        #: Records quarantined by the flush-time isolation pass (poison
        #: that only surfaces when the batch is packed); handed out by
        #: `take_poisoned()`.
        self._poisoned: List[Tuple[Any, Event, Exception]] = []

    # ------------------------------------------------------------------ API
    def process(
        self,
        key: K,
        value: V,
        timestamp: int = 0,
        topic: str = "",
        partition: int = 0,
        offset: int = 0,
    ) -> List[Tuple[K, Any]]:
        """Enqueue one record; returns flushed matches when the batch fills."""
        if key is None or value is None:
            return []
        hwm_key = (key, f"{topic}#{partition}")
        latest = self._hwm.get(hwm_key)
        if latest is not None and offset < latest:
            return []  # replayed record below the high-water mark
        event = Event(key, value, timestamp, topic, partition, offset)
        if self.gate is not None:
            # What the watermark releases (possibly other keys' records,
            # possibly nothing) enqueues with its release clock. The mark
            # advances only after admission: a CEPOverflowError from
            # on_overflow="raise" leaves it, so the caller's retry of the
            # rejected record is not deduped as a replay.
            released = self.gate.offer(event)
            self._hwm[hwm_key] = offset + 1
            self._enqueue_released(released)
        else:
            self._hwm[hwm_key] = offset + 1
            self._pending.setdefault(key, []).append(event)
            self._pending_count += 1
        if self._pending_count >= self.batch_size:
            return self.flush()
        return []

    def _enqueue_released(self, released: List[Tuple[Event, int]]) -> None:
        for ev, clk in released:
            self._pending.setdefault(ev.key, []).append(ev)
            self._pending_wm.setdefault(ev.key, []).append(clk)
            self._pending_count += 1

    def tick_event_time(self, now_ms: int) -> List[Tuple[K, Any]]:
        """Wall-clock tick for idle-source watermarks (the driver's poll
        cadence): enqueue what the advanced watermark released, flush if
        the batch filled. No-op without a gate."""
        if self.gate is None:
            return []
        self._enqueue_released(self.gate.advance_wall(now_ms))
        if self._pending_count >= self.batch_size:
            return self.flush()
        return []

    def flush_event_time(self) -> List[Tuple[K, Any]]:
        """End of stream: release every buffered record in event-time
        order and flush."""
        if self.gate is not None:
            self._enqueue_released(self.gate.flush())
        return self.flush()

    def take_late(self) -> List[Event]:
        """Drain the gate's late side output (late_policy="sideoutput")."""
        return self.gate.take_late() if self.gate is not None else []

    def flush(self) -> List[Tuple[K, Any]]:
        """Drive the pending micro-batch through the device engine."""
        if not self._pending:
            return []
        self._flushes += 1
        if (
            not self._warned_low_keys
            and self._flushes >= self.LOW_KEY_WARN_FLUSHES
            and self._next_lane <= 2
        ):
            self._warned_low_keys = True
            warnings.warn(
                f"DeviceCEPProcessor has seen only {self._next_lane} distinct "
                "key(s): the device engine parallelizes across keys, so each "
                "flush of so few keys leaves nearly all of the card idle",
                RuntimeWarning,
            )
        batch: Dict[_Lane, List[Event]] = {}
        wms: Optional[Dict[_Lane, List[Optional[int]]]] = (
            {} if self.gate is not None else None)
        for key, events in self._pending.items():
            lane = self._lane_for(key)
            batch[lane] = events
            if wms is not None:
                clocks = self._pending_wm.get(key, [])
                # Pending records restored from a snapshot without event
                # time carry no clocks: pad at the front (they precede
                # every later release) with None, arrival-order expiry.
                wms[lane] = [None] * (len(events) - len(clocks)) + list(clocks)
        self._pending = {}
        self._pending_wm = {}
        self._pending_count = 0
        # Only the host pack is guarded: a record the schema cannot pack
        # raises there, before the engine changes. A failed native build
        # and any error of the upload, the step or the drain propagate.
        try:
            cols = self.engine.pack_host(batch, wms)
        except NativeBuildError:
            raise
        except Exception:
            # The batched pack is all-or-nothing, so isolate record by
            # record: the healthy remainder advances, the poison lands in
            # `self._poisoned`.
            advanced = self._advance_isolating(batch, wms)
        else:
            advanced = self.engine.advance_packed(self.engine.upload(cols))
        out: List[Tuple[K, Any]] = []
        for lane, seqs in advanced.items():
            out.extend((lane.key, s) for s in seqs)
        self._m_flushes.inc()
        if out:
            self._m_matches.inc(len(out))
        return out

    def take_poisoned(self) -> List[Tuple[Any, Event, Exception]]:
        """Hand quarantined records to the caller (clears the buffer)."""
        out, self._poisoned = self._poisoned, []
        return out

    def provenance_exemplars(self, limit: int = 64) -> List[Dict[str, Any]]:
        """Recent sampled match-lineage exemplars of the engine, newest
        first, under the record keys (empty unless provenance_sample > 0)."""
        return self.engine.provenance_exemplars(limit)

    def runs(self, key: K) -> int:
        return self.engine.runs(self._lane_for(key))

    @property
    def stats(self) -> Dict[str, int]:
        return self.engine.stats

    # --------------------------------------------------------- checkpointing
    def snapshot(self) -> bytes:
        """Bytes-level checkpoint, the JAX processor's frame: the engine
        snapshot (whose keys are the lane handles, so the lane map rides
        it), the high-water marks, the pending records and, with a gate,
        their release clocks; the gate's buffers and watermark state ride
        a wrapper frame, so a restore gets gate and engine of one commit."""
        w = serde._Writer()
        w._buf.write(serde.MAGIC)
        w.blob(self.engine.snapshot())
        w.blob(serde.dumps(self._hwm))
        w.i32(len(self._pending))
        for key, events in self._pending.items():
            w.blob(serde.dumps(key))
            w.blob(serde.encode_event_registry(dict(enumerate(events))))
        if self.gate is not None:
            w.blob(serde.dumps(self._pending_wm))
        inner = serde.seal_frame(w.getvalue())
        if self.gate is None:
            return inner
        return serde.wrap_event_time(
            inner, serde.encode_event_time_state(self.gate.snapshot_state()))

    @classmethod
    def restore(
        cls,
        query_name: str,
        pattern_or_query: Any,
        data: bytes,
        schema: Optional[EventSchema] = None,
        config: Optional[EngineConfig] = None,
        batch_size: int = 64,
        initial_keys: int = 8,
        registry: Optional[MetricsRegistry] = None,
        watermark_gen: Optional[Any] = None,
        **engine_opts: Any,
    ) -> "DeviceCEPProcessor":
        """A processor from a `snapshot()` of either package's processor
        (lane handles pickled by the JAX package load as this module's
        `_Lane`). A snapshot with gate state needs a config that arms the
        gate (ValueError otherwise); one without restores a fresh gate."""
        proc = cls(
            query_name, pattern_or_query, schema=schema, config=config,
            batch_size=batch_size, initial_keys=initial_keys,
            registry=registry, watermark_gen=watermark_gen, **engine_opts,
        )
        data, gate_bytes = serde.split_event_time(data)
        if gate_bytes is not None and proc.gate is None:
            raise ValueError(
                "checkpoint carries event-time gate state but the restored "
                "processor has no gate (EngineConfig.reorder_capacity == 0); "
                "restore with the original event-time config"
            )
        r = serde._Reader(serde.open_frame(data))
        serde.read_magic(r)
        proc.engine = BatchedDeviceNFA.restore(
            proc.query, r.blob(), config=proc.config, registry=proc.metrics,
            **proc._engine_opts,
        )
        proc._capacity = len(proc.engine.keys)
        proc._lane_of_key = {
            lane.key: lane for lane in proc.engine.keys if lane.key is not None
        }
        proc._next_lane = len(proc._lane_of_key)
        proc._hwm = serde.loads(r.blob())
        proc._pending = {}
        proc._pending_wm = {}
        proc._pending_count = 0
        for _ in range(r.i32()):
            key = serde.loads(r.blob())
            events = serde.decode_event_registry(r.blob())
            proc._pending[key] = [events[i] for i in sorted(events)]
            proc._pending_count += len(events)
        if gate_bytes is not None:
            proc._pending_wm = serde.loads(r.blob())
        r.expect_end()
        if gate_bytes is not None:
            proc.gate.restore_state(serde.decode_event_time_state(gate_bytes))
        return proc

    # ------------------------------------------------------------ internals
    def _advance_isolating(
        self,
        batch: Dict["_Lane", List[Event]],
        wms: Optional[Dict["_Lane", List[Optional[int]]]] = None,
    ) -> Dict["_Lane", List[Any]]:
        """Record-at-a-time pass after a batch pack raised: each record
        advances alone (per-lane order preserved, with its release clock);
        records whose pack still raises are quarantined instead of
        wedging the pump."""
        out: Dict[_Lane, List[Any]] = {}
        for lane, events in batch.items():
            for i, ev in enumerate(events):
                one_wm = {lane: [wms[lane][i]]} if wms is not None else None
                try:
                    cols = self.engine.pack_host({lane: [ev]}, one_wm)
                except NativeBuildError:
                    raise
                except Exception as exc:
                    self._poisoned.append((lane.key, ev, exc))
                    continue
                res = self.engine.advance_packed(self.engine.upload(cols))
                for l, seqs in res.items():
                    if seqs:
                        out.setdefault(l, []).extend(seqs)
        return out

    def _lane_for(self, key: Any) -> "_Lane":
        lane = self._lane_of_key.get(key)
        if lane is not None:
            return lane
        if self._next_lane >= self._capacity:
            grow = self._capacity  # double
            self.engine.add_keys([_Lane(self._capacity + i) for i in range(grow)])
            self._capacity += grow
        lane = self.engine.keys[self._next_lane]
        lane.key = key
        self._next_lane += 1
        self._lane_of_key[key] = lane
        return lane


class DeviceStateStore:
    """Changelog checkpointing for the device runtime (crash consistency).

    The device runtime's state is one engine-wide blob, so this store
    appends the whole `DeviceCEPProcessor.snapshot()` (CRC-sealed) to a
    changelog topic at every `flush()` -- the commit cadence -- and
    `restore_from_changelog()` restores the newest snapshot that
    validates: torn tails are truncated by the log reload, and corrupt
    payloads fail the CRC and fall back to the generation before, counted
    in `cep_checkpoint_corrupt_total`."""

    def __init__(self, node: Any, log: Any, topic: str,
                 registry: Optional[MetricsRegistry] = None) -> None:
        from ..obs.registry import default_registry

        self.name = device_state_store(node.name)
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
        self.log.append(self.topic, None, self.node.processor.snapshot())

    def restore_from_changelog(self) -> int:
        """Rebuild the node's processor from the newest valid snapshot.

        Returns the changelog record count read. Walks back past records
        that fail CRC or framing validation (last-good fallback, with a
        RuntimeWarning: the records between that commit and the committed
        input offsets will not be reprocessed). When snapshots exist but
        none validates, the fresh processor stays in place and
        `CheckpointError` is raised rather than resume empty."""
        if self.log is None:
            return 0
        recs = self.log.read(self.topic)
        rejected = 0
        for rec in reversed(recs):
            if rec.value is None:
                continue
            try:
                self.node.processor = DeviceCEPProcessor.restore(
                    self.node.name,
                    self.node.pattern,
                    rec.value,
                    schema=(
                        self.node.queried.schema
                        if self.node.queried is not None
                        else None
                    ),
                    registry=self.node.registry,
                    **self.node.device_opts,
                )
            except serde.CheckpointError:
                rejected += 1
                self._m_corrupt.inc()
                continue
            if rejected:
                warnings.warn(
                    f"{self.name}: fell back past {rejected} corrupt "
                    "device-state snapshot(s); restored state may predate "
                    "the committed consumer offsets and the gap's records "
                    "will not be reprocessed",
                    RuntimeWarning,
                )
            return len(recs)
        if rejected:
            raise serde.CheckpointError(
                f"{self.name}: all {rejected} device-state snapshot(s) "
                "failed CRC/framing validation; refusing to resume from "
                "committed offsets with empty engine state"
            )
        return len(recs)


class _Lane:
    """A stable lane handle; `key` binds on first assignment. Hashes by
    identity, so binding the key does not move it in the engine's index."""

    __slots__ = ("index", "key")

    def __init__(self, index: int) -> None:
        self.index = index
        self.key: Any = None

    def __repr__(self) -> str:
        return f"Lane({self.index}:{self.key!r})"
