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

Left out (ROADMAP.md): snapshot/restore and the device state store, and
the event-time reorder gate.
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
from ..state.naming import normalize_query_name

K = TypeVar("K")
V = TypeVar("V")


class DeviceCEPProcessor(Generic[K, V]):
    """Batched device driver bound to one compiled query.

    `process()` enqueues and flushes once `batch_size` records are
    pending; `flush()` forces the pending micro-batch through the engine
    and returns [(key, Sequence)] in per-key emission order. With
    `sink_format="json"` (one of `**engine_opts`, which pass through to
    `BatchedDeviceNFA`, as do `device=` and `engine=`) every flush yields
    `(key, SinkMatch)` pairs instead.
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
        self.engine = BatchedDeviceNFA(
            self.query,
            keys=[_Lane(i) for i in range(self._capacity)],
            config=self.config,
            **engine_opts,
        )
        self.metrics = registry if registry is not None else MetricsRegistry()
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
        self._lane_of_key: Dict[Any, _Lane] = {}
        self._next_lane = 0
        self._pending: Dict[Any, List[Event]] = {}
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
        self._hwm[hwm_key] = offset + 1
        self._pending.setdefault(key, []).append(
            Event(key, value, timestamp, topic, partition, offset))
        self._pending_count += 1
        if self._pending_count >= self.batch_size:
            return self.flush()
        return []

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
        batch = {self._lane_for(key): events for key, events in self._pending.items()}
        self._pending = {}
        self._pending_count = 0
        # Only the host pack is guarded: a record the schema cannot pack
        # raises there, before the engine changes. A failed native build
        # and any error of the upload, the step or the drain propagate.
        try:
            cols = self.engine.pack_host(batch)
        except NativeBuildError:
            raise
        except Exception:
            # The batched pack is all-or-nothing, so isolate record by
            # record: the healthy remainder advances, the poison lands in
            # `self._poisoned`.
            advanced = self._advance_isolating(batch)
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

    def runs(self, key: K) -> int:
        return self.engine.runs(self._lane_for(key))

    @property
    def stats(self) -> Dict[str, int]:
        return self.engine.stats

    # ------------------------------------------------------------ internals
    def _advance_isolating(self, batch: Dict["_Lane", List[Event]]) -> Dict["_Lane", List[Any]]:
        """Record-at-a-time pass after a batch pack raised: each record
        advances alone (per-lane order preserved); records whose pack
        still raises are quarantined instead of wedging the pump."""
        out: Dict[_Lane, List[Any]] = {}
        for lane, events in batch.items():
            for ev in events:
                try:
                    cols = self.engine.pack_host({lane: [ev]})
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


class _Lane:
    """A stable lane handle; `key` binds on first assignment. Hashes by
    identity, so binding the key does not move it in the engine's index."""

    __slots__ = ("index", "key")

    def __init__(self, index: int) -> None:
        self.index = index
        self.key: Any = None

    def __repr__(self) -> str:
        return f"Lane({self.index}:{self.key!r})"
