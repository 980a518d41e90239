"""Automatic runtime routing: host first, the card on growth.

A copy of the JAX package's `streams/auto_router.py`, promoting to the
port's `DeviceCEPProcessor` (the step kernel on the card); the runtime
names are the port's, "host" and "cuda" (the JAX router says "tpu").

The reference engine is per-key sequential and fast at K=1
(CEPProcessor.java:111-124): a stream with a handful of keys pays device
batch overhead for nothing, while a high-cardinality stream starves on
the host loop. `runtime="auto"` removes that decision from the caller:

- the query STARTS on the host `CEPProcessor` (the reference-parity
  runtime, including its event-time gate when armed);
- every raw arrival is also appended to a bounded promotion ledger;
- when the observed distinct-key count reaches `promote_after`
  (default 64 -- the same scale DeviceCEPProcessor's low-key warning
  flags from the other side), the router builds a `DeviceCEPProcessor`
  and REPLAYS the ledger through it, then routes everything after to
  the device.

Replay is the promotion-correctness trick: the device rebuilds its
state from the full event history, so it emits every match the history
completes -- including those the host already emitted. The router
absorbs that overlap itself: every host-phase output is recorded as an
occurrence-qualified sequence identity (the same
`streams/emission.py` framing the EmissionGate hashes), and the replay
renumbers deterministically against a fresh counter -- exactly the
renumbering argument crash recovery relies on -- so regenerated
matches drop and only genuinely new ones surface. The sink therefore
sees each match exactly once with the same digests an all-device run
assigns (the acceptance pin), and in-memory consumers never see the
replay at all.

If the ledger would exceed `buffer_max` before the key threshold is
reached, promotion is disabled and the query stays on the host runtime
for its lifetime (high per-key volume means the host loop is handling
it; an unbounded ledger would be a leak). Durability: the host trio's
changelogs cover the host phase; after promotion the engine state is
rebuilt by re-reading the source topics on restore (the ledger is not
checkpointed), so long-lived durable deployments that want device-side
snapshots should pin `runtime="cuda"` explicitly.

The replay renumbers the device's matches from zero in engine order,
which is the order an all-device run of the same records emits them in:
the device processor flushes per key in lane order, and the ledger
replays arrivals in their original order through the same micro-batch
size.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = ["AutoRoutingProcessor"]


class AutoRoutingProcessor:
    """Routes one query between the host and device runtimes.

    Presents the keyed-processor surface `Topology` drives
    (`process_keyed`, `flush`, `tick_event_time`, `flush_event_time`)
    and delegates everything else to whichever runtime is live.
    """

    #: Distinct-key threshold at which the device runtime wins.
    PROMOTE_AFTER = 64
    #: Promotion-ledger bound: past this, stay on the host for good.
    BUFFER_MAX = 65536

    def __init__(
        self,
        query_name: str,
        pattern: Any,
        host: Any,
        *,
        schema: Optional[Any] = None,
        registry: Optional[Any] = None,
        promote_after: Optional[int] = None,
        buffer_max: Optional[int] = None,
        device_opts: Optional[Dict[str, Any]] = None,
        autosize: bool = True,
    ) -> None:
        self.query_name = query_name
        self.pattern = pattern
        self.host = host
        self.schema = schema
        self.registry = registry
        self.promote_after = int(
            promote_after if promote_after is not None else self.PROMOTE_AFTER
        )
        self.buffer_max = int(
            buffer_max if buffer_max is not None else self.BUFFER_MAX
        )
        self.device_opts = dict(device_opts or {})
        self.autosize = bool(autosize)
        self.device: Optional[Any] = None
        self.autosizer: Optional[Any] = None
        self._ledger: List[Tuple[Any, Any, int, str, int, int]] = []
        self._keys_seen: set = set()
        self._pinned_host = False
        self._since_tick = 0
        #: occurrence-qualified identities of every host-phase output;
        #: the promotion replay renumbers against a fresh counter and
        #: drops collisions (module docstring). Dropped after promotion.
        self._host_emitted: Set[bytes] = set()
        self._host_occ: Dict[bytes, int] = {}
        #: The promotion's walls and counts (None before it): the whole
        #: promotion, the ledger replay in it, the records replayed, the
        #: matches the replay regenerated and those the host had emitted.
        self.promotion: Optional[Dict[str, Any]] = None
        from ..obs.registry import default_registry

        metrics = registry if registry is not None else default_registry()
        self._m_promotions = metrics.counter(
            "cep_auto_promotions_total",
            "runtime='auto' host->device promotions (distinct-key "
            "threshold crossed; the promotion ledger replays through "
            "the fresh device engine)",
            labels=("query",),
        ).labels(query=query_name)
        self._m_runtime = metrics.gauge(
            "cep_auto_runtime",
            "Live runtime for a runtime='auto' query (value 1 on the "
            "current one)",
            labels=("query", "runtime"),
        )
        self._m_runtime.labels(query=query_name, runtime="host").set(1)
        self._m_runtime.labels(query=query_name, runtime="cuda").set(0)

    # ------------------------------------------------------------- routing
    @property
    def runtime(self) -> str:
        return "cuda" if self.device is not None else "host"

    @property
    def gate(self) -> Optional[Any]:
        active = self.device if self.device is not None else self.host
        return getattr(active, "gate", None)

    @property
    def engine(self) -> Optional[Any]:
        return None if self.device is None else self.device.engine

    def process_keyed(
        self,
        key: Any,
        value: Any,
        timestamp: int = 0,
        topic: str = "",
        partition: int = 0,
        offset: int = 0,
    ) -> List[Tuple[Any, Any]]:
        if self.device is not None:
            out = self.device.process(
                key, value, timestamp=timestamp, topic=topic,
                partition=partition, offset=offset,
            )
            self._tick(1)
            return out
        if not self._pinned_host and key is not None and value is not None:
            self._ledger.append(
                (key, value, timestamp, topic, partition, offset)
            )
            self._keys_seen.add(key)
            if len(self._ledger) > self.buffer_max:
                # High volume, low cardinality: the host loop is the
                # right runtime; an unbounded ledger would be a leak.
                self._pinned_host = True
                self._ledger = []
        out = self._record_host(
            self.host.process_keyed(
                key, value, timestamp=timestamp, topic=topic,
                partition=partition, offset=offset,
            )
        )
        if (
            not self._pinned_host
            and len(self._keys_seen) >= self.promote_after
        ):
            out = out + self._promote()
        return out

    def _ident(self, key: Any, seq: Any) -> bytes:
        """Base sequence identity of one output, bitwise-equal for the
        host Sequence and the device's replayed copy of the same match
        (both hash the `streams/emission.py` identity frames)."""
        from .emission import identity_prefix, sequence_ident_frames
        from .serde import SinkMatch

        h = hashlib.blake2b(digest_size=16)
        h.update(identity_prefix(self.query_name, key))
        if isinstance(seq, SinkMatch):
            h.update(seq.ident)
        else:
            h.update(sequence_ident_frames(seq))
        return h.digest()

    def _record_host(
        self, out: List[Tuple[Any, Any]]
    ) -> List[Tuple[Any, Any]]:
        if self.device is None and not self._pinned_host:
            for key, seq in out:
                base = self._ident(key, seq)
                n = self._host_occ.get(base, 0)
                self._host_occ[base] = n + 1
                self._host_emitted.add(base + n.to_bytes(8, "little"))
        return list(out)

    def _promote(self) -> List[Tuple[Any, Any]]:
        """Build the device processor and replay the ledger through it.

        The replay regenerates the host phase's matches along with any
        the fuller device batch completes; regenerated ones renumber
        deterministically into the recorded host identities and drop, so
        downstream admission sees each match exactly once with the same
        occurrence numbering an all-device run assigns."""
        from .device_processor import DeviceCEPProcessor

        t0 = time.perf_counter()
        dev = DeviceCEPProcessor(
            self.query_name,
            self.pattern,
            schema=self.schema,
            registry=self.registry,
            **self.device_opts,
        )
        if self.autosize:
            from ..parallel.drain_sched import CapacityAutosizer

            self.autosizer = CapacityAutosizer(
                dev.engine, registry=self.registry
            )
        replayed: List[Tuple[Any, Any]] = []
        t1 = time.perf_counter()
        for key, value, timestamp, topic, partition, offset in self._ledger:
            replayed.extend(
                dev.process(
                    key, value, timestamp=timestamp, topic=topic,
                    partition=partition, offset=offset,
                )
            )
        replayed.extend(dev.flush())
        t2 = time.perf_counter()
        # Renumber the replay from zero (deterministic engine order) and
        # drop everything the host phase already delivered.
        out: List[Tuple[Any, Any]] = []
        replay_occ: Dict[bytes, int] = {}
        for key, seq in replayed:
            base = self._ident(key, seq)
            n = replay_occ.get(base, 0)
            replay_occ[base] = n + 1
            if base + n.to_bytes(8, "little") in self._host_emitted:
                continue
            out.append((key, seq))
        self.promotion = {
            "wall_s": time.perf_counter() - t0, "replay_s": t2 - t1,
            "ledger": len(self._ledger), "replayed_matches": len(replayed),
            "host_matches": len(self._host_emitted),
        }
        self.device = dev
        self._ledger = []
        self._keys_seen = set()
        self._host_emitted = set()
        self._host_occ = {}
        self._m_promotions.inc()
        self._m_runtime.labels(query=self.query_name, runtime="host").set(0)
        self._m_runtime.labels(query=self.query_name, runtime="cuda").set(1)
        return out

    def _tick(self, n: int) -> None:
        """Batch the autosizer's control ticks to the device flush scale
        (host arithmetic only; never per-record device work)."""
        if self.autosizer is None:
            return
        self._since_tick += n
        batch = max(1, int(getattr(self.device, "batch_size", 64)))
        if self._since_tick >= batch:
            self.autosizer.observe(events=self._since_tick)
            self._since_tick = 0

    # ------------------------------------------------------- passthroughs
    def flush(self) -> List[Tuple[Any, Any]]:
        if self.device is None:
            return []
        out = self.device.flush()
        self._tick(0)
        return out

    def tick_event_time(self, now_ms: int) -> List[Tuple[Any, Any]]:
        active = self.device if self.device is not None else self.host
        fn = getattr(active, "tick_event_time", None)
        return [] if fn is None else self._record_host(fn(now_ms))

    def flush_event_time(self) -> List[Tuple[Any, Any]]:
        active = self.device if self.device is not None else self.host
        fn = getattr(active, "flush_event_time", None)
        return [] if fn is None else self._record_host(fn())

    def take_poisoned(self) -> List[Any]:
        if self.device is None:
            return []
        fn = getattr(self.device, "take_poisoned", None)
        return [] if fn is None else fn()

    def event_time_state(self) -> Dict[str, Any]:
        # Host-phase durability surface (EventTimeStateStore); after
        # promotion the device carries its own gate, and the restore
        # path rebuilds from the source topics (module docstring).
        return self.host.event_time_state()

    def restore_event_time(self, state: Dict[str, Any]) -> None:
        self.host.restore_event_time(state)

    def state(self) -> Dict[str, Any]:
        """JSON-ready routing snapshot (artifacts / health endpoints)."""
        return {
            "runtime": self.runtime,
            "keys_seen": len(self._keys_seen),
            "promote_after": self.promote_after,
            "ledger": len(self._ledger),
            "pinned_host": self._pinned_host,
            "autosizer": (
                None if self.autosizer is None else self.autosizer.state()
            ),
        }
