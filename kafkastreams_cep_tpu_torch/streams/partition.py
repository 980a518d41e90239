"""Partitioned broker fleet: the RecordLog contract across N brokers.

A copy of the JAX package's `streams/partition.py`: each (topic,
partition) routes to the same broker as there.

The reference delegates partition assignment to the Kafka Streams task
layer: each task owns a topic-partition set on one broker, and the group
coordinator moves ownership when a broker dies or load skews (SURVEY §1,
L0). This module owns that layer for the embedded pipeline:

  * `PartitionedRecordLog` -- a client view over an ordered list of
    brokers (anything satisfying the RecordLog contract, typically
    `SocketRecordLog` clients of a `RecordLogServer`). Every
    (topic, partition) routes to exactly one broker -- deterministically
    by a stable hash until `assign()`/`move_partition()` pins it -- so
    `LogDriver`, the changelog store stack, and the EmissionGate run
    unchanged on top: offsets stay per (topic, partition, broker) and
    commit ordering is per-broker exactly as on one log.
  * `move_partition` -- the data-plane half of a rebalance: copy one
    (topic, partition)'s records to the target broker from its current
    end offset (idempotent resume: a re-run move appends nothing), then
    flip the route. When the owner is dead, a salvage log (the broker's
    durable file-backed segments reopened in-process) stands in as the
    read side -- the embedded stand-in for reading a replica.
  * `BrokerFleet` -- test/soak harness that spawns N file-backed
    `RecordLogServer`s, hands out clients, and can kill one broker and
    reopen its segments for salvage.

The control-plane half (when to move, fencing, shard checkpoint handoff)
lives in streams/rebalance.py.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..state.serde import crc32c
from .log import LogRecord


class PartitionedRecordLog:
    """RecordLog-contract router over an ordered broker list.

    The broker ORDER is the fleet topology: every client view of the same
    fleet must list the same brokers in the same order, or their default
    routes diverge. Explicit assignments (`assign`, `move_partition`)
    override the hash route and are the unit of rebalance."""

    def __init__(
        self,
        brokers: Sequence[Any],
        registry: Optional[Any] = None,
        assignment: Optional[Dict[Tuple[str, int], int]] = None,
    ) -> None:
        from ..obs.registry import default_registry

        if not brokers:
            raise ValueError("PartitionedRecordLog needs at least one broker")
        self.brokers: List[Any] = list(brokers)
        self.path = None  # contract parity: not itself file-backed
        self.metrics = registry if registry is not None else default_registry()
        self._lock = threading.Lock()
        self._assignment: Dict[Tuple[str, int], int] = dict(assignment or {})
        #: Default-route redirects for downed brokers: (topic, partition)s
        #: materialized BEFORE the death are re-homed explicitly by the
        #: rebalance layer (move_partition), but a topic first touched
        #: AFTER it would still hash onto the corpse -- mark_down() sends
        #: those future defaults to a survivor instead.
        self._down: Dict[int, int] = {}
        for idx in self._assignment.values():
            self._check_idx(idx)
        m = self.metrics
        n = len(self.brokers)
        self._m_up = m.gauge(
            "cep_transport_broker_up",
            "1 while the broker's last routed request succeeded, 0 after "
            "a routed request raised (reset by the next success)",
            labels=("broker",),
        )
        _m_reqs = m.counter(
            "cep_transport_broker_requests_total",
            "Requests routed to each broker of the partitioned fleet",
            labels=("broker", "op"),
        )
        _m_errs = m.counter(
            "cep_transport_broker_errors_total",
            "Routed requests that raised, per broker (the health signal "
            "the rebalance controller watches alongside last_ok age)",
            labels=("broker",),
        )
        # Children bound once per broker: routing is the append/read hot
        # path and labels() resolution locks per call.
        self._up = [self._m_up.labels(broker=str(i)) for i in range(n)]
        self._reqs_append = [
            _m_reqs.labels(broker=str(i), op="append") for i in range(n)
        ]
        self._reqs_read = [
            _m_reqs.labels(broker=str(i), op="read") for i in range(n)
        ]
        self._errs = [_m_errs.labels(broker=str(i)) for i in range(n)]
        for up in self._up:
            up.set(1.0)

    # ------------------------------------------------------------- routing
    def _check_idx(self, idx: int) -> None:
        if not 0 <= idx < len(self.brokers):
            raise ValueError(
                f"broker index {idx} out of range (fleet of "
                f"{len(self.brokers)})"
            )

    def _default_route(self, topic: str, partition: int) -> int:
        # Stable across processes and fleet restarts (no PYTHONHASHSEED
        # dependence): the same (topic, partition) always lands on the
        # same broker of an equally-ordered fleet.
        return (crc32c(topic.encode("utf-8")) + partition) % len(self.brokers)

    def broker_for(self, topic: str, partition: int = 0) -> int:
        """The owning broker index for one (topic, partition)."""
        with self._lock:
            key = (topic, int(partition))
            idx = self._assignment.get(key)
            if idx is None:
                idx = self._default_route(topic, partition)
                # Follow down-redirects (bounded: a redirect chain longer
                # than the fleet means a cycle -- a config bug, not a
                # reachable route).
                for _ in range(len(self.brokers)):
                    if idx not in self._down:
                        break
                    idx = self._down[idx]
                else:
                    raise ValueError(
                        f"down-broker redirect cycle resolving "
                        f"({topic}, {partition})"
                    )
                self._assignment[key] = idx
            return idx

    def mark_down(self, broker: int, redirect_to: int) -> None:
        """Route future default assignments away from a dead broker.
        Existing assignments are untouched (the rebalance layer moves
        those explicitly, data first)."""
        self._check_idx(broker)
        self._check_idx(redirect_to)
        if broker == redirect_to:
            raise ValueError("cannot redirect a downed broker to itself")
        with self._lock:
            self._down[broker] = redirect_to

    def assign(self, topic: str, partition: int, broker: int) -> None:
        """Pin one (topic, partition) to a broker (no data movement --
        use `move_partition` to rebalance a populated partition)."""
        self._check_idx(broker)
        with self._lock:
            self._assignment[(topic, int(partition))] = broker

    def assignment(self) -> Dict[Tuple[str, int], int]:
        """Snapshot of every materialized (topic, partition) -> broker
        route (defaults materialize on first touch)."""
        with self._lock:
            return dict(self._assignment)

    def partitions_on(self, broker: int) -> List[Tuple[str, int]]:
        """Every materialized (topic, partition) currently routed to one
        broker -- the move list when that broker dies."""
        with self._lock:
            return sorted(
                tp for tp, idx in self._assignment.items() if idx == broker
            )

    def _routed(self, topic: str, partition: int) -> Tuple[Any, int]:
        idx = self.broker_for(topic, partition)
        return self.brokers[idx], idx

    # ----------------------------------------------------------- contract
    def append(
        self,
        topic: str,
        key: Optional[bytes],
        value: Optional[bytes],
        timestamp: int = 0,
        partition: int = 0,
        trace: Optional[bytes] = None,
    ) -> int:
        broker, idx = self._routed(topic, partition)
        self._reqs_append[idx].inc()
        try:
            off = broker.append(
                topic, key, value, timestamp=timestamp, partition=partition,
                trace=trace,
            )
        except Exception:
            self._errs[idx].inc()
            self._up[idx].set(0.0)
            raise
        self._up[idx].set(1.0)
        return off

    def read(
        self,
        topic: str,
        partition: int = 0,
        start: int = 0,
        max_records: Optional[int] = None,
    ) -> List[LogRecord]:
        broker, idx = self._routed(topic, partition)
        self._reqs_read[idx].inc()
        try:
            records = broker.read(
                topic, partition=partition, start=start,
                max_records=max_records,
            )
        except Exception:
            self._errs[idx].inc()
            self._up[idx].set(0.0)
            raise
        self._up[idx].set(1.0)
        return records

    def end_offset(self, topic: str, partition: int = 0) -> int:
        broker, _idx = self._routed(topic, partition)
        return broker.end_offset(topic, partition=partition)

    def topics(self) -> List[str]:
        seen = set()
        for idx, broker in enumerate(self.brokers):
            if idx in self._down:
                continue  # evacuated corpse: survivors hold its metadata
            seen.update(broker.topics())
        return sorted(seen)

    def partitions(self, topic: str) -> List[int]:
        seen = set()
        for idx, broker in enumerate(self.brokers):
            if idx in self._down:
                continue  # evacuated corpse: survivors hold its metadata
            seen.update(broker.partitions(topic))
        return sorted(seen)

    def flush(self) -> None:
        """Flush every broker that owns at least one materialized route
        (all of them before any route exists). Fail-stop on the first
        failure, matching the embedded log's fsyncgate stance: commit()
        must never record offsets over changelog/sink appends whose
        durability is unknown. Ownerless brokers are skipped so a dead,
        fully-evacuated broker cannot wedge the survivors' commits."""
        with self._lock:
            owners = set(self._assignment.values())
        for idx, broker in enumerate(self.brokers):
            if owners and idx not in owners:
                continue
            broker.flush()

    def close(self) -> None:
        first: Optional[BaseException] = None
        for broker in self.brokers:
            try:
                broker.close()
            except Exception as exc:  # close the rest before raising
                if first is None:
                    first = exc
        if first is not None:
            raise first

    # ---------------------------------------------------------- rebalance
    def move_partition(
        self,
        topic: str,
        partition: int,
        target: int,
        source_log: Optional[Any] = None,
    ) -> int:
        """Copy one (topic, partition) to broker `target` and flip its
        route; returns how many records were appended.

        The copy resumes from the target's current end offset, so a move
        interrupted and re-run appends only the missing suffix (offsets
        are record ordinals on both sides -- the single-owner invariant
        means the target's prefix IS the source's prefix). `source_log`
        substitutes the read side when the owner is unreachable: the
        dead broker's durable segments reopened as a salvage RecordLog."""
        self._check_idx(target)
        with self._lock:
            src_idx = self._assignment.get(
                (topic, int(partition)),
                self._default_route(topic, partition),
            )
        if src_idx == target and source_log is None:
            return 0
        src = source_log if source_log is not None else self.brokers[src_idx]
        dst = self.brokers[target]
        already = dst.end_offset(topic, partition=partition)
        records = src.read(topic, partition=partition, start=already)
        for rec in records:
            dst.append(
                topic, rec.key, rec.value,
                timestamp=rec.timestamp, partition=partition,
                trace=getattr(rec, "trace", None),
            )
        dst.flush()
        self.assign(topic, partition, target)
        return len(records)

    # ------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        with self._lock:
            assignment = {
                f"{t}:{p}": idx for (t, p), idx in sorted(self._assignment.items())
            }
        per_broker = []
        for i, broker in enumerate(self.brokers):
            fn = getattr(broker, "health", None)
            per_broker.append(fn() if callable(fn) else None)
        with self._lock:
            down = {str(b): t for b, t in sorted(self._down.items())}
        return {
            "mode": "partitioned",
            "brokers": len(self.brokers),
            "broker_health": per_broker,
            "assignment": assignment,
            "down": down,
        }


class BrokerFleet:
    """N file-backed socket brokers under one base directory.

    The soak/test harness half of the fleet: spawn servers, hand out
    `SocketRecordLog` clients (one per broker, shared registry), kill a
    broker under traffic, and reopen its durable segments for salvage
    (`move_partition(source_log=...)`) -- the embedded stand-in for a
    replica read. Restart brings the broker back on its old segments
    (RecordLog reload truncates any torn tail)."""

    def __init__(
        self,
        base_dir: str,
        n_brokers: int = 2,
        registry: Optional[Any] = None,
        **server_opts: Any,
    ) -> None:
        import os

        from .log import RecordLog
        from .transport import RecordLogServer

        if n_brokers < 1:
            raise ValueError("fleet needs at least one broker")
        self.base_dir = base_dir
        self.registry = registry
        self.server_opts = dict(server_opts)
        self.paths = [
            os.path.join(base_dir, f"broker{i}") for i in range(n_brokers)
        ]
        self.servers: List[Optional[RecordLogServer]] = []
        for path in self.paths:
            os.makedirs(path, exist_ok=True)
            self.servers.append(
                RecordLogServer(
                    RecordLog(path), registry=registry, **self.server_opts
                ).start()
            )

    @property
    def n_brokers(self) -> int:
        return len(self.servers)

    def addresses(self) -> List[Optional[Tuple[str, int]]]:
        return [s.address if s is not None else None for s in self.servers]

    def clients(self, registry: Optional[Any] = None, **client_opts: Any):
        """One `SocketRecordLog` per live broker, fleet order preserved
        (dead brokers get a non-connecting placeholder client so routing
        indices stay stable; requests to them fail loudly)."""
        from .transport import SocketRecordLog

        out = []
        for i, server in enumerate(self.servers):
            opts = dict(client_opts)
            # Distinct per-broker backoff streams from one seed.
            if "backoff_seed" in opts:
                opts["backoff_seed"] = opts["backoff_seed"] + i
            if server is None:
                out.append(
                    SocketRecordLog(
                        ("127.0.0.1", 9), registry=registry,
                        connect=False, retry_budget=0, **opts,
                    )
                )
            else:
                out.append(
                    SocketRecordLog(
                        server.address, registry=registry, **opts
                    )
                )
        return out

    def kill(self, broker: int) -> None:
        """Stop one broker's server (its durable segments stay on disk).
        Clients see disconnects; salvage_log() reads what it flushed."""
        server = self.servers[broker]
        if server is not None:
            server.stop()
            self.servers[broker] = None

    def salvage_log(self, broker: int):
        """The dead broker's durable segments reopened in-process -- the
        read side of a salvage `move_partition`."""
        from .log import RecordLog

        return RecordLog(self.paths[broker])

    def restart(self, broker: int):
        """Bring a killed broker back on its old segments."""
        from .log import RecordLog
        from .transport import RecordLogServer

        if self.servers[broker] is not None:
            raise RuntimeError(f"broker {broker} is already running")
        self.servers[broker] = RecordLogServer(
            RecordLog(self.paths[broker]), registry=self.registry,
            **self.server_opts,
        ).start()
        return self.servers[broker]

    def stop(self) -> None:
        for i, server in enumerate(self.servers):
            if server is not None:
                server.stop()
                self.servers[i] = None
