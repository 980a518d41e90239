"""Shard rebalance: fence, checkpoint, migrate, resume -- never from zero.

A mirror of the JAX package's `streams/rebalance.py`. The device runtime
is `"cuda"` here: a migrated `"cuda"` shard's successor rebuilds its
engine through `DeviceCEPProcessor.restore` on the device the node's
options name (the card unless the caller asked for the CPU), so its
first step after the move launches the same kernels as before it.

The task/rebalance layer the reference delegates to Kafka Streams' group
coordinator (SURVEY §1, L0): shards of one application run as independent
pipelines (own `Topology` + `LogDriver`, disjoint source partitions,
shard-salted changelog topics), and this module moves a live shard
between pipelines mid-stream:

  1. **fence** the source shard -- it stops polling, so no new records
     enter after the cut point;
  2. **flush + checkpoint** -- a final commit makes every store/changelog/
     sink append durable and the emission-gate watermark current, then the
     shard's movable state (consumer positions, per-query store +
     event-time snapshots, emission watermark, per-broker transport
     sessions) is sealed into one `state/serde.py` shard frame;
  3. **hand off** -- the successor pipeline is built over the target's
     brokers with `restore=False`, adopts the checkpoint (stores re-put
     through the change-logging stacks, so the shard's changelog continues
     on the target broker), seeds the committed positions, and adopts the
     transport sessions so the brokers' seq->offset dedup keeps covering
     appends issued before the move;
  4. **resume** from the committed watermark -- the first target poll
     continues exactly where the fenced source stopped, and the
     EmissionGate's sink-tail recovery dedups any matches the source
     emitted but whose effects straddle the cut.

`plan()` is the pure policy half: it watches per-shard load (the
`cep_shard_state_counter` family) and broker freshness
(`cep_transport_last_ok_age_seconds` / per-broker last_ok ages) and
proposes migrations and broker recoveries; the chaos soak drives it
against a seeded broker kill (faults/soak.py).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..state.nfa_store import EmitWatermark
from ..state.serde import (
    decode_event_time_state,
    decode_shard_checkpoint,
    encode_shard_checkpoint,
    split_event_time,
)
from .driver import LogDriver
from .partition import PartitionedRecordLog


def _collect_sessions(log: Any) -> Dict[str, Tuple[bytes, int]]:
    """Per-broker transport sessions ({broker_label: (session, seq)}):
    the idempotent-producer identity a shard checkpoint carries. Brokers
    without a session surface (file-backed logs) contribute nothing."""
    sessions: Dict[str, Tuple[bytes, int]] = {}
    if isinstance(log, PartitionedRecordLog):
        for i, broker in enumerate(log.brokers):
            fn = getattr(broker, "session_state", None)
            if callable(fn):
                sessions[str(i)] = fn()
    else:
        fn = getattr(log, "session_state", None)
        if callable(fn):
            sessions["0"] = fn()
    return sessions


def _apply_query_state(node: Any, q: Dict[str, Any], log: Any) -> None:
    """Adopt one query's checkpointed state into a freshly-built node.

    Host runtime: the snapshot's stores are re-put through the node's
    change-logging stacks (the shard's changelog CONTINUES on whatever
    broker the target routes to -- a later cold restore replays there).
    Device runtime: the node's processor is rebuilt from the engine blob,
    the same replacement `DeviceStateStore.restore_from_changelog` does.
    Both paths finish by seeding the emission watermark and running the
    gate's sink-tail recovery, so emissions stay exactly-once across the
    move."""
    blob = q.get("stores")
    if blob is not None and node.runtime == "cuda":
        from .device_processor import DeviceCEPProcessor

        node.processor = DeviceCEPProcessor.restore(
            node.name,
            node.pattern,
            blob,
            schema=(
                node.queried.schema if node.queried is not None else None
            ),
            registry=node.registry,
            **node.device_opts,
        )
    elif blob is not None:
        data, gate_bytes = split_event_time(blob)
        nfa, buffers, aggregates = (
            node.store_builders.codec.decode_query_stores(data)
        )
        proc = node.processor
        for key, states in nfa.items():
            proc.nfa_store.put(key, states)
        for key, buf in buffers.items():
            proc.buffer.set_for_key(key, buf)
        for (key, name, seq), value in aggregates.items():
            proc.aggregates.put(key, name, seq, value)
        if gate_bytes is not None:
            proc.restore_event_time(decode_event_time_state(gate_bytes))
    sink_pos = q.get("sink_pos") or {}
    recovered = list(q.get("recovered") or ())
    if sink_pos or recovered:
        node.emission_store.put(
            EmitWatermark(sink_pos=dict(sink_pos), recovered=recovered)
        )
    gate_blob = q.get("event_time")
    if gate_blob is not None:
        node.processor.restore_event_time(
            decode_event_time_state(gate_blob)
        )
    node.gate.recover(log, node.sink_topics)


class ShardPipeline:
    """One shard of the application: its own topology + driver over a
    disjoint source-partition scope, with fence/checkpoint/resume.

    `build_topology(log, shard_id)` constructs the shard's topology over
    the given log -- using `shard_id` to salt the app id keeps each
    shard's changelog topics disjoint on a shared fleet. Pass
    `checkpoint=` (bytes from another pipeline's `checkpoint()`) to build
    a successor that adopts the fenced source's state instead of
    restoring from a changelog."""

    def __init__(
        self,
        shard_id: str,
        build_topology: Callable[[Any, str], Any],
        log: Any,
        partitions: Optional[Mapping[str, Sequence[int]]] = None,
        group: Optional[str] = None,
        registry: Optional[Any] = None,
        restore: bool = True,
        checkpoint: Optional[bytes] = None,
        driver_opts: Optional[Dict[str, Any]] = None,
    ) -> None:
        cp = decode_shard_checkpoint(checkpoint) if checkpoint is not None else None
        if cp is not None:
            if cp["shard_id"] != shard_id:
                raise ValueError(
                    f"checkpoint is for shard {cp['shard_id']!r}, "
                    f"not {shard_id!r}"
                )
            group = cp["group"]
            restore = False
        self.shard_id = shard_id
        self.build_topology = build_topology
        self.log = log
        self.group = group if group is not None else f"shard-{shard_id}"
        self.registry = registry
        self.fenced = False
        self.topology = build_topology(log, shard_id)
        scope: Optional[Dict[str, Tuple[int, ...]]] = None
        if partitions is not None:
            scope = {t: tuple(ps) for t, ps in partitions.items()}
        elif cp is not None:
            # Successor scope from the checkpointed positions: the fenced
            # source committed one position per scoped (topic, partition).
            derived: Dict[str, List[int]] = {}
            for (topic, part) in cp["positions"]:
                if topic in self.topology.source_topics:
                    derived.setdefault(topic, []).append(part)
            scope = {t: tuple(sorted(ps)) for t, ps in derived.items()}
        self.partitions = scope
        self.driver = LogDriver(
            self.topology,
            log=log,
            group=self.group,
            restore=restore,
            registry=registry,
            partitions=scope,
            **(driver_opts or {}),
        )
        if cp is not None:
            nodes = {
                node.name: node for _s, node, _o in self.topology.queries
            }
            for qname, q in cp["queries"].items():
                node = nodes.get(qname)
                if node is None:
                    raise ValueError(
                        f"checkpoint carries query {qname!r} the target "
                        "topology does not define"
                    )
                _apply_query_state(node, q, log)
            self.driver.seed_positions(cp["positions"])

    def poll(self, **kwargs: Any) -> int:
        if self.fenced:
            raise RuntimeError(
                f"shard {self.shard_id} is fenced (mid-migration)"
            )
        return self.driver.poll(**kwargs)

    def fence(self) -> None:
        """Stop this shard's pump: no record enters after the cut point.
        Idempotent; only `checkpoint()` and `close()` remain legal."""
        self.fenced = True

    def checkpoint(self) -> bytes:
        """Seal the shard's movable state (requires a fence first: a live
        pump would advance past the cut while the frame is being built).
        Commits before cutting, so the frame's positions are durable and
        the emission watermark covers every emitted match."""
        if not self.fenced:
            raise RuntimeError("checkpoint() requires fence() first")
        self.driver.commit()
        positions = self.driver.positions()
        if self.partitions:
            # Scoped partitions that never saw a record still ride the
            # frame (position 0), so the successor derives the full scope.
            for topic, parts in self.partitions.items():
                for part in parts:
                    positions.setdefault((topic, part), 0)
        queries: Dict[str, Dict[str, Any]] = {}
        for _stream, node, _out in self.topology.queries:
            wm = node.emission_store.get()
            queries[node.name] = {
                "runtime": node.runtime,
                # snapshot() already wraps event-time gate state
                # (state/serde.wrap_event_time), so the frame's separate
                # event_time slot stays empty for both runtimes.
                "stores": node.processor.snapshot(),
                "sink_pos": dict(wm.sink_pos) if wm is not None else {},
                "event_time": None,
            }
            outstanding = getattr(wm, "recovered", None)
            if outstanding:
                # Digests a crash recovery left for replay to regenerate
                # (streams/emission.py): the successor keeps deduping them.
                queries[node.name]["recovered"] = list(outstanding)
        return encode_shard_checkpoint(
            {
                "shard_id": self.shard_id,
                "group": self.group,
                "positions": positions,
                "sessions": _collect_sessions(self.log),
                "queries": queries,
            }
        )

    def close(self, close_log: bool = False) -> None:
        self.driver.close()
        if close_log:
            self.log.close()


def plan(
    shard_loads: Mapping[str, float],
    broker_last_ok_age_s: Mapping[int, Optional[float]],
    skew_ratio: float = 4.0,
    dead_after_s: float = 10.0,
    min_load: float = 1.0,
) -> List[Dict[str, Any]]:
    """Pure rebalance policy: observed state in, proposed actions out.

    `shard_loads` is per-shard aggregate state-counter load (the
    `cep_shard_state_counter` family summed per shard); `broker_last_ok_age_s`
    is each broker's seconds-since-last-successful-request (the client's
    `cep_transport_last_ok_age_seconds` / health()["last_ok_age_s"]; None
    means never connected, treated as dead). Brokers stale past
    `dead_after_s` get a recover action; a shard whose load exceeds
    `skew_ratio` times the mean of the others (and `min_load`) gets a
    skew migration. Deterministic given its inputs -- the chaos soak and
    the unit tests drive the same function."""
    actions: List[Dict[str, Any]] = []
    for broker in sorted(broker_last_ok_age_s):
        age = broker_last_ok_age_s[broker]
        if age is None or age >= dead_after_s:
            actions.append(
                {
                    "kind": "recover_broker",
                    "broker": broker,
                    "reason": "broker_dead",
                }
            )
    if len(shard_loads) >= 2:
        top_shard = max(sorted(shard_loads), key=lambda s: shard_loads[s])
        top = float(shard_loads[top_shard])
        rest = [
            float(v) for s, v in shard_loads.items() if s != top_shard
        ]
        mean_rest = sum(rest) / len(rest)
        if top >= min_load and top >= skew_ratio * max(mean_rest, 1e-9):
            actions.append(
                {
                    "kind": "migrate",
                    "shard": top_shard,
                    "reason": "skew",
                }
            )
    return actions


@contextlib.contextmanager
def _maybe_span(tracer: Optional[Any], name: str, trace: Optional[Any]):
    """tracer.span when a tracer is attached; a no-op yielding None
    otherwise (migration spans are optional observability, never a
    dependency of the handoff)."""
    if tracer is None:
        yield None
    else:
        with tracer.span(name, trace=trace) as child:
            yield child


class RebalanceController:
    """Executes rebalance actions: live shard migration and dead-broker
    recovery, with the `cep_rebalance_*` metric family."""

    def __init__(self, registry: Optional[Any] = None) -> None:
        from ..obs.registry import default_registry

        self.metrics = registry if registry is not None else default_registry()
        m = self.metrics
        self._m_migrations = m.counter(
            "cep_rebalance_migrations_total",
            "Completed live shard migrations, by trigger",
            labels=("reason",),
        )
        self._m_fenced = m.gauge(
            "cep_rebalance_fenced_shards",
            "Shards currently fenced mid-migration (nonzero only inside "
            "a migrate(); stuck here means a wedged handoff)",
        )
        self._m_duration = m.gauge(
            "cep_rebalance_duration_seconds",
            "Wall time of the last completed shard migration "
            "(fence -> successor ready)",
        )
        self._m_checkpoint_bytes = m.gauge(
            "cep_rebalance_checkpoint_bytes",
            "Sealed size of the last shard checkpoint frame",
        )
        self._m_partition_moves = m.counter(
            "cep_rebalance_partition_moves_total",
            "Topic-partitions re-homed to another broker",
        )
        self._m_moved_records = m.counter(
            "cep_rebalance_moved_records_total",
            "Records copied between brokers by partition moves",
        )

    def migrate(
        self,
        source: ShardPipeline,
        make_log: Callable[[Dict[str, Tuple[bytes, int]]], Any],
        build_topology: Optional[Callable[[Any, str], Any]] = None,
        reason: str = "skew",
        close_source_log: bool = True,
        registry: Optional[Any] = None,
        driver_opts: Optional[Dict[str, Any]] = None,
        tracer: Optional[Any] = None,
        trace: Optional[Any] = None,
    ) -> ShardPipeline:
        """Fence `source`, checkpoint it, and hand the shard to a successor
        pipeline over `make_log(sessions)` -- the caller builds the target's
        log view there, passing each broker's (session, seq) into its
        `SocketRecordLog(session=..., start_seq=...)` so server-side dedup
        spans the move. Returns the resumed successor.

        With a `tracer` (and optionally a `TraceContext` in `trace`, e.g.
        minted by the fleet controller for its decision) the three handoff
        phases land as a stitched parent chain -- migrate.fence ->
        migrate.checkpoint -> migrate.resume -- so the Perfetto fleet view
        shows the migration window inside the affected records' traces."""
        t0 = time.perf_counter()
        self._m_fenced.inc()
        ctx = trace
        try:
            with _maybe_span(tracer, "migrate.fence", ctx) as child:
                source.fence()
                ctx = child if child is not None else ctx
            with _maybe_span(tracer, "migrate.checkpoint", ctx) as child:
                blob = source.checkpoint()
                self._m_checkpoint_bytes.set(len(blob))
                ctx = child if child is not None else ctx
            sessions = decode_shard_checkpoint(blob)["sessions"]
            with _maybe_span(tracer, "migrate.resume", ctx):
                target_log = make_log(sessions)
                source.close(close_log=close_source_log)
                target = ShardPipeline(
                    source.shard_id,
                    build_topology or source.build_topology,
                    target_log,
                    registry=(
                        registry if registry is not None else source.registry
                    ),
                    checkpoint=blob,
                    driver_opts=driver_opts,
                )
        finally:
            self._m_fenced.dec()
        self._m_duration.set(time.perf_counter() - t0)
        self._m_migrations.labels(reason=reason).inc()
        return target

    def recover_broker(
        self,
        views: Sequence[PartitionedRecordLog],
        dead: int,
        target: int,
        salvage_log: Any,
    ) -> Tuple[int, int]:
        """Re-home every (topic, partition) the dead broker owned onto
        `target`, reading from `salvage_log` (the dead broker's durable
        segments reopened -- `BrokerFleet.salvage_log`). All client
        `views` of the fleet are re-pointed; the data copy runs once (the
        idempotent resume makes repeats no-ops). Returns (partitions
        moved, records copied)."""
        if not views:
            raise ValueError("recover_broker needs at least one fleet view")
        primary = views[0]
        for view in views:
            view.mark_down(dead, redirect_to=target)
        moved_parts = 0
        moved_records = 0
        for topic in salvage_log.topics():
            for part in salvage_log.partitions(topic):
                if primary.broker_for(topic, part) != dead:
                    continue
                moved_records += primary.move_partition(
                    topic, part, target, source_log=salvage_log
                )
                moved_parts += 1
                for view in views[1:]:
                    view.assign(topic, part, target)
        # Routes still materialized to the corpse after the salvage pass
        # are partitions that left NO durable segment behind (their
        # unflushed tail died with the broker -- nothing to copy). They
        # still need a live home: re-point them at the survivor so replay
        # from the committed offsets can regenerate their content instead
        # of every read wedging on a dead client.
        for view in views:
            for (topic, part), idx in view.assignment().items():
                if idx == dead:
                    view.assign(topic, part, target)
        self._m_partition_moves.inc(moved_parts)
        self._m_moved_records.inc(moved_records)
        return moved_parts, moved_records
