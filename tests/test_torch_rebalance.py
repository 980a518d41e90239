"""The port's partitioned brokers and live shard rebalance against the
JAX package's.

Broker routing, `plan()` and the shard checkpoint frames are the JAX
package's: the same (topic, partition) lands on the same broker, the
same observations plan the same actions, and a host shard fenced at the
same point seals the same bytes. A live mid-stream migration on the host
and on the device runtime (the plain kernels on the CPU) leaves a sink
equal to the JAX migration's on the same stream and to the single-broker
golden run, each match once; a broker kill with salvage stays exactly
once; the successor resumes at the committed positions, never from zero.

Counterparts of the JAX package's tests/test_rebalance.py: each test of
the same name here, the migration on both runtimes as
`test_live_migration_equals_jax_and_golden`, and the routing and
checkpoint tests as the byte-equality tests. test_slice_merge_shard_tree_bitwise
holds `parallel/key_shard.py`'s mesh path: its counterpart is
tests/test_torch_mesh.py::test_slice_merge_shard_tree_equals_jax. The JAX package's
tests/test_controller.py acceptance test is
`test_fleet_controller_acceptance_two_brokers` here.
"""
from __future__ import annotations

import json
import pickle
import random
import time
from urllib.request import urlopen

import pytest

import kafkastreams_cep_tpu as J
import kafkastreams_cep_tpu.streams.partition as jpart
import kafkastreams_cep_tpu.streams.rebalance as jreb
import kafkastreams_cep_tpu_torch as P
from kafkastreams_cep_tpu.state import serde as jserde
from kafkastreams_cep_tpu_torch.faults import FaultInjector, FaultPoint, FaultSchedule, InjectedCrash, armed
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry
from kafkastreams_cep_tpu_torch.obs.trace import SpanTracer
from kafkastreams_cep_tpu_torch.obs.trace_export import stitched_chrome_trace
from kafkastreams_cep_tpu_torch.ops.controller import ControllerPolicy, FleetController
from kafkastreams_cep_tpu_torch.state import serde as pserde
from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key
from kafkastreams_cep_tpu_torch.streams.partition import BrokerFleet, PartitionedRecordLog
from kafkastreams_cep_tpu_torch.streams.rebalance import (
    RebalanceController,
    ShardPipeline,
    plan,
)
from kafkastreams_cep_tpu_torch.streams.transport import SocketRecordLog

JAX_DEVICE_OPTS = dict(
    config=J.EngineConfig(lanes=8, nodes=256, matches=256, matches_per_step=4, nodes_per_step=8),
    batch_size=5, initial_keys=2,
)
PORT_DEVICE_OPTS = dict(
    config=P.EngineConfig(lanes=8, nodes=256, matches=256, matches_per_step=4, nodes_per_step=8),
    batch_size=5, initial_keys=2, device="cpu",
)


def _pattern(pkg, runtime):
    if runtime == "host":
        qb = pkg.QueryBuilder()
        return (qb.select("select-A").where(lambda e, s: e.value == "A")
                .then().select("select-B").where(lambda e, s: e.value == "B")
                .then().select("select-C").where(lambda e, s: e.value == "C").build())
    v = pkg.value
    return (pkg.QueryBuilder().select("select-A").where(v() == "A")
            .then().select("select-B").where(v() == "B")
            .then().select("select-C").where(v() == "C").build())


def _stream(seed, n=36):
    rng = random.Random(seed)
    out: list = []
    while len(out) < n:
        out.extend(rng.choice(("ABC", "ABC", "AB", "BC", "X", "AXC", "Y")))
    return out[:n]


def _topology(pkg, log, shard_id, registry=None, runtime="host"):
    opts = {} if runtime == "host" else (PORT_DEVICE_OPTS if pkg is P else JAX_DEVICE_OPTS)
    builder = pkg.ComplexStreamsBuilder(log=log, app_id=f"reb-{shard_id}")
    builder.stream("letters").query(
        "q", _pattern(pkg, runtime), runtime=runtime, registry=registry, **opts,
    ).to("matches")
    return builder.build()


def _digests(log):
    out = []
    for rec in log.read("matches"):
        _key, digest = decode_sink_key(rec.key)
        assert digest is not None
        out.append((digest, rec.value))
    return sorted(out)


def _golden(events, runtime="host"):
    log = P.RecordLog()
    for i, ch in enumerate(events):
        P.produce(log, "letters", "K", ch, timestamp=i)
    driver = P.LogDriver(_topology(P, log, "golden", runtime=runtime), group="shard-s0")
    while driver.poll(max_records=4):
        pass
    return _digests(log)


def _fleet_view(fleet, reg, sessions=None, assignment=None, down=None, **client_opts):
    clients = []
    for i, server in enumerate(fleet.servers):
        if server is None:
            clients.append(SocketRecordLog(("127.0.0.1", 9), registry=reg, connect=False, retry_budget=0))
            continue
        kw = dict(client_opts)
        sess = (sessions or {}).get(str(i))
        if sess is not None:
            kw.update(session=sess[0], start_seq=sess[1])
        clients.append(SocketRecordLog(server.address, registry=reg, **kw))
    view = PartitionedRecordLog(clients, registry=reg, assignment=assignment)
    for dead, target in (down or {}).items():
        view.mark_down(dead, redirect_to=target)
    return view


# ------------------------------------------------------- routing and frames
@pytest.mark.parametrize("n_brokers", [1, 2, 3, 5])
def test_broker_routing_equals_jax(n_brokers):
    pv = PartitionedRecordLog([P.RecordLog() for _ in range(n_brokers)], registry=MetricsRegistry())
    jv = jpart.PartitionedRecordLog([J.RecordLog() for _ in range(n_brokers)])
    rng = random.Random(n_brokers)
    topics = ["letters", "matches", "__consumer_offsets", "x-y-z", "ü"] + [
        "".join(rng.choice("abcdefgh.-_") for _ in range(rng.randint(1, 24))) for _ in range(40)]
    for topic in topics:
        for part in range(6):
            assert pv.broker_for(topic, part) == jv.broker_for(topic, part)


def _checkpoint_dict(runtime):
    return {
        "shard_id": "s0", "group": "shard-s0",
        "positions": {("letters", 0): 17, ("letters", 2): 0},
        "sessions": {"0": (b"\x01" * 16, 42), "1": (b"\x02" * 16, 0)},
        "queries": {
            "q": {"runtime": runtime, "stores": b"\x00stores-blob",
                  "sink_pos": {"matches": 3}, "event_time": None},
            "empty": {"runtime": runtime, "stores": None, "sink_pos": {}, "event_time": b"gate"},
        },
    }


def test_shard_checkpoint_roundtrip_and_corruption():
    cp = _checkpoint_dict("cuda")
    blob = pserde.encode_shard_checkpoint(cp)
    assert pserde.decode_shard_checkpoint(blob) == cp
    assert blob == jserde.encode_shard_checkpoint(cp)
    assert jserde.decode_shard_checkpoint(blob) == cp
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(pserde.CheckpointError):
        pserde.decode_shard_checkpoint(bytes(bad))
    with pytest.raises(pserde.CheckpointError):
        pserde.decode_shard_checkpoint(pserde.seal_frame(b"KCT5junk"))


def test_shard_checkpoint_trailer_carries_outstanding_digests():
    """A query's outstanding recovered digests ride a trailer that only
    such a frame has: with none the frame is the JAX package's, with some
    the port reads them back and the JAX package refuses the frame."""
    cp = _checkpoint_dict("host")
    cp["queries"]["q"]["recovered"] = []
    blob = pserde.encode_shard_checkpoint(cp)
    assert blob == jserde.encode_shard_checkpoint(_checkpoint_dict("host"))
    digests = [bytes([i]) * 16 for i in (3, 1, 2)]
    cp["queries"]["q"]["recovered"] = digests
    blob = pserde.encode_shard_checkpoint(cp)
    back = pserde.decode_shard_checkpoint(blob)
    assert back["queries"]["q"]["recovered"] == sorted(digests)
    assert "recovered" not in back["queries"]["empty"]
    with pytest.raises(jserde.CheckpointError):
        jserde.decode_shard_checkpoint(blob)


def _host_shard_checkpoint(pkg, reb, events, k):
    log = pkg.RecordLog()
    for i, ch in enumerate(events):
        pkg.produce(log, "letters", "K", ch, timestamp=i)
    pipe = reb.ShardPipeline("s0", lambda lg, sid: _topology(pkg, lg, sid), log,
                             partitions={"letters": (0,)})
    for _ in range(k):
        pipe.poll(max_records=4)
    pipe.fence()
    return pipe.checkpoint(), log


@pytest.mark.parametrize("polls", [1, 3, 9])
def test_host_shard_checkpoint_bytes_equal_jax(polls):
    """A host shard fenced after the same polls seals the same frame in
    both packages, and the port's successor resumes from the JAX frame to
    the golden sink."""
    events = _stream(7)
    pblob, _plog = _host_shard_checkpoint(P, __import__(
        "kafkastreams_cep_tpu_torch.streams.rebalance", fromlist=["x"]), events, polls)
    jblob, jlog = _host_shard_checkpoint(J, jreb, events, polls)
    assert pblob == jblob
    # A port successor adopts the JAX frame over a copy of the JAX log.
    log = P.RecordLog()
    for topic in jlog.topics():
        for r in jlog.read(topic):
            log.append(topic, r.key, r.value, timestamp=r.timestamp)
    succ = ShardPipeline("s0", lambda lg, sid: _topology(P, lg, sid), log, checkpoint=jblob)
    while succ.poll(max_records=4):
        pass
    assert _digests(log) == _golden(events)


def test_plan_equals_jax():
    rng = random.Random(5)
    for _ in range(300):
        loads = {f"s{i}": rng.choice([0.0, 0.5, 1.0, 5.0, 50.0, 100.0, rng.random() * 200])
                 for i in range(rng.randint(0, 4))}
        ages = {b: rng.choice([None, 0.1, 9.9, 10.0, 30.0]) for b in range(rng.randint(0, 3))}
        kw = dict(skew_ratio=rng.choice([1.0, 2.0, 4.0]), dead_after_s=rng.choice([5.0, 10.0]),
                  min_load=rng.choice([0.0, 1.0, 10.0]))
        assert plan(loads, ages, **kw) == jreb.plan(loads, ages, **kw)


def test_plan_policy_pure_and_deterministic():
    assert plan({"s0": 10.0, "s1": 11.0}, {0: 0.1, 1: 0.2}) == []
    assert plan({"s0": 100.0, "s1": 5.0}, {0: 0.1, 1: 0.2}) == [
        {"kind": "migrate", "shard": "s0", "reason": "skew"}]
    acts = plan({"s0": 100.0, "s1": 5.0}, {0: 0.1, 1: None})
    assert acts[0] == {"kind": "recover_broker", "broker": 1, "reason": "broker_dead"}
    assert plan({"b": 50.0, "a": 50.0}, {0: 0.1}, skew_ratio=1.0) == [
        {"kind": "migrate", "shard": "a", "reason": "skew"}]


# ------------------------------------------------------------ the fleet
def test_partitioned_log_contract_parity(tmp_path):
    reg = MetricsRegistry()
    fleet = BrokerFleet(str(tmp_path), n_brokers=2, registry=reg)
    try:
        log = PartitionedRecordLog(fleet.clients(registry=reg), registry=reg)
        mem = P.RecordLog()
        for lg in (log, mem):
            assert lg.append("t", b"k1", b"v1", timestamp=5) == 0
            assert lg.append("t", b"k2", None) == 1
            assert lg.append("t", b"k3", b"v3", partition=2) == 0
        assert [tuple(r)[:4] for r in log.read("t")] == [tuple(r)[:4] for r in mem.read("t")]
        assert (log.topics(), log.partitions("t"), log.end_offset("t")) == (["t"], [0, 2], 2)
        assert log.read("t", start=0, max_records=1)[0].value == b"v1"
        log.flush()
        assert log.health()["brokers"] == 2
        a = PartitionedRecordLog(fleet.clients(registry=reg), registry=reg)
        for topic in ("letters", "matches", "x-y-z"):
            for part in range(4):
                assert a.broker_for(topic, part) == log.broker_for(topic, part)
        a.assign("letters", 0, 1)
        assert a.broker_for("letters", 0) == 1 and ("letters", 0) in a.partitions_on(1)
        a.close()
        log.close()
    finally:
        fleet.stop()


def test_move_partition_live_and_salvage_idempotent(tmp_path):
    reg = MetricsRegistry()
    fleet = BrokerFleet(str(tmp_path), n_brokers=2, registry=reg)
    try:
        log = PartitionedRecordLog(fleet.clients(registry=reg), registry=reg)
        for i in range(8):
            log.append("t", b"k%d" % i, b"v%d" % i, timestamp=i)
        log.flush()
        src = log.broker_for("t", 0)
        tgt = 1 - src
        assert log.move_partition("t", 0, tgt) == 8
        assert log.move_partition("t", 0, tgt, source_log=fleet.salvage_log(src)) == 0
        fleet.kill(tgt)
        log.mark_down(tgt, redirect_to=src)
        assert log.move_partition("t", 0, src, source_log=fleet.salvage_log(tgt)) == 0
        assert log.broker_for("t", 0) == src
        assert [r.value for r in log.read("t")] == [b"v%d" % i for i in range(8)]
        log.close()
    finally:
        fleet.stop()


def test_fence_blocks_poll_and_checkpoint_requires_fence(tmp_path):
    reg = MetricsRegistry()
    fleet = BrokerFleet(str(tmp_path), n_brokers=2, registry=reg)
    try:
        log = _fleet_view(fleet, reg)
        P.produce(log, "letters", "K", "A", timestamp=0)
        pipe = ShardPipeline("s0", lambda lg, sid: _topology(P, lg, sid, registry=reg), log,
                             partitions={"letters": (0,)}, registry=reg)
        with pytest.raises(RuntimeError):
            pipe.checkpoint()
        pipe.fence()
        with pytest.raises(RuntimeError):
            pipe.poll()
        cp = pserde.decode_shard_checkpoint(pipe.checkpoint())
        assert (cp["shard_id"], cp["group"]) == ("s0", "shard-s0")
        assert ("letters", 0) in cp["positions"] and set(cp["sessions"]) == {"0", "1"}
        pipe.close(close_log=True)
    finally:
        fleet.stop()


def _migrate_run(pkg, reb, part, tmp_path, events, runtime, polls=3):
    """Live migration across 2 socket brokers of `pkg`: a prefix on the
    source shard, fence + checkpoint + restore + resume on a successor
    over a second view. Returns the successor's sink digests, positions
    at the move, and the successor pipeline (closed)."""
    reg = pkg.MetricsRegistry() if pkg is J else MetricsRegistry()
    fleet = part.BrokerFleet(str(tmp_path / pkg.__name__), n_brokers=2, registry=reg)
    Sock = P.SocketRecordLog if pkg is P else J.SocketRecordLog
    try:
        def view(sessions=None, assignment=None):
            clients = []
            for i, server in enumerate(fleet.servers):
                kw = {}
                sess = (sessions or {}).get(str(i))
                if sess is not None:
                    kw.update(session=sess[0], start_seq=sess[1])
                clients.append(Sock(server.address, registry=reg, **kw))
            return part.PartitionedRecordLog(clients, registry=reg, assignment=assignment)

        src_log = view()
        for i, ch in enumerate(events):
            pkg.produce(src_log, "letters", "K", ch, timestamp=i)
        src_log.flush()

        def bt(lg, sid):
            return _topology(pkg, lg, sid, registry=reg, runtime=runtime)

        src = reb.ShardPipeline("s0", bt, src_log, partitions={"letters": (0,)}, registry=reg)
        consumed = sum(src.poll(max_records=4) for _ in range(polls))
        tgt = reb.RebalanceController(registry=reg).migrate(
            src, lambda sessions: view(sessions, src_log.assignment()), reason="skew")
        resumed_at = tgt.driver.position("letters", 0)
        while tgt.poll(max_records=4):
            pass
        tgt.driver.commit()
        final = _digests(tgt.log)
        migrations = reg._metrics["cep_rebalance_migrations_total"].labels(reason="skew").value
        tgt.close(close_log=True)
        return final, consumed, resumed_at, migrations, tgt
    finally:
        fleet.stop()


@pytest.mark.parametrize("runtime", ["host", "cuda"])
def test_live_migration_equals_jax_and_golden(tmp_path, runtime):
    """The acceptance property on both runtimes: the port's sink after a
    live migration equals the JAX package's migration on the same stream
    (the JAX device runtime is `"tpu"`) and the single-broker golden run,
    with zero duplicate digests; the successor resumed at the committed
    position."""
    events = _stream(11, n=24 if runtime == "cuda" else 36)
    golden = _golden(events, runtime=runtime)
    assert golden
    from kafkastreams_cep_tpu_torch.streams import partition as ppart
    from kafkastreams_cep_tpu_torch.streams import rebalance as preb

    final, consumed, resumed_at, migrations, tgt = _migrate_run(
        P, preb, ppart, tmp_path, events, runtime)
    jfinal, *_ = _migrate_run(J, jreb, jpart, tmp_path, events, "tpu" if runtime == "cuda" else "host")
    assert final == golden == jfinal
    assert len({d for d, _v in final}) == len(final), "duplicate emission"
    assert 0 < consumed == resumed_at < len(events)
    assert migrations == 1
    if runtime == "cuda":
        proc = tgt.topology.queries[0][1].processor
        assert proc.engine.device.type == "cpu"


def test_migration_never_from_zero(tmp_path):
    reg = MetricsRegistry()
    events = _stream(5, n=36)
    fleet = BrokerFleet(str(tmp_path), n_brokers=2, registry=reg)
    try:
        src_log = _fleet_view(fleet, reg)
        for i, ch in enumerate(events):
            P.produce(src_log, "letters", "K", ch, timestamp=i)
        src_log.flush()
        src = ShardPipeline("s0", lambda lg, sid: _topology(P, lg, sid, registry=reg), src_log,
                            partitions={"letters": (0,)}, registry=reg)
        consumed = sum(src.poll(max_records=4) for _ in range(4))
        assert 0 < consumed < len(events)
        tgt = RebalanceController(registry=reg).migrate(
            src, lambda s: _fleet_view(fleet, reg, sessions=s, assignment=src_log.assignment()))
        assert tgt.driver.position("letters", 0) == consumed
        remainder = 0
        while True:
            n = tgt.poll(max_records=4)
            if not n:
                break
            remainder += n
        assert consumed + remainder == len(events)
        tgt.close(close_log=True)
    finally:
        fleet.stop()


def test_broker_kill_salvage_and_migration_exactly_once(tmp_path):
    reg = MetricsRegistry()
    events = _stream(23, n=36)
    golden = _golden(events)
    fleet = BrokerFleet(str(tmp_path), n_brokers=2, registry=reg)
    try:
        src_log = _fleet_view(fleet, reg, io_timeout_s=2.0, retry_budget=2)
        for i, ch in enumerate(events):
            P.produce(src_log, "letters", "K", ch, timestamp=i)
        src_log.flush()
        src = ShardPipeline("s0", lambda lg, sid: _topology(P, lg, sid, registry=reg), src_log,
                            partitions={"letters": (0,)}, registry=reg)
        for _ in range(3):
            src.poll(max_records=4)
        src.driver.commit()
        dead = src_log.broker_for("letters", 0)
        survivor = 1 - dead
        fleet.kill(dead)
        ctl = RebalanceController(registry=reg)
        parts, recs = ctl.recover_broker([src_log], dead, survivor, fleet.salvage_log(dead))
        assert parts > 0 and recs > 0
        tgt = ctl.migrate(
            src, lambda s: _fleet_view(fleet, reg, sessions=s, assignment=src_log.assignment(),
                                       down={dead: survivor}),
            reason="broker_dead")
        while tgt.poll(max_records=4):
            pass
        tgt.driver.commit()
        final = _digests(tgt.log)
        assert final == golden and len({d for d, _v in final}) == len(final)
        assert tgt.driver.position("letters", 0) == len(events)
        assert reg._metrics["cep_rebalance_partition_moves_total"].value == parts
        tgt.close(close_log=True)
    finally:
        fleet.stop()


def test_crash_then_migration_emits_each_match_once():
    """A shard crashes before a commit with matches of its last poll in
    the sink; restarted, it commits once more before replay has
    regenerated them all, then migrates. The frame carries the digests
    still outstanding, the successor dedupes them, and its sink equals
    the golden run's, each match once. Once the successor has passed
    every record that existed at the restart, its persisted watermark
    sits at the sink's end with nothing outstanding."""
    events = _stream(11, n=36)
    golden = _golden(events)
    log = P.RecordLog()
    for i, ch in enumerate(events):
        P.produce(log, "letters", "K", ch, timestamp=i)

    def bt(lg, sid):
        return _topology(P, lg, sid, registry=MetricsRegistry())

    scope = {"letters": (0,)}
    crash = FaultPoint("driver.pre_commit", 3)
    with armed(FaultInjector(FaultSchedule([crash]), registry=MetricsRegistry())):
        src = ShardPipeline("s0", bt, log, partitions=scope)
        with pytest.raises(InjectedCrash):
            while src.poll(max_records=8):
                pass
    src = ShardPipeline("s0", bt, log, partitions=scope)
    assert src.topology.emission_outstanding() > 0
    src.poll(max_records=2)
    src.fence()
    frame = src.checkpoint()
    src.close()
    outstanding = pserde.decode_shard_checkpoint(frame)["queries"]["q"].get("recovered")
    assert outstanding, "the frame carries no outstanding digests"
    tgt = ShardPipeline("s0", bt, log, checkpoint=frame)
    assert tgt.driver.position("letters", 0) == 18
    while tgt.poll(max_records=4):
        pass
    tgt.driver.commit()
    final = _digests(log)
    assert final == golden and len({d for d, _v in final}) == len(final)
    changelog = next(t for t in log.topics() if t.endswith("-emitted-changelog"))
    last = pickle.loads(log.read(changelog)[-1].value)
    assert last.sink_pos == {"matches": log.end_offset("matches")} and last.recovered == []
    assert tgt.topology.emission_outstanding() == 0


def test_restored_cuda_shard_needs_the_card():
    """A `"cuda"` successor builds its engine where the node's options
    say: with no device named that is the card, and without one the
    restore raises instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    log = P.RecordLog()
    for i, ch in enumerate(_stream(3, n=12)):
        P.produce(log, "letters", "K", ch, timestamp=i)
    src = ShardPipeline("s0", lambda lg, sid: _topology(P, lg, sid, runtime="cuda"), log,
                        partitions={"letters": (0,)})
    src.poll(max_records=6)
    src.fence()
    blob = src.checkpoint()
    assert pserde.decode_shard_checkpoint(blob)["queries"]["q"]["runtime"] == "cuda"

    def on_the_card(lg, sid):
        builder = P.ComplexStreamsBuilder(log=lg, app_id=f"reb-{sid}")
        opts = {k: v for k, v in PORT_DEVICE_OPTS.items() if k != "device"}
        builder.stream("letters").query("q", _pattern(P, "cuda"), runtime="cuda", **opts).to("matches")
        return builder.build()

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardPipeline("s0", on_the_card, log, checkpoint=blob)


# ----------------------------------------------------- controller acceptance
def test_fleet_controller_acceptance_two_brokers(tmp_path):
    """A busy and an idle shard registry scraped by the controller: it
    sees the skew in `cep_driver_records_total` deltas alone, plans and
    executes a live migration through its callback; the successor
    finishes exactly once, its match.emit spans parent on the producer's
    root spans across the move, and /explainz serves the lineage."""
    events = _stream(11, n=36)
    reg, idle_reg = MetricsRegistry(), MetricsRegistry()
    idle_reg.counter("cep_driver_records_total", "h", labels=("group",)).labels(group="idle")
    prod_tracer, broker_tracer = SpanTracer(MetricsRegistry()), SpanTracer(MetricsRegistry())
    fleet = BrokerFleet(str(tmp_path), n_brokers=2, registry=reg, tracer=broker_tracer)
    tgt = http = None
    try:
        src_log = _fleet_view(fleet, reg)
        for i, ch in enumerate(events):
            P.produce(src_log, "letters", "K", ch, timestamp=i, trace=True, tracer=prod_tracer)
        src_log.flush()
        src = ShardPipeline("s0", lambda lg, sid: _topology(P, lg, sid, registry=reg), src_log,
                            partitions={"letters": (0,)}, registry=reg)
        reb = RebalanceController(registry=reg)
        migrated = []

        def execute(action):
            assert action["kind"] == "migrate" and action["shard"] == "s0"
            migrated.append(reb.migrate(
                src, lambda s: _fleet_view(fleet, reg, sessions=s, assignment=src_log.assignment()),
                reason=str(action["reason"])))
            return "migrated"

        ctl = FleetController(
            {"s0": reg, "idle": idle_reg}, registry=MetricsRegistry(),
            policy=ControllerPolicy(skew_ratio=2.0, min_load=1.0, cooldown_s=60.0,
                                    latency_p99_budget_s=60.0),
            execute=execute,
        )
        ctl.tick()
        for _ in range(3):
            src.poll(max_records=4)
        time.sleep(0.02)
        decision = ctl.tick()
        assert [a["kind"] for a in decision["planned"]] == ["migrate"]
        assert decision["executed"][0]["result"] == "migrated" and src.fenced
        tgt = migrated[0]
        while tgt.poll(max_records=4):
            pass
        tgt.driver.commit()
        digests = [decode_sink_key(r.key)[1] for r in tgt.log.read("matches")]
        assert digests and len(set(digests)) == len(digests)
        assert reg._metrics["cep_driver_records_total"].labels(group="shard-s0").value == len(events)
        roots = {s["span_id"]: s["trace_id"] for s in prod_tracer.recent(512, name="produce")}
        emits = tgt.driver.tracer.recent(512, name="match.emit")
        assert any(roots.get(s["parent_id"]) == s["trace_id"] for s in emits)
        hops = broker_tracer.recent(1024, name="broker.append")
        assert hops and all(h["parent_id"] in roots for h in hops)
        doc = stitched_chrome_trace(prod_tracer, broker_tracer, tgt.driver.tracer,
                                    names=["producer", "brokers", "successor"])
        assert any(e.get("name") == "propagate" for e in doc["traceEvents"])
        http = tgt.driver.serve_http(port=0)
        with urlopen(http.url + "/explainz?limit=64", timeout=5) as resp:
            body = json.loads(resp.read().decode("utf-8"))
        assert body["kind"] == "explain" and body["matches"][0]["trace_id"]
        assert ctl.state()["actions"] == 1
    finally:
        if http is not None:
            http.stop()
        if tgt is not None:
            tgt.close(close_log=True)
        fleet.stop()
