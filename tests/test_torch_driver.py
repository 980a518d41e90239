"""The port's `LogDriver` (streams/driver.py) against the JAX package's,
on the CPU.

  * poll / commit / restart / dead letters: the same records (8 keys,
    arrivals shuffled within the lateness bound, one record whose bytes
    do not deserialize and one whose value the schema cannot pack)
    produced into a file-backed `RecordLog` of each package, pumped by
    each package's `LogDriver` over its gated device topology (the
    port's `runtime="cuda"`, the JAX `runtime="tpu"` with
    `engine="xla"`), committing every poll; half way the driver,
    topology and engine are dropped and rebuilt on the same files. Both
    sinks hold the same records (keys, emission digests, payloads) in
    the same order, equal to the port's uninterrupted run, each match
    once; both dead-letter topics hold the same two records; the port's
    metric names are a subset of the JAX run's, and
    `cep_match_latency_seconds` counts one sample per sink match of the
    uninterrupted run and, across the restart, as many as the JAX run;
  * an engine failure is not poison: a failed native build or decode
    of a flush that `poll` started raises out of `LogDriver.poll` with
    the dead-letter topic empty and nothing committed (the JAX driver
    dead-letters it as a predicate failure and moves on);
  * the fault sites of the port (faults/injection.py): a transient
    `engine.device_step` is retried, crashes at `engine.mid_drain`,
    `driver.pre_commit` and `log.torn_append` recover from disk, and the
    sink equals the fault-free run's, duplicate-free;
  * the introspection plane: `serve_http` answers /healthz (event-time
    plane, dead letters), /metrics, /tracez?kind=match (provenance
    exemplars) and /explainz (lineage with the producer's trace id);
    `SpanTracer.device` writes a torch.profiler trace and a second
    concurrent capture degrades to `cep_profiler_unavailable`.

The JAX side shares one engine configuration with
tests/test_torch_event_time.py (K = 8, the skip-till-any pattern).
"""
import json
import random
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.streams.driver import LogDriver as JaxLogDriver  # noqa: E402
from kafkastreams_cep_tpu.streams.driver import produce as jax_produce  # noqa: E402
from kafkastreams_cep_tpu.streams.log import RecordLog as JaxRecordLog  # noqa: E402
from kafkastreams_cep_tpu_torch.faults import (  # noqa: E402
    FaultInjector, FaultPoint, FaultSchedule, InjectedCrash, armed,
)
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from kafkastreams_cep_tpu_torch.obs.trace import SpanTracer  # noqa: E402
from kafkastreams_cep_tpu_torch.state.store import default_deserializer  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.driver import dlq_topic  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key  # noqa: E402

TS = 1_000_000
BOUND_MS = 4
KEYS = [f"k{i}" for i in range(8)]
CFG = dict(lanes=128, nodes=1024, matches=2048, matches_per_step=128,
           strict_windows=True, reorder_capacity=64, lateness_ms=6)
JAX_OFF = dict(engine="xla", exact_replay=False, compile_telemetry=False)
TOPIC = "letters"


def skipany_pattern(pkg, window_ms=16):
    v = pkg.value
    return (
        pkg.QueryBuilder()
        .select("a").where(v() == "A").within(ms=window_ms)
        .then()
        .select("b", pkg.Selected.with_skip_til_any_match())
        .where(v() == "B").within(ms=window_ms)
        .then()
        .select("c", pkg.Selected.with_skip_til_next_match())
        .where(v() == "C").within(ms=window_ms)
        .build()
    )


def _records(n=240, seed=5):
    """(key, value, ts) in arrival order: keys interleaved, event time
    displaced within BOUND_MS; record 37's value cannot be packed."""
    rng = random.Random(seed)
    evs, ts = [], TS
    for _ in range(n):
        ts += rng.choice((0, 0, 1))
        evs.append((rng.choice(KEYS), rng.choice("ABCX"), ts))
    order = sorted(range(n), key=lambda i: (evs[i][2] + rng.randint(0, BOUND_MS), i))
    out = [evs[i] for i in order]
    out[37] = (out[37][0], {"not": "a letter"}, out[37][2])
    return out


def _produce_all(log, produce):
    for i, (key, value, ts) in enumerate(_records()):
        produce(log, TOPIC, key, value, timestamp=ts)
        if i == 90:
            log.append(TOPIC, b"\x00not a pickle", b"\x00neither", timestamp=ts)
    log.flush()


def _topology(pkg, log, registry):
    if pkg is J:
        opts = dict(JAX_OFF, runtime="tpu", config=JaxEngineConfig(**CFG))
    else:
        opts = dict(runtime="cuda", device="cpu", config=P.EngineConfig(**CFG))
    builder = pkg.ComplexStreamsBuilder(log=log)
    builder.stream(TOPIC).query("letters", skipany_pattern(pkg), batch_size=16,
                                registry=registry, **opts).to("matches")
    return builder.build()


def _pump(pkg, path, restart_after=None):
    """Produce, then poll 7 records at a time committing each poll; after
    `restart_after` polls drop everything but the files and rebuild."""
    log_cls, driver_cls, reg_cls, produce = (
        (JaxRecordLog, JaxLogDriver, JaxRegistry, jax_produce) if pkg is J
        else (P.RecordLog, P.LogDriver, MetricsRegistry, P.produce))
    log = log_cls(str(path))
    _produce_all(log, produce)
    regs, restored = [], []
    polls = 0
    while True:
        reg = reg_cls()
        regs.append(reg)
        driver = driver_cls(_topology(pkg, log, reg), group="g", registry=reg)
        restored.append(driver.restored_records)
        while driver.poll(max_records=7):
            polls += 1
            if polls == restart_after:
                break
        else:
            driver.drain_event_time()
            break
        log.close()
        log = log_cls(str(path))
    sink = [(decode_sink_key(r.key), r.value, r.timestamp) for r in log.read("matches")]
    dlq = [(r.key, r.value, r.timestamp) for r in log.read(dlq_topic(TOPIC))]
    health = driver.health()
    log.close()
    return {"sink": sink, "dlq": dlq, "regs": regs, "restored": restored, "health": health}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("driver")
    return {
        "jax": _pump(J, base / "jax", restart_after=9),
        "port": _pump(P, base / "port", restart_after=9),
        "port_whole": _pump(P, base / "whole"),
    }


def test_driver_restart_sink_equals_jax_and_the_uninterrupted_run(runs):
    port, jax = runs["port"], runs["jax"]
    assert len(port["sink"]) > 20
    assert port["sink"] == jax["sink"]
    assert port["sink"] == runs["port_whole"]["sink"]
    digests = [key[1] for key, _v, _t in port["sink"]]
    assert None not in digests and len(set(digests)) == len(digests)
    assert port["restored"] == jax["restored"] and port["restored"][1] > 0


def test_driver_dead_letters_equal_jax(runs):
    port, jax = runs["port"], runs["jax"]
    assert port["dlq"] == jax["dlq"] and len(port["dlq"]) == 2
    reasons = [default_deserializer(key)[4] for key, _v, _t in port["dlq"]]
    assert sorted(reasons) == ["deserialize", "predicate"]
    assert port["health"]["dead_letters_by_reason"] == jax["health"]["dead_letters_by_reason"]
    assert runs["port_whole"]["health"]["dead_letters_by_reason"] == {
        f"{TOPIC}/deserialize": 1.0, f"{TOPIC}/predicate": 1.0}
    assert port["health"]["event_time"] == jax["health"]["event_time"]
    assert port["health"]["event_time"]["gated_queries"] == 1


def test_driver_metric_names_are_jax_names_and_latency_counts_every_match(runs):
    port, jax = runs["port"], runs["jax"]
    names = set().union(*(r.names() for r in port["regs"]))
    # The JAX engines here run without compile telemetry: its CompileWatch
    # names come from a watch of their own.
    from kafkastreams_cep_tpu.obs.compile import CompileWatch as JaxCompileWatch

    jax_names = set().union(*(r.names() for r in jax["regs"]))
    assert names <= jax_names | set(JaxCompileWatch(JaxRegistry()).registry.names())
    for name in ("cep_driver_polls_total", "cep_driver_commits_total",
                 "cep_driver_dead_letters_total", "cep_match_latency_seconds",
                 "cep_reorder_released_total", "cep_span_seconds"):
        assert name in names, name

    def latency(run):
        return [r.get("cep_match_latency_seconds").labels(query="letters").count
                for r in run["regs"]]

    # Uninterrupted, every sink match is observed once. Across a restart
    # a match whose completing record was polled (stamped) before it and
    # restored from the snapshot's gate buffer has no stamp: as in JAX.
    assert latency(runs["port_whole"]) == [len(runs["port_whole"]["sink"])]
    assert latency(port) == latency(jax)


def _break_build(monkeypatch, _topo):
    from kafkastreams_cep_tpu_torch import native

    def broken(name, cxx=None, build_dir=None):
        raise native.NativeBuildError(f"building the native {name} failed: test")

    monkeypatch.setattr(native, "build_ext", broken)
    monkeypatch.setattr(native, "_mods", {})
    return native.NativeBuildError, "failed: test"


def _break_decoder(_monkeypatch, topo):
    class BrokenDecoder:
        def decode_matches_flat(self, *args):
            raise RuntimeError("decoder failed")

    topo.queries[0][1].processor.engine._decoder = BrokenDecoder()
    return RuntimeError, "decoder failed"


@pytest.mark.parametrize("breakage", [_break_build, _break_decoder],
                         ids=["native_build", "decode"])
def test_engine_failure_raises_out_of_poll_and_commits_nothing(monkeypatch, breakage):
    """A failed build or decode of a flush that `poll` started is the
    engine's, not the record's: it raises out of `LogDriver.poll`, the
    dead-letter topic stays empty and no offset is committed, so a
    restart replays the whole batch."""
    log = P.RecordLog()
    for i, (key, value, ts) in enumerate(_records()):
        if i != 37:  # no pack poison: nothing may land in the DLQ
            P.produce(log, TOPIC, key, value, timestamp=ts)
    reg = MetricsRegistry()
    topo = _topology(P, log, reg)
    exc_type, message = breakage(monkeypatch, topo)
    driver = P.LogDriver(topo, group="g", registry=reg)
    with pytest.raises(exc_type, match=message):
        driver.poll()
    assert log.read(dlq_topic(TOPIC)) == []
    assert log.read("__consumer_offsets") == []
    assert topo.take_poisoned() == []
    assert reg.get("cep_driver_dead_letters_total").labels(
        topic=TOPIC, reason="predicate").value == 0


def _fault_run(tmp_path, schedule, registry):
    path = str(tmp_path / "wal")
    log = P.RecordLog(path)
    _produce_all(log, P.produce)
    crashes = 0
    with armed(FaultInjector(schedule, registry=registry)):
        while True:
            try:
                reg = MetricsRegistry()
                driver = P.LogDriver(_topology(P, log, reg), group="g", registry=reg)
                while driver.poll(max_records=7):
                    pass
                driver.drain_event_time()
                break
            except InjectedCrash:
                crashes += 1
                assert crashes <= 8
                log.close()
                log = P.RecordLog(path)
    sink = [(decode_sink_key(r.key)[1], r.value) for r in log.read("matches")]
    log.close()
    return sink, crashes


def test_fault_sites_recover_exactly_once(tmp_path, runs):
    golden = [(key[1], v) for key, v, _t in runs["port_whole"]["sink"]]
    schedule = FaultSchedule([
        FaultPoint("engine.device_step", 2), FaultPoint("engine.mid_drain", 3),
        FaultPoint("driver.pre_commit", 4), FaultPoint("log.torn_append", 30),
    ])
    reg = MetricsRegistry()
    sink, crashes = _fault_run(tmp_path, schedule, reg)
    assert all(p.fired for p in schedule.points)
    assert crashes == 3
    assert sorted(sink) == sorted(golden)
    assert len({d for d, _v in sink}) == len(sink)
    fired = reg.get("cep_faults_injected_total")
    assert fired.labels(site="engine.device_step").value == 1


def test_introspection_plane_serves_provenance_lineage_and_traces(tmp_path):
    log = P.RecordLog()
    prod = SpanTracer(MetricsRegistry())
    rng = random.Random(3)
    for i in range(40):
        P.produce(log, TOPIC, KEYS[i % 2], rng.choice("ABC"), timestamp=TS + i,
                  trace=True, tracer=prod)
    reg = MetricsRegistry()
    builder = P.ComplexStreamsBuilder(log=log)
    builder.stream(TOPIC).query("letters", skipany_pattern(P), runtime="cuda", device="cpu",
                                batch_size=8, config=P.EngineConfig(**CFG), registry=reg,
                                provenance_sample=1.0, sink_format="json").to("matches")
    driver = P.LogDriver(builder.build(), registry=reg)
    srv = driver.serve_http(port=0)
    try:
        while driver.poll(max_records=16):
            pass
        driver.drain_event_time()

        def get(path):
            with urllib.request.urlopen(srv.url + path, timeout=10) as resp:
                return resp.read().decode()

        health = json.loads(get("/healthz"))
        assert health["event_time"]["gated_queries"] == 1 and health["polls"] >= 3
        assert "cep_match_latency_seconds" in get("/metrics")
        matches = json.loads(get("/tracez?kind=match&limit=500"))["matches"]
        n_sink = len(log.read("matches"))
        assert n_sink > 0 and len(matches) == n_sink
        assert {m["key"] for m in matches} <= set(KEYS[:2])
        explained = json.loads(get("/explainz?limit=500"))["matches"]
        assert len(explained) == n_sink
        roots = {s["span_id"] for s in prod.recent(100) if s["span"] == "produce"}
        for entry in explained:
            assert entry["trace_id"] is not None and entry["stage_path"] == ["a", "b", "c"]
            assert entry["events"] and entry["latency_s"] is not None
        emits = [s for s in driver.tracer.recent(500) if s["span"] == "match.emit"]
        assert emits and all(s["parent_id"] in roots for s in emits)
    finally:
        driver.close()
    assert reg.get("cep_match_latency_seconds").labels(query="letters").count == n_sink
    assert reg.get("cep_provenance_sampled_total").labels(query="letters").value == n_sink
    assert reg.get("cep_sink_matches_total").labels(query="letters", format="json").value == n_sink


def test_device_trace_writes_a_torch_profile_and_degrades_when_busy(tmp_path):
    reg = MetricsRegistry()
    tracer = SpanTracer(reg)
    with tracer.device(str(tmp_path / "outer")):
        with tracer.device(str(tmp_path / "inner")):
            torch.ones(8).sum()
    assert (tmp_path / "outer" / "trace.json").exists()
    assert not (tmp_path / "inner").exists()
    busy = reg.get("cep_profiler_unavailable")
    assert busy.labels(reason="a device trace is already active").value == 1
    assert reg.get("cep_span_total").labels(span="device_trace").value == 2


def test_ingest_stamps_outlive_a_micro_batch_and_evict_oldest_first():
    """The stamp map keeps at least two micro-batches of the largest
    query (the JAX bound, 65,536, is less than one flagship flush) and
    evicts the oldest stamps first."""
    builder = P.ComplexStreamsBuilder()
    builder.stream(TOPIC).query("letters", skipany_pattern(P), runtime="cuda", device="cpu",
                                batch_size=40_000, config=P.EngineConfig(lanes=8, nodes=64),
                                registry=MetricsRegistry())
    topo = builder.build()
    assert topo.ingest_stamps_max == 80_000 > topo.INGEST_STAMPS_MAX
    topo.ingest_stamps_max = 3
    for offset in range(5):
        topo.stamp_ingest(TOPIC, 0, "k0", offset, float(offset))
    assert [k[3] for k in topo._ingest_stamps] == [2, 3, 4]
