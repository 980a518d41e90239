"""The port's drain and capacity controllers, micro-drains and decode
worker, against the JAX package's.

  * `DrainController`, `CapacityAutosizer` and `AdmissionPacer` of both
    packages drive the same jax-free fake engine through the same
    observation sequence (probe readings, lane occupancy, drop counters,
    latency and compute samples, a scripted clock): `state()`, the
    engine's config and knobs are equal after every tick;
  * on a port engine: the controller arms the micro-drain dial; a settled
    controller is compile-flat by the engine's `compile_watch` (a resize
    adds one step-kernel signature, a `gc_group` step none);
  * micro-drains (`target_emit_ms`, tests/test_gc_groups.py's cases):
    matches equal the deferred-decode run and the JAX engine's `drain()`
    output, in order, the flushes stay advances / gc_group, the pulls are
    more than 2 and at most 10, and the dial stays silent on a
    match-free stream once a probe saw the empty ring;
  * a probe retired by a pull still reads the live lanes;
  * the decode worker: auto-drained matches come out FIFO ahead of the
    drain's own; an error on the worker re-raises from the join and
    nothing decodes the table again; `resize` and `close` shut the worker
    down and keep its results;
  * `LogDriver(pacing=True)`: the sink equals the unpaced run's and the
    JAX paced driver's; the budgets are powers of two in the pacer's
    range.
"""
import random
import threading
from dataclasses import dataclass, replace

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.parallel import drain_sched as jax_sched  # noqa: E402
from kafkastreams_cep_tpu.state.serde import ShapeRestoreError as JaxShapeRestoreError  # noqa: E402
from kafkastreams_cep_tpu.streams.builder import ComplexStreamsBuilder as JaxBuilder  # noqa: E402
from kafkastreams_cep_tpu.streams.driver import LogDriver as JaxLogDriver  # noqa: E402
from kafkastreams_cep_tpu.streams.driver import produce as jax_produce  # noqa: E402
from kafkastreams_cep_tpu.streams.log import RecordLog as JaxRecordLog  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import letters_pattern, letters_stream  # noqa: E402
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel import drain_sched as port_sched  # noqa: E402
from kafkastreams_cep_tpu_torch.state.serde import ShapeRestoreError  # noqa: E402

TS = 1_000_000


# ------------------------------------------------------------ control laws
@dataclass(frozen=True)
class FakeConfig:
    lanes: int = 8
    nodes: int = 256
    matches: int = 64
    matches_per_step: int = 4
    gc_group: int = 8


class FakeEngine:
    """The surface the controllers read and move, host-only: one per
    package (its registry and its ShapeRestoreError)."""

    def __init__(self, registry, shape_error, cfg=FakeConfig()):
        self.config = cfg
        self.metrics = registry
        self.shape_error = shape_error
        self.query_name = "fake"
        self.instance_id = "i0"
        self.keys = ["k0", "k1", "k2", "k3"]
        self.target_emit_ms = None
        self.gc_group = cfg.gc_group
        self.lane_obs = None
        self.occ = (0, 0, None)
        self.flushed = 0
        self.refuse_below = None  # lanes a resize may not go under

    def _occupancy_bound(self):
        return self.occ

    def _flush_group(self):
        self.flushed += 1

    def resize(self, cfg):
        if self.refuse_below is not None and cfg.lanes < self.refuse_below:
            raise self.shape_error("live lanes would not fit")
        changed = cfg != self.config
        self.config = cfg
        return changed


class Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


#: One tick: (probe (occ, fill, pos), lane_obs, drop deltas {counter: n},
#: latency samples (s), compute (advance_s, post_s) or None, events, t).
def _scenario(name):
    hot_lat = [2.0] * 40
    cool_lat = [0.001] * 600
    steps = {
        "latency_aimd": [((1, 10, 1), 2, {}, hot_lat, None, 100, None)] * 6
        + [((0, 10, 0), 2, {}, cool_lat, None, 100, None)] * 12,
        "ring_hot": [((40, 10, 40), 2, {}, [], None, 64, None)] * 4
        + [((2, 10, 2), 2, {}, [], None, 64, None)] * 6,
        "gc_halving": [((0, 240, 0), 2, {}, [], None, 10, None)] * 12,
        "gc_doubling_on_post": [((0, 10, 0), 2, {}, [], (0.001, 0.01), 10, None)] * 20,
        "drop_reactive": [((5, 10, 5), 3, {}, [], None, 10, 4),
                          ((5, 10, 5), 3, {"match_drops": 3}, [], None, 10, 4),
                          ((5, 10, 5), 3, {"lane_drops": 1, "node_drops": 2}, [], None, 10, 4),
                          ((5, 10, 5), 3, {}, [], None, 10, 4)],
        "proactive_grow": [((120, 10, 120), 15, {}, [], None, 10, None)] * 20,
        "patience_shrink": [((60, 230, 60), 7, {}, [], None, 10, None)]
        + [((1, 5, 1), 1, {}, [], None, 10, None)] * 12,
        "refused_shrink": [((60, 10, 60), 7, {}, [], None, 10, None)]
        + [((1, 5, 1), 1, {}, [], None, 10, None)] * 10,
    }
    return steps[name]


SCENARIOS = ("latency_aimd", "ring_hot", "gc_halving", "gc_doubling_on_post",
             "drop_reactive", "proactive_grow", "patience_shrink", "refused_shrink")


def _arm(sched, registry_cls, shape_error, name, clock, monkeypatch):
    monkeypatch.setattr(sched, "_time", clock)
    eng = FakeEngine(registry_cls(), shape_error)
    if name.startswith("gc_") or name in ("latency_aimd", "ring_hot"):
        ctl = sched.DrainController(eng, compile_budget=3, cooldown=2)
    else:
        ctl = sched.CapacityAutosizer(eng, compile_budget=4, cooldown=2, shrink_patience=3)
    if name == "refused_shrink":
        eng.refuse_below = 16
    drops = eng.metrics.counter("cep_overflow_dropped_total", "", labels=("counter",))
    lat = eng.metrics.histogram("cep_match_latency_seconds", "", labels=("query",))
    comp = eng.metrics.histogram("cep_advance_compute_seconds", "",
                                 labels=("instance", "phase"))
    return eng, ctl, drops, lat.labels(query="fake"), comp


@pytest.mark.parametrize("name", SCENARIOS)
def test_controllers_state_equals_jax_every_tick(name, monkeypatch):
    clocks = (Clock(), Clock())
    sides = [
        _arm(port_sched, MetricsRegistry, ShapeRestoreError, name, clocks[0], monkeypatch),
        _arm(jax_sched, JaxRegistry, JaxShapeRestoreError, name, clocks[1], monkeypatch),
    ]
    for tick, (occ, lanes, drop, lat, comp, events, t) in enumerate(_scenario(name)):
        states = []
        for (eng, ctl, drops, hist, compute), clock in zip(sides, clocks):
            clock.t += 0.05
            eng.occ, eng.lane_obs = occ, lanes
            for counter, n in drop.items():
                drops.labels(counter=counter).inc(n)
            for v in lat:
                hist.observe(v)
            if comp is not None:
                compute.labels(instance="i0", phase="advance").observe(comp[0])
                compute.labels(instance="i0", phase="post").observe(comp[1])
            if isinstance(ctl, port_sched.DrainController) or isinstance(
                    ctl, jax_sched.DrainController):
                st = ctl.observe(events=events)
            else:
                st = ctl.observe(events=events, t=t)
            states.append((st, eng.config, eng.target_emit_ms, eng.gc_group, eng.flushed))
        assert states[0] == states[1], (name, tick)
    eng, ctl = sides[0][0], sides[0][1]
    moved = {
        "latency_aimd": lambda: ctl.state()["adjustments"] > 6,
        "ring_hot": lambda: eng.target_emit_ms < ctl.max_emit_ms,
        "gc_halving": lambda: eng.gc_group == 1 and eng.flushed == 3,
        "gc_doubling_on_post": lambda: eng.gc_group == 64,
        "drop_reactive": lambda: eng.config.matches_per_step == 8 and ctl.resizes >= 2,
        "proactive_grow": lambda: ctl.resizes == 2 and eng.config.lanes == 32,
        "patience_shrink": lambda: ctl.resizes == 2 and eng.config.lanes == 8,
        "refused_shrink": lambda: ctl.refused >= 1 and eng.config.lanes == 16,
    }[name]
    assert moved(), ctl.state()


def test_ensure_page_and_admission_pacer_equal_jax(monkeypatch):
    clocks = (Clock(), Clock())
    for sched, clock in zip((port_sched, jax_sched), clocks):
        monkeypatch.setattr(sched, "_time", clock)
    engs = [FakeEngine(MetricsRegistry(), ShapeRestoreError),
            FakeEngine(JaxRegistry(), JaxShapeRestoreError)]
    autos = [port_sched.CapacityAutosizer(engs[0]), jax_sched.CapacityAutosizer(engs[1])]
    for t in (8, 16, 100):
        for a in autos:
            a.ensure_page(t)
        assert engs[0].config == engs[1].config
        assert autos[0].state() == autos[1].state()
    assert engs[0].config.matches == 512
    pacers = [port_sched.AdmissionPacer(registry=MetricsRegistry(), group="g"),
              jax_sched.AdmissionPacer(registry=JaxRegistry(), group="g")]
    for n, dt in ((0, 0.1), (32, 0.05), (5000, 0.2), (100_000, 0.5), (10, 1.0)):
        for pacer, clock in zip(pacers, clocks):
            clock.t += dt
            pacer.observe(n)
        assert pacers[0].state() == pacers[1].state()
    with pytest.raises(ValueError):
        port_sched.AdmissionPacer(target_poll_ms=0)


# ------------------------------------------------------- on a port engine
def abc_pattern(pkg=P):
    return (pkg.QueryBuilder()
            .select("a").where(pkg.value() == "A")
            .then().select("b").where(pkg.value() == "B")
            .then().select("c").where(pkg.value() == "C")
            .build())


def _port_engine(engine="torch", **cfg_kw):
    """tests/test_drain_sched.py's `mk_engine`, on the port."""
    cfg = P.EngineConfig(lanes=8, nodes=64, matches=32, **cfg_kw)
    return P.BatchedDeviceNFA(P.compile_pattern(abc_pattern()), keys=["k0", "k1"], config=cfg,
                              device="cpu", engine=engine, query_name="q1",
                              registry=MetricsRegistry())


def _feed(bat, n, start=0):
    bat.advance({k: [P.Event(k, "ABC"[i % 3], TS + start + i, "t", 0, start + i)
                     for i in range(n)] for k in ("k0", "k1")})


def test_controller_arms_the_dial_on_a_port_engine():
    bat = _port_engine()
    assert bat.target_emit_ms is None
    ctl = P.parallel.DrainController(bat, max_emit_ms=800.0)
    assert bat.target_emit_ms == 800.0
    st = ctl.observe(events=12)
    assert st["target_emit_ms"] == 1000.0 * 0.8 and st["gc_group"] == 1
    assert bat.metrics.get("cep_drain_controller_target_emit_ms").labels(query="q1").value == 800.0


def test_steady_state_is_compile_flat_by_compile_watch():
    """tests/test_drain_sched.py's pin with the port's kernel-signature
    count (engine="cuda": the kernel's wrapper, which runs the plain step
    on CPU tensors, still names its signature)."""
    bat = _port_engine(engine="cuda", matches_per_step=4)
    assert bat.compile_watch.seen_count == 1
    ctl = P.parallel.DrainController(bat)
    for i in range(4):
        _feed(bat, 6, start=i * 6)
        ctl.observe(events=12)
    bat.drain()
    settled = bat.compile_watch.seen_count
    for i in range(4, 10):
        _feed(bat, 6, start=i * 6)
        ctl.observe(events=12)
        bat.drain()
    assert bat.compile_watch.seen_count == settled == 1
    assert ctl.state()["compiles_seen"] == settled
    # A gc_group step changes no kernel source; a resize is one new one.
    bat._pos_obs = (bat._pend_accum, 0, int(bat.config.nodes * 0.9))
    bat.gc_group = 4
    _feed(bat, 6, start=60)
    assert bat.compile_watch.seen_count == 1
    assert bat.resize(replace(bat.config, lanes=16))
    assert bat.compile_watch.seen_count == 2
    assert bat.compile_watch.compiles("nfa_step") == 2
    assert bat.resize(replace(bat.config, lanes=8))  # back: a signature seen before
    assert bat.compile_watch.seen_count == 2


# ------------------------------------------------------------ micro-drains
#: tests/test_gc_groups.py's micro-drain config.
GC_CFG = dict(lanes=16, nodes=256, matches=4096, gc_group=4, matches_per_step=4,
              nodes_per_step=8)


def _letter_streams(pkg):
    """tests/test_gc_groups.py's `letter_stream(980 + i, 36, k)` for 2 keys."""
    out = {}
    for i in range(2):
        rng = random.Random(980 + i)
        out[f"k{i}"] = [pkg.Event(f"k{i}", rng.choice("ABCD"), TS + j, "t", 0, j)
                        for j in range(36)]
    return out


def _micro_run(pkg, target, streams=None):
    streams = streams or _letter_streams(pkg)
    if pkg is P:
        bat = P.BatchedDeviceNFA(P.compile_pattern(abc_pattern()), keys=list(streams),
                                 config=P.EngineConfig(**GC_CFG), device="cpu",
                                 target_emit_ms=target)
    else:
        bat = JaxBatched(J.compile_pattern(abc_pattern(J)), keys=list(streams),
                         config=JaxEngineConfig(**GC_CFG), target_emit_ms=target)
    pulls = [0]
    orig = bat._pull_raw

    def counting(**kw):
        pulls[0] += 1
        return orig(**kw)

    bat._pull_raw = counting
    for b in range(9):
        bat.advance_packed(bat.pack({k: s[b * 4:(b + 1) * 4] for k, s in streams.items()}),
                           decode=False)
    return bat.drain(), pulls[0], bat


def test_micro_drains_equal_deferred_decode_and_the_jax_drain():
    want, pulls_off, _ = _micro_run(P, None)
    got, pulls_on, bat = _micro_run(P, 0.0)
    j_got, _j_pulls, j_bat = _micro_run(J, 0.0)
    assert got == want and sum(map(len, got.values())) > 0
    assert {k: [P.sequence_to_json(s) for s in v] for k, v in got.items()} == {
        k: [jax_json(s) for s in v] for k, v in j_got.items()}
    assert pulls_off == 1
    assert 2 < pulls_on <= 10
    assert bat.stats["match_drops"] == 0
    assert bat.flushes == 2 == j_bat.flushes  # 9 advances at G=4, micro-drains or not
    micro = bat.metrics.get("cep_auto_drains_total").labels(trigger="micro_drain").value
    assert micro == pulls_on - 1


def test_micro_drain_gates_on_the_probed_cursor():
    quiet = {"k0": [P.Event("k0", "X", TS + i, "t", 0, i) for i in range(36)]}
    got, pulls, _ = _micro_run(P, 0.0, streams=quiet)
    assert got == {}
    assert pulls <= 5, "a match-free micro-drain must go probe-silent"


def test_a_probe_retired_by_a_pull_still_reads_the_live_lanes():
    """On the card a probe lands after the advance's own pull (a
    micro-drain, a processor's drain) has retired it; its live-lane count
    is still the autosizer's lane signal, its ring reading is not."""
    streams = _letter_streams(P)
    bat = _ring_engine()
    bat.advance_packed(bat.pack({k: s[:4] for k, s in streams.items()}), decode=False)
    assert bat._pos_probes and bat.lane_obs is None
    bat._ring_cleared()  # what a pull does before the probe is read
    bat._occupancy_bound()
    assert bat.lane_obs == int(bat.state["active"].sum(0).max()) > 0
    assert bat._pos_obs is None


# ---------------------------------------------------------- decode worker
def _ring_engine(**kw):
    """A one-page ring, so every deferred advance after the first pulls
    (ring_full) onto the worker."""
    cfg = P.EngineConfig(lanes=16, nodes=256, matches=16, matches_per_step=4,
                         nodes_per_step=8)
    return P.BatchedDeviceNFA(P.compile_pattern(abc_pattern()), keys=["k0", "k1"],
                              config=cfg, device="cpu", **kw)


def _drive(bat, streams, n=9, drain_every=None):
    out = {}
    for b in range(n):
        bat.advance_packed(bat.pack({k: s[b * 4:(b + 1) * 4] for k, s in streams.items()}),
                           decode=False)
        if drain_every and (b + 1) % drain_every == 0:
            for k, v in bat.drain().items():
                out.setdefault(k, []).extend(map(P.sequence_to_json, v))
    for k, v in bat.drain().items():
        out.setdefault(k, []).extend(map(P.sequence_to_json, v))
    return out


def test_auto_drains_decode_fifo_on_the_worker():
    streams = _letter_streams(P)
    ring = _ring_engine()
    got = _drive(ring, streams)
    ring_full = ring.metrics.get("cep_auto_drains_total").labels(trigger="ring_full").value
    assert ring_full >= 2
    assert got == _drive(_ring_engine(auto_drain=False), streams, drain_every=1)
    assert ring._decode_pool is not None
    ring.close()
    assert ring._decode_pool is None


def test_worker_error_reraises_from_the_join_and_decodes_nothing_twice():
    streams = _letter_streams(P)
    bat = _ring_engine()
    calls = []

    def failing(raw, trigger="drain", events=None):
        calls.append(threading.current_thread().name)
        raise RuntimeError("decode failed")

    bat._decode_flat = failing
    for b in range(9):
        bat.advance_packed(bat.pack({k: s[b * 4:(b + 1) * 4] for k, s in streams.items()}),
                           decode=False)
    n_pulled = len(bat._decode_futs)
    assert n_pulled >= 2
    with pytest.raises(RuntimeError, match="decode failed"):
        bat.drain()
    # Each pulled table was decoded once, on the worker: the drain's own
    # pull (if the ring held anything) included, nothing inline.
    assert len(calls) in (n_pulled, n_pulled + 1)
    assert all(name.startswith("cep-decode") for name in calls)
    assert bat._decode_futs == []


def test_resize_shuts_the_worker_down_and_keeps_its_results():
    streams = _letter_streams(P)
    bat = _ring_engine()
    want = _drive(_ring_engine(), streams)
    out = {}
    for b in range(9):
        bat.advance_packed(bat.pack({k: s[b * 4:(b + 1) * 4] for k, s in streams.items()}),
                           decode=False)
        if b == 4:
            pending = len(bat._decode_futs)
            assert pending >= 1 and bat._decode_pool is not None
            assert bat.resize(replace(bat.config, lanes=32))
            assert bat._decode_pool is None and len(bat._decode_futs) == pending
    for k, v in bat.drain().items():
        out.setdefault(k, []).extend(map(P.sequence_to_json, v))
    assert out == want


# ----------------------------------------------------------- paced driver
def test_paced_driver_sink_equals_unpaced_and_jax():
    rng = random.Random(5)
    streams = {f"u{i}": letters_stream(rng, 200) for i in range(4)}

    def run(pkg, pacing):
        log = P.RecordLog() if pkg is P else JaxRecordLog()
        produce = P.produce if pkg is P else jax_produce
        for j in range(200):
            for k, s in streams.items():
                produce(log, "letters", k, s[j].value, timestamp=s[j].timestamp)
        builder = (P.ComplexStreamsBuilder if pkg is P else JaxBuilder)(log=log)
        builder.stream("letters").query("Q", letters_pattern(pkg), runtime="host").to("m")
        reg = MetricsRegistry() if pkg is P else JaxRegistry()
        driver = (P.LogDriver if pkg is P else JaxLogDriver)(builder.build(), group="g",
                                                            registry=reg, pacing=pacing)
        budgets = []
        while True:
            if driver.pacer is not None:
                budgets.append(driver.pacer.suggest_batch())
            if not driver.poll():
                break
        return [(r.key, r.value) for r in log.read("m")], budgets, reg

    sink, budgets, reg = run(P, True)
    assert sink == run(P, None)[0] == run(J, True)[0] and len(sink) >= 4
    assert len(budgets) >= 3 and all(32 <= b <= 8192 and b & (b - 1) == 0 for b in budgets)
    assert reg.get("cep_driver_poll_batch").labels(group="g").value in budgets
