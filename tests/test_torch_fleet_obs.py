"""The port's fleet observability against the JAX package's: registry
merge, self-scraped time series, the fleet controller, wire trace
context, and the soak's fleet-block schema.

The same snapshots merge to the same output; the same samples summarize
to the same series; the same scripted snapshots, on the same clock, make
the port's `FleetController` decide what the JAX one decides, tick for
tick. The scraper runs over a live port `/metrics` endpoint.

Counterparts of the JAX package's tests:
- tests/test_fleet_obs.py: the trace-context codec and wire tests ->
  `test_trace_context_equals_jax` and `test_wire_trace_blob` (cases);
  stitching -> `test_stitched_chrome_trace_equals_jax`; the four merge
  edge rules -> `test_merge_edge_rules` (cases);
- tests/test_controller.py: each unit test -> `test_controller_decisions_equal_jax`
  (cases) plus the tests of the same name here; the two-broker acceptance
  test lives in tests/test_torch_rebalance.py;
- tests/test_fleet_schema.py: the fleet-block schema tests -> the tests
  of the same name here against faults/soak_schema.py; its three
  `perf_ledger` tests have none: scripts/perf_ledger.py is the repo's
  shared script, not part of either package, and the port's soak calls
  it unchanged;
- tests/test_soak.py: the time-series and scraper tests ->
  `test_timeseries_equals_jax` and the scraper tests here.
"""
from __future__ import annotations

import json
import os
import random
import struct
import sys
import time

import pytest

import kafkastreams_cep_tpu.obs.merge as jmerge
import kafkastreams_cep_tpu.obs.registry as jregistry
import kafkastreams_cep_tpu.obs.scrape as jscrape
import kafkastreams_cep_tpu.obs.trace as jtrace
import kafkastreams_cep_tpu.ops.controller as jctl
from kafkastreams_cep_tpu_torch.faults import soak as psoak
from kafkastreams_cep_tpu_torch.faults.soak_schema import _check_fleet_block, validate_soak
from kafkastreams_cep_tpu_torch.obs import IntrospectionServer
from kafkastreams_cep_tpu_torch.obs.merge import merge_registries, merge_snapshots
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry
from kafkastreams_cep_tpu_torch.obs.scrape import MetricsScraper, TimeSeries
from kafkastreams_cep_tpu_torch.obs.trace import TRACE_CTX_VERSION, SpanTracer, TraceContext
from kafkastreams_cep_tpu_torch.obs.trace_export import stitched_chrome_trace
from kafkastreams_cep_tpu_torch.ops.controller import (
    DROP_SERIES,
    ControllerPolicy,
    FleetController,
    histogram_quantile,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))


# ------------------------------------------------------------------ merge
def _fill(reg, seed, device=None):
    rng = random.Random(seed)
    c = reg.counter("cep_driver_records_total", "records", labels=("group",))
    for g in ("a", "b"):
        c.labels(group=g).inc(rng.randint(0, 50))
    reg.gauge("cep_pend_occupancy", "pend").set(rng.random() * 9)
    if device is not None:
        reg.gauge("cep_dev_gauge", "g", labels=("device",)).labels(device=device).set(seed)
    h = reg.histogram("cep_match_latency_seconds", "lat", labels=("query",), buckets=(0.01, 0.1, 1.0))
    for _ in range(rng.randint(1, 20)):
        h.labels(query=rng.choice("pq")).observe(rng.random())
    return reg


def test_merge_snapshots_and_registries_equal_jax():
    for seed in range(4):
        psnaps = {f"dev{d}": _fill(MetricsRegistry(), seed * 10 + d, device=f"x{d}").snapshot()
                  for d in range(3)}
        jsnaps = {k: json.loads(json.dumps(v)) for k, v in psnaps.items()}
        assert merge_snapshots(psnaps) == jmerge.merge_snapshots(jsnaps)
        pregs = {f"dev{d}": _fill(MetricsRegistry(), seed + d) for d in range(2)}
        jregs = {f"dev{d}": _fill(jregistry.MetricsRegistry(), seed + d) for d in range(2)}
        assert merge_registries(pregs).snapshot() == jmerge.merge_registries(jregs).snapshot()
        assert merge_registries(pregs).to_prom_text() == jmerge.merge_registries(jregs).to_prom_text()


def _gauge_snap(value, device_label=None):
    reg = MetricsRegistry()
    if device_label is None:
        reg.gauge("cep_pend_occupancy", "h").set(value)
    else:
        reg.gauge("cep_pend_occupancy", "h", labels=("device",)).labels(device=device_label).set(value)
    return reg.snapshot()


def _edge_collision():
    with pytest.raises(ValueError, match="two devices claim"):
        merge_snapshots({"dev0": _gauge_snap(1.0, "dev1"), "dev1": _gauge_snap(2.0, "dev1")})


def _edge_distinct():
    fam = merge_snapshots({"dev0": _gauge_snap(1.0), "dev1": _gauge_snap(2.0)})["cep_pend_occupancy"]
    assert fam["label_names"] == ["device"]
    assert {e["labels"]["device"]: e["value"] for e in fam["values"]} == {"dev0": 1.0, "dev1": 2.0}


def _edge_cardinality():
    regs = {}
    for d in range(4):
        reg = MetricsRegistry()
        reg.gauge("cep_pend_occupancy", "h").set(float(d))
        regs[f"dev{d}"] = reg
    assert len(merge_registries(regs, max_label_sets=8).snapshot()["cep_pend_occupancy"]["values"]) == 4
    with pytest.raises(ValueError, match="cardinality"):
        merge_registries(regs, max_label_sets=2)


def _edge_layout():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("cep_h_seconds", "h", buckets=(0.1, 1.0)).observe(0.05)
    b.histogram("cep_h_seconds", "h", buckets=(0.5, 2.0)).observe(0.05)
    with pytest.raises(ValueError, match="bucket layout"):
        merge_snapshots({"dev0": a.snapshot(), "dev1": b.snapshot()})


@pytest.mark.parametrize("case", [_edge_collision, _edge_distinct, _edge_cardinality, _edge_layout],
                         ids=["gauge_collision", "gauges_distinct", "bounded_cardinality", "bucket_layout"])
def test_merge_edge_rules(case):
    case()


# ---------------------------------------------------------- time series
def test_timeseries_equals_jax():
    rng = random.Random(3)
    for maxlen in (4, 64, 4096):
        p, j = TimeSeries(maxlen=maxlen), jscrape.TimeSeries(maxlen=maxlen)
        assert p.slope_per_s() is None is j.slope_per_s()
        t = 0.0
        for _ in range(rng.randint(3, 200)):
            t += rng.random()
            v = rng.choice([rng.random() * 100, 5.0, float(rng.randint(0, 9))])
            p.append(t, v)
            j.append(t, v)
        assert p.summary() == j.summary()
        assert (p.rate_per_s(), p.n, p.min, p.max, p.last) == (j.rate_per_s(), j.n, j.min, j.max, j.last)
    leak, spike = TimeSeries(), TimeSeries()
    for i in range(20):
        leak.append(float(i), float(i))
        spike.append(float(i), 19.0 if i == 10 else 1.0)
    assert leak.slope_per_s() == pytest.approx(1.0)
    assert abs(spike.slope_per_s()) < 0.2 and spike.last == spike.min


def test_scraper_aggregation_rules_and_rss():
    reg = MetricsRegistry()
    c = reg.counter("cep_x_total", "x", labels=("q",))
    c.labels(q="a").inc(3)
    c.labels(q="b").inc(4)
    g = reg.gauge("cep_lag_seconds", "lag", labels=("q",))
    g.labels(q="a").set(2.0)
    g.labels(q="b").set(5.0)
    sc = MetricsScraper(registry=reg, every_s=10)
    jreg = jregistry.MetricsRegistry()
    jsc = jscrape.MetricsScraper(registry=jreg, every_s=10)
    jc = jreg.counter("cep_x_total", "x", labels=("q",))
    jc.labels(q="a").inc(3)
    jc.labels(q="b").inc(4)
    jg = jreg.gauge("cep_lag_seconds", "lag", labels=("q",))
    jg.labels(q="a").set(2.0)
    jg.labels(q="b").set(5.0)
    for now in (1.0, 2.0):
        assert sc.scrape_once(now=now) and jsc.scrape_once(now=now)
        c.labels(q="a").inc(1)
        jc.labels(q="a").inc(1)
    names = ("cep_x_total", "cep_lag_seconds")
    assert sc.summaries(names) == jsc.summaries(names)
    assert sc.get("cep_x_total").last == 8.0 and sc.get("cep_lag_seconds").last == 5.0
    assert sc.get("process_rss_bytes").last > 0
    assert sc.scrapes == 2 and sc.errors == 0


def test_scraper_over_live_port_metrics_endpoint():
    reg = MetricsRegistry()
    reg.counter("cep_live_total", "x").inc(7)
    srv = IntrospectionServer(registry=reg, port=0).start()
    url = srv.url
    try:
        sc = MetricsScraper(url=url, every_s=0.05).start()
        deadline = time.time() + 5
        while sc.scrapes < 3 and time.time() < deadline:
            time.sleep(0.02)
        sc.stop(final_scrape=True)
        assert sc.scrapes >= 3 and sc.get("cep_live_total").last == 7.0
    finally:
        srv.stop()
    dead = MetricsScraper(url=url, every_s=10, timeout_s=0.5)
    assert not dead.scrape_once() and dead.errors == 1
    with pytest.raises(ValueError):
        MetricsScraper()
    with pytest.raises(ValueError):
        MetricsScraper(url="http://x", registry=reg)


# ------------------------------------------------------------ controller
def test_policy_defaults_round_trip():
    d = ControllerPolicy().as_dict()
    assert d == jctl.ControllerPolicy().as_dict()
    assert set(d) == set(ControllerPolicy.__slots__)
    assert ControllerPolicy(skew_ratio=2).as_dict()["skew_ratio"] == 2.0


def test_drop_series_mirrors_soak():
    assert tuple(DROP_SERIES) == tuple(psoak.DROP_SERIES) == tuple(jctl.DROP_SERIES)


def test_histogram_quantile_equals_jax():
    rng = random.Random(2)
    fams = [{"values": []}]
    for _ in range(40):
        entries = []
        for _ in range(rng.randint(1, 3)):
            cum, buckets = 0, {}
            for le in ("0.01", "0.1", "1.0", "10.0", "+Inf"):
                cum += rng.randint(0, 5)
                buckets[le] = cum
            entries.append({"count": cum, "sum": rng.random(), "buckets": buckets})
        fams.append({"type": "histogram", "values": entries})
    for fam in fams:
        for q in (0.0, 0.5, 0.85, 0.99, 1.0):
            assert histogram_quantile(fam, q) == jctl.histogram_quantile(fam, q)


class _Clock:
    t = 1000.0

    def __call__(self):
        return self.t


def _records_snap(reg_cls, n, drops=0, lat=None, pend=None):
    reg = reg_cls()
    reg.counter("cep_driver_records_total", "h", labels=("group",)).labels(group="g").inc(n)
    if drops:
        reg.counter("cep_late_dropped_total", "h").inc(drops)
    if lat is not None:
        reg.histogram("cep_match_latency_seconds", "h", labels=("query",),
                      buckets=(0.1, 1.0, 10.0)).labels(query="q").observe(lat)
    if pend is not None:
        reg.gauge("cep_pend_occupancy", "h").set(pend)
    return reg.snapshot()


def _script_skew(k):
    return {"busy": _records_snap(MetricsRegistry, 500 * k), "idle": _records_snap(MetricsRegistry, 0)}


def _script_burn(k):
    return {"busy": _records_snap(MetricsRegistry, 10 * k, drops=k, lat=5.0, pend=3.0 * k),
            "idle": _records_snap(MetricsRegistry, 0)}


def _script_dead(k):
    return {"ok": _records_snap(MetricsRegistry, 7 * k), "dead": None}


@pytest.mark.parametrize("script,policy", [
    (_script_skew, dict(skew_ratio=2.0, min_load=1.0, cooldown_s=60.0)),
    (_script_skew, dict(skew_ratio=2.0, min_load=1.0, cooldown_s=1.5)),
    (_script_burn, {}),
    (_script_dead, {}),
], ids=["skew_cooldown", "skew_cooldown_expires", "burn_breaches", "scrape_error"])
def test_controller_decisions_equal_jax(monkeypatch, script, policy):
    """Both controllers scrape the same scripted snapshots on the same
    clock: every decision, the state and the controllers' own metrics
    are equal."""
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    tick = {"k": 0}

    def sources():
        out = {}
        for name in script(0):
            def fn(name=name):
                snap = script(tick["k"])[name]
                if snap is None:
                    raise ConnectionError("down")
                return json.loads(json.dumps(snap))
            out[name] = fn
        return out

    executed = {"p": [], "j": []}
    p_reg, j_reg = MetricsRegistry(), jregistry.MetricsRegistry()
    pc = FleetController(sources(), registry=p_reg, policy=ControllerPolicy(**policy),
                         execute=lambda a: executed["p"].append(a) or "ok")
    jc = jctl.FleetController(sources(), registry=j_reg, policy=jctl.ControllerPolicy(**policy),
                              execute=lambda a: executed["j"].append(a) or "ok")
    for k in range(6):
        tick["k"] = k
        clock.t = 1000.0 + k
        assert pc.tick() == jc.tick()
    assert pc.state() == jc.state()
    assert executed["p"] == executed["j"]
    assert p_reg.snapshot() == j_reg.snapshot()


def test_controller_requires_sources_and_bounds_decisions():
    with pytest.raises(ValueError):
        FleetController({})
    reg = MetricsRegistry()
    reg.counter("cep_driver_records_total", "h", labels=("group",)).labels(group="g")
    ctl = FleetController({"b": reg}, registry=MetricsRegistry(), decisions=4)
    for _ in range(7):
        ctl.tick()
    assert len(ctl.state()["decisions"]) == 4 and ctl.state()["ticks"] == 7
    newest = ctl.decisions(limit=2)
    assert len(newest) == 2 and newest[0]["t_unix"] >= newest[1]["t_unix"]


def test_controller_daemon_lifecycle():
    reg = MetricsRegistry()
    reg.counter("cep_driver_records_total", "h", labels=("group",)).labels(group="g")
    with FleetController({"b": reg}, registry=MetricsRegistry(), every_s=0.02) as ctl:
        deadline = time.time() + 5.0
        while ctl.state()["ticks"] < 3 and time.time() < deadline:
            time.sleep(0.02)
    ticks = ctl.state()["ticks"]
    assert ticks >= 3
    time.sleep(0.08)
    assert ctl.state()["ticks"] == ticks


# --------------------------------------------------------- trace context
def test_trace_context_equals_jax():
    ctx = TraceContext("0123456789abcdef", "fedcba9876543210", 12.5)
    jctx = jtrace.TraceContext("0123456789abcdef", "fedcba9876543210", 12.5)
    blob = ctx.encode()
    assert blob == jctx.encode() == struct.pack(
        "<B8s8sd", TRACE_CTX_VERSION, bytes.fromhex("0123456789abcdef"),
        bytes.fromhex("fedcba9876543210"), 12.5)
    assert TraceContext.decode(blob) == ctx and jtrace.TraceContext.decode(blob) == jctx
    good = TraceContext.new(1.0).encode()
    for bad in (None, b"", good[:-1], good + b"\x00", bytes([TRACE_CTX_VERSION + 1]) + good[1:]):
        assert TraceContext.decode(bad) is None
    child = ctx.child("00000000000000aa")
    assert (child.trace_id, child.span_id, child.ingest_unix) == (ctx.trace_id, "00000000000000aa", 12.5)


def _wire_mixed(cli):
    ctx = TraceContext.new(7.0)
    cli.append("t", b"k0", b"v0", trace=ctx.encode())
    cli.append("t", b"k1", b"v1")
    recs = cli.read("t")
    assert [r.value for r in recs] == [b"v0", b"v1"]
    assert TraceContext.decode(recs[0].trace) == ctx and recs[1].trace is None
    for i in range(4):
        cli.append("plain", b"k", b"v%d" % i)
    assert all(r.trace is None for r in cli.read("plain"))


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_wire_trace_blob(server_pkg):
    """Traced and untraced records over the wire, from a port client to
    a server of either package."""
    import kafkastreams_cep_tpu.streams.transport as jwire
    import kafkastreams_cep_tpu_torch.streams.transport as pwire

    wire = pwire if server_pkg == "port" else jwire
    srv = wire.RecordLogServer().start()
    cli = pwire.SocketRecordLog(srv.address)
    try:
        _wire_mixed(cli)
    finally:
        cli.close()
        srv.stop()


def test_trace_blob_survives_crash_restart_replay(tmp_path):
    from kafkastreams_cep_tpu_torch.faults import FaultInjector, FaultPoint, FaultSchedule, armed
    from kafkastreams_cep_tpu_torch.streams.log import RecordLog
    from kafkastreams_cep_tpu_torch.streams.transport import RecordLogServer, SocketRecordLog

    srv = RecordLogServer(RecordLog(str(tmp_path / "broker"))).start()
    cli = None
    try:
        ctxs = [TraceContext.new(float(i)) for i in range(6)]
        with armed(FaultInjector(FaultSchedule([FaultPoint("log.torn_append", 3)]))):
            cli = SocketRecordLog(srv.address, io_timeout_s=2.0)
            for i, ctx in enumerate(ctxs):
                assert cli.append("t", b"k", b"v%d" % i, trace=ctx.encode()) == i
        recs = cli.read("t")
        assert [r.value for r in recs] == [b"v%d" % i for i in range(6)]
        assert all(r.trace is None for r in recs[:2])
        assert [TraceContext.decode(r.trace) for r in recs[2:]] == ctxs[2:]
        assert srv.health()["restarts"] == 1
    finally:
        if cli is not None:
            cli.close()
        srv.stop()


def test_stitched_chrome_trace_equals_jax():
    """The same spans recorded into port and JAX tracers stitch to the
    same document, with cross-process flow arrows and distinct pids."""
    def build(T, Reg, Ctx):
        tracers = [T(Reg()) for _ in range(3)]
        ctx = Ctx("0123456789abcdef", "1111111111111111", 10.0)
        tracers[0].record("produce", 0.0, end_unix=10.0, trace=ctx, span_id=ctx.span_id, parent_id="")
        tracers[1].record("broker.append", 0.002, end_unix=10.5, trace=ctx, span_id="2222222222222222")
        tracers[2].record("match.emit", 0.001, end_unix=11.0, trace=ctx, span_id="3333333333333333")
        return tracers

    from kafkastreams_cep_tpu.obs.trace_export import stitched_chrome_trace as jstitch

    pdoc = stitched_chrome_trace(*build(SpanTracer, MetricsRegistry, TraceContext), names=["a", "b", "c"])
    jdoc = jstitch(*build(jtrace.SpanTracer, jregistry.MetricsRegistry, jtrace.TraceContext),
                   names=["a", "b", "c"])

    def stable(doc):
        return sorted(json.dumps({k: v for k, v in e.items() if k not in ("ts", "dur")}, sort_keys=True)
                      for e in doc["traceEvents"])

    assert stable(pdoc) == stable(jdoc)
    assert any(e.get("name") == "propagate" for e in pdoc["traceEvents"])
    pids = {e["pid"] for e in pdoc["traceEvents"] if e.get("name") == "process_name"}
    assert len(pids) == 4


# ------------------------------------------------------- fleet-block schema
def _live_fleet_block(ticks=2):
    reg = MetricsRegistry()
    reg.counter("cep_driver_records_total", "h", labels=("group",)).labels(group="g")
    ctl = FleetController({"dev0": reg}, registry=MetricsRegistry())
    for _ in range(ticks):
        ctl.tick()
    block = ctl.state()
    block["trace"] = {"spans": 0, "stitched": 0, "trace_file": None}
    return block


def test_live_controller_state_validates():
    from check_bench_schema import _check_fleet_block as script_check

    for check in (_check_fleet_block, script_check):
        errors: list = []
        check(_live_fleet_block(), "fleet", errors)
        assert errors == []


def test_disabled_fleet_block_is_minimal():
    errors: list = []
    _check_fleet_block({"enabled": False, "trace": {"spans": 3, "stitched": 1, "trace_file": "T.json"}},
                       "fleet", errors)
    assert errors == []
    errors = []
    _check_fleet_block({"enabled": False, "ticks": 5,
                        "trace": {"spans": 0, "stitched": 0, "trace_file": None}}, "fleet", errors)
    assert any("ticks" in e for e in errors)


@pytest.mark.parametrize("mutate, needle", [
    (lambda b: b["burn"].pop("pend_drift"), "pend_drift"),
    (lambda b: b["burn"].update(novel_slo=1.0), "novel_slo"),
    (lambda b: b["policy"].pop("cooldown_s"), "cooldown_s"),
    (lambda b: b["decisions"][-1].pop("breached"), "breached"),
    (lambda b: b["decisions"][-1].update(surprise=1), "surprise"),
    (lambda b: b["trace"].update(trace_file=7), "trace_file"),
    (lambda b: b.pop("actions"), "actions"),
])
def test_fleet_block_drift_fails_schema(mutate, needle):
    block = _live_fleet_block()
    mutate(block)
    errors: list = []
    _check_fleet_block(block, "fleet", errors)
    assert any(needle in e for e in errors), errors


def test_validate_soak_tolerates_a_missing_fleet_block():
    doc = {"passed": True, "slos": {}}
    assert not any("fleet" in e for e in validate_soak(doc))
    doc["fleet"] = {"enabled": False, "trace": {"spans": 0}}
    assert any("fleet.trace" in e for e in validate_soak(doc))
