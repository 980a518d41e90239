"""The port's SLO-gated chaos soak, its workload generators and the chaos
CLI, against the JAX package's.

The adversarial generators give the JAX package's records for each
seed. The quick soak passes every SLO on the host runtime and with the
device runtime on the CPU (`--runtime mixed --device cpu`), exits 0, and
its artifact passes both the port's `faults/soak_schema.validate_soak`
and the repo's `scripts/check_bench_schema.validate_soak`. Its
`emission_integrity` SLO holds at 0 duplicates: the JAX package's quick
soak (tests/test_soak.py::test_quick_soak_passes_every_slo) emits
duplicates on the gated host query across an injected crash, which two
repairs in the port's copies end (streams/emission.py keeps recovered
digests until replay regenerates them; streams/builder.py writes a gated
host query's stores back at the commit). `test_gated_crash_emits_each_match_once`
pins them at a fixed crash point. `--violation drops` flips the verdict;
`--runtime tpu`, and `cuda`/`mixed` without a card or `--device cpu`,
raise.

Counterparts of the JAX package's tests/test_soak.py: each test of the
same name here; the generator tests as `test_generators_equal_jax` and
`test_generator_shapes` (cases); the time-series and scraper tests live
in tests/test_torch_fleet_obs.py; test_mixed_runtime_soak_runs_device_fleet
(slow-marked there) as `test_quick_soak_mixed_on_the_cpu`.
"""
from __future__ import annotations

import collections
import json
import os
import pickle
import subprocess
import sys
import tempfile
import urllib.request
from pathlib import Path

import pytest
import torch

import kafkastreams_cep_tpu.models.adversarial as jadv
import kafkastreams_cep_tpu_torch as P
from kafkastreams_cep_tpu_torch.faults import (
    FaultInjector,
    FaultPoint,
    FaultSchedule,
    InjectedCrash,
    armed,
)
from kafkastreams_cep_tpu_torch.faults import __main__ as faults_cli
from kafkastreams_cep_tpu_torch.faults import soak
from kafkastreams_cep_tpu_torch.faults.soak_schema import SOAK_SLOS, looks_like_soak, validate_soak
from kafkastreams_cep_tpu_torch.models.adversarial import (
    KeySkewHotspot,
    MatchStorm,
    QueryChurnPlan,
    WatermarkStall,
)
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry
from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key
from kafkastreams_cep_tpu_torch.time.watermarks import BoundedOutOfOrderness, MinMergeWatermark

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
from check_bench_schema import validate_soak as script_validate_soak  # noqa: E402

NO_CARD = not torch.cuda.is_available()


# ------------------------------------------------------------ generators
def _sig(gen, sizes=(7, 200, 64)):
    return [[(e.key, e.value, e.timestamp, e.topic, e.partition) for e in gen.chunk(n)] for n in sizes]


@pytest.mark.parametrize("name,args", [
    ("KeySkewHotspot", dict(keys=8)),
    ("KeySkewHotspot", dict(keys=4, hot_frac=0.5)),
    ("MatchStorm", dict(quiet_len=60, storm_len=30)),
    ("WatermarkStall", dict(sources=3, stall_after=80)),
])
def test_generators_equal_jax(name, args):
    for seed in (0, 1, 13):
        p = getattr(sys.modules[KeySkewHotspot.__module__], name)(seed, **args)
        j = getattr(jadv, name)(seed, **args)
        assert _sig(p) == _sig(j)
        assert (p.topics, p.produced) == (j.topics, j.produced)
    for seed in (0, 3):
        a, b = QueryChurnPlan(seed, period_s=2.0), jadv.QueryChurnPlan(seed, period_s=2.0)
        assert [a.live(i) for i in range(12)] == [b.live(i) for i in range(12)]
        assert [a.epoch_at(t / 3) for t in range(30)] == [b.epoch_at(t / 3) for t in range(30)]


def _shape_hotspot():
    evs = KeySkewHotspot(5, keys=8, hot_frac=0.9).chunk(1000)
    assert sum(1 for e in evs if e.key == "h0") > 800 and len({e.key for e in evs}) == 8


def _shape_storm():
    evs = MatchStorm(7, keys=2, quiet_len=50, storm_len=30).chunk(200)
    values = [e.value for e in evs]
    assert all(v in "ABC" for v in values[50:80])
    assert sum(1 for v in values[:50] if v in "ABC") < 20


def _shape_stall():
    gen = WatermarkStall(9, sources=3, stall_source=0, stall_after=60)
    evs = gen.chunk(60) + gen.chunk(120)
    assert any(e.topic == "stall0" for e in evs[:60]) and not any(e.topic == "stall0" for e in evs[60:])
    worst, seen = 0, -1
    for e in evs:
        worst, seen = max(worst, seen - e.timestamp), max(seen, e.timestamp)
    assert 0 < worst <= gen.reorder_bound_ms


def _shape_churn():
    a = QueryChurnPlan(3, period_s=2.0)
    epochs = [a.live(i) for i in range(8)]
    assert epochs[0] == a.queries and all(p != c for p, c in zip(epochs, epochs[1:]))


@pytest.mark.parametrize("case", [_shape_hotspot, _shape_storm, _shape_stall, _shape_churn],
                         ids=["hotspot_skews", "storm_phases", "stall_goes_dark", "churn_always_churns"])
def test_generator_shapes(case):
    case()


# ------------------------------------------------- the emission fault
def _watermarks(log):
    """Every emission watermark each query's commits persisted, in order,
    by changelog topic."""
    return {t: [pickle.loads(r.value) for r in log.read(t)]
            for t in sorted(log.topics()) if t.endswith("-emitted-changelog")}


def _gated_run(path, events, topics, bound, hits, budgets, queries=("q",)):
    """The soak's gated host query (one for each name in `queries`, all
    sinking to one topic) through a LogDriver over a file log, crashed
    before the commits numbered in `hits` and restarted with the poll
    budget budgets[1]: the sink's (digest, value) records, the persisted
    emission watermarks and the sink's end offset."""
    log = P.RecordLog(path)
    for ev in events:
        P.produce(log, ev.topic, ev.key, ev.value, timestamp=ev.timestamp)
    log.flush()
    budget = budgets[0]
    points = [FaultPoint("driver.pre_commit", hit) for hit in hits]
    with armed(FaultInjector(FaultSchedule(points), registry=MetricsRegistry())):
        while True:
            builder = P.ComplexStreamsBuilder(log=log, app_id="g")
            stream = builder.stream(topics)
            for name in queries:
                stream.query(
                    name, soak._letters_pattern(), runtime="host", registry=MetricsRegistry(),
                    reorder_capacity=16, lateness_ms=bound, late_policy="recompute-none",
                    reorder_overflow="block",
                    watermark_gen=MinMergeWatermark(
                        per_source={(t, 0): BoundedOutOfOrderness(bound) for t in topics}),
                ).to("m")
            try:
                driver = P.LogDriver(builder.build(), group="g", registry=MetricsRegistry())
                while driver.poll(max_records=budget):
                    pass
                driver.drain_event_time()
                break
            except InjectedCrash:
                budget = budgets[1]
                log.close()
                log = P.RecordLog(path)
    out = [(decode_sink_key(r.key)[1], r.value) for r in log.read("m")]
    wms, end = _watermarks(log), log.end_offset("m")
    log.close()
    return out, wms, end


def _stall_stream():
    gen = WatermarkStall(2, sources=3, stall_after=10**9)
    return gen.chunk(600), gen.topics, gen.reorder_bound_ms


@pytest.mark.parametrize("hit,budgets", [(1, (64, 3)), (4, (96, 4)), (7, (48, 2))])
def test_gated_crash_emits_each_match_once(tmp_path, hit, budgets):
    """A crash before a commit through the soak's gated host query (three
    out-of-order sources, min-merge watermark, recompute-none, block),
    recovered with a smaller poll budget so that replay regenerates the
    crash window's matches over several commits: every sink digest
    appears once, and the sink equals the run without a crash."""
    events, topics, bound = _stall_stream()
    golden, _wms, _end = _gated_run(str(tmp_path / "g"), events, topics, bound, (), (64, 64))
    chaos, _wms, _end = _gated_run(str(tmp_path / "c"), events, topics, bound, (hit,), budgets)
    counts = collections.Counter(d for d, _v in chaos)
    assert max(counts.values()) == 1, "duplicate emission"
    assert sorted(chaos) == sorted(golden) and len(golden) > 10


@pytest.mark.parametrize("hits,budgets", [((4, 6), (96, 4)), ((7, 9), (48, 2))])
def test_second_crash_before_the_replay_settles(tmp_path, hits, budgets):
    """Two crashes through the gated host query, the second two commits
    after the first restart, while replay has not yet regenerated the
    first crash window: a commit between them persisted the outstanding
    digests, every sink digest appears once and the sink equals the run
    without a crash. Once replay has passed the first window, the
    persisted watermark moves on: the last one sits at the sink's end
    with nothing outstanding, so a later restart reads no old output."""
    events, topics, bound = _stall_stream()
    golden, _wms, _end = _gated_run(str(tmp_path / "g"), events, topics, bound, (), (64, 64))
    chaos, wms, end = _gated_run(str(tmp_path / "c"), events, topics, bound, hits, budgets)
    counts = collections.Counter(d for d, _v in chaos)
    assert max(counts.values()) == 1, "duplicate emission"
    assert sorted(chaos) == sorted(golden) and len(golden) > 10
    (wms,) = wms.values()
    held = [i for i, wm in enumerate(wms) if wm.recovered]
    assert held, "no commit persisted outstanding digests"
    assert wms[-1].sink_pos == {"m": end} and wms[-1].recovered == []
    assert all(wm.sink_pos["m"] <= later.sink_pos["m"] for wm, later in zip(wms, wms[1:]))
    assert wms[held[-1]].sink_pos["m"] < end


def test_shared_sink_topic_settles_after_the_replay(tmp_path):
    """Two gated queries sink to one topic, and a crash leaves each gate
    the other's crash-window digests, which its replay never
    regenerates. Each match is emitted once; once the consumer has passed
    every record that existed at the restart, the gates drop them: each
    query's last persisted watermark sits at the sink's end with nothing
    outstanding."""
    events, topics, bound = _stall_stream()
    two = ("q", "r")
    golden, _wms, _end = _gated_run(str(tmp_path / "g"), events, topics, bound, (), (64, 64),
                                    queries=two)
    chaos, wms, end = _gated_run(str(tmp_path / "c"), events, topics, bound, (4,), (96, 4),
                                 queries=two)
    counts = collections.Counter(d for d, _v in chaos)
    assert max(counts.values()) == 1, "duplicate emission"
    assert sorted(chaos) == sorted(golden) and len(golden) > 20
    assert len(wms) == 2
    for per_query in wms.values():
        assert any(wm.recovered for wm in per_query)
        assert per_query[-1].sink_pos == {"m": end} and per_query[-1].recovered == []


# ------------------------------------------------------------ the soak run
def _soak(args, out):
    rc = soak.main(args + ["--out", str(out)])
    with open(out) as f:
        return rc, json.load(f)


@pytest.fixture(scope="module")
def quick_soak(tmp_path_factory):
    """One CI-sized host soak, seed 0, shared by the tests below."""
    out = tmp_path_factory.mktemp("soak") / "SOAK_quick.json"
    return _soak(["--quick", "--duration", "4", "--seed", "0", "--runtime", "host",
                  "--device", "cpu", "--scrape-every", "0.25"], out)


def test_quick_soak_passes_every_slo(quick_soak):
    rc, doc = quick_soak
    assert rc == 0 and doc["passed"] is True
    assert set(doc["slos"]) == set(SOAK_SLOS)
    for name, entry in doc["slos"].items():
        assert entry["ok"] is True, (name, entry)
    integrity = doc["slos"]["emission_integrity"]
    assert integrity["value"] == 0.0 and integrity["excused"] is False
    assert all(v["duplicates"] == 0 for v in integrity["detail"].values())
    s = doc["soak"]
    assert s["events_produced"] > 0 and s["events_processed"] == s["events_produced"]
    assert s["matches"] > 0 and s["scrapes"] > 0 and s["churn_epochs"] >= 1 and s["crashes"] >= 1
    assert s["platform"] == "cpu"
    assert set(doc["scenarios"]) == {"hotspot", "match_storm", "watermark_stall"}
    assert all(sc["matches"] > 0 for sc in doc["scenarios"].values())


def test_quick_soak_artifact_schema_and_series(quick_soak):
    _rc, doc = quick_soak
    assert looks_like_soak(doc)
    assert validate_soak(doc) == [] and script_validate_soak(doc) == []
    assert doc.get("schema_ok") is True
    for name in ("cep_watermark_lag_seconds", "cep_reorder_occupancy", "process_rss_bytes",
                 "cep_match_latency_seconds_count"):
        summary = doc["series"][name]
        assert set(summary) == {"n", "min", "max", "last", "slope_per_s"} and summary["n"] >= 3
    assert doc["series"]["cep_watermark_lag_seconds"]["max"] > 0
    assert doc["fleet"]["enabled"] is True and doc["fleet"]["ticks"] >= 1


def test_validate_soak_enforces_both_ways(quick_soak):
    _rc, doc = quick_soak
    assert any("undocumented key 'bogus'" in e for e in validate_soak(dict(doc, bogus=1)))
    missing = {k: v for k, v in doc.items() if k != "slos"}
    assert any("missing documented key 'slos'" in e for e in validate_soak(missing))
    broken = json.loads(json.dumps(doc))
    broken["slos"]["made_up"] = broken["slos"].pop("drops")
    errs = validate_soak(broken)
    assert any("missing SLO 'drops'" in e for e in errs) and any("undocumented SLO 'made_up'" in e for e in errs)
    broken2 = json.loads(json.dumps(doc))
    next(iter(broken2["series"].values())).pop("slope_per_s")
    assert any("slope_per_s" in e for e in validate_soak(broken2))


def test_soak_regression_slo_against_prior_artifact(quick_soak, tmp_path):
    _rc, doc = quick_soak
    eps = {f"soak_{n}": {"eps": sc["eps"]} for n, sc in doc["scenarios"].items()}
    kw = dict(platform=doc["soak"]["platform"], tolerance=0.15, quick=True,
              autosized=doc["soak"]["autosized"], controller_migrations=bool(doc["fleet"]["actions"]))
    boosted = json.loads(json.dumps(doc))
    for sc in boosted["scenarios"].values():
        sc["eps"] *= 100.0
    (tmp_path / "fast.json").write_text(json.dumps(boosted))
    block = soak._eps_regression_block(str(tmp_path / "fast.json"), eps, **kw)
    assert block["regressed"] is True and block["excused"] is False and block["excuse"] is None
    (tmp_path / "same.json").write_text(json.dumps(doc))
    assert soak._eps_regression_block(str(tmp_path / "same.json"), eps, **kw)["regressed"] is False


def test_quick_soak_mixed_on_the_cpu(tmp_path):
    """The hotspot on the device runtime, here on the CPU's plain kernels."""
    rc, doc = _soak(["--quick", "--duration", "4", "--seed", "0", "--runtime", "mixed",
                     "--device", "cpu", "--scrape-every", "0.25"], tmp_path / "mixed.json")
    assert doc["scenarios"]["hotspot"]["runtime"] == "cuda"
    assert doc["scenarios"]["hotspot"]["matches"] > 0
    assert doc["scenarios"]["hotspot"]["controller"]["resizes"] >= 0
    assert doc["soak"]["platform"] == "cpu"
    assert validate_soak(doc) == [] and script_validate_soak(doc) == []
    assert doc["slos"]["emission_integrity"]["value"] == 0.0
    assert rc == 0, doc["slos"]


def test_seeded_violation_flips_verdict(tmp_path):
    rc, doc = _soak(["--quick", "--duration", "2.5", "--seed", "0", "--runtime", "host",
                     "--violation", "drops"], tmp_path / "violation.json")
    assert rc == 1 and doc["passed"] is False
    drops = doc["slos"]["drops"]
    assert drops["ok"] is False and drops["value"] > 0
    assert drops["detail"]["cep_reorder_overflow_dropped_total"] > 0
    assert validate_soak(doc) == []
    assert doc["series"]["cep_reorder_overflow_dropped_total"]["last"] > 0


def test_soak_usage_errors_fail_fast(tmp_path):
    for extra in (["--violation", "drops", "--scenarios", "hotspot"],
                  ["--compare", str(tmp_path / "no_such_prior.json")],
                  ["--scenarios", "nonsense"],
                  ["--runtime", "tpu"]):
        args = ["--quick", "--duration", "1", "--runtime", "host"] + extra
        assert soak.main(args + ["--out", str(tmp_path / "x.json")]) == 2, extra
    assert not (tmp_path / "x.json").exists()
    with pytest.raises(ValueError, match="'tpu' is 'cuda'"):
        soak.build_fleet(0, "tpu", True)


@pytest.mark.skipif(not NO_CARD, reason="a card is present")
@pytest.mark.parametrize("runtime", ["cuda", "mixed"])
def test_device_runtimes_need_the_card_or_device_cpu(tmp_path, runtime):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--quick", "--duration", "1", "--runtime", runtime, "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        faults_cli.main(["--seeds", "1", "--events", "12", "--runtime", "cuda"])
    assert soak.build_fleet(0, runtime, True, device="cpu")[0].runtime == "cuda"


def test_next_artifact_path_numbering(tmp_path):
    assert soak.next_artifact_path(str(tmp_path)).endswith("SOAK_r01.json")
    (tmp_path / "SOAK_r03.json").write_text("{}")
    assert soak.next_artifact_path(str(tmp_path)).endswith("SOAK_r04.json")


# ------------------------------------------------------- faults CLI entry
def test_faults_cli_rejects_bad_args_and_offers_help(capsys):
    for argv, code in ((["--no-such-flag"], 2), (["--help"], 0), (["soak", "--no-such-flag"], 2),
                       (["--runtime", "tpu"], 2)):
        with pytest.raises(SystemExit) as exc:
            faults_cli.main(argv)
        assert exc.value.code == code
    assert "--seeds" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--seeds", "1", "--events", "12", "--points", "1"],
    ["sweep", "--seeds", "1", "--events", "12", "--points", "1"],
    ["--seeds", "1", "--events", "18", "--points", "2", "--runtime", "cuda", "--device", "cpu"],
], ids=["host", "sweep_subcommand", "cuda_on_the_cpu"])
def test_faults_cli_sweep_exit_zero_and_progress(capsys, argv):
    assert faults_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "seed 0:" in out and "1 seeds, 0 divergent" in out


def test_faults_cli_http_port_wiring(capsys):
    assert faults_cli.main(["--seeds", "1", "--events", "12", "--points", "1", "--http-port", "0"]) == 0
    assert "introspection plane: http://" in capsys.readouterr().out


def test_faults_cli_dispatches_soak_without_jax_or_the_schema_script(tmp_path):
    """`python -m kafkastreams_cep_tpu_torch.faults soak` in a fresh
    process: it runs, prints the verdict as its last stdout line, and
    loads neither JAX, the JAX package nor scripts/check_bench_schema.py."""
    out = tmp_path / "SOAK_cli.json"
    code = (
        "import sys\n"
        "from kafkastreams_cep_tpu_torch.faults.__main__ import main\n"
        f"rc = main(['soak', '--quick', '--duration', '1.5', '--seed', '2', '--runtime', 'host',"
        f" '--scenarios', 'hotspot,match_storm', '--chaos-points', '0', '--out', {str(out)!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'check_bench_schema'"
        " or m == 'kafkastreams_cep_tpu' or m.startswith('kafkastreams_cep_tpu.')]\n"
        "print('BAD', bad, file=sys.stderr)\n"
        "sys.exit(rc if not bad else 9)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tempfile.gettempdir(), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(out.read_text())
    assert set(doc["scenarios"]) == {"hotspot", "match_storm"} and doc["soak"]["crashes"] == 0
    assert json.loads(proc.stdout.strip().splitlines()[-1])["passed"] is True


# -------------------------------------------------- /healthz event time
def test_healthz_carries_event_time_plane_and_dlq_breakdown():
    reg = MetricsRegistry()
    rlog = P.RecordLog()
    builder = P.ComplexStreamsBuilder(log=rlog, app_id="hz-et")
    builder.stream("src").query("gated", soak._letters_pattern(), runtime="host", registry=reg,
                                reorder_capacity=16, lateness_ms=50).to("m")
    driver = P.LogDriver(builder.build(), group="hz-et", registry=reg)
    srv = driver.serve_http()
    try:
        for ts, ch in ((100, "A"), (140, "B"), (120, "C")):
            P.produce(rlog, "src", "K", ch, timestamp=ts)
        driver.poll()
        hz = json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read())
        et = hz["event_time"]
        assert et["gated_queries"] == 1 and et["reorder_occupancy"] > 0
        assert et["queries"]["gated"]["reorder_occupancy"] > 0
        assert et["watermark_lag_s_max"] is not None and et["watermark_lag_s_max"] >= 0
        assert hz["dead_letters_by_reason"] == {}
    finally:
        srv.stop()
        driver.close()


def test_healthz_event_time_zeros_without_gates():
    rlog = P.RecordLog()
    builder = P.ComplexStreamsBuilder(log=rlog, app_id="hz-plain")
    builder.stream("src").query("plain", soak._letters_pattern(), runtime="host").to("m")
    driver = P.LogDriver(builder.build(), group="hz-plain")
    try:
        assert driver.health()["event_time"] == {
            "gated_queries": 0, "reorder_occupancy": 0, "watermark_lag_s_max": None, "queries": {}}
    finally:
        driver.close()
