"""The port's `runtime="auto"` topology against the JAX package's.

Both start on the host runtime (which compiles nothing) and promote to
the device runtime once `promote_after` distinct keys were seen,
replaying the promotion ledger through the device processor and dropping
what the host phase already emitted. The port's device phase runs the
plain step on the CPU (`device="cpu"`). The JAX side reuses
tests/test_autosize.py's topology and config, so its promotion compiles
what that test compiles. Every comparison is exact:
  * a small stream (4 keys, promote_after 8) stays on the host;
  * 12 keys promote: the port's auto sink equals its `runtime="cuda"`
    sink and the JAX auto sink, with the autosizer armed;
  * `cep_auto_promotions_total` and `cep_auto_runtime{query, runtime}`
    equal the JAX ones, runtime "cuda" where the JAX package says "tpu";
  * past `buffer_max` the query pins the host; a custom `watermark_gen`
    pins it too;
  * the host event-time knobs carry into the promoted engine's config
    (port only: the auto sink equals the gated `runtime="cuda"` sink),
    and `EventTimeStateStore` is registered;
  * a strict-window config runs the host phase under strict windows too,
    so the auto sink equals the `runtime="cuda"` sink on the skip-till-any
    flagship pattern (the JAX host phase runs reference windows there).
"""
import random

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.streams.builder import ComplexStreamsBuilder as JaxBuilder  # noqa: E402
from kafkastreams_cep_tpu.streams.log import RecordLog as JaxRecordLog  # noqa: E402
from kafkastreams_cep_tpu.time import BoundedOutOfOrderness as JaxBounded  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from kafkastreams_cep_tpu_torch.time import BoundedOutOfOrderness  # noqa: E402

#: tests/test_autosize.py's auto-promotion config.
CFG = dict(lanes=16, nodes=512, matches=128)


def abc_pattern(pkg):
    return (pkg.QueryBuilder()
            .select("a").where(pkg.value() == "A")
            .then().select("b").where(pkg.value() == "B")
            .then().select("c").where(pkg.value() == "C")
            .build())


def _run(pkg, runtime, nkeys, app_id="auto", **opts):
    """tests/test_autosize.py's `_run_topology`: every key's
    "ABCABCXABC" in turn, key after key. Returns (node, sorted sink
    (key, value) bytes, registry)."""
    if pkg is P:
        log, builder, reg = P.RecordLog(), P.ComplexStreamsBuilder, MetricsRegistry()
        if runtime != "host":
            opts.setdefault("device", "cpu")
        if "config" in opts:
            opts["config"] = P.EngineConfig(**opts["config"])
    else:
        log, builder, reg = JaxRecordLog(), JaxBuilder, JaxRegistry()
        if "config" in opts:
            opts["config"] = JaxEngineConfig(**opts["config"])
    b = builder(log=log, app_id=app_id)
    b.stream("letters").query("q1", abc_pattern(pkg), runtime=runtime, registry=reg,
                              **opts).to("matches")
    topo = b.build()
    off = 0
    for i in range(nkeys):
        for v in "ABCABCXABC":
            topo.process("letters", f"k{i}", v, timestamp=1000 + off, offset=off)
            off += 1
    topo.flush()
    topo.flush_event_time()
    node = topo.queries[0][1]
    return node, sorted((r.key, r.value) for r in log.read("matches")), reg


@pytest.fixture(scope="module")
def promoted():
    """The 12-key run through the port's auto and cuda runtimes and the
    JAX auto runtime."""
    return {
        "auto": _run(P, "auto", 12, promote_after=8, config=CFG),
        "cuda": _run(P, "cuda", 12, batch_size=64, config=CFG),
        "jax": _run(J, "auto", 12, promote_after=8, config=CFG),
    }


def _state(proc, jax=False):
    """`state()` with the JAX runtime name mapped to the port's and the
    autosizer's wall-clock and compile-count readings left out."""
    st = dict(proc.state())
    if jax and st["runtime"] == "tpu":
        st["runtime"] = "cuda"
    if st["autosizer"] is not None:
        auto = {k: v for k, v in st["autosizer"].items()
                if k not in ("cadence", "compiles_seen", "suggest_t")}
        st["autosizer"] = auto
    return st


def test_auto_small_stream_stays_on_host():
    node, sink, _ = _run(P, "auto", 4, promote_after=8)
    j_node, j_sink, _ = _run(J, "auto", 4, promote_after=8)
    assert node.processor.device is None and node.processor.autosizer is None
    assert _state(node.processor) == _state(j_node.processor, jax=True)
    assert node.processor.state()["runtime"] == "host"
    assert sink == j_sink and len(sink) == 4 * 3


def test_auto_promotes_with_the_cuda_sink_and_the_jax_sink(promoted):
    node, sink, _ = promoted["auto"]
    proc = node.processor
    assert proc.runtime == "cuda" and proc.device is not None
    assert proc.autosizer is not None and proc.engine is proc.device.engine
    assert proc.promotion["ledger"] == 7 * 10 + 1
    assert proc.promotion["replayed_matches"] >= proc.promotion["host_matches"] > 0
    assert sink == promoted["cuda"][1]
    assert sink == promoted["jax"][1] and len(sink) == 12 * 3
    assert _state(proc) == _state(promoted["jax"][0].processor, jax=True)


def test_auto_metrics_equal_jax(promoted):
    for key, runtime in (("auto", "cuda"), ("jax", "tpu")):
        reg = promoted[key][2]
        assert reg.get("cep_auto_promotions_total").labels(query="q1").value == 1
        gauge = reg.get("cep_auto_runtime")
        assert gauge.labels(query="q1", runtime=runtime).value == 1
        assert gauge.labels(query="q1", runtime="host").value == 0
    _, _, reg = _run(P, "auto", 4, promote_after=8)
    _, _, j_reg = _run(J, "auto", 4, promote_after=8)
    assert reg.get("cep_auto_promotions_total").labels(query="q1").value == 0
    assert reg.get("cep_auto_runtime").labels(query="q1", runtime="host").value == 1
    assert reg.get("cep_auto_runtime").labels(query="q1", runtime="cuda").value == 0
    assert j_reg.get("cep_auto_runtime").labels(query="q1", runtime="tpu").value == 0


def test_auto_pins_host_past_buffer_max():
    node, sink, _ = _run(P, "auto", 12, promote_after=8, buffer_max=25)
    j_node, j_sink, _ = _run(J, "auto", 12, promote_after=8, buffer_max=25)
    st = node.processor.state()
    assert st["pinned_host"] and st["ledger"] == 0 and st["runtime"] == "host"
    assert node.processor.device is None
    assert _state(node.processor) == _state(j_node.processor, jax=True)
    assert sink == j_sink and len(sink) == 12 * 3


def test_auto_pins_host_under_watermark_gen():
    opts = dict(promote_after=8, reorder_capacity=16, lateness_ms=3)
    node, sink, _ = _run(P, "auto", 12, watermark_gen=BoundedOutOfOrderness(3), **opts)
    j_node, j_sink, _ = _run(J, "auto", 12, watermark_gen=JaxBounded(3), **opts)
    assert node.processor.promote_after == 1 << 62 == j_node.processor.promote_after
    assert node.processor.device is None and node.processor.gate is not None
    assert _state(node.processor) == _state(j_node.processor, jax=True)
    assert sink == j_sink and len(sink) == 12 * 3


def test_auto_event_time_knobs_reach_the_promoted_engine():
    """Host kwargs reorder_capacity / lateness_ms / on_overflow become the
    promoted engine's EngineConfig; with a log the gate's changelog store
    is registered for the host phase."""
    et = dict(reorder_capacity=16, lateness_ms=3, on_overflow="drop")
    node, sink, _ = _run(P, "auto", 12, promote_after=8, config=CFG, **et)
    proc = node.processor
    cfg = proc.device.config
    assert (cfg.reorder_capacity, cfg.lateness_ms, cfg.on_overflow) == (16, 3, "drop")
    assert proc.gate is proc.device.gate is not None
    assert "q1-streamscep-eventtime" in node.stores
    gated_cfg = dict(CFG, reorder_capacity=16, lateness_ms=3)
    _c_node, c_sink, _ = _run(P, "cuda", 12, batch_size=64, config=gated_cfg)
    assert sink == c_sink and len(sink) == 12 * 3


def test_auto_strict_windows_host_phase_equals_cuda():
    """On a strict-window config both phases expire runs alike: the
    flagship's skip-till-any pattern through auto equals runtime="cuda"."""
    cfg = dict(skip_any.FLAGSHIP_CONFIG, lanes=96, nodes=1024, matches=512)
    rng = random.Random(7)
    streams = {f"k{i}": skip_any.skip_any8_stream(rng, 48) for i in range(10)}
    sinks = {}
    for runtime, opts in (("auto", dict(promote_after=6)), ("cuda", dict(batch_size=64))):
        log, reg = P.RecordLog(), MetricsRegistry()
        b = P.ComplexStreamsBuilder(log=log)
        b.stream("letters").query("s", skip_any.skip_any8_pattern(), runtime=runtime,
                                  config=P.EngineConfig(**cfg), device="cpu", registry=reg,
                                  **opts).to("matches")
        topo = b.build()
        for k, s in streams.items():
            for e in s:
                topo.process("letters", k, e.value, timestamp=e.timestamp, offset=e.offset)
        topo.flush()
        sinks[runtime] = sorted((r.key, r.value) for r in log.read("matches"))
        if runtime == "auto":
            assert topo.queries[0][1].processor.runtime == "cuda"
            assert topo.queries[0][1].processor.host.strict_windows
    assert sinks["auto"] == sinks["cuda"] and len(sinks["auto"]) > 10
