"""The port's event-time path against the JAX package, on the CPU.

  * the gate (time/gate.py), its reorder buffer and watermark generators:
    the same seeded arrivals through both packages release the same
    records with the same clocks, count the same late and overflow
    records (every late policy, every overflow policy, min-merge over
    registered sources, an idle-timeout source, chunked `offer_batch`),
    and snapshot to the same bytes (`encode_event_time_state`); each
    package's snapshot restores into the other and both continue equal;
  * the out-of-order = presorted differential of
    tests/test_watermarks.py's reorder test (8 keys, a per-source
    min-merge watermark, arrivals shuffled within the lateness bound)
    through the port's engine, fed round by round and in one batch, and
    through its `runtime="cuda"` topology: every key's matches equal the
    JAX `engine="xla"` run on the gate's releases and the port's own run
    on the presorted stream; late, overflow and drop counts are 0;
    sampled provenance exemplars (objects and JSON sinks) equal the JAX
    engine's;
  * processor snapshots that carry gate state: gate frame, release
    clocks, high-water marks, pending records and engine trees byte for
    byte the JAX processor's, restored both ways; crash-restore mid stream
    equals the uninterrupted run; a snapshot without gate state restores
    into a gated config; a gated snapshot refuses a gateless one;
  * one error class: a `CEPOverflowError` raised by the gate is the
    engine's, and leaves the high-water mark so the retry admits;
  * the flush's "wm" column (`rebase_watermarks`) equal to the JAX
    package's: scalars, None entries, clamping;
  * the copied event-time models (exchanges, sensors).

One JAX engine configuration (`CFG`, K = 8, the skip-till-any pattern) is
shared by every JAX engine here, so the file costs one XLA compile per
batch length.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu import time as jtime  # noqa: E402
from kafkastreams_cep_tpu.core.event import Event as JaxEvent  # noqa: E402
from kafkastreams_cep_tpu.faults.injection import CEPOverflowError as JaxOverflowError  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.state import serde as jax_serde  # noqa: E402
from kafkastreams_cep_tpu.streams.device_processor import (  # noqa: E402
    DeviceCEPProcessor as JaxProcessor,
)
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch import time as ptime  # noqa: E402
from kafkastreams_cep_tpu_torch.core.event import Event  # noqa: E402
from kafkastreams_cep_tpu_torch.faults import injection  # noqa: E402
from kafkastreams_cep_tpu_torch.nfa import NFA  # noqa: E402
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from kafkastreams_cep_tpu_torch.state import serde  # noqa: E402
from kafkastreams_cep_tpu_torch.state.aggregates import AggregatesStore  # noqa: E402
from kafkastreams_cep_tpu_torch.state.buffer import SharedVersionedBuffer  # noqa: E402
from kafkastreams_cep_tpu_torch.streams import errors  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.device_processor import DeviceCEPProcessor  # noqa: E402

TS = 1_000_000
BOUND_MS = 6
KEYS = [f"k{i}" for i in range(8)]
#: Sized for zero drops on these seeds (skip-till-any doubles its runs).
CFG = dict(lanes=128, nodes=1024, matches=2048, matches_per_step=128,
           strict_windows=True, reorder_capacity=64, lateness_ms=BOUND_MS)
JAX_OFF = dict(engine="xla", exact_replay=False, compile_telemetry=False)


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


def _ev(pkg_event, t):
    return pkg_event(*t)


def _rel(released):
    return [(e.key, e.value, e.timestamp, e.topic, e.partition, e.offset, clk)
            for e, clk in released]


def _tup(e):
    return (e.key, e.value, e.timestamp, e.topic, e.partition, e.offset)


def _event_time_metrics(reg):
    snap = reg.snapshot()
    return {n: snap[n]["values"] for n in sorted(snap)
            if n.startswith(("cep_late_", "cep_reorder_", "cep_watermark_"))}


# ------------------------------------------------------------------ the gate
def _arrivals(seed, n_keys=4, n=24, bound=BOUND_MS):
    """Keys interleaved, arrival displaced by up to `bound` ms of event
    time, offsets in arrival order; key k on partition k."""
    rng = random.Random(seed)
    evs = []
    for k in range(n_keys):
        ts = TS
        for _ in range(n):
            ts += rng.choice((0, 1, 1, 2, 5))
            evs.append((f"k{k}", rng.choice("ABCX"), ts, k))
    order = sorted(range(len(evs)), key=lambda i: (evs[i][2] + rng.randint(0, bound), i))
    return [(evs[i][0], evs[i][1], evs[i][2], "t", evs[i][3], pos)
            for pos, i in enumerate(order)]


def _gen(t, kind):
    if kind == "minmerge":
        return t.MinMergeWatermark(
            per_source={("t", k): t.BoundedOutOfOrderness(BOUND_MS) for k in range(4)})
    if kind == "idle":
        return t.IdleTimeout(
            t.MinMergeWatermark(default_factory=lambda: t.BoundedOutOfOrderness(0)),
            timeout_ms=100)
    if kind == "arrival":
        return t.ArrivalOrderWatermark()
    return None


#: name -> (gate kwargs, generator kind, drive mode)
GATE_CASES = {
    "late-drop": (dict(capacity=64, lateness_ms=2), None, "offer"),
    "late-sideoutput": (dict(capacity=64, lateness_ms=2, late_policy="sideoutput"), None, "offer"),
    "late-recompute-none": (dict(capacity=64, lateness_ms=2, late_policy="recompute-none"), None,
                            "offer"),
    "minmerge": (dict(capacity=64, lateness_ms=BOUND_MS), "minmerge", "offer"),
    "arrival-order": (dict(capacity=64), "arrival", "offer"),
    "overflow-drop": (dict(capacity=2, lateness_ms=20), None, "offer"),
    "overflow-block": (dict(capacity=2, lateness_ms=20, on_overflow="block"), None, "offer"),
    "overflow-raise": (dict(capacity=2, lateness_ms=20, on_overflow="raise"), None, "offer"),
    "idle-timeout": (dict(capacity=64), "idle", "idle"),
    "offer-batch": (dict(capacity=64, lateness_ms=3), None, "batch"),
}


class _GateRun:
    """One package's gate driven through a case's arrivals."""

    def __init__(self, t, event_cls, overflow_cls, registry, case):
        kwargs, kind, self.mode = GATE_CASES[case]
        self.t, self.event_cls, self.overflow_cls = t, event_cls, overflow_cls
        self.gate = t.EventTimeGate(generator=_gen(t, kind), registry=registry,
                                    query_name="g", **kwargs)
        self.out = []

    def step(self, i, chunk):
        evs = [_ev(self.event_cls, a) for a in chunk]
        if self.mode == "batch":
            self.out.append(_rel(self.gate.offer_batch(evs)))
            return
        for e in evs:
            if self.mode == "idle" and e.partition == 3 and e.offset > 30:
                continue  # partition 3 goes dark half way
            try:
                self.out.append(_rel(self.gate.offer(e)))
            except self.overflow_cls:
                self.out.append("raised")
        if self.mode == "idle":
            self.out.append(_rel(self.gate.advance_wall(40 * i)))

    def finish(self):
        self.out.append(_rel(self.gate.flush()))
        self.out.append([_tup(e) for e in self.gate.take_late()])
        return self.out


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_releases_clocks_counts_and_snapshots_equal_jax(case):
    arrivals = _arrivals(seed=sorted(GATE_CASES).index(case) + 3)
    chunks = [arrivals[i:i + 5] for i in range(0, len(arrivals), 5)]
    half = len(chunks) // 2
    jreg, preg = JaxRegistry(), MetricsRegistry()
    j = _GateRun(jtime, JaxEvent, JaxOverflowError, jreg, case)
    p = _GateRun(ptime, Event, errors.CEPOverflowError, preg, case)
    for i, chunk in enumerate(chunks[:half]):
        j.step(i, chunk)
        p.step(i, chunk)
    assert p.out == j.out
    jb = jax_serde.encode_event_time_state(j.gate.snapshot_state())
    pb = serde.encode_event_time_state(p.gate.snapshot_state())
    assert pb == jb
    # Each package's snapshot restores into the other.
    p2 = _GateRun(ptime, Event, errors.CEPOverflowError, MetricsRegistry(), case)
    p2.gate.restore_state(serde.decode_event_time_state(jb))
    j2 = _GateRun(jtime, JaxEvent, JaxOverflowError, JaxRegistry(), case)
    j2.gate.restore_state(jax_serde.decode_event_time_state(pb))
    assert serde.encode_event_time_state(p2.gate.snapshot_state()) == \
        jax_serde.encode_event_time_state(j2.gate.snapshot_state())
    for i, chunk in enumerate(chunks[half:], start=half):
        for run in (j, p, j2, p2):
            run.step(i, chunk)
    want = j.finish()
    assert p.finish() == want
    got2 = p2.finish()
    assert got2 == j2.finish()
    if case != "idle-timeout":
        # A restored idle timeout re-arms its wall anchor (a fresh grace
        # period, by design), so only there the restored run may differ
        # from the uninterrupted one.
        assert got2 == want[len(want) - len(got2):]
    assert _event_time_metrics(preg) == _event_time_metrics(jreg)
    assert serde.encode_event_time_state(p.gate.snapshot_state()) == \
        jax_serde.encode_event_time_state(j.gate.snapshot_state())
    if case == "minmerge":
        assert not want[-1] and not any(r == "raised" for r in want)


@pytest.mark.parametrize("seed", [1, 2])
def test_reorder_buffer_equals_jax(seed):
    rng = random.Random(seed)
    jb, pb = jtime.ReorderBuffer(capacity=6), ptime.ReorderBuffer(capacity=6)
    trace_j, trace_p = [], []
    for seq in range(60):
        op = rng.random()
        if op < 0.55 and not jb.full:
            t = ("k", rng.choice("AB"), TS + rng.randint(0, 20), "t", 0, seq)
            jb.push(_ev(JaxEvent, t), seq)
            pb.push(_ev(Event, t), seq)
        elif op < 0.8:
            wm = TS + rng.randint(0, 20)
            trace_j.append([(s, _tup(e)) for s, e in jb.release(wm)])
            trace_p.append([(s, _tup(e)) for s, e in pb.release(wm)])
        elif len(jb):
            ts, s, e = jb.pop_oldest()
            trace_j.append((ts, s, _tup(e)))
            ts, s, e = pb.pop_oldest()
            trace_p.append((ts, s, _tup(e)))
        assert (len(pb), pb.full, pb.peek_ts()) == (len(jb), jb.full, jb.peek_ts())
    trace_j.append([(s, _tup(e)) for s, e in jb.drain()])
    trace_p.append([(s, _tup(e)) for s, e in pb.drain()])
    assert trace_p == trace_j


def test_watermark_generators_equal_jax_and_restore_across():
    """Every generator: the same marks after the same observations and
    wall ticks, states equal, and each package's state restores into the
    other's generator."""
    rng = random.Random(4)
    steps = [(TS + rng.randint(0, 50), rng.choice("abc"), rng.random() < 0.2)
             for _ in range(80)]
    for make in (
        lambda t: t.ArrivalOrderWatermark(),
        lambda t: t.BoundedOutOfOrderness(7),
        lambda t: t.MinMergeWatermark(per_source={s: t.BoundedOutOfOrderness(3) for s in "abc"}),
        lambda t: t.IdleTimeout(t.BoundedOutOfOrderness(5), timeout_ms=30),
        lambda t: t.MinMergeWatermark(
            per_source={s: t.IdleTimeout(t.BoundedOutOfOrderness(2), 25) for s in "abc"}),
    ):
        gj, gp = make(jtime), make(ptime)
        marks_j, marks_p = [], []
        for i, (ts, src, tick) in enumerate(steps):
            if tick:
                gj.advance_wall(10 * i)
                gp.advance_wall(10 * i)
            elif src != "c" or i < 40:  # source c goes silent
                gj.observe(ts, src)
                gp.observe(ts, src)
            marks_j.append(gj.current_ms())
            marks_p.append(gp.current_ms())
            if i == 40:
                assert gp.state() == gj.state()
                rj, rp = make(jtime), make(ptime)
                rj.restore(gp.state())
                rp.restore(gj.state())
                assert (rj.current_ms(), rp.current_ms()) == (gj.current_ms(),) * 2
        assert marks_p == marks_j and gp.state() == gj.state()
        assert gp.kind == gj.kind


@pytest.mark.parametrize("seed", [5, 6])
def test_min_merge_equals_jax_under_idle_flips_and_new_sources(seed):
    """The port's merge keeps its minimum incrementally; the JAX merge
    rescans. Lockstep and random arrivals, sources first seen mid stream,
    idle flips and wall ticks: the same mark after every step."""
    rng = random.Random(seed)
    make = {
        "j": lambda: jtime.MinMergeWatermark(
            per_source={s: jtime.BoundedOutOfOrderness(2) for s in range(6)}),
        "p": lambda: ptime.MinMergeWatermark(
            per_source={s: ptime.BoundedOutOfOrderness(2) for s in range(6)}),
    }
    gj, gp = make["j"](), make["p"]()
    ts = TS
    for i in range(600):
        op = rng.random()
        if op < 0.05:
            src, idle = rng.randrange(9), rng.random() < 0.6
            gj.mark_idle(src, idle)
            gp.mark_idle(src, idle)
        elif op < 0.08:
            gj.advance_wall(i)
            gp.advance_wall(i)
        else:
            src = i % 6 if i < 300 else rng.randrange(9)
            ts += rng.choice((0, 1, 1, 3))
            t = ts - rng.randint(0, 4)
            gj.observe(t, src)
            gp.observe(t, src)
        assert gp.current_ms() == gj.current_ms(), i
    assert gp.state() == gj.state()


# ------------------------------------------- out of order == presorted, engine
def _shuffled_streams():
    """tests/test_watermarks.py's reorder differential streams: 30 events
    per key, arrivals displaced within BOUND_MS, offsets in arrival
    order; key k_i on partition i (the gate's default source)."""
    rng = random.Random(29)
    per_key = {}
    for i, k in enumerate(KEYS):
        ts = TS
        evs = []
        for n in range(30):
            ts += rng.choice((0, 1, 1, 2, 5))
            evs.append((k, rng.choice("ABCX"), ts, "t", i, n))
        srng = random.Random(1000 + i)
        order = sorted(range(len(evs)), key=lambda j: (evs[j][2] + srng.randint(0, BOUND_MS), j))
        per_key[k] = [evs[j][:5] + (pos,) for pos, j in enumerate(order)]
    return per_key


def _min_merge(t):
    return t.MinMergeWatermark(
        per_source={("t", i): t.BoundedOutOfOrderness(BOUND_MS) for i in range(len(KEYS))})


def _gate_rounds(t, event_cls, registry, per_key):
    """Round-robin arrivals through a gate; the releases of each round."""
    gate = t.EventTimeGate(capacity=CFG["reorder_capacity"], lateness_ms=BOUND_MS,
                           generator=_min_merge(t), registry=registry, query_name="diff")
    rounds = []
    for step in range(30):
        rel = []
        for k in KEYS:
            rel.extend(gate.offer(_ev(event_cls, per_key[k][step])))
        rounds.append(rel)
    rounds.append(gate.flush())
    return rounds


def _by_key(released):
    evs, wms = {}, {}
    for e, clk in released:
        evs.setdefault(e.key, []).append(e)
        wms.setdefault(e.key, []).append(clk)
    return evs, wms


def _advance_json(eng, evs, wms, to_json, out):
    for k, seqs in eng.advance(evs, watermarks=wms).items():
        out[k].extend(to_json(s) if not isinstance(s, P.SinkMatch) else s.payload.decode()
                      for s in seqs)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine on the JAX gate's releases (one batch), with every
    other match's provenance sampled."""
    per_key = _shuffled_streams()
    reg = JaxRegistry()
    rounds = _gate_rounds(jtime, JaxEvent, reg, per_key)
    eng = JaxBatched(J.compile_pattern(skipany_pattern(J)), keys=KEYS,
                     config=JaxEngineConfig(**CFG), provenance_sample=0.5,
                     query_name="diff", **JAX_OFF)
    out = {k: [] for k in KEYS}
    _advance_json(eng, *_by_key([r for rnd in rounds for r in rnd]), jax_json, out)
    stats = eng.stats
    assert stats["lane_drops"] == stats["match_drops"] == stats["node_drops"] == 0
    fam = reg.snapshot().get("cep_late_dropped_total")
    assert not fam or sum(v["value"] for v in fam["values"]) == 0
    return {"per_key": per_key, "out": out, "exemplars": eng.provenance_exemplars(10_000),
            "rounds": [_rel(r) for r in rounds]}


def test_out_of_order_equals_presorted_through_the_engine(jax_reference):
    per_key = jax_reference["per_key"]
    want = jax_reference["out"]
    assert sum(map(len, want.values())) > 0
    preg = MetricsRegistry()
    rounds = _gate_rounds(ptime, Event, preg, per_key)
    assert [_rel(r) for r in rounds] == jax_reference["rounds"]
    cfg = P.EngineConfig(**CFG)
    pattern = P.compile_pattern(skipany_pattern(P))
    # Round by round, as the gate releases.
    eng = P.BatchedDeviceNFA(pattern, keys=KEYS, config=cfg, device="cpu")
    got = {k: [] for k in KEYS}
    for rnd in rounds:
        if rnd:
            _advance_json(eng, *_by_key(rnd), P.sequence_to_json, got)
    assert got == want
    assert sum(eng.stats[k] for k in ("lane_drops", "match_drops", "node_drops")) == 0
    # The presorted stream, no gate and no watermark column.
    plain = P.BatchedDeviceNFA(pattern, keys=KEYS, config=cfg, device="cpu")
    presorted = {k: [_ev(Event, t) for t in sorted(per_key[k], key=lambda t: t[2])]
                 for k in KEYS}
    got_sorted = {k: [] for k in KEYS}
    for k, seqs in plain.advance(presorted).items():
        got_sorted[k].extend(P.sequence_to_json(s) for s in seqs)
    assert got_sorted == want
    # One batch with provenance, objects and JSON sinks: the JAX exemplars.
    released = [r for rnd in rounds for r in rnd]
    for sink_format in ("objects", "json"):
        one = P.BatchedDeviceNFA(pattern, keys=KEYS, config=cfg, device="cpu",
                                 provenance_sample=0.5, query_name="diff",
                                 sink_format=sink_format)
        got_one = {k: [] for k in KEYS}
        _advance_json(one, *_by_key(released), P.sequence_to_json, got_one)
        assert got_one == want, sink_format
        assert one.provenance_exemplars(10_000) == jax_reference["exemplars"], sink_format
        assert one.metrics.get("cep_provenance_sampled_total").labels(query="diff").value == \
            len(jax_reference["exemplars"])
    late = preg.snapshot().get("cep_late_dropped_total")
    assert not late or sum(v["value"] for v in late["values"]) == 0


def test_out_of_order_equals_presorted_through_the_topology(jax_reference):
    """The gated `runtime="cuda"` topology (micro-batches of 16, the
    processor's own gate over a per-partition min-merge) emits every key's
    matches of the JAX run, attributed to their own key."""
    per_key = jax_reference["per_key"]
    reg = MetricsRegistry()
    builder = P.ComplexStreamsBuilder()
    out = builder.stream("t").query(
        "diff", skipany_pattern(P), runtime="cuda", device="cpu", batch_size=16,
        config=P.EngineConfig(**CFG), watermark_gen=_min_merge(ptime), registry=reg)
    topo = builder.build()
    for step in range(30):
        for k in KEYS:
            key, value, ts, topic, partition, offset = per_key[k][step]
            topo.process(topic, key, value, timestamp=ts, partition=partition, offset=offset)
    health = topo.event_time_health()
    assert health["gated_queries"] == 1 and health["reorder_occupancy"] > 0
    topo.flush_event_time()
    assert topo.event_time_health()["reorder_occupancy"] == 0
    got = {k: [] for k in KEYS}
    for r in out.records:
        got[r.key].append(P.sequence_to_json(r.value))
    assert got == jax_reference["out"]
    snap = reg.snapshot()
    for name in ("cep_late_dropped_total", "cep_reorder_overflow_dropped_total"):
        fam = snap.get(name)
        assert not fam or sum(v["value"] for v in fam["values"]) == 0, name
    assert sum(out.node.processor.engine.stats[k]
               for k in ("lane_drops", "match_drops", "node_drops")) == 0


# ---------------------------------------------------------------- processors
PROC_LETTERS = "ABCABCXABCABC" * 2


def _proc_records():
    evs = [("K", v, TS + i, "t", 0, i) for i, v in enumerate(PROC_LETTERS)]
    rng = random.Random(9)
    order = sorted(range(len(evs)), key=lambda i: (evs[i][2] + rng.randint(0, 4), i))
    return [evs[i][:5] + (pos,) for pos, i in enumerate(order)]


def _proc(pkg, blob=None, config=None):
    if pkg is J:
        cls, cfg, opts = JaxProcessor, JaxEngineConfig, dict(JAX_OFF, registry=JaxRegistry())
    else:
        cls, cfg, opts = DeviceCEPProcessor, P.EngineConfig, dict(device="cpu",
                                                                  registry=MetricsRegistry())
    cfg = config if config is not None else cfg(**CFG)
    opts.update(config=cfg, batch_size=5, auto_drain=False)
    if blob is None:
        return cls("q", skipany_pattern(pkg), **opts)
    return cls.restore("q", skipany_pattern(pkg), blob, **opts)


def _feed(proc, records, to_json):
    out = []
    for key, value, ts, topic, partition, offset in records:
        out.extend(proc.process(key, value, timestamp=ts, topic=topic, partition=partition,
                                offset=offset))
    return [(k, to_json(s)) for k, s in out]


def _finish(proc, to_json):
    return [(k, to_json(s)) for k, s in proc.flush_event_time()]


def _frame_parts(blob):
    """A gated processor snapshot split into its fields (the lane handles'
    pickles name their package's module, so the key list is compared as
    (index, key) pairs and everything else byte for byte)."""
    inner, gate = serde.split_event_time(blob)
    r = serde._Reader(serde.open_frame(inner))
    serde.read_magic(r)
    er = serde._Reader(serde.open_frame(bytes(r.blob())))
    serde.read_magic(er)
    lanes = [(lane.index, lane.key) for lane in serde.loads(bytes(er.blob()))]
    engine_rest = bytes(er._data[er._pos:])
    hwm = bytes(r.blob())
    pending = [(bytes(r.blob()), bytes(r.blob())) for _ in range(r.i32())]
    clocks = bytes(r.blob())
    r.expect_end()
    return lanes, engine_rest, hwm, pending, clocks, gate


def test_processor_snapshot_with_gate_state_equals_jax_and_restores_both_ways():
    records = _proc_records()
    head, tail = records[:13], records[13:]
    jp, pp = _proc(J), _proc(P)
    assert _feed(pp, head, P.sequence_to_json) == _feed(jp, head, jax_json)
    assert pp.gate.occupancy > 0 and pp._pending_count > 0
    blob_j, blob_p = jp.snapshot(), pp.snapshot()
    assert serde.split_event_time(blob_p)[1] is not None
    assert _frame_parts(blob_p) == _frame_parts(blob_j)
    p2, j2 = _proc(P, blob_j), _proc(J, blob_p)
    assert p2.gate.occupancy == pp.gate.occupancy and p2._pending_wm == pp._pending_wm
    want = _feed(jp, tail, jax_json) + _finish(jp, jax_json)
    assert len(want) > 0
    assert _feed(j2, tail, jax_json) + _finish(j2, jax_json) == want
    for proc in (pp, p2):
        assert _feed(proc, tail, P.sequence_to_json) + _finish(proc, P.sequence_to_json) == want


@pytest.mark.parametrize("crash_at", [4, 8, 19])
def test_processor_crash_restore_is_consistent(crash_at):
    """tests/test_watermarks.py's crash-restore case: a snapshot taken
    mid stream (gate buffers, release clocks, pending records) restored
    into a fresh processor finishes with the uninterrupted run's matches."""
    records = _proc_records()
    ref = _proc(P)
    want = _feed(ref, records, P.sequence_to_json) + _finish(ref, P.sequence_to_json)
    proc = _proc(P)
    got = _feed(proc, records[:crash_at], P.sequence_to_json)
    proc = _proc(P, proc.snapshot())
    got += _feed(proc, records[crash_at:], P.sequence_to_json) + _finish(proc, P.sequence_to_json)
    assert got == want and len(want) > 0


def test_snapshot_without_gate_restores_into_a_gated_config_and_not_back():
    small = dict(lanes=16, nodes=256, matches=64)
    plain = _proc(P, config=P.EngineConfig(**small))
    for off, v in enumerate("AB"):
        plain.process("K", v, timestamp=TS + off, offset=off)
    gated_cfg = P.EngineConfig(**small, reorder_capacity=8, lateness_ms=4)
    gated = _proc(P, plain.snapshot(), config=gated_cfg)
    assert gated.gate is not None and gated._pending_count == 2
    gated.flush()  # the restored records carry no release clocks
    out = gated.process("K", "C", timestamp=TS + 2, offset=2) + gated.flush_event_time()
    assert len(out) == 1
    with pytest.raises(ValueError):
        _proc(P, gated.snapshot(), config=P.EngineConfig(**small))


def test_gate_overflow_raise_is_the_engine_error_and_keeps_the_hwm():
    """tests/test_watermarks.py's raise case on the port: the gate's
    CEPOverflowError is the one class of faults/injection.py (the engine's
    and the streams layer's), and the rejected offset retries."""
    assert errors.CEPOverflowError is injection.CEPOverflowError
    assert errors.TransientFault is injection.TransientFault
    proc = _proc(P, config=P.EngineConfig(lanes=16, nodes=256, matches=64, reorder_capacity=1,
                                          lateness_ms=1000, on_overflow="raise"))
    proc.process("K", "A", timestamp=TS, offset=0)
    with pytest.raises(injection.CEPOverflowError):
        proc.process("K", "B", timestamp=TS + 1, offset=1)
    proc.flush_event_time()
    res = proc.process("K", "B", timestamp=TS + 1, offset=1)
    assert proc.gate.occupancy == 1 or res, "the retry must not be deduped"


# ------------------------------------------------------- the "wm" column
@pytest.mark.parametrize("watermarks", [
    1_000_040, None, [None, None, None], [1_000_003, None, 1_000_010],
    [2**62, -(2**62), 1_000_000], [np.int64(1_000_007)] * 3,
], ids=["scalar", "none", "all_none", "some_none", "clamped", "numpy"])
def test_rebase_watermarks_equals_jax(watermarks):
    """The flush's "wm" column: absolute clocks rebased to the batch's
    timestamp base, None as WM_NONE, clamped into i32; equal to the JAX
    package's column."""
    from kafkastreams_cep_tpu.ops.runtime import rebase_watermarks as jax_rebase
    from kafkastreams_cep_tpu_torch.ops.runtime import rebase_watermarks

    got = rebase_watermarks(watermarks, 3, TS)
    want = jax_rebase(watermarks, 3, TS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_rebase_watermarks_refuses_a_column_of_another_length():
    from kafkastreams_cep_tpu_torch.ops.runtime import rebase_watermarks

    with pytest.raises(ValueError, match="length 2 != batch length 3"):
        rebase_watermarks([TS, TS], 3, TS)


# -------------------------------------------------------------------- models
def test_event_time_models_equal_jax_and_the_sorted_oracle():
    from kafkastreams_cep_tpu.models import exchanges as jex, sensors as jsens
    from kafkastreams_cep_tpu_torch.models import exchanges as pex, sensors as psens

    stream = pex.exchanges_stream(random.Random(17), 120)
    assert [_tup(e) for e in stream] == [
        _tup(e) for e in jex.exchanges_stream(random.Random(17), 120)]
    s_stream = psens.sensors_stream(random.Random(7), 80)
    assert [_tup(e) for e in s_stream] == [
        _tup(e) for e in jsens.sensors_stream(random.Random(7), 80)]
    assert pex.exchanges_config() == P.EngineConfig(**dataclasses.asdict(jex.exchanges_config()))

    proc = DeviceCEPProcessor("ex", pex.exchanges_pattern(), schema=pex.exchanges_schema(),
                              config=pex.exchanges_config(), batch_size=16, device="cpu",
                              registry=MetricsRegistry())
    got = []
    for e in stream:
        got.extend(proc.process(e.key, e.value, timestamp=e.timestamp, topic=e.topic,
                                offset=e.offset))
    got.extend(proc.flush_event_time())
    nfa = NFA.build(P.compile_pattern(pex.exchanges_pattern()), AggregatesStore(),
                    SharedVersionedBuffer())
    want = []
    for _i, e in sorted(enumerate(stream), key=lambda ie: (ie[1].timestamp, ie[0])):
        want.extend(nfa.match_pattern(e))
    assert [s for _k, s in got] == want and len(want) > 0

    # The idle sensor: a wall tick past the timeout releases what it held.
    gen = ptime.IdleTimeout(ptime.MinMergeWatermark(
        default_factory=lambda: ptime.BoundedOutOfOrderness(0)), timeout_ms=100)
    sens = DeviceCEPProcessor(
        "sens", psens.sensors_pattern(), schema=psens.sensors_schema(), device="cpu",
        config=P.EngineConfig(lanes=64, nodes=1024, matches=256, strict_windows=True,
                              reorder_capacity=256, lateness_ms=0),
        batch_size=1 << 30, registry=MetricsRegistry(), watermark_gen=gen)
    sens.gate.generator.advance_wall(0)
    for e in s_stream:
        sens.process(e.key, e.value, timestamp=e.timestamp, topic=e.topic, offset=e.offset)
    buffered = sens.gate.occupancy
    assert buffered > 0
    sens.tick_event_time(10_000)
    sens.tick_event_time(10_200)
    assert sens.gate.occupancy < buffered
