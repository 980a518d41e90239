"""Exact replay in the port against the JAX engine and the host oracle.

The case is tests/test_differential.py's batched replay differential
(`models/cases.py` `branchy_case`): a branchy fold pattern drawn from
`random.Random(50_000 + seed)`, keys kA/kB/kC with 20 events each, fed in
4 batches of 5, at lanes=256, nodes=4096, matches=2048,
matches_per_step=256. On such patterns two lanes that share a run id can
both fold in one event (`seq_collisions`), and the per-lane registers then
leave the reference's per-run semantics; exact replay re-runs the
interval of each such key through the host oracle at the drain and
resyncs its device state.

Both engines run at their defaults: the port `BatchedDeviceNFA(device=
"cpu")` and the JAX `BatchedDeviceNFA` (engine "auto", which is the XLA
step on the CPU). The reference matches are the JAX package's host
oracle (`nfa.NFA`) per key; the port's copy of the oracle is held to it
too. Checked:
  * seeds 72, 3, 7, 19, 42: port == JAX == oracle per key, and the
    detector's soundness (no collision, no replay); on seed 72 the port
    replays and gives kA 21, kB 9, kC 0 matches;
  * replay off: seed 72 still diverges, warns once, sets
    `cep_fold_divergence_detected`, and under on_overflow="raise" raises;
  * the ledger bound: the one-shot warning, `cep_replay_ledger_overflow`
    while the interval lasts, and the "raise" escalation;
  * `add_keys`, `resize` and `restore` inside or at the edge of an
    interval stay oracle-exact; a resize that the replay snapshot does not
    fit is refused; resyncing a key's state writes new tensors and leaves
    the interval snapshot as it was;
  * a `runtime="cuda"` topology on seed 72, keys arriving while the
    stream runs, emits record by record what the JAX engine emits for the
    same micro-batches, and per key the oracle's matches. (The JAX
    `runtime="tpu"` topology is not the reference here: its engine's keys
    are lane handles, and its replay files the oracle's fold cells under
    the lane while the oracle reads them under the record key, so on this
    case its kA and kB differ from the oracle.)
  * the engine metrics the port registers are JAX engine names, and the
    counters of the same run are equal;
  * a `DeviceCEPProcessor` snapshot restores with replay armed.
The JAX engines compile once per seed (a few seconds each); the runs
they share are cached per test process.
"""
import functools
import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.nfa import NFA as JaxNFA  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.state.aggregates import AggregatesStore as JaxAggregates  # noqa: E402
from kafkastreams_cep_tpu.state.buffer import SharedVersionedBuffer as JaxBuffer  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import branchy_case  # noqa: E402
from kafkastreams_cep_tpu_torch.nfa import NFA  # noqa: E402
from kafkastreams_cep_tpu_torch.state.aggregates import AggregatesStore  # noqa: E402
from kafkastreams_cep_tpu_torch.state.buffer import SharedVersionedBuffer  # noqa: E402
from kafkastreams_cep_tpu_torch.state.serde import ShapeRestoreError  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.errors import CEPOverflowError  # noqa: E402

SEEDS = [72, 3, 7, 19, 42]
KEYS = ["kA", "kB", "kC"]
CFG = dict(lanes=256, nodes=4096, matches=2048, matches_per_step=256)
N_BATCHES, PER_BATCH = 4, 5
#: The engine metrics both packages register for this run (the port's
#: subset of the JAX engine's names).
PORTED_ENGINE_METRICS = {
    "cep_advance_dispatch_seconds", "cep_post_dispatch_seconds", "cep_drain_seconds",
    "cep_drain_pull_seconds", "cep_decode_seconds", "cep_emit_latency_seconds",
    "cep_batches_total", "cep_drains_total", "cep_slots_total", "cep_matches_total",
    "cep_drain_bytes_total", "cep_tunnel_mbps", "cep_gc_phase", "cep_gc_flushes_total",
    "cep_auto_drains_total", "cep_pend_occupancy", "cep_region_fill",
    "cep_lane_occupancy", "cep_engine_resizes_total", "cep_pending_matches",
    "cep_chain_depth_max", "cep_replay_ledger_overflow", "cep_fold_divergence_detected",
    "cep_replays_total", "cep_engine_state_counter", "cep_overflow_backpressure_total",
    "cep_overflow_dropped_total", "cep_advance_compute_seconds", "cep_engine_info",
    "cep_provenance_sampled_total", "cep_sink_matches_total", "cep_sink_bytes_total",
    "cep_compiles_total", "cep_compile_seconds",
}
#: Counters whose values the two engines must agree on.
COUNTERS = ("cep_batches_total", "cep_drains_total", "cep_slots_total",
            "cep_matches_total", "cep_gc_flushes_total", "cep_replays_total")


@functools.lru_cache(maxsize=None)
def _case(seed):
    return branchy_case(seed, KEYS), branchy_case(seed, KEYS, dsl=J)


def _batch(streams, b, keys=KEYS):
    return {k: streams[k][b * PER_BATCH:(b + 1) * PER_BATCH] for k in keys}


def _jsons(out, to_json=P.sequence_to_json):
    return {k: [to_json(s) for s in v] for k, v in out.items() if v}


def _extend(acc, out, to_json=P.sequence_to_json):
    for k, v in _jsons(out, to_json).items():
        acc.setdefault(k, []).extend(v)


@functools.lru_cache(maxsize=None)
def _expected(seed):
    """The JAX package's host oracle per key; the port's copy of the
    oracle must give the same matches."""
    (pattern, streams), (j_pattern, j_streams) = _case(seed)
    out = {}
    for key in KEYS:
        oracle = NFA.build(P.compile_pattern(pattern), AggregatesStore(), SharedVersionedBuffer())
        j_oracle = JaxNFA.build(J.compile_pattern(j_pattern), JaxAggregates(), JaxBuffer())
        got = [P.sequence_to_json(s) for e in streams[key] for s in oracle.match_pattern(e)]
        want = [jax_json(s) for e in j_streams[key] for s in j_oracle.match_pattern(e)]
        assert got == want, f"seed {seed} key {key}: the port's oracle differs from the JAX one"
        if want:
            out[key] = want
    return out


def _port(seed, keys=KEYS, **opts):
    pattern, _ = _case(seed)[0]
    return P.BatchedDeviceNFA(P.compile_pattern(pattern), keys=list(keys), device="cpu",
                              config=P.EngineConfig(**CFG), **opts)


def _run_port(bat, seed):
    streams = _case(seed)[0][1]
    got = {}
    for b in range(N_BATCHES):
        _extend(got, bat.advance(_batch(streams, b)))
    return got


@functools.lru_cache(maxsize=None)
def _jax_run(seed):
    """The JAX engine at its defaults, one drained advance per batch:
    (engine, matches per key, (key, match) in emission order)."""
    j_pattern, j_streams = _case(seed)[1]
    bat = JaxBatched(J.compile_pattern(j_pattern), keys=KEYS, config=JaxEngineConfig(**CFG))
    got, rows = {}, []
    for b in range(N_BATCHES):
        out = bat.advance(_batch(j_streams, b))
        _extend(got, out, jax_json)
        rows += [(k, jax_json(s)) for k, v in out.items() for s in v]
    return bat, got, rows


@pytest.mark.parametrize("seed", SEEDS)
def test_port_at_defaults_equals_jax_and_oracle(seed):
    expected = _expected(seed)
    j_bat, j_got, _ = _jax_run(seed)
    bat = _port(seed)
    assert bat.exact_replay
    got = _run_port(bat, seed)
    assert j_got == expected
    assert got == expected, f"seed {seed}: port {({k: len(v) for k, v in got.items()})}, " \
        f"oracle {({k: len(v) for k, v in expected.items()})}"
    collisions = bat.stats["seq_collisions"]
    assert collisions == j_bat.stats["seq_collisions"]
    if collisions == 0:
        assert bat.replays == 0  # replay arms only on detection
    assert bat.replays == j_bat.replays
    if seed == 72:
        assert bat.replays > 0
        assert {k: len(got.get(k, [])) for k in KEYS} == {"kA": 21, "kB": 9, "kC": 0}


def test_replay_off_diverges_warns_once_and_sets_the_gauge():
    expected = _expected(72)
    bat = _port(72, exact_replay=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _run_port(bat, 72)
    assert bat.stats["seq_collisions"] > 0 and bat.replays == 0
    assert got != expected
    div = [w for w in caught if "seq_collisions > 0" in str(w.message)]
    assert len(div) == 1 and div[0].category is RuntimeWarning
    gauge = bat.metrics.get("cep_fold_divergence_detected")
    assert gauge.labels(instance=bat.instance_id).value == 1

    pattern, streams = _case(72)[0]
    raising = P.BatchedDeviceNFA(P.compile_pattern(pattern), keys=KEYS, device="cpu",
                                 config=P.EngineConfig(**CFG, on_overflow="raise"),
                                 exact_replay=False)
    with pytest.warns(RuntimeWarning), pytest.raises(CEPOverflowError, match="fold divergence"):
        for b in range(N_BATCHES):
            raising.advance(_batch(streams, b))


def test_replay_ledger_overflow_warns_sets_the_gauge_and_escalates():
    streams = _case(72)[0][1]
    bat = _port(72)
    bat.REPLAY_LEDGER_MAX_BATCHES = 2
    gauge = bat.metrics.get("cep_replay_ledger_overflow").labels(instance=bat.instance_id)
    with pytest.warns(RuntimeWarning, match="ledger exceeded") as caught:
        for b in range(3):
            bat.advance_packed(bat.pack(_batch(streams, b)), decode=False)
            assert gauge.value == (1 if b == 2 else 0)
    assert sum("ledger exceeded" in str(w.message) for w in caught) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bat.drain()
    assert gauge.value == 0 and not bat._interval_overflow
    # The next interval keeps its ledger again.
    bat.advance_packed(bat.pack(_batch(streams, 3)), decode=False)
    assert len(bat._interval_packs) == 1 and gauge.value == 0

    raising = P.BatchedDeviceNFA(P.compile_pattern(_case(72)[0][0]), keys=KEYS, device="cpu",
                                 config=P.EngineConfig(**CFG, on_overflow="raise"))
    raising.REPLAY_LEDGER_MAX_BATCHES = 1
    raising.advance_packed(raising.pack(_batch(streams, 0)), decode=False)
    with pytest.warns(RuntimeWarning), pytest.raises(CEPOverflowError, match="ledger"):
        raising.advance_packed(raising.pack(_batch(streams, 1)), decode=False)


def test_add_keys_mid_interval_stays_oracle_exact():
    """kC joins after two deferred batches of kA and kB, inside the
    interval, and takes its whole stream in the last two batches."""
    expected = _expected(72)
    streams = _case(72)[0][1]
    bat = _port(72, keys=["kA", "kB"])
    got = {}
    _extend(got, bat.advance(_batch(streams, 0, ["kA", "kB"])))
    bat.advance_packed(bat.pack(_batch(streams, 1, ["kA", "kB"])), decode=False)
    bat.add_keys(["kC"])
    assert bat._snap[0]["active"].shape[-1] == 3 and bat._collision_base.shape == (3,)
    for b in (2, 3):
        batch = _batch(streams, b, ["kA", "kB"])
        batch["kC"] = streams["kC"][(b - 2) * 10:(b - 1) * 10]
        bat.advance_packed(bat.pack(batch), decode=False)
    _extend(got, bat.drain())
    assert bat.replays > 0
    assert got == expected


def test_resize_mid_interval_stays_oracle_exact_and_checks_the_snapshot():
    expected = _expected(72)
    streams = _case(72)[0][1]
    bat = _port(72)
    got = {}
    _extend(got, bat.advance(_batch(streams, 0)))
    bat.advance_packed(bat.pack(_batch(streams, 1)), decode=False)
    assert bat.resize(replace(bat.config, lanes=384, nodes=6144))
    assert bat._snap[0]["active"].shape[0] == 384 and bat._snap[1]["node_event"].shape[0] == 6144
    for b in (2, 3):
        bat.advance_packed(bat.pack(_batch(streams, b)), decode=False)
    _extend(got, bat.drain())
    assert bat.replays > 0
    assert got == expected

    # A shrink that the live state fits but the interval's snapshot does
    # not is refused, and the engine keeps its shape.
    live = int(bat.state["active"].sum(0).max())
    snap_state, snap_pool = bat._snap
    fat = dict(snap_state, active=torch.ones_like(snap_state["active"]))
    bat._snap = (fat, snap_pool)
    with pytest.raises(ShapeRestoreError, match="replay snapshot"):
        bat.resize(replace(bat.config, lanes=max(live, 1) + 1))
    assert bat.config.lanes == 384


def test_restore_rearms_replay():
    """An engine restored from a snapshot taken at a drain replays the
    collisions of its own later interval."""
    expected = _expected(72)
    pattern, streams = _case(72)[0]
    bat = _port(72)
    got = {}
    for b in range(2):
        _extend(got, bat.advance(_batch(streams, b)))
    blob = bat.snapshot()
    restored = P.BatchedDeviceNFA.restore(P.compile_pattern(pattern), blob, device="cpu",
                                          config=P.EngineConfig(**CFG))
    assert restored.exact_replay and restored._snap is not None
    assert np.array_equal(restored._collision_base, bat.state["seq_collisions"].numpy())
    for b in (2, 3):
        restored.advance_packed(restored.pack(_batch(streams, b)), decode=False)
    _extend(got, restored.drain())
    assert restored.replays > 0
    assert got == expected


def test_resync_writes_new_tensors_and_leaves_the_snapshot():
    streams = _case(72)[0][1]
    bat = _port(72)
    bat.advance(_batch(streams, 0))
    snap_state, snap_pool = bat._snap
    held = ({n: v.clone() for n, v in snap_state.items()},
            {n: v.clone() for n, v in snap_pool.items()})
    k = 1
    new_state = {n: v[..., k].numpy().copy() for n, v in bat.state.items()}
    new_pool = {n: v[..., k].numpy().copy() for n, v in bat.pool.items()}
    new_state["runs"] = new_state["runs"] + 5
    new_pool["node_count"] = new_pool["node_count"] + 1
    before = (dict(bat.state), dict(bat.pool))
    bat._write_key_state({k: (new_state, new_pool)})
    assert int(bat.state["runs"][k]) == int(before[0]["runs"][k]) + 5
    assert int(bat.pool["node_count"][k]) == int(before[1]["node_count"][k]) + 1
    for tree, ref in zip((snap_state, snap_pool), held):
        for n, v in tree.items():
            assert torch.equal(v, ref[n]), f"the snapshot's {n} moved"
    assert bat._snap[0] is snap_state and bat._snap[1] is snap_pool
    assert bat.state["runs"] is not before[0]["runs"]


def _records(streams):
    """Record by record, the keys interleaved event by event."""
    recs, offset = [], 0
    for i in range(len(streams[KEYS[0]])):
        for key in KEYS:
            e = streams[key][i]
            recs.append((key, e.value, e.timestamp, offset))
            offset += 1
    return recs


def test_runtime_cuda_topology_equals_the_jax_engine_and_the_oracle():
    """15 records a flush are 5 of each key: the engine test's batches.
    kC arrives in the first flush past `initial_keys=2`, so the key axis
    grows (and the replay snapshot with it) inside that flush."""
    expected = _expected(72)
    pattern, streams = _case(72)[0]
    _, _, j_rows = _jax_run(72)
    builder = P.ComplexStreamsBuilder(log=P.RecordLog())
    p_out = builder.stream("letters").query(
        "q", pattern, runtime="cuda", device="cpu", config=P.EngineConfig(**CFG),
        batch_size=3 * PER_BATCH, initial_keys=2).to("matches")
    topo = builder.build()
    for key, letter, ts, offset in _records(streams):
        topo.process("letters", key, letter, timestamp=ts, offset=offset)
    topo.flush()
    p_rows = [(r.key, P.sequence_to_json(r.value)) for r in p_out.records]
    assert p_rows == j_rows
    by_key = {}
    for key, js in p_rows:
        by_key.setdefault(key, []).append(js)
    assert by_key == expected
    engine = p_out.node.processor.engine
    assert engine.exact_replay and engine.replays > 0 and engine.K == 4


def test_engine_metrics_are_jax_names_with_equal_counters():
    """The same run through both engines; `profile_every=2` (the JAX
    engine's sampled compute timing) samples advances 0 and 2 of 4."""
    j_bat, _, _ = _jax_run(72)
    bat = _port(72, profile_every=2)
    _run_port(bat, 72)
    names = set(bat.metrics.names())
    assert names == PORTED_ENGINE_METRICS
    # The JAX engine here runs without compile telemetry: its CompileWatch
    # names come from a watch of their own.
    from kafkastreams_cep_tpu.obs.compile import CompileWatch as JaxCompileWatch
    from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry

    assert names <= set(j_bat.metrics.names()) | set(JaxCompileWatch(JaxRegistry()).registry.names())
    for name in COUNTERS:
        ours = bat.metrics.get(name).value
        assert ours == j_bat.metrics.get(name).value, name
        assert ours > 0, name
    compute = bat.metrics.get("cep_advance_compute_seconds")
    for phase in ("advance", "post"):
        assert compute.labels(instance=bat.instance_id, phase=phase).count == 2
    assert bat.metrics.get("cep_gc_flushes_total").value == bat.flushes == N_BATCHES


def test_processor_snapshot_and_restore_keep_replay_armed():
    """A `DeviceCEPProcessor` snapshotted after two flushes and restored
    replays the collisions of its later flushes: both halves together are
    the oracle's matches."""
    from kafkastreams_cep_tpu_torch.streams.device_processor import DeviceCEPProcessor

    expected = _expected(72)
    pattern, streams = _case(72)[0]
    opts = dict(config=P.EngineConfig(**CFG), batch_size=3 * PER_BATCH, initial_keys=4,
                device="cpu")
    records = _records(streams)
    half = len(records) // 2
    proc = DeviceCEPProcessor("q", pattern, **opts)
    got = {}
    for key, letter, ts, offset in records[:half]:
        for k, seq in proc.process(key, letter, timestamp=ts, offset=offset):
            got.setdefault(k, []).append(P.sequence_to_json(seq))
    blob = proc.snapshot()
    restored = DeviceCEPProcessor.restore("q", pattern, blob, **opts)
    assert restored.engine.exact_replay and restored.engine._snap is not None
    for key, letter, ts, offset in records[half:]:
        for k, seq in restored.process(key, letter, timestamp=ts, offset=offset):
            got.setdefault(k, []).append(P.sequence_to_json(seq))
    for k, seq in restored.flush():
        got.setdefault(k, []).append(P.sequence_to_json(seq))
    assert restored.engine.replays > 0
    assert got == expected
