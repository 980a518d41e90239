"""The port's key mesh against the JAX package's.

The JAX side runs on the 8-device CPU mesh tests/conftest.py forces,
`key_mesh(8)` with `engine="xla"` (as tests/test_batched.py's
test_batched_sharded_over_mesh does), built with `auto_drain=False,
exact_replay=False, provenance_sample=0` so both packages drain at the
same points. The port side shards the same 16 keys over a virtual mesh of
8 on the CPU (`key_mesh(8, devices=["cpu"])`): eight shards, each with
its own tensors and its own calls of the plain step and post passes.

Held bitwise, at every advance or drain: the matches, `stats`,
`shard_stats()`, `runs` and `n_live`, of the sharded port, the unsharded
port and the sharded JAX engine, and the snapshot bytes after a flush;
for the flat and the pool drain, and for deferred advances drained every
third batch at gc_group 2 (JAX test_batched_sharded_over_mesh and
test_pallas_sharded_over_mesh, the latter's shape). Then `add_keys` on a
mesh (keys move between shards), a restore across shard counts (8 ->
none -> 4), the shard-tree slice and merge (JAX
tests/test_rebalance.py::test_slice_merge_shard_tree_bitwise), the
global reduction (JAX test_global_stats_reduction, which fails on the
JAX side for a reason of its own and stays untouched), the merged device
registries and the dryrun (in process and in a subprocess with no
conftest), the stacked engine and a runtime="cuda" topology on a mesh,
and the zero-sync scan over the sharded advance. Two cases run at the
engines' defaults (exact replay and auto_drain on): branchy seed 72 on a
mesh that does not divide K against the host oracle, and capacities that
drop lanes, nodes and matches against the JAX `key_mesh(8)` engine.
"""
from __future__ import annotations

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.parallel import StackedQueryEngine as JaxStacked  # noqa: E402
from kafkastreams_cep_tpu.parallel import key_mesh as jax_key_mesh  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.analysis import zerosync  # noqa: E402
from kafkastreams_cep_tpu_torch.carry import state_from_numpy, state_to_numpy  # noqa: E402
from kafkastreams_cep_tpu_torch.models import stacked as stacked_models  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel import key_shard  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N_KEYS = 16
KEYS = [f"k{i}" for i in range(N_KEYS)]
CFG = dict(lanes=64, nodes=512, matches=128)
#: Past 2**20 ms: the JAX restore drops a negative timestamp base (and
#: re-bases), so the frames of a restored engine would differ from the
#: port's, which keeps it.
TS = 10_000_000


def port_mesh(n):
    return P.parallel.key_mesh(n, devices=["cpu"])


def branching_pattern(m):
    """tests/test_batched.py's: skip-till-any + one_or_more, a fold and a
    window-free chain (branching, folds)."""
    return (
        m.QueryBuilder()
        .select("first").where(m.value() == "A").fold("cnt", m.agg("cnt", default=0) + 1)
        .then().select("second", m.Selected.with_skip_til_any_match()).one_or_more()
        .where(m.value() == "C")
        .then().select("latest").where(m.value() == "D")
        .build()
    )


def letter_stream(m, seed, n):
    rng = random.Random(seed)
    return [m.Event(f"k{seed}-e{i}", rng.choice("ABCD"), TS + i, "t", 0, i) for i in range(n)]


def streams(m, n, keys=KEYS, seed0=100):
    return {k: letter_stream(m, seed0 + i, n) for i, k in enumerate(keys)}


def jax_engine(keys, mesh, gc_group=1, drain_mode="flat", pattern=None):
    return JaxBatched(
        J.compile_pattern(pattern or branching_pattern(J)), keys=keys,
        config=JaxEngineConfig(**CFG, gc_group=gc_group), mesh=mesh, engine="xla",
        auto_drain=False, exact_replay=False, provenance_sample=0.0, drain_mode=drain_mode,
        compile_telemetry=False,
    )


def port_engine(keys, mesh, gc_group=1, drain_mode="flat", pattern=None):
    return P.BatchedDeviceNFA(
        P.compile_pattern(pattern or branching_pattern(P)), keys=keys,
        config=P.EngineConfig(**CFG, gc_group=gc_group), device="cpu", mesh=mesh,
        auto_drain=False, exact_replay=False, drain_mode=drain_mode,
    )


def js_jax(out):
    return {k: [jax_json(s) for s in v] for k, v in out.items() if v}


def js_port(out):
    return {k: [P.sequence_to_json(s) for s in v] for k, v in out.items() if v}


def chunk(strs, lo, hi):
    return {k: evs[lo:hi] for k, evs in strs.items() if evs[lo:hi]}


def assert_engines_agree(jx, ports, keys):
    """stats, shard_stats (per shard on a mesh, summed without), runs and
    n_live of every port engine == the JAX engine's."""
    want_stats = jx.stats
    want_shards = {k: np.asarray(v) for k, v in jx.shard_stats().items()}
    for eng in ports:
        assert eng.stats == want_stats
        got = eng.shard_stats()
        for name, arr in want_shards.items():
            if eng.n_shards == len(arr):
                assert got[name].tolist() == arr.tolist(), name
            assert int(got[name].sum()) == int(arr.sum()), name
        for k in keys:
            assert eng.runs(k) == jx.runs(k), k
            assert eng.n_live(k) == jx.n_live(k), k


# ------------------------------------------------------- sharded == unsharded
@pytest.mark.parametrize("drain_mode,deferred", [("flat", False), ("pool", False),
                                                 ("flat", True), ("pool", True)],
                         ids=["flat", "pool", "flat-deferred-g2", "pool-deferred-g2"])
def test_sharded_port_equals_unsharded_and_jax_sharded(drain_mode, deferred):
    assert len(jax.devices()) == 8, "conftest must force an 8-device CPU mesh"
    gc_group = 2 if deferred else 1
    jx = jax_engine(KEYS, jax_key_mesh(8), gc_group, drain_mode)
    sharded = port_engine(KEYS, port_mesh(8), gc_group, drain_mode)
    whole = port_engine(KEYS, None, gc_group, drain_mode)
    assert sharded.n_shards == 8 and sharded.K_padded == N_KEYS
    assert [tuple(st["active"].shape) for st in sharded._state] == [(64, 2)] * 8
    sj, sp = streams(J, 30), streams(P, 30)
    bounds = [(0, 6), (6, 100)] if not deferred else [(5 * b, 5 * b + 5) for b in range(6)]
    for b, (lo, hi) in enumerate(bounds):
        if not deferred:
            want = js_jax(jx.advance(chunk(sj, lo, hi)))
            outs = [js_port(e.advance(chunk(sp, lo, hi))) for e in (sharded, whole)]
        else:
            jx.advance_packed(jx.pack(chunk(sj, lo, hi)), decode=False)
            for e in (sharded, whole):
                e.advance_packed(e.pack(chunk(sp, lo, hi)), decode=False)
            if b % 3 != 2:
                continue
            want = js_jax(jx.drain())
            outs = [js_port(e.drain()) for e in (sharded, whole)]
        assert outs[0] == want and outs[1] == want, f"batch {b}"
        assert_engines_agree(jx, (sharded, whole), KEYS)
    assert sum(len(v) for v in want.values()) > 0
    blob = jx.snapshot()
    assert sharded.snapshot() == blob
    assert whole.snapshot() == blob
    # `state` reads the shards gathered: equal to the unsharded engine's.
    for name, leaf in whole.state.items():
        assert torch.equal(sharded.state[name], leaf), name


def test_carried_jax_sharded_state_continues_on_the_port_mesh():
    """A JAX sharded engine's gathered state split over the port's mesh
    (`state_from_numpy(..., mesh=)`) advances as the JAX engine does."""
    jx = jax_engine(KEYS, jax_key_mesh(8))
    port = port_engine(KEYS, port_mesh(8))
    sj, sp = streams(J, 12), streams(P, 12)
    jx.advance(chunk(sj, 0, 6))
    port.advance(chunk(sp, 0, 6))
    np_state = {k: np.asarray(v) for k, v in jx.state.items()}
    np_pool = {k: np.asarray(v) for k, v in jx.pool.items()}
    port.state, port.pool = state_from_numpy(np_state, np_pool, mesh=port.mesh)
    assert len(port._state) == 8 and port._state[3]["active"].shape[-1] == 2
    back_s, back_p = state_to_numpy(port._state, port._pool)
    for name, arr in np_state.items():
        assert np.array_equal(back_s[name], arr), name
    for name, arr in np_pool.items():
        assert np.array_equal(back_p[name], arr), name
    assert js_port(port.advance(chunk(sp, 6, 12))) == js_jax(jx.advance(chunk(sj, 6, 12)))
    assert port.snapshot() == jx.snapshot()


# ------------------------------------------------------ key growth, restores
def test_add_keys_on_a_mesh_moves_keys_between_shards_as_jax():
    first, extra = KEYS, [f"x{i}" for i in range(11)]
    jx = jax_engine(list(first), jax_key_mesh(8))
    port = port_engine(list(first), port_mesh(8))
    sj, sp = streams(J, 12, first + extra), streams(P, 12, first + extra)
    assert js_port(port.advance(chunk({k: sp[k] for k in first}, 0, 6))) == js_jax(
        jx.advance(chunk({k: sj[k] for k in first}, 0, 6)))
    before = {k: (port.runs(k), port.n_live(k)) for k in first}
    jx.add_keys(extra)
    port.add_keys(extra)
    # 27 keys pad to 32: 4 a shard; k2 moved from shard 1 to shard 0.
    assert port.K == 27 and port.K_padded == 32 == jx.K_padded
    assert port._shard_of("k2") == (0, 2)
    assert {k: (port.runs(k), port.n_live(k)) for k in first} == before
    assert js_port(port.advance(chunk(sp, 6, 12))) == js_jax(jx.advance(chunk(sj, 6, 12)))
    assert_engines_agree(jx, (port,), first + extra)
    assert port.snapshot() == jx.snapshot()


def test_restore_across_shard_counts_equals_jax():
    """8 shards -> no mesh -> 4 shards, both packages, each leg one batch."""
    pat_j, pat_p = J.compile_pattern(branching_pattern(J)), P.compile_pattern(branching_pattern(P))
    jx = jax_engine(KEYS, jax_key_mesh(8))
    port = port_engine(KEYS, port_mesh(8))
    sj, sp = streams(J, 18), streams(P, 18)
    opts_j = dict(engine="xla", auto_drain=False, exact_replay=False, provenance_sample=0.0,
                  compile_telemetry=False)
    opts_p = dict(device="cpu", auto_drain=False, exact_replay=False)
    for leg, (mj, mp) in enumerate([(None, None), (jax_key_mesh(4), port_mesh(4)),
                                    ("end", "end")]):
        lo, hi = 6 * leg, 6 * leg + 6
        assert js_port(port.advance(chunk(sp, lo, hi))) == js_jax(jx.advance(chunk(sj, lo, hi)))
        blob = jx.snapshot()
        assert port.snapshot() == blob, f"leg {leg}"
        if mj == "end":
            break
        jx = JaxBatched.restore(pat_j, blob, config=JaxEngineConfig(**CFG), mesh=mj, **opts_j)
        port = P.BatchedDeviceNFA.restore(pat_p, blob, config=P.EngineConfig(**CFG), mesh=mp,
                                          **opts_p)
        assert port.n_shards == (1 if mp is None else 4)
        assert_engines_agree(jx, (port,), KEYS)


def test_restore_pads_and_unpads_the_key_axis():
    """19 keys: a frame of an 8-shard engine holds 24 columns; it restores
    without a mesh at 19 and on 4 shards at 20, and back on 8 at 24, each
    continuing as the engine that never stopped."""
    keys = KEYS + ["x0", "x1", "x2"]
    pat = P.compile_pattern(branching_pattern(P))
    ref = port_engine(keys, None)
    eng = port_engine(keys, port_mesh(8))
    sp = streams(P, 18, keys)
    assert js_port(eng.advance(chunk(sp, 0, 6))) == js_port(ref.advance(chunk(sp, 0, 6)))
    for leg, (mesh, k_pad) in enumerate([(None, 19), (port_mesh(4), 20), (port_mesh(8), 24)]):
        eng = P.BatchedDeviceNFA.restore(pat, eng.snapshot(), config=P.EngineConfig(**CFG),
                                         mesh=mesh, device="cpu", auto_drain=False,
                                         exact_replay=False)
        assert eng.K_padded == k_pad
        if leg < 2:
            lo, hi = 6 + 6 * leg, 12 + 6 * leg
            assert js_port(eng.advance(chunk(sp, lo, hi))) == js_port(ref.advance(chunk(sp, lo, hi)))
    for name, leaf in ref.state.items():
        assert torch.equal(eng.state[name][..., :19], leaf), name


def test_resize_on_a_mesh_equals_the_unsharded_resize():
    sharded, whole = port_engine(KEYS, port_mesh(8)), port_engine(KEYS, None)
    sp = streams(P, 12)
    for e in (sharded, whole):
        e.advance(chunk(sp, 0, 6))
        assert e.resize(P.EngineConfig(lanes=96, nodes=768, matches=128))
    assert sharded._state[5]["active"].shape == (96, 2)
    assert js_port(sharded.advance(chunk(sp, 6, 12))) == js_port(whole.advance(chunk(sp, 6, 12)))
    assert sharded.snapshot() == whole.snapshot()


# --------------------------------------------------------- the shard trees
def test_slice_merge_shard_tree_equals_jax():
    """The counterpart of tests/test_rebalance.py::test_slice_merge_shard_tree_bitwise,
    held against the JAX functions on one numpy tree."""
    import jax.numpy as jnp

    from kafkastreams_cep_tpu.parallel.key_shard import merge_shard_tree as jax_merge
    from kafkastreams_cep_tpu.parallel.key_shard import shard_stats as jax_shard_stats
    from kafkastreams_cep_tpu.parallel.key_shard import slice_shard_tree as jax_slice

    rng = np.random.default_rng(3)
    tree = {
        "a": rng.integers(0, 99, size=(4, 16)).astype(np.int32),
        "b": rng.standard_normal((2, 3, 16)).astype(np.float32),
        "c": rng.integers(0, 2, size=(16,)).astype(bool),
    }
    shards = [key_shard.slice_shard_tree(tree, 4, s) for s in range(4)]
    jshards = [jax_slice({k: jnp.asarray(v) for k, v in tree.items()}, 4, s) for s in range(4)]
    for mine, theirs in zip(shards, jshards):
        for k in tree:
            assert mine[k].dtype == np.asarray(theirs[k]).dtype
            assert np.array_equal(mine[k], np.asarray(theirs[k]))
    assert all(sh["a"].shape == (4, 4) for sh in shards)
    rebuilt = {k: np.zeros_like(v) for k, v in tree.items()}
    jrebuilt = {k: jnp.zeros_like(jnp.asarray(v)) for k, v in tree.items()}
    for s in range(4):
        rebuilt = key_shard.merge_shard_tree(rebuilt, shards[s], 4, s)
        jrebuilt = jax_merge(jrebuilt, jshards[s], 4, s)
    for k in tree:
        assert np.array_equal(rebuilt[k], tree[k])
        assert np.array_equal(rebuilt[k], np.asarray(jrebuilt[k]))
    # The same over torch leaves.
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    tmerged = key_shard.merge_shard_tree(
        {k: torch.zeros_like(v) for k, v in ttree.items()},
        key_shard.slice_shard_tree(ttree, 4, 2), 4, 2)
    assert np.array_equal(tmerged["a"].numpy(), np.asarray(jax_merge(
        {k: jnp.zeros_like(jnp.asarray(v)) for k, v in tree.items()}, jshards[2], 4, 2)["a"]))
    with pytest.raises(ValueError):
        key_shard.slice_shard_tree(tree, 5, 0)  # 16 % 5 != 0
    with pytest.raises(ValueError):
        key_shard.slice_shard_tree(tree, 4, 4)  # shard out of range
    with pytest.raises(ValueError):
        key_shard.merge_shard_tree(tree, shards[0], 2, 0)  # block width 8, not 4
    counters = {k: rng.integers(0, 50, size=(16,)).astype(np.int32) for k in key_shard.STAT_KEYS}
    mine = key_shard.shard_stats({k: torch.from_numpy(v) for k, v in counters.items()}, 4)
    theirs = jax_shard_stats({k: jnp.asarray(v) for k, v in counters.items()}, 4)
    for k in key_shard.STAT_KEYS:
        assert mine[k].tolist() == np.asarray(theirs[k]).tolist()


def test_global_stats_reduction_on_a_mesh():
    """The port's counterpart of tests/test_batched.py::test_global_stats_reduction."""
    keys = KEYS[:8]
    sp = {k: letter_stream(P, 200 + i, 8) for i, k in enumerate(keys)}
    bat = port_engine(keys, port_mesh(8))
    bat.advance(chunk(sp, 0, 100))
    per_shard = [key_shard.global_stats(st) for st in bat._state]
    assert len(per_shard) == 8
    total = {k: sum(int(g[k]) for g in per_shard) for k in key_shard.STAT_KEYS}
    assert total["n_events"] == sum(len(s) for s in sp.values())
    assert total["runs"] == sum(bat.runs(k) for k in keys)
    assert bat.stats["n_events"] == total["n_events"]
    whole = key_shard.global_stats(bat.state)
    assert {k: int(v) for k, v in whole.items()} == total


# ------------------------------------------------------ registries, dryrun
def test_device_registries_merge_to_the_global_totals():
    from kafkastreams_cep_tpu_torch.obs.merge import merge_registries

    bat = port_engine(KEYS, port_mesh(8))
    sp = streams(P, 10)
    bat.advance(chunk(sp, 0, 10))
    regs = bat.device_registries()
    assert sorted(regs, key=int) == [str(s) for s in range(8)]
    snap = merge_registries(regs).snapshot()
    totals = {v["labels"]["counter"]: v["value"] for v in snap["cep_device_state_total"]["values"]}
    stats = bat.stats
    assert {k: int(v) for k, v in totals.items()} == stats
    runs = {v["labels"]["device"]: v["value"] for v in snap["cep_device_runs"]["values"]}
    assert sum(runs.values()) == sum(bat.runs(k) for k in KEYS)
    shard = bat.shard_stats()
    assert [runs[str(s)] for s in range(8)] == shard["runs"].tolist()
    gauge = bat.metrics.snapshot()["cep_shard_state_counter"]["values"]
    assert {(v["labels"]["counter"], v["labels"]["shard"]) for v in gauge} == {
        (c, str(s)) for c in key_shard.STAT_KEYS for s in range(8)}


def test_dryrun_multichip_in_process():
    summary = dryrun_multichip(8, devices=["cpu"])
    assert summary["mesh"] == {"shards": 8, "devices": ["cpu"] * 8, "distinct": 1,
                               "virtual": True}
    assert summary["n_events"] == 8 * 16 and summary["matches_per_key"] == 4
    assert sorted(summary["runs_per_device"], key=int) == [str(s) for s in range(8)]


def test_dryrun_multichip_subprocess_without_conftest():
    code = ("import sys\n"
            "from kafkastreams_cep_tpu_torch.parallel.dryrun import main\n"
            "main(['--devices', '8', '--device', 'cpu'])\n"
            "assert 'jax' not in sys.modules and 'kafkastreams_cep_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("merged_registry: ")
    assert '"n_events": 128' in res.stdout


def test_key_mesh_refuses_a_machine_without_cuda_and_describes_itself():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            key_shard.key_mesh()
    mesh = port_mesh(3)
    assert mesh.size == 3 and mesh.distinct == 1 and mesh.virtual
    assert key_shard.key_mesh(devices=["cpu"]).size == 1
    with pytest.raises(ValueError):
        key_shard.KeyMesh([])
    with pytest.raises(TypeError):
        port_engine(KEYS, object())


# ------------------------------------------------------ stacked, topology
def test_stacked_engine_on_a_mesh_equals_jax():
    rng = random.Random(13)
    keys = [f"s{i}" for i in range(N_KEYS)]
    raw = {k: [rng.choice("ABCDXY") for _ in range(24)] for k in keys}
    ev = {m: {k: [m.Event(k, v, TS + i, "t", 0, i) for i, v in enumerate(vals)]
              for k, vals in raw.items()} for m in (J, P)}
    cfg = dict(lanes=32, nodes=1024, matches=512, matches_per_step=16)
    jx = JaxStacked(stacked_models.letter_queries(dsl=J), keys=keys,
                    config=JaxEngineConfig(**cfg), mesh=jax_key_mesh(8), engine="xla")
    port = P.StackedQueryEngine(stacked_models.letter_queries(), keys=keys,
                                config=P.EngineConfig(**cfg), device="cpu", mesh=port_mesh(8))
    assert port.engine.n_shards == 8
    total = 0
    for lo in range(0, 24, 12):
        want = jx.advance(chunk(ev[J], lo, lo + 12))
        got = port.advance(chunk(ev[P], lo, lo + 12))
        assert {k: {q: [jax_json(s) for s in v] for q, v in per.items()}
                for k, per in want.items()} == {
            k: {q: [P.sequence_to_json(s) for s in v] for q, v in per.items()}
            for k, per in got.items()}
        total += sum(len(v) for per in got.values() for v in per.values())
    assert total > 0
    assert port.stats == jx.stats


def test_topology_on_a_mesh_equals_jax_and_the_unsharded_topology():
    """A runtime="cuda" query with mesh= (the processor grows its lanes
    8 -> 16 -> 32 by add_keys on the mesh) against the JAX runtime="tpu"
    query on its 8-device mesh and the port's unsharded query."""
    from kafkastreams_cep_tpu_torch.models.cases import letters_pattern

    rng = random.Random(21)
    recs = [(f"u{rng.randrange(20)}", rng.choice("ABCD")) for _ in range(400)]

    def run(m, **opts):
        b = m.ComplexStreamsBuilder()
        out = b.stream("letters").query("q", letters_pattern(m), batch_size=50,
                                        config=(JaxEngineConfig if m is J else P.EngineConfig)(
                                            lanes=16, nodes=256, matches=64), **opts)
        topo = b.build()
        for i, (k, v) in enumerate(recs):
            topo.process("letters", k, v, timestamp=TS + i)
        topo.flush()
        node = out.node.processor
        js = jax_json if m is J else P.sequence_to_json
        return [(r.key, js(r.value)) for r in out.records], node

    want, jnode = run(J, runtime="tpu", mesh=jax_key_mesh(8), engine="xla",
                      compile_telemetry=False)
    got, node = run(P, runtime="cuda", device="cpu", mesh=port_mesh(8))
    flat, _ = run(P, runtime="cuda", device="cpu")
    assert node.engine.n_shards == 8 and node.engine.K == 32
    assert got == want == flat and len(got) > 0


# ------------------------------------------------- at the engines' defaults
@pytest.mark.parametrize("deferred,gc_group", [(False, 1), (True, 2)],
                         ids=["drained-g1", "deferred-g2"])
def test_exact_replay_on_a_mesh_that_does_not_divide_k_equals_the_oracle(deferred, gc_group):
    """Exact replay and auto_drain on (the defaults) over a mesh of 2 for
    3 keys (padded to 4): tests/test_torch_replay.py's branchy case, seed
    72, whose lanes collide, gives each key the host oracle's matches."""
    from kafkastreams_cep_tpu_torch.models.cases import branchy_case
    from kafkastreams_cep_tpu_torch.nfa import NFA
    from kafkastreams_cep_tpu_torch.state.aggregates import AggregatesStore
    from kafkastreams_cep_tpu_torch.state.buffer import SharedVersionedBuffer

    keys = ["kA", "kB", "kC"]
    pattern, strs = branchy_case(72, keys)
    want = {}
    for k in keys:
        oracle = NFA.build(P.compile_pattern(pattern), AggregatesStore(), SharedVersionedBuffer())
        out = [P.sequence_to_json(m) for e in strs[k] for m in oracle.match_pattern(e)]
        if out:
            want[k] = out
    eng = P.BatchedDeviceNFA(
        P.compile_pattern(pattern), keys=keys, device="cpu", mesh=port_mesh(2),
        config=P.EngineConfig(lanes=256, nodes=4096, matches=2048, matches_per_step=256,
                              gc_group=gc_group))
    assert eng.exact_replay and eng.auto_drain and eng.K_padded == 4
    got = {}
    for b in range(4):
        batch = {k: strs[k][b * 5:(b + 1) * 5] for k in keys}
        if deferred:
            eng.advance_packed(eng.pack(batch), decode=False)
            out = eng.drain() if b % 2 else {}
        else:
            out = eng.advance(batch)
        for k, v in js_port(out).items():
            got.setdefault(k, []).extend(v)
    assert eng.replays > 0
    assert got == want and {k: len(v) for k, v in got.items()} == {"kA": 21, "kB": 9}


def test_dropping_capacities_with_auto_drain_equal_the_jax_mesh():
    """At capacities that drop lanes, nodes and matches, with auto_drain
    and the other options at both packages' defaults: the port on a mesh
    of 8 and the JAX engine on key_mesh(8), deferred advances drained
    every second batch, give the same matches, stats and snapshot bytes
    (11 keys, padded to 16)."""
    keys = [f"k{i}" for i in range(11)]
    cfg = dict(lanes=8, nodes=256, matches=8, matches_per_step=4, nodes_per_step=6,
               pin_interval=True, gc_group=2)
    jx = JaxBatched(J.compile_pattern(branching_pattern(J)), keys=keys,
                    config=JaxEngineConfig(**cfg), mesh=jax_key_mesh(8), engine="xla")
    pe = P.BatchedDeviceNFA(P.compile_pattern(branching_pattern(P)), keys=keys,
                            config=P.EngineConfig(**cfg), device="cpu", mesh=port_mesh(8))
    assert pe.auto_drain and pe.K_padded == 16
    strs_j, strs_p = streams(J, 40, keys=keys), streams(P, 40, keys=keys)
    got, want = {}, {}
    for b in range(8):
        jx.advance_packed(jx.pack(chunk(strs_j, b * 5, b * 5 + 5)), decode=False)
        pe.advance_packed(pe.pack(chunk(strs_p, b * 5, b * 5 + 5)), decode=False)
        if b % 2:
            for k, v in js_jax(jx.drain()).items():
                want.setdefault(k, []).extend(v)
            for k, v in js_port(pe.drain()).items():
                got.setdefault(k, []).extend(v)
    stats = jx.stats
    assert stats["lane_drops"] > 0 and stats["node_drops"] > 0 and stats["match_drops"] > 0
    assert got == want and len(got) > 0
    assert pe.stats == stats
    assert pe.snapshot() == jx.snapshot()


# ---------------------------------------------------------------- zero sync
def test_zero_sync_scan_covers_the_sharded_advance():
    assert zerosync.scan() == []
    for fn in ("BatchedDeviceNFA._shard_xs", "BatchedDeviceNFA._map_shards"):
        assert fn in zerosync.HOT_PATHS["parallel/batched.py"]
    assert "shard_xs" in zerosync.HOT_PATHS["parallel/key_shard.py"]
    src = zerosync.source("parallel/batched.py")
    anchor = "        self._state = [st for st, _ys in stepped]\n"
    assert anchor in src
    mutated = src.replace(
        anchor, anchor + "        self._n = [int(sh['n_events'].sum()) for sh in self._state]\n")
    found = zerosync.scan(overrides={"parallel/batched.py": mutated})
    assert [(f.function, f.construct) for f in found] == [
        ("BatchedDeviceNFA.advance_packed", "int() of a tensor")]
    per_shard = "        return [fn(*args) for args in zip(*per_shard)]\n"
    assert per_shard in src
    mutated = src.replace(per_shard, "        assert bool(per_shard[0][0]['active'].any())\n"
                                     + per_shard)
    found = zerosync.scan(overrides={"parallel/batched.py": mutated})
    assert [(f.function, f.construct) for f in found] == [
        ("BatchedDeviceNFA._map_shards", "bool() of a tensor")]
    ks = zerosync.source("parallel/key_shard.py")
    put = "            part[name] = torch.as_tensor(col[:, lo:hi]).contiguous().to(dev)\n"
    assert put in ks
    found = zerosync.scan(overrides={"parallel/key_shard.py": ks.replace(
        put, put + "            assert bool(part[name].any())\n")})
    assert [(f.function, f.construct) for f in found] == [("shard_xs", "bool() of a tensor")]


def test_launches_run_with_their_tensors_device_current(monkeypatch):
    """ops/step_kernel.py `call` launches under `on_device(<device>)`: the
    device is current while the library's launch runs (the mark and the
    sweep share the guard, ops/kernel_build.py)."""
    from kafkastreams_cep_tpu_torch.ops import kernel_build, step_kernel

    current = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    seen = []

    class Lib:
        def nfa_step_launch(self, ptrs, T, K, stream):
            seen.append(list(current))
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    card1 = torch.device("cuda", 1)
    step_kernel.call(Lib(), None, 2, 3, card1)
    assert seen == [[card1]] and current == []
    with kernel_build.on_device(torch.device("cpu")):
        assert current == []
