"""The pool drain (`drain_mode="pool"`) against the JAX package's.

The pool drain is the JAX engine's semantic reference drain: the group
is flushed, a [2, K] probe reads the counts and cursors, the
pend-reachable closure is marked from the ring and compacted to its rank
space (ops/engine.py `drain_compact`), and the ring and the closure's
node planes are pulled for `decode_matches` to walk. Checked on the CPU
(the plain step, the plain mark `_walk`):

  * the port's `BatchedDeviceNFA(device="cpu", engine="torch",
    drain_mode="pool")` against the JAX `BatchedDeviceNFA(engine="xla",
    drain_mode="pool")` on the same seeded inputs: at every pull the
    pulled arrays (`counts`, `pend`, `node_event`, `node_name`,
    `node_pred`) bitwise equal, and at every drain the matches per key,
    for skip-till-any, a fold query under exact replay (both packages at
    their defaults), capacity pressure with node drops (the GC nulls
    ring entries: holes), `gc_group` 2 and 4 with drains in mid-group,
    and `pin_interval`; in each case the native `decode_matches` equals
    the Python walk (`native=False`) and the pool drain equals the
    port's flat drain;
  * the stacked engine's pool decode gives the JAX stacked engine's
    (qid, Sequence) pairs, and the flat drain's;
  * the mark of `drain_compact` through the g++ emulation build of
    csrc/gc_mark.cu (the kernel's own source) bitwise equal to `_walk` on
    drain-shaped inputs: a frontier of the ring's first maxpos rows with
    -1 holes over the region's preds alone, on random graphs and on the
    pools of real drains; and `drain_compact`'s outputs with the kernel
    equal to the same with `_walk`.
"""
import random
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.schema import EventSchema as JaxEventSchema  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.parallel import StackedQueryEngine as JaxStacked  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, branchy_case  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stacked import letter_queries  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import engine as engine_mod  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel import StackedQueryEngine  # noqa: E402

RAW = ("counts", "pend", "node_event", "node_name", "node_pred")
KEYS = [f"k{i}" for i in range(8)]

#: name -> (conformance case, EngineConfig overrides, T, batches, drain
#: every n-th advance). Drains every 3rd advance at gc_group 2 and 4 fall
#: in mid-group; skip2 at 48 nodes drops nodes and leaves ring holes. Its
#: drains fall on group boundaries: a mid-group flat drain reads the
#: window without the flush the pool drain forces, and under overflow a
#: GC at another point keeps other nodes (in both packages).
POOL_CASES = {
    "skip_any": ("skip2", dict(), 10, 4, 2),
    "node_drops": ("skip2", dict(nodes=48, gc_group=2), 8, 8, 2),
    "gc_group2": ("stock", dict(gc_group=2), 10, 6, 3),
    "gc_group4": ("skip2", dict(gc_group=4), 10, 6, 3),
    "pin_interval": ("skip2", dict(matches=10 * 16, pin_interval=True, gc_group=2), 10, 6, 3),
}


def _record(eng, sink):
    """Keep a copy of every table the engine's pool drain pulls."""
    pull = eng._pull_raw_pool

    def recorded():
        raw = pull()
        if raw is not None:
            sink.append({n: np.array(raw[n]) for n in RAW})
        return raw

    eng._pull_raw_pool = recorded


def _extend(acc, out, to_json):
    for k, v in out.items():
        acc.setdefault(k, []).extend(to_json(s) for s in v)


def _same_raws(jax_raws, port_raws):
    assert len(port_raws) == len(jax_raws) > 0
    for i, (rj, rp) in enumerate(zip(jax_raws, port_raws)):
        for n in RAW:
            assert rj[n].dtype == rp[n].dtype and rj[n].shape == rp[n].shape, (i, n)
            assert np.array_equal(rj[n], rp[n]), (i, n)


def _run(engines, batches, drain_every, to_jsons):
    """Advance every engine deferred through the batches, draining each
    every `drain_every`-th advance and after the last; the matches of
    each engine at each drain."""
    per_drain = [[] for _ in engines]
    for b, chunks in enumerate(batches):
        drain = (b + 1) % drain_every == 0 or b == len(batches) - 1
        for i, (eng, chunk) in enumerate(zip(engines, chunks)):
            eng.advance_packed(eng.pack(chunk), decode=False)
            if drain:
                got = {}
                _extend(got, eng.drain(), to_jsons[i])
                per_drain[i].append(got)
    return per_drain


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_pool_drain_equals_jax_pool_drain(name):
    case, overrides, T, n_batches, drain_every = POOL_CASES[name]
    pattern, fields, stream, cfg = CASES[case]
    cfg = {**cfg, **overrides}
    jq = jax_compile_query(J.compile_pattern(pattern(J)), JaxEventSchema(fields) if fields else None)
    rng = random.Random(5)
    sj = {k: stream(rng, T * n_batches, J) for k in KEYS}
    rng = random.Random(5)
    sp = {k: stream(rng, T * n_batches) for k in KEYS}
    jax_eng = JaxBatched(jq, keys=KEYS, config=JaxEngineConfig(**cfg), engine="xla",
                         drain_mode="pool", auto_drain=False, exact_replay=False,
                         provenance_sample=0.0, compile_telemetry=False)

    def port(**opts):
        q = P.compile_query(P.compile_pattern(pattern()), P.EventSchema(fields) if fields else None)
        return P.BatchedDeviceNFA(q, keys=KEYS, config=P.EngineConfig(**cfg), device="cpu",
                                  engine="torch", auto_drain=False, exact_replay=False, **opts)

    pool, pool_py, flat = port(drain_mode="pool"), port(drain_mode="pool", native=False), port()
    jax_raws, port_raws = [], []
    _record(jax_eng, jax_raws)
    _record(pool, port_raws)
    batches = [[{k: s[b * T:(b + 1) * T] for k, s in streams.items()} for streams in
                (sj, sp, sp, sp)] for b in range(n_batches)]
    want, got, got_py, got_flat = _run(
        [jax_eng, pool, pool_py, flat], batches, drain_every,
        [jax_json, P.sequence_to_json, P.sequence_to_json, P.sequence_to_json])
    _same_raws(jax_raws, port_raws)
    assert got == want
    assert got_py == got and got_flat == got
    assert sum(len(v) for d in got for v in d.values()) > 0
    assert pool.stats == jax_eng.stats
    label = pool.metrics.get("cep_engine_info").labels(
        instance=pool.instance_id, engine="torch", drain_mode="pool")
    assert label.value == 1
    if name == "node_drops":
        assert pool.stats["node_drops"] > 0
        # GC-nulled ring entries: -1 within a key's counted entries.
        assert any((r["pend"][k, :c] < 0).any() for r in port_raws
                   for k, c in enumerate(r["counts"]))
    if drain_every % overrides.get("gc_group", 1):
        assert flat.flushes < pool.flushes  # the pool drain flushed in mid-group


def test_fold_query_under_exact_replay_equals_jax_pool_drain():
    """tests/test_torch_replay.py's seed 72 (kA replays) at both packages'
    defaults but the drain: every pull bitwise, the replayed matches
    equal."""
    keys = ["kA", "kB", "kC"]
    cfg = dict(lanes=256, nodes=4096, matches=2048, matches_per_step=256)
    (pattern, sp), (j_pattern, sj) = branchy_case(72, keys), branchy_case(72, keys, dsl=J)
    jax_eng = JaxBatched(J.compile_pattern(j_pattern), keys=keys, config=JaxEngineConfig(**cfg),
                         drain_mode="pool")
    pool = P.BatchedDeviceNFA(P.compile_pattern(pattern), keys=keys,
                              config=P.EngineConfig(**cfg), device="cpu", drain_mode="pool")
    flat = P.BatchedDeviceNFA(P.compile_pattern(pattern), keys=keys,
                              config=P.EngineConfig(**cfg), device="cpu")
    assert pool.exact_replay and jax_eng.exact_replay
    jax_raws, port_raws = [], []
    _record(jax_eng, jax_raws)
    _record(pool, port_raws)
    batches = [[{k: s[b * 5:(b + 1) * 5] for k, s in streams.items()} for streams in
                (sj, sp, sp)] for b in range(4)]
    want, got, got_flat = _run([jax_eng, pool, flat], batches, 1,
                               [jax_json, P.sequence_to_json, P.sequence_to_json])
    _same_raws(jax_raws, port_raws)
    assert got == want and got_flat == got
    assert pool.replays == jax_eng.replays > 0
    assert sum(len(d.get("kA", [])) for d in got) == 21


def test_stacked_pool_decode_carries_qids():
    """Config 4's letter queries stacked: the pool drain's (qid, Sequence)
    pairs equal the JAX stacked engine's pool drain and the port's flat
    drain, in the native decoder and the Python walk alike."""
    keys = [f"k{i}" for i in range(6)]
    cfg = dict(lanes=32, nodes=1024, matches=512, matches_per_step=16, gc_group=2)
    rng = random.Random(13)
    letters = {k: [rng.choice("ABCD") for _ in range(48)] for k in keys}

    def batches(m):
        return [{k: [m.Event(k, v, 1000 + i, "t", 0, i) for i, v in enumerate(s)][b:b + 12]
                 for k, s in letters.items()} for b in range(0, 48, 12)]

    jax_eng = JaxStacked(letter_queries(dsl=J), keys=keys, config=JaxEngineConfig(**cfg),
                         engine="xla", drain_mode="pool")

    def port(**opts):
        return StackedQueryEngine(letter_queries(), keys=keys, config=P.EngineConfig(**cfg),
                                  device="cpu", **opts)

    engines = [jax_eng, port(drain_mode="pool"), port(drain_mode="pool", native=False), port()]
    assert engines[1].engine.drain_mode == "pool"
    jb, pb = batches(J), batches(P)
    outs = []
    for eng, bs, to_json in zip(engines, (jb, pb, pb, pb),
                                (jax_json, P.sequence_to_json, P.sequence_to_json,
                                 P.sequence_to_json)):
        got = {}
        for b, chunk in enumerate(bs):
            eng.advance_packed(eng.pack(chunk), decode=False)
            if b % 3 == 2 or b == len(bs) - 1:
                for k, per_q in eng.drain().items():
                    for qname, seqs in per_q.items():
                        got.setdefault((k, qname), []).extend(to_json(s) for s in seqs)
        outs.append(got)
    assert outs[1] == outs[0] and outs[2] == outs[0] and outs[3] == outs[0]
    assert {q for _k, q in outs[0]} == {q for q, _ in letter_queries()}
    # The decoders themselves hand out (qid, Sequence) pairs.
    eng = port(drain_mode="pool")
    pairs = eng.engine.advance(pb[0])
    assert pairs and all(isinstance(item, tuple) and isinstance(item[0], int)
                         for items in pairs.values() for item in items)


# ----------------------------------------------------- the drain's mark kernel
@pytest.fixture(scope="module")
def cpu_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    return gk.load_library(gk.build_library(target="cpu"))


def _drain_inputs(rng, B, M, K, holes):
    """A region's creation-ordered preds [B, K] and a ring [M, K]: each
    key's first pend_pos rows hold node ids (a `holes` share of them -1,
    chains a GC nulled), the rest -1; returns (pred, pend, maxpos)."""
    pred = np.full((B, K), -1, np.int32)
    pend = np.full((M, K), -1, np.int32)
    pos = [rng.randrange(0, M + 1) for _ in range(K)]
    for k in range(K):
        for i in range(1, B):
            if rng.random() < 0.85:
                pred[i, k] = rng.randrange(max(0, i - 6), i)
        for j in range(pos[k]):
            if rng.random() >= holes:
                pend[j, k] = rng.randrange(B)
    return torch.from_numpy(pred), torch.from_numpy(pend), max(pos)


@pytest.mark.parametrize("B,M,K,holes", [(64, 16, 8, 0.3), (200, 40, 13, 0.5), (96, 1, 4, 0.0),
                                         (128, 64, 33, 0.9)])
def test_drain_mark_kernel_equals_walk_on_drain_shapes(cpu_lib, B, M, K, holes):
    rng = random.Random(B * 1000 + M * 10 + K)
    pred, pend, maxpos = _drain_inputs(rng, B, M, K, holes)
    seed = torch.zeros((B + 1, K), dtype=torch.bool)
    frontier = pend[:maxpos]
    want = gk._walk(seed, frontier, pred)
    for kpb in (0, 4, 32):
        got = gk.launch(cpu_lib, seed, frontier.contiguous(), pred, keys_per_block=kpb)
        assert torch.equal(got, want), kpb
    assert torch.equal(gk.launch(cpu_lib, seed, frontier.contiguous(), pred,
                                 global_bitmaps=True), want)
    assert not want[B].any()  # the trash row comes back as seeded


def test_drain_compact_with_the_kernel_equals_the_walk_on_real_drains(cpu_lib, monkeypatch):
    """The pools of the node-drop case's drains (holes in the ring):
    `drain_compact` with the emulated kernel as its mark gives the
    (pend_r, nodes3, pcount) it gives with `_walk`."""
    case, overrides, T, n_batches, drain_every = POOL_CASES["node_drops"]
    pattern, fields, stream, cfg = CASES[case]
    q = P.compile_query(P.compile_pattern(pattern()), None)
    eng = P.BatchedDeviceNFA(q, keys=KEYS, config=P.EngineConfig(**{**cfg, **overrides}),
                             device="cpu", drain_mode="pool", auto_drain=False)
    captured = []
    compact = eng._drain_compact

    def capture(pool, maxpos):
        captured.append((dict(pool), maxpos))
        return compact(pool, maxpos)

    eng._drain_compact = capture
    rng = random.Random(5)
    streams = {k: stream(rng, T * n_batches) for k in KEYS}
    for b in range(n_batches):
        eng.advance_packed(eng.pack({k: s[b * T:(b + 1) * T] for k, s in streams.items()}),
                           decode=False)
        if (b + 1) % drain_every == 0:
            eng.drain()
    assert captured and any(((p["pend"][:m] < 0) & (torch.arange(m)[:, None] < p["pend_pos"])).any()
                            for p, m in captured)
    launches = []

    def kernel_mark(marked, frontier, pred):
        launches.append(frontier.shape[0])
        return gk.launch(cpu_lib, marked, frontier.contiguous(), pred)

    for pool, maxpos in captured:
        want = engine_mod.drain_compact(pool, maxpos)
        monkeypatch.setattr(engine_mod, "gc_mark", kernel_mark)
        got = engine_mod.drain_compact(pool, maxpos)
        monkeypatch.undo()
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert launches == [m for _p, m in captured]  # F = maxpos rows, one launch a drain
