"""The port's stacked multi-query engine against the JAX package's.

`compile_multi_query` (ops/tables.py) stacks Q compiled queries into one
table set, and `StackedQueryEngine` (parallel/stacked.py) advances them as
one program whose matches route back to their query by the chain's
stage-name id. Checked on the CPU (the plain step; the kernel's source
over stacked and wide tables is tests/test_torch_step.py's):

  * every table array, `name_of_id`, `qid_of_name_id`, `begin_stages`,
    `agg_slots`/`agg_defaults` and the sizes equal the JAX function's, on
    the JAX tests' two workloads (tests/test_stacked.py: the four letter
    queries of BASELINE config 4, and a fold-and-window query beside a
    letter query), and the two refusals (a fold name shared across
    queries, a CompiledQuery of another schema) raise;
  * `StackedQueryEngine(device="cpu")` on those workloads equals the JAX
    `StackedQueryEngine(engine="xla")` per key, per query and in order,
    with state and pool bitwise equal after every advance (gc_group 1:
    each advance ends in a group flush), and equals the port's own
    independent engines, one per query; and, deferred with a drain every
    third batch at gc_group 2 and 4 under `pin_interval` (group flushes of
    several windows through the GC kernels' plain versions), the same
    matches at every drain and the same snapshot bytes;
  * query attribution: the native decoder and the Python walk give the
    same (qid, Sequence) pairs, provenance names a match by its query,
    the JSON sink, the mesh and unknown drain modes are refused, and the
    pool drain is accepted;
  * the wide stack (eight rotations of the flagship pattern: 72 stages,
    120 predicates) per query equals eight independent engines.
The EngineConfigs are the JAX tests', so the JAX side reuses their
compiles.
"""
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.schema import EventSchema as JaxEventSchema  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_multi_query as jax_compile_multi_query  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu.parallel import StackedQueryEngine as JaxStacked  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stacked import (  # noqa: E402
    letter_queries, letters_query, rotated_skip_any_queries,
)
from kafkastreams_cep_tpu_torch.ops.tables import compile_multi_query  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel import StackedQueryEngine  # noqa: E402

TABLES = ("consume_op", "consume_pred", "consume_target", "ignore_pred", "proceed_kind",
          "proceed_pred", "proceed_target", "window_ms", "name_id", "pure_name_id",
          "is_begin", "is_final", "is_fwd", "fwd_final", "pred_stateful", "qid_of_name_id")


def _counted(tag, dsl):
    m = dsl
    return (
        m.QueryBuilder()
        .select(f"{tag}-first").where(m.value() == "A")
        .fold(f"{tag}-n", m.agg(f"{tag}-n", default=0) + 1)
        .then()
        .select(f"{tag}-second").where((m.value() == "B") & (m.agg(f"{tag}-n", default=0) <= 2))
        .within(ms=8)
        .build()
    )


#: name -> (named queries of a package, keys, events per key, batch,
#: stream seed, stacked EngineConfig, independent EngineConfig): the two
#: workloads of tests/test_stacked.py.
WORKLOADS = {
    "letters": (lambda m: letter_queries(dsl=m), [f"k{i}" for i in range(6)], 48, 12, 13,
                dict(lanes=32, nodes=1024, matches=512, matches_per_step=16),
                dict(lanes=16, nodes=1024, matches=512, matches_per_step=16)),
    "folds": (lambda m: [("qx", _counted("qx", m)), ("qy", letters_query("qy", "BCD", m))],
              ["ka", "kb"], 40, 10, 3,
              dict(lanes=32, nodes=512, matches=256, matches_per_step=16),
              dict(lanes=16, nodes=512, matches=256, matches_per_step=16)),
}


def _streams(name, m):
    keys, n, seed = WORKLOADS[name][1], WORKLOADS[name][2], WORKLOADS[name][4]
    rng = random.Random(seed)
    return {k: [m.Event(k, rng.choice("ABCD"), 1000 + i, "t", 0, i) for i in range(n)]
            for k in keys}


def _batches(name, m):
    n, b = WORKLOADS[name][2], WORKLOADS[name][3]
    streams = _streams(name, m)
    return [{k: s[i:i + b] for k, s in streams.items()} for i in range(0, n, b)]


def _collect(acc, out, to_json):
    for k, per_q in out.items():
        for q, seqs in per_q.items():
            acc.setdefault((k, q), []).extend(to_json(s) for s in seqs)


def _diffs(jax_tree, port_tree):
    return [n for n in jax_tree
            if not np.array_equal(np.asarray(jax_tree[n]), port_tree[n].numpy())
            or np.asarray(jax_tree[n]).dtype != port_tree[n].numpy().dtype]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_compile_multi_query_equals_jax(name):
    qp = compile_multi_query(WORKLOADS[name][0](P))
    qj = jax_compile_multi_query(WORKLOADS[name][0](J))
    for t in TABLES:
        a, b = getattr(qj, t), getattr(qp, t)
        assert a.dtype == b.dtype and np.array_equal(a, b), t
    for attr in ("n_stages", "n_preds", "n_aggs", "max_depth", "name_of_id", "begin_stage",
                 "begin_stages", "agg_slots", "agg_defaults", "query_names"):
        assert getattr(qp, attr) == getattr(qj, attr), attr
    assert qp.host_stages is None and qj.host_stages is None
    assert len(qp.predicates) == qp.n_preds and len(qp.folds) == qp.n_stages
    assert [[s for s, _ in f] for f in qp.folds] == [[s for s, _ in f] for f in qj.folds]


def test_compile_multi_query_refuses_a_shared_fold_name():
    def q_with_fold(tag):
        return (P.QueryBuilder()
                .select(f"{tag}-a").where(P.value() == "A")
                .fold("shared", P.agg("shared", default=0) + 1)
                .then().select(f"{tag}-b").where(P.value() == "B")
                .build())

    with pytest.raises(ValueError, match="shared"):
        compile_multi_query([("q0", q_with_fold("q0")), ("q1", q_with_fold("q1"))])


def test_compile_multi_query_refuses_a_query_of_another_schema():
    cq = P.compile_query(P.compile_pattern(letters_query("q0", "ABC")), P.EventSchema())
    with pytest.raises(ValueError, match="shared schema"):
        compile_multi_query([("q0", cq)], schema=P.EventSchema())
    with pytest.raises(ValueError, match="at least one"):
        compile_multi_query([])


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_stacked_engine_equals_jax_and_independent_engines(name):
    make, keys, _n, _b, _seed, cfg, solo_cfg = WORKLOADS[name]
    port = StackedQueryEngine(make(P), keys=keys, config=P.EngineConfig(**cfg), device="cpu")
    jax_eng = JaxStacked(make(J), keys=keys, config=JaxEngineConfig(**cfg), engine="xla")
    assert not port.engine.exact_replay  # no host stages: replay is off
    got, want = {}, {}
    for b, (chunk_p, chunk_j) in enumerate(zip(_batches(name, P), _batches(name, J))):
        _collect(got, port.advance(chunk_p), P.sequence_to_json)
        _collect(want, jax_eng.advance(chunk_j), jax_json)
        assert got == want, f"{name} batch {b}: matches differ"
        # gc_group 1: every advance ended in a group flush.
        assert not _diffs(jax_eng.engine.state, port.engine.state), f"{name} batch {b} state"
        assert not _diffs(jax_eng.engine.pool, port.engine.pool), f"{name} batch {b} pool"
    assert sum(len(v) for v in got.values()) > 0
    assert all(port.stats[k] == 0 for k in ("lane_drops", "node_drops", "match_drops"))
    # The same queries, each on its own engine.
    for qname, pattern in make(P):
        solo = P.BatchedDeviceNFA(P.compile_pattern(pattern), keys=keys,
                                  config=P.EngineConfig(**solo_cfg), device="cpu")
        alone = {}
        for chunk in _batches(name, P):
            for k, seqs in solo.advance(chunk).items():
                alone.setdefault((k, qname), []).extend(P.sequence_to_json(s) for s in seqs)
        for k in keys:
            assert got.get((k, qname), []) == alone.get((k, qname), []), f"{qname}/{k}"


@pytest.mark.parametrize("gc_group", [2, 4])
def test_stacked_engine_deferred_group_flushes_equal_jax(gc_group):
    make, keys, _n, _b, _seed, cfg, _ = WORKLOADS["letters"]
    cfg = dict(cfg, gc_group=gc_group, pin_interval=True)
    port = StackedQueryEngine(make(P), keys=keys, config=P.EngineConfig(**cfg), device="cpu")
    jax_eng = JaxStacked(make(J), keys=keys, config=JaxEngineConfig(**cfg), engine="xla")
    got, want = {}, {}
    batches = list(zip(_batches("letters", P), _batches("letters", J)))
    for b, (chunk_p, chunk_j) in enumerate(batches):
        assert not port.advance_packed(port.pack(chunk_p), decode=False)
        jax_eng.advance_packed(jax_eng.pack(chunk_j), decode=False)
        if b % 3 == 2 or b == len(batches) - 1:
            _collect(got, port.drain(), P.sequence_to_json)
            _collect(want, jax_eng.drain(), jax_json)
            assert got == want, f"gc_group {gc_group} drain after batch {b}: matches differ"
            assert port.snapshot() == jax_eng.snapshot(), f"gc_group {gc_group} batch {b}"
    assert sum(len(v) for v in got.values()) > 0 and port.engine.flushes > 0
    assert all(port.stats[k] == 0 for k in ("lane_drops", "node_drops", "match_drops"))


def test_query_attribution_native_equals_python_and_names_provenance():
    make, keys, _n, _b, _seed, cfg, _ = WORKLOADS["letters"]
    outs = []
    for native in (True, False):
        eng = P.BatchedDeviceNFA(compile_multi_query(make(P)), keys=keys,
                                 config=P.EngineConfig(**cfg), device="cpu",
                                 native=native, provenance_sample=1.0)
        pairs = []
        for chunk in _batches("letters", P):
            for k, items in eng.advance(chunk).items():
                for qid, seq in items:  # (qid, Sequence) pairs
                    pairs.append((k, qid, P.sequence_to_json(seq), seq.provenance.query))
        outs.append(pairs)
    assert outs[0] == outs[1] and outs[0]
    names = [q for q, _ in make(P)]
    assert all(prov == names[qid] for _k, qid, _s, prov in outs[0])
    assert {qid for _k, qid, _s, _p in outs[0]} == set(range(len(names)))


def test_native_decoder_refuses_a_malformed_query_table():
    from kafkastreams_cep_tpu_torch.core.sequence import Sequence, Staged
    from kafkastreams_cep_tpu_torch.native import load_decoder

    planes = [np.zeros((1, 1, 1), np.int32)] * 3
    with pytest.raises(ValueError, match="qid_of_name_id must be int32"):
        load_decoder().decode_matches_flat(
            np.zeros(1, np.int32), *planes, ["a"], {}, Staged, Sequence,
            np.zeros(1, np.int64))


def test_stacked_engine_refuses_json_sinks_meshes_and_other_drain_modes():
    make, keys, *_ = WORKLOADS["letters"]
    with pytest.raises(ValueError, match="stacked"):
        StackedQueryEngine(make(P), keys=keys, device="cpu", sink_format="json")
    with pytest.raises(ValueError, match="mesh"):
        StackedQueryEngine(make(P), keys=keys, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="drain_mode"):
        StackedQueryEngine(make(P), keys=keys, device="cpu", drain_mode="chains")
    # The pool drain is ported (tests/test_torch_pool_drain.py holds it).
    assert StackedQueryEngine(make(P), keys=keys, device="cpu",
                              drain_mode="pool").engine.drain_mode == "pool"


def test_wide_stack_per_query_equals_independent_engines():
    """72 stages and 120 predicates: per key and query, in order, what
    eight independent flagship-rotation engines give (plain step)."""
    keys, T, n_batches = ["k0", "k1", "k2"], 64, 2
    rng = random.Random(7)
    streams = {k: skip_any.skip_any8_stream(rng, T * n_batches) for k in keys}
    chunks = [{k: s[b * T:(b + 1) * T] for k, s in streams.items()} for b in range(n_batches)]
    cfg = dict(skip_any.FLAGSHIP_CONFIG, lanes=256, nodes=8192)
    stacked = StackedQueryEngine(rotated_skip_any_queries(), keys=keys,
                                 config=P.EngineConfig(**cfg), device="cpu")
    assert stacked.query.n_stages == 72 and stacked.query.n_preds == 120
    got = {}
    for chunk in chunks:
        _collect(got, stacked.advance(chunk), P.sequence_to_json)
    for qname, pattern in rotated_skip_any_queries():
        solo = P.BatchedDeviceNFA(P.compile_pattern(pattern), keys=keys,
                                  config=P.EngineConfig(**skip_any.FLAGSHIP_CONFIG), device="cpu")
        for chunk in chunks:
            for k, seqs in solo.advance(chunk).items():
                want = [P.sequence_to_json(s) for s in seqs]
                have = got.setdefault((k, qname), [])
                assert have[:len(want)] == want, f"{qname}/{k}"
                del have[:len(want)]
    assert not any(got.values()), "matches no independent engine gave"
    assert all(stacked.stats[k] == 0 for k in ("lane_drops", "node_drops", "match_drops"))
