"""The port's `runtime="cuda"` topology against the JAX package's
`runtime="tpu"` topology.

Everything runs on the CPU: the port side with `device="cpu"` (the plain
step behind the same driver, native pack and decode, processor, emission
gate and sink), the JAX side with `engine="xla"` and the options the port
leaves out turned off (`auto_drain=False`, `provenance_sample=0`,
`drain_mode="flat"`) and `exact_replay=False` (the letters query has no
folds, so replay arms on neither side), both with one small
EngineConfig so the JAX side compiles once per key extent:
  * the stock demo golden out of `runtime="cuda"`, batch_size 3 and 100
    (tests/test_stock_demo.py's device cases);
  * a letters stream over 6 keys, keys arriving two at a time against
    `initial_keys=2` so that the key axis grows twice (2 -> 4 -> 8) with
    live state and an open GC group (gc_group=2), and one replayed offset
    below a key's high-water mark: every output record (key, JSON,
    timestamp, topic, partition, offset) equal, record by record, and the
    `.to()` sink topic's key and value bytes equal -- the port with
    sink_format "objects" and "json", each against one JAX objects run
    (the JAX package pins its json bytes and digests to its objects
    run's);
  * options the port lacks (`mesh=`, `runtime="tpu"`, an unknown
    keyword) raise, `compile_cost_estimates=True` raises, and the ported
    ones (`drain_mode="pool"`, `sink_format="arrow"`, the host and auto
    runtimes, `target_emit_ms`) reach the engine; every sink key carries
    a distinct emission digest;
  * a record the schema cannot pack is quarantined alone, while a failed
    native build or a failure after the step raises out of the topology
    and re-runs nothing.
"""
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.streams.log import RecordLog as JaxRecordLog  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import STOCK_FIELDS, TS0, letters_pattern  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stocks import (  # noqa: E402
    GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
)

CFG = dict(lanes=8, nodes=128, matches=64, matches_per_step=8, nodes_per_step=4,
           gc_group=2)
JAX_OFF = dict(engine="xla", auto_drain=False, exact_replay=False,
               provenance_sample=0.0, drain_mode="flat", compile_telemetry=False)


@pytest.mark.parametrize("batch_size", [3, 100])
def test_stock_golden_through_runtime_cuda(batch_size):
    log = P.RecordLog()
    builder = P.ComplexStreamsBuilder(log=log)
    out = builder.stream("stock-events").query(
        "Stocks", stocks_pattern(), P.Queried(schema=P.EventSchema(STOCK_FIELDS)),
        runtime="cuda", batch_size=batch_size, device="cpu",
        config=P.EngineConfig(lanes=32, nodes=512, matches=64),
    ).to("matches")
    topology = builder.build()
    for i, event in enumerate(GOLDEN_EVENTS):
        topology.process("stock-events", "K1", event, timestamp=i)
    topology.flush()
    assert [P.sequence_to_json(r.value) for r in out.records] == GOLDEN_MATCHES
    assert all(r.key == "K1" for r in out.records)
    assert [r.value.decode() for r in log.read("matches")] == GOLDEN_MATCHES


def _letters_records():
    """(key, letter, timestamp, offset) in arrival order: 6 keys arriving
    two at a time, 24 records each, then one replay of an offset below its
    key's high-water mark."""
    rng = random.Random(11)
    keys = [f"u{i}" for i in range(6)]
    recs, offset = [], 0
    for first in (0, 2, 4):
        for i in range(48):
            key = keys[first + (i % 2)]
            # Mostly A, B, C in turn per key, so strict runs complete often.
            letter = "ABC"[(i // 2) % 3] if rng.random() < 0.85 else rng.choice("ABCD")
            recs.append((key, letter, TS0 + offset, offset))
            offset += 1
    replay = recs[100]
    recs.insert(130, replay)
    return recs


def _drive(topology, records):
    outs = []
    for key, letter, ts, offset in records:
        outs += topology.process("letters", key, letter, timestamp=ts, offset=offset)
    return outs + topology.flush()


def _rows(records, to_json):
    def val(v):
        return v.payload.decode() if hasattr(v, "payload") else to_json(v)
    return [(r.key, val(r.value), r.timestamp, r.topic, r.partition, r.offset)
            for r in records]


def test_letters_topology_equals_jax_record_by_record():
    """One JAX run (objects) is the reference for both port runs: the JAX
    package pins its json sink bytes and digests to its objects run's."""
    records = _letters_records()
    opts = dict(batch_size=16, initial_keys=2)

    j_log = JaxRecordLog()
    jb = J.ComplexStreamsBuilder(log=j_log)
    j_out = jb.stream("letters").query(
        "Letters", letters_pattern(J), runtime="tpu",
        config=JaxEngineConfig(**CFG), **opts, **JAX_OFF).to("matches")
    j_rows = _rows(_drive(jb.build(), records), jax_json)
    assert _rows(j_out.records, jax_json) == j_rows
    assert len(j_rows) >= 20
    j_sink = [(r.key, r.value, r.timestamp) for r in j_log.read("matches")]
    assert len(j_sink) == len(j_rows)

    for sink_format in ("objects", "json"):
        p_log = P.RecordLog()
        pb = P.ComplexStreamsBuilder(log=p_log)
        p_out = pb.stream("letters").query(
            "Letters", letters_pattern(), runtime="cuda", device="cpu",
            config=P.EngineConfig(**CFG), sink_format=sink_format, **opts).to("matches")
        p_rows = _rows(_drive(pb.build(), records), P.sequence_to_json)
        assert p_rows == j_rows, sink_format
        assert _rows(p_out.records, P.sequence_to_json) == j_rows, sink_format
        engine = p_out.node.processor.engine
        assert engine.K == 8 and engine.pack_route == "native"
        # The replayed record was deduped: every other record was packed once.
        assert engine._next_gidx == len(records) - 1
        assert all(isinstance(r.value, P.SinkMatch) == (sink_format == "json")
                   for r in p_out.records)
        p_sink = [(r.key, r.value, r.timestamp) for r in p_log.read("matches")]
        assert p_sink == j_sink, sink_format


def _opt_id(case):
    opt = case[0]
    return next(iter(opt)) + "=" + str(next(iter(opt.values())))[:12]


# Options of the JAX engine the port has no parameter for raise TypeError
# from the signature; values the port cannot honour raise ValueError. The
# cases whose expected error is None were ported since (the host and auto
# runtimes, the micro-drain dial, the pool drain and the Arrow sink) and
# must now be accepted; compile_cost_estimates=True is a parameter now
# and raises ValueError (an nvcc build has no cost model).
@pytest.mark.parametrize("opt", [
    ({"runtime": "host"}, None), ({"runtime": "tpu"}, ValueError),
    ({"sink_format": "arrow"}, None),
    ({"compile_cost_estimates": True}, ValueError),
    ({"target_emit_ms": 5.0}, None), ({"drain_mode": "pool"}, None),
    ({"mesh": object()}, TypeError),
    ({"runtime": "auto"}, None),
], ids=_opt_id)
def test_unported_options_raise(opt):
    opt, exc = opt
    opts = {"runtime": "cuda", "device": "cpu", **opt}
    if exc is not None:
        with pytest.raises(exc):
            P.ComplexStreamsBuilder().stream("letters").query("q", letters_pattern(), **opts)
        return
    out = P.ComplexStreamsBuilder().stream("letters").query("q", letters_pattern(), **opts)
    proc = out.node.processor
    if "runtime" in opt:
        assert out.node.runtime == opt["runtime"]
        assert proc.runtime == "host" if opt["runtime"] == "auto" else proc.gate is None
    else:
        (name, value), = opt.items()
        assert getattr(proc.engine, name) == value


def test_unknown_engine_option_raises():
    with pytest.raises(TypeError):
        P.ComplexStreamsBuilder().stream("letters").query(
            "q", letters_pattern(), runtime="cuda", device="cpu", no_such_engine_option=False)


def test_sink_keys_carry_the_gate_digest_and_dedupe_replays():
    """Every sink record's key carries its record key and the match's
    emission digest, one distinct digest per match, and a fault-free run
    dedupes nothing (`cep_emit_deduped_total` stays 0)."""
    from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key

    log = P.RecordLog()
    builder = P.ComplexStreamsBuilder(log=log)
    out = builder.stream("letters").query(
        "Letters", letters_pattern(), runtime="cuda", device="cpu",
        config=P.EngineConfig(**CFG), batch_size=16, initial_keys=2).to("matches")
    _drive(builder.build(), _letters_records())
    digests = [decode_sink_key(r.key) for r in log.read("matches")]
    assert [k for k, _d in digests] == [r.key for r in out.records]
    assert len({d for _k, d in digests}) == len(digests)
    assert np.all([d is not None for _k, d in digests])
    assert out.node.gate._m_deduped.value == 0


def _letters_topology(**opts):
    builder = P.ComplexStreamsBuilder(log=P.RecordLog())
    out = builder.stream("letters").query(
        "Letters", letters_pattern(), runtime="cuda", device="cpu",
        config=P.EngineConfig(**CFG), batch_size=16, initial_keys=2, **opts)
    return builder.build(), out


@pytest.mark.parametrize("native_pack", [True, False], ids=["native", "python"])
def test_poison_record_is_quarantined_and_the_rest_advances(native_pack):
    """A value the schema cannot pack is quarantined alone (reachable
    through `Topology.take_poisoned`); every other record of its batch
    advances, so each key's matches equal a run without that record (the
    isolation pass advances record by record, so the order across keys
    differs)."""
    records = _letters_records()
    slot = 37
    key, _letter, ts, offset = records[slot]
    topo, _out = _letters_topology(native=native_pack)
    outs = []
    for i, (k, letter, t, o) in enumerate(records):
        value = ["unpackable"] if i == slot else letter
        outs += topo.process("letters", k, value, timestamp=t, offset=o)
    outs += topo.flush()
    ref_topo, _ref = _letters_topology(native=native_pack)
    ref = _drive(ref_topo, records[:slot] + records[slot + 1:])
    per_key = lambda rows: sorted(rows, key=lambda r: (r[0], r[5]))  # noqa: E731
    assert per_key(_rows(outs, P.sequence_to_json)) == per_key(_rows(ref, P.sequence_to_json))
    assert len(ref) > 0
    (poisoned,) = topo.take_poisoned()
    assert poisoned[:2] == ("letters", key)
    assert (poisoned[2].value, poisoned[2].offset) == (["unpackable"], offset)
    assert topo.take_poisoned() == []


def test_failed_native_build_raises_through_the_topology(monkeypatch):
    """A broken native build is not poison: `Topology.process` raises it
    at the first flush and quarantines nothing."""
    from kafkastreams_cep_tpu_torch import native

    def broken(name, cxx=None, build_dir=None):
        raise native.NativeBuildError(f"building the native {name} failed: test")

    monkeypatch.setattr(native, "build_ext", broken)
    monkeypatch.setattr(native, "_mods", {})
    topo, out = _letters_topology()
    records = _letters_records()
    with pytest.raises(native.NativeBuildError):
        for key, letter, ts, offset in records[:16]:
            topo.process("letters", key, letter, timestamp=ts, offset=offset)
    assert topo.take_poisoned() == [] and out.records == []
    assert out.node.processor.engine._next_gidx == 0


def test_decode_failure_raises_and_advances_nothing_twice():
    """An error after the step (here the decoder's) propagates out of
    `Topology.flush`: the batch is not re-run record by record, so each
    record was packed once and nothing is quarantined."""
    topo, out = _letters_topology()
    engine = out.node.processor.engine

    class BrokenDecoder:
        def decode_matches_flat(self, *args):
            raise RuntimeError("decoder failed")

    engine._decoder = BrokenDecoder()
    records = _letters_records()[:15]
    for key, letter, ts, offset in records:
        topo.process("letters", key, letter, timestamp=ts, offset=offset)
    with pytest.raises(RuntimeError, match="decoder failed"):
        topo.flush()
    assert engine._next_gidx == len(records)
    assert topo.take_poisoned() == [] and out.records == []
