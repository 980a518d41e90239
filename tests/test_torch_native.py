"""The port's native packer and decoder against its Python reference and
the JAX package.

Everything runs on the CPU. The port's engine packs and decodes on the
host whatever its device, so `device="cpu"` exercises the same C++ as
the card does:
  * the native pack (native/packer.cc) equals the port's Python pack
    (`native=False`) column for column, bitwise, and both equal the JAX
    engine's `pack()` (which compiles no step); the event registry, the
    next event id and the schema's vocabularies are equal too. On the
    flagship skip_any8 pattern (K=8, T=64, stream seed 7, 3 batches) and
    on the stock schema with a float32 price and tokenized names;
  * the native decode of drained chain-flatten tables from a port run
    equals the Python walk and the JAX package's own native
    `decode_matches_flat` on the same arrays, as `sequence_to_json` per
    key;
  * the JSON sink bytes (`sink_format="json"`) equal the JAX package's
    `sequence_to_json_bytes` of the decoded objects, and their identity
    frames hash to the JAX `sequence_identity`;
  * a native build pointed at a missing compiler raises, and the engine
    raises rather than packing in Python when the native build fails.

The JAX engine here only packs (its `exact_replay=False` arms nothing:
`pack()` runs no step and no drain).
"""
import hashlib
import random
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu import native as jax_native  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.schema import EventSchema as JaxEventSchema  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.streams.emission import sequence_identity  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json_bytes  # noqa: E402
from kafkastreams_cep_tpu_torch import native  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import TS0, stock_pattern  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.emission import identity_prefix  # noqa: E402

K, T, N_BATCHES = 8, 64, 3
KEYS = [f"k{i}" for i in range(K)]
SMALL = dict(lanes=96, nodes=2048, matches=256, matches_per_step=32,
             nodes_per_step=128, strict_windows=True, pin_interval=True)
STOCK_FLOAT_FIELDS = {"name": np.int32, "price": np.float32, "volume": np.int32}


def stock_float_stream(rng, n, dsl=None):
    ev = (dsl or P).Event
    return [
        ev("K", {"name": rng.choice(["s", "t", "u"]),
                 "price": round(rng.uniform(80.0, 140.0), 3),
                 "volume": rng.randint(500, 1500)}, TS0 + i, "t", 0, i)
        for i in range(n)
    ]


#: name -> (pattern, schema fields, stream, stream seed)
WORKLOADS = {
    "skip_any8": (skip_any.skip_any8_pattern, None, skip_any.skip_any8_stream, 7),
    "stock_floats": (stock_pattern, STOCK_FLOAT_FIELDS, stock_float_stream, 7),
}


def _queries(workload):
    pattern, fields, _stream, _seed = WORKLOADS[workload]
    qj = jax_compile_query(J.compile_pattern(pattern(J)),
                           JaxEventSchema(fields) if fields else None)
    qp = P.compile_query(P.compile_pattern(pattern()),
                         P.EventSchema(fields) if fields else None)
    return qj, qp


def _streams(workload, dsl=None):
    _pattern, _fields, stream, seed = WORKLOADS[workload]
    rng = random.Random(seed)
    return {k: stream(rng, T * N_BATCHES, dsl) for k in KEYS}


def _batch(streams, b):
    return {k: s[b * T:(b + 1) * T] for k, s in streams.items()}


def _port_engine(query, **kw):
    return P.BatchedDeviceNFA(query, keys=KEYS, config=P.EngineConfig(**SMALL),
                              device="cpu", **kw)


def _event_tuple(e):
    return (e.key, repr(e.value), e.timestamp, e.topic, e.partition, e.offset)


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_native_pack_equals_python_pack_and_jax(workload):
    qj, qp_native = _queries(workload)
    _qj2, qp_python = _queries(workload)
    nat = _port_engine(qp_native)
    py = _port_engine(qp_python, native=False)
    jax_eng = JaxBatched(
        qj, keys=KEYS, config=JaxEngineConfig(**SMALL), engine="xla",
        auto_drain=False, exact_replay=False, provenance_sample=0.0,
        drain_mode="flat", compile_telemetry=False,
    )
    sp, sj = _streams(workload), _streams(workload, J)
    for b in range(N_BATCHES):
        xs_n = nat.pack(_batch(sp, b))
        xs_p = py.pack(_batch(sp, b))
        xs_j = jax_eng.pack(_batch(sj, b))
        assert (nat.pack_route, py.pack_route) == ("native", "python")
        assert set(xs_n) == set(xs_p) == set(xs_j)
        for name in xs_n:
            a, p, j = xs_n[name].numpy(), xs_p[name].numpy(), np.asarray(xs_j[name])
            assert a.dtype == p.dtype == j.dtype and a.shape == p.shape == j.shape, name
            # Bitwise, floats included.
            assert a.tobytes() == p.tobytes() == j.tobytes(), (b, name)
        assert nat._next_gidx == py._next_gidx == jax_eng._next_gidx
        assert list(nat._events) == list(py._events) == list(jax_eng._events)
        assert all(nat._events[g] is py._events[g] for g in nat._events)
        assert ([_event_tuple(e) for e in nat._events.values()]
                == [_event_tuple(e) for e in jax_eng._events.values()])
    for sch in (qp_python.schema, qj.schema):
        assert qp_native.schema._vocab == sch._vocab
        assert qp_native.schema._rev_vocab == sch._rev_vocab
        assert qp_native.schema._topic_vocab == sch._topic_vocab
    if workload == "stock_floats":
        assert sorted(qp_native.schema._rev_vocab) == ["s", "t", "u"]


def _drained_tables(workload):
    """(engine, raw table) per batch of a native port run: the drain's
    probe and chain-flatten table, pulled as `drain()` pulls them."""
    _qj, qp = _queries(workload)
    eng = _port_engine(qp)
    sp = _streams(workload)
    out = []
    for b in range(N_BATCHES):
        eng.advance_packed(eng.pack(_batch(sp, b)), decode=False)
        raw = eng._pull_raw_flat(eng._window_pool_view())
        if raw is not None:
            out.append(raw)
    return eng, out


def _flat_planes(raw):
    counts = np.ascontiguousarray(raw["counts"], np.int32)
    return (counts,) + tuple(np.moveaxis(raw["table"][i], -1, 0) for i in range(3))


def _jax_decoder():
    """The JAX package's native decoder. Its loader builds in place, so a
    test worker can find a half-written library while another builds it:
    retry a few times before failing."""
    for _ in range(20):
        dec = jax_native.load_decoder()
        if dec is not None:
            return dec
        jax_native._mods.pop(("decoder", False), None)
        time.sleep(1.0)
    raise AssertionError("the JAX package's native decoder did not build")


def _with_dropped_puts(raw):
    """The table with GC-dropped puts written in: the oldest live hop of
    every third chain gets gidx -1 (skipped while the chain goes on), and
    every hop of every seventh chain (a chain that decodes to nothing)."""
    table = raw["table"].copy()
    live = table[2] != 0                      # [Mb, Cb, K]
    Mb, _Cb, K = live.shape
    for k in range(K):
        for j in range(min(int(raw["counts"][k]), Mb)):
            hops = np.flatnonzero(live[j, :, k])
            if hops.size and (j + k) % 7 == 0:
                table[0, j, hops, k] = -1
            elif hops.size and (j + k) % 3 == 0:
                table[0, j, hops[-1], k] = -1
    return {"counts": raw["counts"], "table": table}


def test_native_decode_equals_python_walk_and_jax_decoder():
    eng, raws = _drained_tables("skip_any8")
    jax_dec = _jax_decoder()
    n_matches = 0
    for raw in raws + [_with_dropped_puts(r) for r in raws]:
        nat = eng._decode_flat(raw)
        py = eng._decode_flat_python(*_flat_planes(raw))
        ref = jax_dec.decode_matches_flat(
            *_flat_planes(raw), eng.query.name_of_id, eng._events,
            P.Staged, P.Sequence, None)
        ref = {KEYS[k]: seqs for k, seqs in enumerate(ref) if seqs}
        as_json = lambda out: {k: [jax_json(s) for s in v] for k, v in out.items()}  # noqa: E731
        assert as_json(nat) == as_json(py) == as_json(ref)
        assert all(type(s) is P.Sequence for v in nat.values() for s in v)
        n_matches += sum(len(v) for v in nat.values())
    assert n_matches > 0


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_json_sink_bytes_equal_jax_serialization_and_identity(workload):
    """skip_any8 has one event per stage; the stock case's zero_or_more
    stage holds several, so event separators are checked too."""
    runs = {}
    for label, kw in (("objects", {}), ("json", {"sink_format": "json"}),
                      ("json_python", {"sink_format": "json", "native": False})):
        _qj, qp = _queries(workload)
        eng = _port_engine(qp, **kw)
        sp = _streams(workload)
        runs[label] = [eng.advance(_batch(sp, b)) for b in range(2)]
    n = 0
    for objs, sms, sms_py in zip(runs["objects"], runs["json"], runs["json_python"]):
        assert list(objs) == list(sms) == list(sms_py)
        for key, seqs in objs.items():
            assert len(seqs) == len(sms[key]) == len(sms_py[key])
            for seq, sm, sm_py in zip(seqs, sms[key], sms_py[key]):
                assert isinstance(sm, P.SinkMatch) and sm.format == "json"
                assert sm.payload == sm_py.payload == sequence_to_json_bytes(seq)
                assert sm.ident == sm_py.ident
                digest = hashlib.blake2b(identity_prefix("skip8", key) + sm.ident,
                                         digest_size=16).digest()
                assert digest == sequence_identity("skip8", key, seq)
                last = _event_tuple(seq.matched[-1].events[-1])
                assert _event_tuple(sm.last_event) == _event_tuple(sm_py.last_event) == last
                n += 1
    assert n > 0
    if workload == "stock_floats":
        assert any(len(st.events) > 1 for o in runs["objects"] for v in o.values()
                   for seq in v for st in seq.matched)


def test_native_build_with_missing_compiler_raises(tmp_path):
    with pytest.raises(native.NativeBuildError, match="building the native packer failed"):
        native.build_ext("packer", cxx=str(tmp_path / "no-such-g++"), build_dir=tmp_path)
    assert not list(tmp_path.glob("_packer_*"))


def test_engine_raises_when_the_native_build_fails(monkeypatch):
    def broken(name, cxx=None, build_dir=None):
        raise native.NativeBuildError(f"building the native {name} failed: test")

    monkeypatch.setattr(native, "build_ext", broken)
    monkeypatch.setattr(native, "_mods", {})
    _qj, qp = _queries("skip_any8")
    eng = _port_engine(qp)
    with pytest.raises(native.NativeBuildError):
        eng.pack(_batch(_streams("skip_any8"), 0))
    # Nothing of the failed pack stays behind, and nothing fell back.
    assert eng._events == {} and eng._next_gidx == 0 and eng.pack_route == "native"
