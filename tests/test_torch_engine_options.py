"""The engine keywords the port took over last: the Arrow sink,
`compile_telemetry` and `compile_cost_estimates`, and signature parity.

Checked on the CPU:

  * `sink_format="arrow"`: every payload, from the native
    `decode_matches_arrow` and from the Python fallback (`native=False`),
    byte-equal to the JAX engine's Arrow payload for the same match and
    to `sequence_to_arrow_ipc` of the objects route's `Sequence` (one
    IPC record batch, a row per matched event); the ident frames give
    the objects route's emission digest (`admit_ident` parity), on
    skip-till-any (one event a stage) and a fold query whose looping
    stage holds several events of float values;
  * an Arrow or JSON sink with the pool drain, and an Arrow sink on a
    stacked engine, raise ValueError, as in the JAX package;
  * `compile_telemetry=False` leaves no `cep_compiles_total` series (in
    both packages) and the controllers' `state()` reads no compile
    count; `compile_cost_estimates=True` raises ValueError, saying why;
  * every keyword of the JAX `BatchedDeviceNFA` and `StackedQueryEngine`
    is a keyword of the port's, but `mesh`; the JAX engine keywords pass
    through a `runtime="cuda"` query to its engine; `mesh=` raises;
  * importing the port and running a JSON sink import no pyarrow; an
    Arrow sink does.
"""
import hashlib
import inspect
import random
import subprocess
import sys
from pathlib import Path

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
from kafkastreams_cep_tpu.streams.serde import (  # noqa: E402
    sequence_to_arrow_ipc as jax_sequence_to_arrow_ipc,
)
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import TS0, stock_pattern  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stacked import letter_queries  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel import DrainController, StackedQueryEngine  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.emission import (  # noqa: E402
    identity_prefix,
    sequence_identity,
)
from kafkastreams_cep_tpu_torch.streams.serde import sequence_to_arrow_ipc  # noqa: E402

pa = pytest.importorskip("pyarrow")
REPO = Path(__file__).resolve().parent.parent

K, T, N_BATCHES = 8, 64, 2
KEYS = [f"k{i}" for i in range(K)]
SMALL = dict(lanes=96, nodes=2048, matches=256, matches_per_step=32,
             nodes_per_step=128, strict_windows=True, pin_interval=True)
FLOAT_FIELDS = {"name": np.int32, "price": np.float32, "volume": np.int32}


def stock_float_stream(rng, n, dsl=None):
    ev = (dsl or P).Event
    return [ev("K", {"name": rng.choice(["s", "t", "u"]),
                     "price": round(rng.uniform(80.0, 140.0), 3),
                     "volume": rng.randint(500, 1500)}, TS0 + i, "t", 0, i)
            for i in range(n)]


#: name -> (pattern, schema fields, stream)
WORKLOADS = {
    "skip_any8": (skip_any.skip_any8_pattern, None, skip_any.skip_any8_stream),
    "stock_floats": (stock_pattern, FLOAT_FIELDS, stock_float_stream),
}


def _batches(workload, dsl=None):
    _pattern, _fields, stream = WORKLOADS[workload]
    rng = random.Random(7)
    streams = {k: stream(rng, T * N_BATCHES, dsl) for k in KEYS}
    return [{k: s[b * T:(b + 1) * T] for k, s in streams.items()} for b in range(N_BATCHES)]


def _port(workload, **kw):
    pattern, fields, _stream = WORKLOADS[workload]
    q = P.compile_query(P.compile_pattern(pattern()), P.EventSchema(fields) if fields else None)
    return P.BatchedDeviceNFA(q, keys=KEYS, config=P.EngineConfig(**SMALL), device="cpu", **kw)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_arrow_payloads_equal_jax_and_the_reference_serializer(workload):
    pattern, fields, _stream = WORKLOADS[workload]
    jax_eng = JaxBatched(
        jax_compile_query(J.compile_pattern(pattern(J)), JaxEventSchema(fields) if fields else None),
        keys=KEYS, config=JaxEngineConfig(**SMALL), engine="xla", auto_drain=False,
        exact_replay=False, provenance_sample=0.0, drain_mode="flat", sink_format="arrow",
        compile_telemetry=False)
    runs = {"jax": [jax_eng.advance(b) for b in _batches(workload, J)]}
    for label, kw in (("objects", {}), ("arrow", {"sink_format": "arrow"}),
                      ("arrow_python", {"sink_format": "arrow", "native": False})):
        eng = _port(workload, exact_replay=False, **kw)
        runs[label] = [eng.advance(b) for b in _batches(workload)]
    n = 0
    for objs, sms, sms_py, sms_jax in zip(runs["objects"], runs["arrow"], runs["arrow_python"],
                                          runs["jax"]):
        assert list(objs) == list(sms) == list(sms_py) == list(sms_jax)
        for key, seqs in objs.items():
            assert len(seqs) == len(sms[key]) == len(sms_py[key]) == len(sms_jax[key])
            for seq, sm, sm_py, sm_jax in zip(seqs, sms[key], sms_py[key], sms_jax[key]):
                assert isinstance(sm, P.SinkMatch) and sm.format == sm_py.format == "arrow"
                ref = sequence_to_arrow_ipc(seq)
                assert sm.payload == sm_py.payload == sm_jax.payload == ref
                assert sm.ident == sm_py.ident == sm_jax.ident
                digest = hashlib.blake2b(identity_prefix("q", key) + sm.ident,
                                         digest_size=16).digest()
                assert digest == sequence_identity("q", key, seq)
                table = pa.ipc.open_stream(sm.payload).read_all()
                assert table.num_rows == sum(len(st.events) for st in seq.matched)
                assert table.column("stage").to_pylist() == [
                    st.stage for st in seq.matched for _ in st.events]
                n += 1
    assert n > 0
    # The JAX package's own serializer writes the same bytes.
    seq = next(s for o in runs["objects"] for v in o.values() for s in v)
    assert jax_sequence_to_arrow_ipc(seq) == sequence_to_arrow_ipc(seq)
    if workload == "stock_floats":
        assert any(len(st.events) > 1 for o in runs["objects"] for v in o.values()
                   for seq in v for st in seq.matched)


def test_arrow_sink_counts_and_topology_sinks_the_payloads():
    """A `runtime="cuda"` query with the Arrow sink writes each match's
    IPC payload to the sink topic and counts it under format="arrow"."""
    log = P.RecordLog()
    b = P.ComplexStreamsBuilder(log=log)
    out = b.stream("t").query("q", skip_any.skip_any8_pattern(), runtime="cuda", device="cpu",
                              config=P.EngineConfig(**SMALL), batch_size=T * K,
                              initial_keys=K, sink_format="arrow").to("matches")
    topo = b.build()
    for batch in _batches("skip_any8"):
        for i in range(T):
            for k in KEYS:
                e = batch[k][i]
                topo.process("t", k, e.value, timestamp=e.timestamp)
    topo.flush()
    sink = log.read("matches")
    assert sink and len(sink) == len(out.records)
    assert [r.value for r in sink] == [r.value.payload for r in out.records]
    eng = out.node.processor.engine
    counted = eng.metrics.get("cep_sink_matches_total").labels(query="q", format="arrow").value
    assert counted == len(sink)
    assert all(pa.ipc.open_stream(r.value).read_all().num_rows >= 1 for r in sink[:8])


def test_bytes_sinks_refuse_the_pool_drain_and_stacked_engines():
    for fmt in ("json", "arrow"):
        with pytest.raises(ValueError, match="drain_mode='flat'"):
            _port("skip_any8", sink_format=fmt, drain_mode="pool")
        with pytest.raises(ValueError, match="stacked"):
            StackedQueryEngine(letter_queries(), keys=KEYS, device="cpu", sink_format=fmt)
    with pytest.raises(ValueError, match="drain_mode"):
        _port("skip_any8", drain_mode="chains")
    with pytest.raises(ValueError, match="sink_format"):
        _port("skip_any8", sink_format="parquet")


def test_compile_telemetry_off_registers_no_compile_series():
    on, off = _port("skip_any8"), _port("skip_any8", compile_telemetry=False)
    assert "cep_compiles_total" in on.metrics.names()
    assert off.compile_watch is None
    assert "cep_compiles_total" not in off.metrics.names()
    jax_off = JaxBatched(J.compile_pattern(skip_any.skip_any8_pattern(J)), keys=KEYS,
                         config=JaxEngineConfig(**SMALL), engine="xla", compile_telemetry=False)
    assert "cep_compiles_total" not in jax_off.metrics.names()
    # The engine still runs, and the controllers read no compile count.
    out = off.advance(_batches("skip_any8")[0])
    assert sum(len(v) for v in out.values()) > 0
    off.target_emit_ms = 50.0
    assert DrainController(off).state()["compiles_seen"] is None


def test_compile_cost_estimates_raises_with_its_reason():
    with pytest.raises(ValueError, match="no cost model"):
        _port("skip_any8", compile_cost_estimates=True)
    assert _port("skip_any8", compile_cost_estimates=False).compile_watch is not None


def _keywords(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if n != "self" and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]


@pytest.mark.parametrize("jax_cls,port_cls", [(JaxBatched, P.BatchedDeviceNFA),
                                              (JaxStacked, StackedQueryEngine)],
                         ids=["BatchedDeviceNFA", "StackedQueryEngine"])
def test_every_jax_keyword_but_mesh_is_a_port_keyword(jax_cls, port_cls):
    jax_kw, port_kw = _keywords(jax_cls.__init__), _keywords(port_cls.__init__)
    missing = [n for n in jax_kw if n not in port_kw]
    assert missing == (["mesh"] if port_cls is P.BatchedDeviceNFA else [])
    for name in ("drain_mode", "sink_format", "compile_telemetry", "compile_cost_estimates"):
        if name in jax_kw:
            assert name in port_kw


def test_topology_passes_every_jax_engine_keyword_through():
    """Each JAX engine keyword but mesh (and those the processor sets:
    the query and its name, the keys, the schema, the config, the
    registry) reaches the port's engine through a runtime="cuda" query."""
    params = inspect.signature(P.BatchedDeviceNFA.__init__).parameters
    set_by_processor = {"stages_or_query", "query_name", "keys", "schema", "config",
                        "registry"}
    passed = {}
    for name in _keywords(JaxBatched.__init__):
        if name in set_by_processor or name == "mesh":
            continue
        passed[name] = params[name].default
    passed.update(engine="torch", drain_mode="pool", compile_telemetry=False)
    out = P.ComplexStreamsBuilder().stream("t").query(
        "q", skip_any.skip_any8_pattern(), runtime="cuda", device="cpu", **passed)
    eng = out.node.processor.engine
    assert eng.drain_mode == "pool" and eng.compile_watch is None and eng.engine == "torch"
    with pytest.raises(TypeError):
        P.ComplexStreamsBuilder().stream("t").query(
            "q", skip_any.skip_any8_pattern(), runtime="cuda", device="cpu", mesh=object())
    with pytest.raises(TypeError):
        _port("skip_any8", mesh=object())


def test_pyarrow_is_imported_only_by_the_arrow_path():
    code = ("import sys, kafkastreams_cep_tpu_torch as P\n"
            "from kafkastreams_cep_tpu_torch.models.cases import letters_pattern\n"
            "eng = P.BatchedDeviceNFA(P.compile_pattern(letters_pattern()), keys=['k'],"
            " device='cpu', sink_format='json')\n"
            "assert 'pyarrow' not in sys.modules\n"
            "P.BatchedDeviceNFA(P.compile_pattern(letters_pattern()), keys=['k'], device='cpu',"
            " sink_format='arrow')\n"
            "assert 'pyarrow' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
