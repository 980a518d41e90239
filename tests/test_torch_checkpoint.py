"""The port's checkpoint path against the JAX package, on the CPU.

  * checksum and frames: the native CRC-32C (native/crc32c.cc) equals the
    port's copy of the JAX pure-Python CRC and the JAX `serde.crc32c` on
    every length 0-17, a 256 KB buffer and chained starting values; sealed
    frames, array trees and event registries written by one package open
    in the other; a broken g++ build raises `NativeBuildError`;
  * engine snapshots: after the same batches (mid GC group, G=4) the
    port's `snapshot()` bytes equal the JAX engine's; each restores into
    the other package and both continue bitwise equal to the
    uninterrupted JAX run (state, pool, matches);
  * key padding: a JAX `pallas_interpret` engine pads 5 keys to 8; its
    snapshot restores into the port (padding dropped) and the port's
    5-key snapshot restores into it (padding grown), both continuing
    bitwise equal; a padding column with live state is refused;
  * cross-shape restore and resize bitwise to the JAX engine: a grow and
    a shrink back landing mid group (tests/test_autosize.py), a refused
    shrink, and a snapshot restored at other capacities;
  * the processor: snapshots with pending records and high-water marks
    restore both ways (the JAX package's lane handles load as the port's
    through its unpickler, which refuses JAX paths it has no copy of);
  * `DeviceStateStore` falls back past a corrupt newest changelog record
    and refuses a changelog with none valid; a topology that commits
    (`flush_stores`) after flushes 3 and 6, crashes inside flush 8 and
    recovers (`restore_stores` + replay from the committed offset) holds
    every match exactly once in its sink, equal to the JAX
    `runtime="tpu"` topology under the same schedule.

The JAX side runs `engine="xla"` (and `pallas_interpret` for the padding)
with `exact_replay=False` and `provenance_sample=0`, and with
`auto_drain=False` wherever the test compares state: a drain's timing
moves what the GC keeps. Replay off changes nothing here: the letters
case has no folds and the stock case's streams never fold-collide
(`seq_collisions` is part of the compared state), so the port's replay,
armed by default on stock, never fires; tests/test_torch_replay.py holds
replay itself to the JAX engine at its defaults.
"""
import gc
import pickle
import random
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.schema import EventSchema as JaxEventSchema  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.state import serde as jax_serde  # noqa: E402
from kafkastreams_cep_tpu.streams.device_processor import (  # noqa: E402
    DeviceCEPProcessor as JaxProcessor,
)
from kafkastreams_cep_tpu.streams.log import RecordLog as JaxRecordLog  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch import native  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, TS0, letters_pattern  # noqa: E402
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from kafkastreams_cep_tpu_torch.state import serde  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.device_processor import (  # noqa: E402
    DeviceCEPProcessor, _Lane,
)
from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key  # noqa: E402

T = 10
JAX_OFF = dict(engine="xla", exact_replay=False, provenance_sample=0.0,
               compile_telemetry=False)


def _trees_equal(label, jax_tree, port_tree):
    bad = [n for n in jax_tree
           if not np.array_equal(np.asarray(jax_tree[n]), np.asarray(port_tree[n]))
           or np.asarray(jax_tree[n]).dtype != np.asarray(port_tree[n]).dtype]
    assert set(jax_tree) == set(port_tree) and not bad, f"{label}: {bad}"


def _same_engine(label, ja, pa, k=None):
    """State and pool of two engines bitwise equal (`k`: the first k key
    columns of the first one)."""
    for what in ("state", "pool"):
        a = {n: np.asarray(v) for n, v in getattr(ja, what).items()}
        if k is not None:
            a = {n: v[..., :k] for n, v in a.items()}
        _trees_equal(f"{label} {what}", a, {n: np.asarray(v) for n, v in getattr(pa, what).items()})


def _json(out, to_json):
    return {k: [to_json(s) for s in v] for k, v in out.items()}


#: Stream times moved so that the engines' timestamp base (the first
#: batch's earliest time less 2**20 ms) is positive: the JAX engine's
#: restore reads a negative base as "none yet" and re-bases the next batch
#: (same matches, other lane times), which the port does not.
TS_SHIFT = 1 << 21


def _case(case, keys, n_batches):
    pattern, fields, stream, cfg = CASES[case]
    qj = jax_compile_query(J.compile_pattern(pattern(J)),
                           JaxEventSchema(fields) if fields else None)
    qp = P.compile_query(P.compile_pattern(pattern()), P.EventSchema(fields) if fields else None)
    streams = []
    for dsl in (J, P):
        rng = random.Random(5)
        streams.append({k: [replace(e, timestamp=e.timestamp + TS_SHIFT)
                            for e in stream(rng, T * n_batches, dsl)] for k in keys})
    return qj, qp, streams[0], streams[1], cfg


def _batch(streams, b, t=T):
    return {k: s[b * t:(b + 1) * t] for k, s in streams.items() if s[b * t:(b + 1) * t]}


# ------------------------------------------------------------ checksum, frames
def test_native_crc32c_equals_the_python_and_jax_crc():
    assert serde.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(3)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in range(18)]
    bufs.append(rng.integers(0, 256, 256 * 1024, dtype=np.uint8).tobytes())
    for data in bufs:
        for start in (0, 1, 0xE3069283, 0xFFFFFFFF):
            want = jax_serde.crc32c(data, start)
            assert serde.crc32c(data, start) == serde.crc32c_python(data, start) == want
    # Chained: the checksum of a whole buffer continues across its pieces.
    whole = bufs[-1]
    crc = 0
    for i in range(0, len(whole), 7777):
        crc = serde.crc32c(whole[i:i + 7777], crc)
    assert crc == serde.crc32c(whole) == jax_serde.crc32c(whole)


def test_frames_open_in_the_other_package():
    tree = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
            "b": np.array([[True, False]]), "c": np.linspace(0, 1, 5, dtype=np.float32),
            "empty": np.zeros((0, 3), np.int32)}
    events = {3: P.Event("k", {"x": 1}, TS0, "t", 0, 7), 9: P.Event("k2", "B", TS0 + 1, "u", 1, 8)}
    jevents = {g: J.Event(e.key, e.value, e.timestamp, e.topic, e.partition, e.offset)
               for g, e in events.items()}
    assert serde.encode_array_tree(tree) == jax_serde.encode_array_tree(tree)
    assert serde.encode_event_registry(events) == jax_serde.encode_event_registry(jevents)
    assert serde.seal_frame(b"KCT5payload") == jax_serde.seal_frame(b"KCT5payload")
    for back in (serde.decode_array_tree(jax_serde.encode_array_tree(tree)),
                 jax_serde.decode_array_tree(serde.encode_array_tree(tree))):
        _trees_equal("array tree", tree, back)
    got = serde.decode_event_registry(jax_serde.encode_event_registry(jevents))
    assert {g: repr(e) for g, e in got.items()} == {g: repr(e) for g, e in events.items()}
    got = jax_serde.decode_event_registry(serde.encode_event_registry(events))
    assert {g: (e.key, e.value, e.timestamp, e.offset) for g, e in got.items()} == {
        g: (e.key, e.value, e.timestamp, e.offset) for g, e in events.items()}
    sealed = serde.seal_frame(b"KCT5payload")
    assert jax_serde.open_frame(sealed) == b"KCT5payload"
    flipped = bytearray(sealed)
    flipped[-1] ^= 1
    with pytest.raises(serde.CheckpointError, match="CRC32C mismatch"):
        serde.open_frame(bytes(flipped))
    with pytest.raises(serde.CheckpointError):
        serde.decode_array_tree(serde.encode_array_tree(tree)[:-3])
    with pytest.raises(serde.CheckpointError, match="trailing"):
        serde.decode_array_tree(serde.seal_frame(
            bytes(serde.open_frame(serde.encode_array_tree(tree))) + b"junk"))


def test_checksum_build_failure_raises(monkeypatch, tmp_path):
    with pytest.raises(native.NativeBuildError, match="building the native crc32c failed"):
        native.build_ext("crc32c", cxx=str(tmp_path / "no-such-g++"), build_dir=tmp_path)

    def broken(name, cxx=None, build_dir=None):
        raise native.NativeBuildError(f"building the native {name} failed: test")

    monkeypatch.setattr(native, "build_ext", broken)
    monkeypatch.setattr(native, "_mods", {})
    monkeypatch.setattr(serde, "_crc_mod", None)
    # Sealing raises; nothing falls back to the Python checksum.
    with pytest.raises(native.NativeBuildError):
        serde.seal_frame(b"KCT5payload")


def test_unpickler_maps_jax_paths_and_refuses_the_rest():
    lane = J.streams.device_processor._Lane(3)
    lane.key = "u1"
    got = serde.loads(pickle.dumps([lane, {"x": 1}]))
    assert type(got[0]) is _Lane and (got[0].index, got[0].key) == (3, "u1")
    assert got[1] == {"x": 1}
    from kafkastreams_cep_tpu.analysis.core import Finding
    from kafkastreams_cep_tpu.analysis.jit_audit import run_jit_cache_audit
    from kafkastreams_cep_tpu.faults.injection import TransientFault
    from kafkastreams_cep_tpu_torch.analysis.core import Finding as PortFinding
    from kafkastreams_cep_tpu_torch.faults.injection import TransientFault as PortTransientFault

    assert type(serde.loads(pickle.dumps(TransientFault("site")))) is PortTransientFault
    assert serde.loads(pickle.dumps(Finding)) is PortFinding
    # The JAX jit audit has no copy in the port (its counterpart is
    # analysis/kernel_audit.py), so its path is refused.
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        serde.loads(pickle.dumps(run_jit_cache_audit))


# ----------------------------------------------------------- engine snapshots
def test_engine_snapshot_bytes_equal_jax_and_restore_both_ways():
    """skip2 at G=4, snapshot mid group. (Fold registers, float leaves,
    ride the snapshots of the resize and cross-shape tests.)"""
    G = 4
    keys = [f"k{i}" for i in range(6)]
    qj, qp, sj, sp, cfg = _case("skip2", keys, 6)
    jcfg, pcfg = JaxEngineConfig(**cfg, gc_group=G), P.EngineConfig(**cfg, gc_group=G)
    bx = JaxBatched(qj, keys=keys, config=jcfg, auto_drain=False, **JAX_OFF)
    bp = P.BatchedDeviceNFA(qp, keys=keys, config=pcfg, device="cpu", auto_drain=False)
    for b in range(3):  # 3 advances: mid group for G=4
        assert _json(bx.advance(_batch(sj, b)), jax_json) == _json(
            bp.advance(_batch(sp, b)), P.sequence_to_json)
    assert bp._group_ys
    blob_j, blob_p = bx.snapshot(), bp.snapshot()
    assert blob_j == blob_p
    assert not bp._group_ys
    port_from_jax = P.BatchedDeviceNFA.restore(qp, blob_j, config=pcfg, device="cpu",
                                               auto_drain=False)
    jax_from_port = JaxBatched.restore(qj, blob_p, config=jcfg, auto_drain=False, **JAX_OFF)
    _same_engine("port restored", bx, port_from_jax)
    _same_engine("jax restored", bx, jax_from_port)
    n = 0
    for b in range(3, 6):
        want = _json(bx.advance(_batch(sj, b)), jax_json)
        assert _json(jax_from_port.advance(_batch(sj, b)), jax_json) == want
        for eng in (bp, port_from_jax):
            assert _json(eng.advance(_batch(sp, b)), P.sequence_to_json) == want
        n += sum(map(len, want.values()))
        for label, eng in (("uninterrupted", bp), ("port restored", port_from_jax)):
            _same_engine(f"{label} batch {b}", bx, eng)
        _same_engine(f"jax restored batch {b}", bx, jax_from_port)
    assert n > 0
    assert bx.snapshot() == bp.snapshot() == port_from_jax.snapshot()


def test_restore_keeps_a_negative_timestamp_base():
    """A base below 0 (streams whose first times are under 2**20 ms)
    survives the port's restore, so the restored engine continues
    bitwise equal to the uninterrupted one."""
    keys = ["k0", "k1"]
    qj, qp, _sj, _sp, cfg = _case("letters", keys, 2)
    rng = random.Random(4)
    sp = {k: CASES["letters"][2](rng, 2 * T) for k in keys}
    bp = P.BatchedDeviceNFA(qp, keys=keys, config=P.EngineConfig(**cfg), device="cpu")
    bp.advance(_batch(sp, 0))
    assert bp._ts_base < 0
    restored = P.BatchedDeviceNFA.restore(qp, bp.snapshot(), config=P.EngineConfig(**cfg),
                                          device="cpu")
    assert restored._ts_base == bp._ts_base
    assert _json(bp.advance(_batch(sp, 1)), P.sequence_to_json) == _json(
        restored.advance(_batch(sp, 1)), P.sequence_to_json)
    _same_engine("negative base", bp, restored)


def test_snapshot_across_the_pallas_key_padding():
    keys = [f"k{i}" for i in range(5)]
    qj, qp, sj, sp, cfg = _case("skip2", keys, 2)
    pal = JaxBatched(qj, keys=keys, config=JaxEngineConfig(**cfg), engine="pallas_interpret",
                     auto_drain=False, exact_replay=False, provenance_sample=0.0,
                     compile_telemetry=False)
    assert pal.K_padded == 8
    bp = P.BatchedDeviceNFA(qp, keys=keys, config=P.EngineConfig(**cfg), device="cpu",
                            auto_drain=False)
    assert _json(pal.advance(_batch(sj, 0)), jax_json) == _json(
        bp.advance(_batch(sp, 0)), P.sequence_to_json)
    snap_pal, snap_p = pal.snapshot(), bp.snapshot()
    port_from_pal = P.BatchedDeviceNFA.restore(qp, snap_pal, config=P.EngineConfig(**cfg),
                                               device="cpu", auto_drain=False)
    assert port_from_pal.K == 5 and port_from_pal.state["active"].shape[-1] == 5
    pal_from_port = JaxBatched.restore(qj, snap_p, config=JaxEngineConfig(**cfg),
                                       engine="pallas_interpret", auto_drain=False,
                                       exact_replay=False, provenance_sample=0.0,
                                       compile_telemetry=False)
    assert pal_from_port.K_padded == 8
    _same_engine("port from pallas", pal, port_from_pal, k=5)
    _same_engine("pallas from port", pal, pal_from_port)
    want = _json(pal.advance(_batch(sj, 1)), jax_json)
    assert sum(map(len, want.values())) > 0
    assert _json(pal_from_port.advance(_batch(sj, 1)), jax_json) == want
    for eng in (bp, port_from_pal):
        assert _json(eng.advance(_batch(sp, 1)), P.sequence_to_json) == want
        _same_engine("after the restore", pal, eng, k=5)
    _same_engine("pallas from port after the restore", pal, pal_from_port)
    # A padding column that holds live state is refused.
    r = jax_serde._Reader(jax_serde.open_frame(snap_pal))
    jax_serde.read_magic(r)
    key_blob, state = r.blob(), jax_serde.decode_array_tree(r.blob())
    rest = [r.blob(), r.blob(), r.i64(), r.i64(), r.i64()]
    state["n_events"][6] = 1
    w = jax_serde._Writer()
    w._buf.write(jax_serde.MAGIC)
    for blob in (key_blob, jax_serde.encode_array_tree(state), rest[0], rest[1]):
        w.blob(blob)
    for v in rest[2:]:
        w.i64(v)
    with pytest.raises(serde.CheckpointError, match="padding"):
        P.BatchedDeviceNFA.restore(qp, jax_serde.seal_frame(w.getvalue()),
                                   config=P.EngineConfig(**cfg), device="cpu")


# ------------------------------------------------------ resize, cross-shape
C0 = dict(lanes=32, nodes=256, matches=128, matches_per_step=32)
GROW = dict(lanes=64, nodes=512, matches=256, matches_per_step=64)
RESIZE_T = 4


def branching_fold_pattern(m):
    """tests/test_gc_groups.py's pattern: skip-till-any, one_or_more and
    a fold."""
    return (
        m.QueryBuilder()
        .select("first").where(m.value() == "A")
        .fold("cnt", m.agg("cnt", default=0) + 1)
        .then().select("second", m.Selected.with_skip_til_any_match())
        .one_or_more().where(m.value() == "C")
        .then().select("latest").where(m.value() == "D")
        .build()
    )


def _letter_streams(m, seed, n=24):
    out = {}
    for i in range(2):
        rng = random.Random(seed + i)
        out[f"k{i}"] = [m.Event(f"k{i}", rng.choice("ABCD"), TS0 + j, "t", 0, j)
                        for j in range(n)]
    return out


def _drive_resized(eng, streams, resize_at, to_json):
    """Deferred advances of RESIZE_T events, a drain after each, and a
    resize after the drains named in `resize_at` (tests/test_autosize.py's
    `drive_resized`)."""
    got = {k: [] for k in streams}
    n = max(len(s) for s in streams.values())
    for b in range(-(-n // RESIZE_T)):
        eng.advance_packed(eng.pack(_batch(streams, b, RESIZE_T)), decode=False)
        for k, seqs in eng.drain().items():
            got[k].extend(to_json(s) for s in seqs)
        if b in resize_at:
            assert eng.resize(replace(eng.config, **resize_at[b]))
    return got


def test_resize_bitwise_to_jax():
    """A grow and a shrink back, both landing mid GC group (G=4): matches
    and final state and pool bitwise equal to the JAX engine's same
    schedule, and to the port's run at G=1 without resizes (a shrink back
    is exact, and the group cadence changes when the GC runs, not what
    it keeps)."""
    G, schedule = 4, {1: GROW, 3: C0}
    qj = J.compile_pattern(branching_fold_pattern(J))
    qp = P.compile_pattern(branching_fold_pattern(P))
    sj, sp = _letter_streams(J, 522), _letter_streams(P, 522)
    bx = JaxBatched(qj, keys=list(sj), config=JaxEngineConfig(gc_group=G, **C0),
                    auto_drain=False, **JAX_OFF)
    bp = P.BatchedDeviceNFA(qp, keys=list(sp), config=P.EngineConfig(gc_group=G, **C0),
                            device="cpu", auto_drain=False)
    straight = P.BatchedDeviceNFA(qp, keys=list(sp), config=P.EngineConfig(**C0),
                                  device="cpu", auto_drain=False)
    want = _drive_resized(bx, sj, schedule, jax_json)
    got = _drive_resized(bp, sp, schedule, P.sequence_to_json)
    assert got == want and sum(map(len, got.values())) > 0
    assert got == _drive_resized(straight, sp, {}, P.sequence_to_json)
    assert bp.resizes == bx.resizes == len(schedule)
    assert bp.config == P.EngineConfig(gc_group=G, **C0)
    # Mid group, the JAX XLA step numbers window slots otherwise than its
    # Pallas kernel (which the port follows); every group flush makes the
    # ids equal, so compare after one.
    bx._flush_group()
    bp._flush_group()
    _same_engine("resized", bx, bp)
    _same_engine("resized vs straight", straight, bp)
    assert all(bp.stats[c] == 0 for c in ("lane_drops", "node_drops", "match_drops"))


def test_refused_shrink_and_cross_shape_restore_match_jax():
    """A shrink below the live occupancy raises ShapeRestoreError in both
    packages and leaves the engine usable at its old shape; a snapshot
    taken at C0 restores at GROW in either package, bitwise equal to the
    JAX engine's own cross-shape restore, and a restore that cannot fit
    is refused."""
    qj = J.compile_pattern(branching_fold_pattern(J))
    qp = P.compile_pattern(branching_fold_pattern(P))
    stream_j = [J.Event("k0", "ACCCCD"[i % 6], TS0 + i, "t", 0, i) for i in range(18)]
    stream_p = [P.Event("k0", "ACCCCD"[i % 6], TS0 + i, "t", 0, i) for i in range(18)]
    bx = JaxBatched(qj, keys=["k0"], config=JaxEngineConfig(**C0), auto_drain=False, **JAX_OFF)
    bp = P.BatchedDeviceNFA(qp, keys=["k0"], config=P.EngineConfig(**C0), device="cpu",
                            auto_drain=False)
    bx.advance_packed(bx.pack({"k0": stream_j}), decode=False)
    bp.advance_packed(bp.pack({"k0": stream_p}), decode=False)
    with pytest.raises(jax_serde.ShapeRestoreError):
        bx.resize(replace(bx.config, matches=2))
    with pytest.raises(serde.ShapeRestoreError, match="pend_pos"):
        bp.resize(replace(bp.config, matches=2))
    assert bp.config == P.EngineConfig(**C0) and bp.resizes == 0
    _same_engine("after the refused shrink", bx, bp)
    blob = bp.snapshot()
    assert blob == bx.snapshot()
    with pytest.raises(serde.ShapeRestoreError):
        P.BatchedDeviceNFA.restore(qp, blob, config=P.EngineConfig(**dict(C0, matches=2)),
                                   device="cpu")
    ref = JaxBatched.restore(qj, blob, config=JaxEngineConfig(**GROW), auto_drain=False,
                             **JAX_OFF)
    grown = P.BatchedDeviceNFA.restore(qp, blob, config=P.EngineConfig(**GROW), device="cpu",
                                       auto_drain=False)
    _same_engine("cross-shape restore", ref, grown)
    out_x, out_p = bx.drain(), bp.drain()
    assert sum(map(len, out_p.values())) > 2
    assert _json(out_x, jax_json) == _json(out_p, P.sequence_to_json)
    assert _json(ref.drain(), jax_json) == _json(grown.drain(), P.sequence_to_json) == _json(
        out_p, P.sequence_to_json)
    _same_engine("cross-shape restore after the drain", ref, grown)


# ------------------------------------------------------------------ processor
PROC_CFG = dict(lanes=8, nodes=128, matches=64, matches_per_step=8, nodes_per_step=4)


def _proc_records(n=70, n_keys=3, seed=11):
    rng = random.Random(seed)
    out = []
    for off in range(n):
        key = f"u{off % n_keys}"
        letter = "ABC"[(off // n_keys) % 3] if rng.random() < 0.85 else rng.choice("ABCD")
        out.append((key, letter, TS0 + off, off))
    return out


def _feed(proc, records, to_json):
    out = []
    for key, letter, ts, off in records:
        out += proc.process(key, letter, timestamp=ts, topic="letters", offset=off)
    return [(k, to_json(s)) for k, s in out]


def test_processor_snapshot_restores_both_ways():
    """Pending records, high-water marks and lanes ride the snapshot: a
    JAX processor's snapshot continues in the port and the port's in the
    JAX package, each equal to the uninterrupted JAX run; a replayed
    offset below the restored high-water mark is skipped."""
    records = _proc_records()
    opts = dict(batch_size=16, initial_keys=4)
    jopts = dict(opts, auto_drain=False, **JAX_OFF)
    popts = dict(opts, device="cpu", auto_drain=False)
    jp = JaxProcessor("Letters", letters_pattern(J), config=JaxEngineConfig(**PROC_CFG), **jopts)
    pp = DeviceCEPProcessor("Letters", letters_pattern(), config=P.EngineConfig(**PROC_CFG),
                            **popts)
    head, tail = records[:37], records[37:] + [records[30]]
    assert _feed(jp, head, jax_json) == _feed(pp, head, P.sequence_to_json)
    assert pp._pending_count == 37 % 16
    blob_j, blob_p = jp.snapshot(), pp.snapshot()
    p2 = DeviceCEPProcessor.restore("Letters", letters_pattern(), blob_j,
                                    config=P.EngineConfig(**PROC_CFG), **popts)
    j2 = JaxProcessor.restore("Letters", letters_pattern(J), blob_p,
                              config=JaxEngineConfig(**PROC_CFG), **jopts)
    assert all(type(lane) is _Lane for lane in p2.engine.keys)
    assert p2._hwm == pp._hwm and p2._pending_count == pp._pending_count
    assert {k: [e.offset for e in v] for k, v in p2._pending.items()} == {
        k: [e.offset for e in v] for k, v in pp._pending.items()}
    want = _feed(jp, tail, jax_json) + [(k, jax_json(s)) for k, s in jp.flush()]
    assert len(want) > 0
    assert _feed(j2, tail, jax_json) + [(k, jax_json(s)) for k, s in j2.flush()] == want
    for proc in (pp, p2):
        assert _feed(proc, tail, P.sequence_to_json) + [
            (k, P.sequence_to_json(s)) for k, s in proc.flush()] == want
        _same_engine("processor", jp.engine, proc.engine)


def _letters_topology(pkg, log, cfg_cls, **opts):
    # A registry of its own: a recovery dedupes, and the process-wide
    # default registry's counters are read by other tests.
    opts.setdefault("registry", MetricsRegistry() if pkg is P else JaxRegistry())
    builder = pkg.ComplexStreamsBuilder(log=log)
    out = builder.stream("letters").query(
        "Letters", letters_pattern(pkg), config=cfg_cls(**PROC_CFG), batch_size=16,
        initial_keys=4, **opts).to("matches")
    return builder.build(), out


def _process(topo, records):
    for key, letter, ts, off in records:
        topo.process("letters", key, letter, timestamp=ts, offset=off)


def test_device_state_store_falls_back_past_a_corrupt_snapshot():
    log = P.RecordLog()
    records = _proc_records()
    topo, out = _letters_topology(P, log, P.EngineConfig, runtime="cuda", device="cpu")
    _process(topo, records[:32])
    topo.flush_stores()
    gidx_first = out.node.processor.engine._next_gidx
    _process(topo, records[32:64])
    topo.flush_stores()
    topic = "app-letters-streamscep-devicestate-changelog"
    assert log.end_offset(topic) == 2
    recs = log._records[(topic, 0)]
    bad = bytearray(recs[1].value)
    bad[len(bad) // 2] ^= 0xFF
    recs[1] = recs[1]._replace(value=bytes(bad))
    registry = MetricsRegistry()
    topo2, out2 = _letters_topology(P, log, P.EngineConfig, runtime="cuda", device="cpu",
                                    registry=registry)
    with pytest.warns(RuntimeWarning, match="fell back past 1 corrupt"):
        topo2.restore_stores()
    assert registry.get("cep_checkpoint_corrupt_total").value == 1
    assert out2.node.processor.engine._next_gidx == gidx_first
    # No valid snapshot at all: the fresh processor stays and restore raises.
    bad0 = bytearray(recs[0].value)
    bad0[-1] ^= 0xFF
    recs[0] = recs[0]._replace(value=bytes(bad0))
    topo3, out3 = _letters_topology(P, log, P.EngineConfig, runtime="cuda", device="cpu")
    fresh = out3.node.processor
    with pytest.raises(serde.CheckpointError, match="all 2"):
        topo3.restore_stores()
    assert out3.node.processor is fresh


def _crash_run(pkg, path, records, cfg_cls, log_cls, **opts):
    """Commit after flushes 3 and 6 (16 records each), crash inside flush
    8, recover on the same log and replay from the committed offset."""
    log = log_cls(str(path))
    topo, _out = _letters_topology(pkg, log, cfg_cls, **opts)
    committed = 0
    for i, rec in enumerate(records[:7 * 16 + 9]):
        _process(topo, [rec])
        if i + 1 in (3 * 16, 6 * 16):
            topo.flush_stores()
            log.flush()
            committed = i + 1
    log.close()
    del topo, _out, log
    gc.collect()
    log = log_cls(str(path))
    topo, _out = _letters_topology(pkg, log, cfg_cls, **opts)
    assert topo.restore_stores() > 0
    _process(topo, records[committed:])
    topo.flush()
    return [(r.key, r.value) for r in log.read("matches")]


def test_crash_recovery_topology_is_exactly_once_and_equals_jax(tmp_path):
    records = _proc_records(n=160, n_keys=4, seed=5)
    plain_log = P.RecordLog()
    topo, _out = _letters_topology(P, plain_log, P.EngineConfig, runtime="cuda",
                                   device="cpu")
    _process(topo, records)
    topo.flush()
    want = [(r.key, r.value) for r in plain_log.read("matches")]
    assert len(want) >= 10
    port = _crash_run(P, tmp_path / "port", records, P.EngineConfig, P.RecordLog,
                      runtime="cuda", device="cpu")
    jax = _crash_run(J, tmp_path / "jax", records, JaxEngineConfig, JaxRecordLog,
                     runtime="tpu", **JAX_OFF)
    digests = [decode_sink_key(k)[1] for k, _v in port]
    assert len(set(digests)) == len(digests)
    assert port == want
    assert port == jax
