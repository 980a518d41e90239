"""The port's batched engine against the JAX engine, batch by batch.

The JAX side is `BatchedDeviceNFA(engine="xla")` -- the XLA step that
tests/test_pallas.py holds bitwise to the Pallas kernel -- built with the
options this port slice leaves out turned off: `auto_drain=False`,
`exact_replay=False`, `provenance_sample=0`, `drain_mode="flat"`,
`sink_format="objects"` (and `compile_telemetry=False`). The port side is
`BatchedDeviceNFA(device="cpu")`, whose wrapper runs the plain PyTorch
step on CPU tensors. Exact replay is off on both sides: these cases are
fold-free (letters, skip2, repeat) or collision-free on their streams
(stock; every test asserts that seq_collisions stays 0), so replay would
change no match, and with replay off both engines drain a GC group
mid-group through the same window view (armed, the port flushes the
group before a drain). tests/test_torch_replay.py holds the port with
replay armed to the JAX engine at its defaults.

Per conformance case (K=8 keys, T=10 events, 3 batches, stream seed 5;
the `repeat` case proceeds from a looping stage straight into a stage of
the same name),
and for skip2 again at the flagship deployment's post-pass settings
(`pin_interval=True`, so the GC pins the id interval from pend_min
instead of walking from the match pages; matches >= T x matches_per_step,
so the pend append takes its dense path):
  * the test_pallas.py loop with gc_group=1: state and pool equal after
    every advance (before its drain, so the ring the append wrote and the
    GC remapped is compared as it stands) and again after the drain, and
    the decoded JSON matches equal; and carry-across: a JAX engine's
    state and pool moved into a port engine after batch 1 with
    `state_from_numpy`, both continuing equal;
  * the same loop with gc_group=4 and a per-event watermark column, run
    for 4 batches so that the fourth advance ends in a group flush that
    GCs the 4-advance window, with the plain step alone held against the JAX
    batched XLA advance on each batch's inputs (nonzero gc_phase, "wm"
    column): state and ys equal, ys moved to one layout.
And past one chunk of 32 lanes: the flagship skip_any8 deployment with
its lanes cut to 96 (K=8 keys, T=64 events, 3 batches, stream seed 7),
the plain step alone against the JAX batched XLA advance, each fed its
own output state; some key holds more than 32 live lanes, which sends the
CUDA kernel's source down its multi-chunk path in
tests/test_torch_step.py.
Each test builds its own engines (the JAX compiles dominate), so no
fixture is rebuilt by several xdist workers.
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
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.carry import state_from_numpy, state_to_numpy  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, TS0  # noqa: E402
from kafkastreams_cep_tpu_torch.ops.step import build_plain_step  # noqa: E402

K, T, N_BATCHES = 8, 10, 3
#: The gc_group=4 run: its fourth advance flushes the group.
G4 = N_BATCHES_G4 = 4
KEYS = [f"k{i}" for i in range(K)]
YS = ("w_event", "w_name", "w_pred", "w_match", "w_mroot")

#: name -> (conformance case, EngineConfig overrides).
VARIANTS = {name: (name, {}) for name in CASES}
VARIANTS["skip2_pinned"] = (
    "skip2", dict(matches=T * CASES["skip2"][3]["matches_per_step"], pin_interval=True),
)


def _dense_append(cfg):
    return cfg["matches"] >= T * cfg["matches_per_step"]


def _jax_engine(query, cfg, gc_group):
    return JaxBatched(
        query, keys=KEYS, config=JaxEngineConfig(**cfg, gc_group=gc_group),
        engine="xla", auto_drain=False, exact_replay=False,
        provenance_sample=0.0, drain_mode="flat", sink_format="objects",
        compile_telemetry=False,
    )


def _diffs(jax_tree, port_tree):
    bad = []
    for name in jax_tree:
        a = np.asarray(jax_tree[name])
        b = port_tree[name].numpy()
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            bad.append(name)
    return bad


def _watermarks(b):
    """Per-key, per-event watermarks from 3 ms behind to 3 ms ahead of the
    event's own timestamp (ahead: an idle-advanced clock that expires runs
    early)."""
    return {k: [TS0 + b * T + i - 3 + 2 * (j % 4) for i in range(T)]
            for j, k in enumerate(KEYS)}


def _setup(variant):
    case, overrides = VARIANTS[variant]
    pattern, fields, stream, cfg = CASES[case]
    cfg = {**cfg, **overrides}
    # The pinned variant runs the flagship's GC and append branches; the
    # conformance cases run the precise walk and the compact append.
    assert cfg.get("pin_interval", False) == _dense_append(cfg) == bool(overrides)
    qj = jax_compile_query(J.compile_pattern(pattern(J)),
                           JaxEventSchema(fields) if fields else None)
    qp = P.compile_query(P.compile_pattern(pattern()),
                         P.EventSchema(fields) if fields else None)
    rng = random.Random(5)
    sj = {k: stream(rng, T * N_BATCHES_G4, J) for k in KEYS}
    rng = random.Random(5)
    sp = {k: stream(rng, T * N_BATCHES_G4) for k in KEYS}
    return qj, qp, sj, sp, cfg


def _batch(streams, b):
    return {k: s[b * T:(b + 1) * T] for k, s in streams.items()}


def _matches_json(out, to_json):
    return {k: [to_json(s) for s in v] for k, v in out.items()}


def _assert_same_state(label, bx, bp):
    assert not _diffs(bx.state, bp.state), f"{label}: state {_diffs(bx.state, bp.state)}"
    assert not _diffs(bx.pool, bp.pool), f"{label}: pool {_diffs(bx.pool, bp.pool)}"


def _assert_equal_after(b, label, bx, bp, jx, jp):
    _assert_same_state(f"{label} batch {b}", bx, bp)
    assert jx == jp, f"{label} batch {b}: matches differ"


def _advance_and_drain(b, label, bx, bp, xs_j, xs_p):
    """Advance both engines without decoding, compare them with the
    batch's matches still in the ring, then drain both and compare the
    matches and the drained state."""
    bx.advance_packed(xs_j, decode=False)
    bp.advance_packed(xs_p, decode=False)
    _assert_same_state(f"{label} batch {b} before the drain", bx, bp)
    jx = _matches_json(bx.drain(), jax_json)
    jp = _matches_json(bp.drain(), P.sequence_to_json)
    _assert_equal_after(b, label, bx, bp, jx, jp)
    return jx


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_engine_matches_jax_xla_and_carries_state(case):
    """(e) with gc_group=1 -- the test_pallas.py loop -- and (f): after
    batch 0 a fresh port engine (which only registered batch 0's events)
    takes the JAX engine's state and pool through `state_from_numpy`, and
    continues equal."""
    qj, qp, sj, sp, cfg = _setup(case)
    bx = _jax_engine(qj, cfg, 1)
    # A tiny prune threshold makes the port prune its event registry after
    # every drain (the JAX engine never does here): the decoded matches
    # must not change.
    bp = P.BatchedDeviceNFA(qp, keys=KEYS, device="cpu", config=P.EngineConfig(**cfg),
                            events_prune_threshold=16, exact_replay=False)
    carried = P.BatchedDeviceNFA(qp, keys=KEYS, device="cpu", config=P.EngineConfig(**cfg),
                                 exact_replay=False)
    n_matches = 0
    for b in range(N_BATCHES):
        jx = _advance_and_drain(b, f"{case} G=1", bx, bp,
                                bx.pack(_batch(sj, b)), bp.pack(_batch(sp, b)))
        n_matches += sum(map(len, jx.values()))
        if b == 0:
            carried.pack(_batch(sp, 0))
            np_state = {k: np.asarray(v) for k, v in bx.state.items()}
            np_pool = {k: np.asarray(v) for k, v in bx.pool.items()}
            carried.state, carried.pool = state_from_numpy(np_state, np_pool, "cpu")
            back_s, back_p = state_to_numpy(carried.state, carried.pool)
            assert all(np.array_equal(back_s[k], np_state[k]) for k in np_state)
            assert all(np.array_equal(back_p[k], np_pool[k]) for k in np_pool)
        else:
            jc = _matches_json(carried.advance(_batch(sp, b)), P.sequence_to_json)
            _assert_equal_after(b, f"{case} carried", bx, carried, jx, jc)
    assert n_matches > 0, "the case produced no matches"
    assert int(bp.state["seq_collisions"].sum()) == 0


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_engine_and_plain_step_match_jax_with_groups_and_watermarks(case):
    """(e) with gc_group=4 and a watermark column, and (d): before each
    advance, the plain step alone against the JAX batched XLA advance on
    the same inputs -- gc_phase is nonzero from the second batch on and
    back to 0 after the flush."""
    qj, qp, sj, sp, cfg = _setup(case)
    bx = _jax_engine(qj, cfg, G4)
    bp = P.BatchedDeviceNFA(qp, keys=KEYS, device="cpu",
                            config=P.EngineConfig(**cfg, gc_group=G4), exact_replay=False)
    plain = build_plain_step(qp, bp.config)
    phases = []
    for b in range(N_BATCHES_G4):
        xs_j = bx.pack(_batch(sj, b), _watermarks(b))
        xs_p = bp.pack(_batch(sp, b), _watermarks(b))
        phases.append(int(np.asarray(bx.state["gc_phase"])[0]))
        js, jys = bx._advance(bx.state, xs_j)
        ps, pys = plain(bp.state, xs_p)
        assert not _diffs(js, ps), f"{case} batch {b}: step state {_diffs(js, ps)}"
        for n in YS:
            assert np.array_equal(np.transpose(np.asarray(jys[n]), (0, 2, 1)),
                                  pys[n].numpy()), f"{case} batch {b}: ys {n}"
        _advance_and_drain(b, f"{case} G=4", bx, bp, xs_j, xs_p)
    phases.append(int(np.asarray(bx.state["gc_phase"])[0]))
    assert phases == [0, T, 2 * T, 3 * T, 0], f"gc_phase before each batch and at the end: {phases}"
    assert int(bp.state["seq_collisions"].sum()) == 0


def test_plain_step_matches_jax_past_one_chunk():
    """skip_any8 at lanes=96: the plain step and the JAX batched XLA
    advance, batch by batch from the initial state, each on its own
    engine's packing of the same events, give equal states and ys."""
    t = skip_any.FLAGSHIP_T
    cfg = {**skip_any.FLAGSHIP_CONFIG, "lanes": 96}
    qj = jax_compile_query(J.compile_pattern(skip_any.skip_any8_pattern(J)), None)
    qp = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    rng = random.Random(7)
    sj = {k: skip_any.skip_any8_stream(rng, t * N_BATCHES, J) for k in KEYS}
    rng = random.Random(7)
    sp = {k: skip_any.skip_any8_stream(rng, t * N_BATCHES) for k in KEYS}
    bx = _jax_engine(qj, cfg, 1)
    bp = P.BatchedDeviceNFA(qp, keys=KEYS, device="cpu", config=P.EngineConfig(**cfg))
    plain = build_plain_step(qp, bp.config)
    js, ps, live = bx.state, bp.state, 0
    for b in range(N_BATCHES):
        xs_j = bx.pack({k: v[b * t:(b + 1) * t] for k, v in sj.items()})
        xs_p = bp.pack({k: v[b * t:(b + 1) * t] for k, v in sp.items()})
        js, jys = bx._advance(js, xs_j)
        ps, pys = plain(ps, xs_p)
        assert not _diffs(js, ps), f"batch {b}: step state {_diffs(js, ps)}"
        for n in YS:
            assert np.array_equal(np.transpose(np.asarray(jys[n]), (0, 2, 1)),
                                  pys[n].numpy()), f"batch {b}: ys {n}"
        live = max(live, int(ps["active"].sum(0).max()))
    assert live > 32, f"at most {live} live lanes in a key at a batch end"
