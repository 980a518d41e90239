"""The GC sweep kernel's source against the plain sweep.

The kernel (kafkastreams_cep_tpu_torch/csrc/gc_sweep.cu) runs only on the
card, where `chip_smoke.py` holds it bitwise to `_sweep` on the flagship's,
config 4's, the wide stack's and `DeviceNFA`'s flushes. Here the same
source is compiled with g++ under csrc/cpu_emu.h and held bitwise to
`_sweep` (ops/gc_sweep.py), every plane it gives back:
  * seeded random marks: more marks than the region holds (ranks past B
    drop, `node_drops` counts them), preds into unkept nodes, `pend_min`
    NONE, a `pend_min` root that drops and ids past BW, ring rows past
    `pend_pos`, key counts off the block's key count (at the geometry the
    launch picks and at 32, 16, 4 and 2 keys a block), one key, the bitmaps
    in a global scratch, and the wide stack's BW = 131,072 at a few keys;
  * every sweep of real group flushes, recorded from plain engine runs:
    the stock fold case (page and lane walks), the flagship skip_any8
    deployment cut to 8 keys (`pin_interval`), the stacked letter queries
    at gc_group 4 (deferred advances, groups of 4 windows) and
    `DeviceNFA` on tests/test_torch_replay.py's fold seed 72 (K = 1).
The wrapper takes `_sweep` for CPU tensors and counts no launch there,
and its input check refuses what the kernel does not take. The flush
itself is held to the JAX engine in tests/test_torch_batched.py,
tests/test_torch_stacked.py and tests/test_torch_device_nfa.py.
"""
import random
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, branchy_case  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stacked import letter_queries  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import engine as engine_mod  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import gc_sweep as gs  # noqa: E402
from kafkastreams_cep_tpu_torch.parallel import StackedQueryEngine  # noqa: E402

NONE = int(gs._PEND_MIN_NONE)


@pytest.fixture(scope="module")
def cpu_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    return gs.load_library(gs.build_library(target="cpu"))


def _random_case(seed, B, T, cap, K, R=12, M=16, keep=0.6):
    """Sweep inputs: marks (row BW unmarked, pins a subset), region and
    window planes and lanes holding ids in [-1, BW], a ring dense below
    each key's cursor and -1 past it, and pend_min NONE, -1, a kept id, a
    dropped id (rank >= B) or BW + 1."""
    rng = np.random.default_rng(seed)
    BW = B + T * cap
    marked = np.zeros((BW + 1, K), bool)
    marked[:BW] = rng.random((BW, K)) < keep
    pin = marked & (rng.random((BW + 1, K)) < 0.5)

    def ids(*shape):
        return rng.integers(-1, BW + 1, shape).astype(np.int32)

    pos = rng.integers(0, M + 1, K).astype(np.int32)
    pend = ids(M, K)
    pend[np.arange(M)[:, None] >= pos[None, :]] = -1
    pend_min = np.empty(K, np.int32)
    for k in range(K):
        marks = np.flatnonzero(marked[:BW, k])
        choice = k % 5
        if choice == 0:
            pend_min[k] = NONE
        elif choice == 1 and marks.size > B:
            pend_min[k] = marks[B]  # its rank is B: dropped, so 0
        elif choice == 2:
            pend_min[k] = BW + 1
        elif choice == 3:
            pend_min[k] = -1
        else:
            pend_min[k] = marks[0] if marks.size else 0
    pool = {"node_event": ids(B, K), "node_name": ids(B, K), "node_pred": ids(B, K),
            "pend": pend, "pend_pos": pos, "pend_min": pend_min}
    ys = {n: ids(T, K, cap) for n in gs.WINDOW_PLANES}
    state = {"node": ids(R, K), "root": ids(R, K),
             "node_drops": rng.integers(0, 4, K).astype(np.int32)}
    t = torch.from_numpy
    return (t(marked), t(pin), {n: t(v) for n, v in state.items()},
            {n: t(v) for n, v in pool.items()}, {n: t(v) for n, v in ys.items()})


def _same(lib, case, label, **geometry):
    want = gs._sweep(*case)
    got = gs.launch(lib, *case, **geometry)
    assert set(got) == set(gs.POOL_OUT + gs.STATE_OUT) == set(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, (label, n)
        bad = (got[n] != want[n]).nonzero()
        assert bad.numel() == 0, f"{label} {n}: {bad.shape[0]} differ, first at {bad[:4].tolist()}"
    return want


#: name -> (B, T, cap, K, keep, launch geometry).
RANDOM = {
    "drops": (64, 3, 8, 8, 0.9, {}),
    "sparse": (64, 3, 8, 7, 0.15, {}),
    "keys_off_block_32": (40, 2, 16, 21, 0.6, {"keys_per_block": 32}),
    "keys_off_block_16": (40, 2, 16, 21, 0.6, {"keys_per_block": 16}),
    "keys_off_block_4": (40, 2, 16, 21, 0.6, {"keys_per_block": 4}),
    "global_scratch_2": (40, 2, 16, 9, 0.7, {"keys_per_block": 2, "global_bitmaps": True}),
    "one_key": (512, 4, 128, 1, 0.7, {}),
    "wide_bw": (65_536, 64, 1024, 2, 0.4, {}),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_sweeps(cpu_lib, name):
    B, T, cap, K, keep, geometry = RANDOM[name]
    case = _random_case(len(name), B, T, cap, K, keep=keep)
    want = _same(cpu_lib, case, name, **geometry)
    n_keep = case[0].sum(dim=0)
    if name == "drops":
        assert bool((n_keep > B).all()) and bool((want["node_drops"] > case[2]["node_drops"]).all())
        assert int(want["pend_min"][1]) == 0  # a dropped pend_min root pins everything
    if name == "wide_bw":
        assert int(cpu_lib.gc_sweep_scratch_words(B + T * cap, 512)) == 0
        assert 0 < int(cpu_lib.gc_sweep_smem_bytes(B + T * cap, 512)) <= 227 * 1024
    assert bool((want["pend_min"][::5] == NONE).all())


def _recorded_sweeps(monkeypatch, make_engine, drive):
    """Run a plain engine and record the inputs of every sweep its group
    flushes ask for."""
    calls = []

    def record(marked, marked_pin, state, pool, ys):
        calls.append((marked, marked_pin, dict(state), dict(pool), dict(ys)))
        return gs._sweep(marked, marked_pin, state, pool, ys)

    monkeypatch.setattr(engine_mod, "gc_sweep", record)
    drive(make_engine())
    monkeypatch.undo()
    return calls


def _stock(monkeypatch):
    pattern, fields, stream, cfg = CASES["stock"]
    q = P.compile_query(P.compile_pattern(pattern()), P.EventSchema(fields))
    keys = [f"k{i}" for i in range(8)]

    def drive(eng):
        rng = random.Random(5)
        st = {k: stream(rng, 40) for k in keys}
        for b in range(4):
            eng.advance({k: s[b * 10:(b + 1) * 10] for k, s in st.items()})

    return _recorded_sweeps(monkeypatch, lambda: P.BatchedDeviceNFA(
        q, keys=keys, device="cpu", config=P.EngineConfig(**cfg)), drive)


def _flagship(monkeypatch):
    T = skip_any.FLAGSHIP_T
    keys = [f"k{i}" for i in range(8)]
    fq = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    fcfg = P.EngineConfig(**{**skip_any.FLAGSHIP_CONFIG, "lanes": 96})
    assert fcfg.pin_interval

    def drive(eng):
        rng = random.Random(7)
        st = {k: skip_any.skip_any8_stream(rng, 3 * T) for k in keys}
        for b in range(3):
            eng.advance({k: s[b * T:(b + 1) * T] for k, s in st.items()})

    return _recorded_sweeps(monkeypatch, lambda: P.BatchedDeviceNFA(
        fq, keys=keys, device="cpu", config=fcfg), drive)


def _stacked(monkeypatch):
    keys = [f"k{i}" for i in range(6)]
    cfg = P.EngineConfig(lanes=32, nodes=1024, matches=512, matches_per_step=16, gc_group=4)

    def drive(eng):
        rng = random.Random(13)
        st = {k: [P.Event(k, rng.choice("ABCD"), 1000 + i, "t", 0, i) for i in range(96)]
              for k in keys}
        for b in range(8):
            eng.advance_packed(eng.pack({k: s[b * 12:(b + 1) * 12] for k, s in st.items()}),
                               decode=False)
        assert sum(len(v) for per_q in eng.drain().values() for v in per_q.values()) > 0

    return _recorded_sweeps(monkeypatch, lambda: StackedQueryEngine(
        letter_queries(), keys=keys, config=cfg, device="cpu"), drive)


def _single_key(monkeypatch):
    pattern, streams = branchy_case(72, ["kA", "kB", "kC"])
    cfg = P.EngineConfig(lanes=256, nodes=4096, matches=2048, matches_per_step=256)

    def drive(dn):
        events = streams["kA"]
        for i in range(0, len(events), 5):
            dn.advance(events[i:i + 5])

    return _recorded_sweeps(monkeypatch, lambda: P.DeviceNFA(
        P.compile_pattern(pattern), config=cfg, device="cpu"), drive)


#: name -> (recorder, flushes it must record, windows in a flush).
REAL = {
    "stock": (_stock, 4, 1),
    "flagship_pin_interval": (_flagship, 3, 1),
    "stacked_gc_group4": (_stacked, 2, 4),
    "device_nfa_branchy72": (_single_key, 4, 1),
}


@pytest.mark.parametrize("name", sorted(REAL))
def test_sweeps_of_real_flushes(cpu_lib, monkeypatch, name):
    recorder, n_flushes, windows = REAL[name]
    calls = recorder(monkeypatch)
    assert len(calls) == n_flushes
    kept = 0
    for i, case in enumerate(calls):
        B = case[3]["node_event"].shape[0]
        T = case[4]["w_event"].shape[0]
        assert T % windows == 0 and (windows == 1 or T > windows)
        want = _same(cpu_lib, case, f"{name} flush {i}")
        kept += int(want["node_count"].sum())
        assert int(want["node_count"].max()) <= B
    assert kept > 0


def test_wrapper_takes_the_plain_sweep_on_cpu_and_checks_inputs():
    case = _random_case(3, 32, 2, 8, 4)
    before = gs.GcSweep.launches
    got = gs.gc_sweep(*case)
    want = gs._sweep(*case)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert gs.GcSweep.launches == before
    marked, pin, state, pool, ys = case
    with pytest.raises(ValueError, match="marked"):
        gs.check_inputs(marked[:-1], pin, state, pool, ys)
    with pytest.raises(ValueError, match="marked_pin"):
        gs.check_inputs(marked, pin.int(), state, pool, ys)
    with pytest.raises(ValueError, match="w_pred"):
        gs.check_inputs(marked, pin, state, pool, {**ys, "w_pred": ys["w_pred"][:, :, :-1]})
    with pytest.raises(ValueError, match="pend_pos"):
        gs.check_inputs(marked, pin, state, {**pool, "pend_pos": pool["pend_pos"].long()}, ys)
    with pytest.raises(ValueError, match="node is not contiguous"):
        gs.check_inputs(marked, pin, {**state, "node": state["node"].t().contiguous().t()},
                        pool, ys)
    with pytest.raises(ValueError, match="unsupported device"):
        gs.gc_sweep(*(t.to("meta") if isinstance(t, torch.Tensor) else
                      {n: v.to("meta") for n, v in t.items()} for t in case))


def test_kernel_matches_plain_sweep_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    case = _random_case(5, 300, 3, 64, 40, keep=0.7)
    on_card = tuple(t.cuda() if isinstance(t, torch.Tensor) else
                    {n: v.cuda() for n, v in t.items()} for t in case)
    got = gs.gc_sweep(*on_card)
    torch.cuda.synchronize()
    want = gs._sweep(*case)
    assert all(torch.equal(got[n].cpu(), want[n]) for n in want)
