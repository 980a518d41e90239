"""The GC mark kernel's source against the plain walk, and the deferred
advance's zero-sync scan.

The kernel (kafkastreams_cep_tpu_torch/csrc/gc_mark.cu) runs only on the
card, where `chip_smoke.py` holds it bitwise to `_walk` on the flagship's
states. Here the same source is compiled with g++ under csrc/cpu_emu.h
(OS threads for CUDA threads, `std::atomic_ref` for atomicOr) and held
bitwise to `_walk` (ops/gc_kernel.py), every row of the [BW + 1, K] mark:
  * seeded random graphs (creation-ordered preds, chains of up to ~40
    hops): page walks from a pinned closure, lane walks seeded with a page
    walk's result, interval seeds as `pin_interval` builds them, a
    frontier of holes only, chains that run into marked nodes, frontiers
    wider than one warp, key counts off the walk block's key count (at the
    geometry the launch picks and at 32, 16, 4 and 2 keys a block, and one
    key: the whole block on it), K a multiple of 4 (the pack and unpack
    take 4 keys a thread) and not, the walk in place in the global words,
    the wide stack's BW = 131,072 (and 90,000) in shared memory, and a
    node region too large for one block's shared memory (the walk in the
    global words);
  * every mark of real group flushes: the stock fold case (page and lane
    walks) and the flagship skip_any8 deployment cut to 8 keys
    (`pin_interval`, lane walks only), recorded from plain engine runs.
The engine's flush itself is held to the JAX engine in
tests/test_torch_batched.py.

The scan (analysis/zerosync.py) pins that the deferred advance path --
`advance_packed` down to the step kernel's wrapper, the pend append and
the group-flush GC -- holds no host read of a tensor: `.item()`, `.cpu()`,
`synchronize`, and `.tolist()`, `.numpy()`, `bool()`, `int()` or
`float()` of a tensor value. `_walk` is the one listed exception (it runs
only on CPU tensors). The old walk, put back into ops/engine.py, fails it.
"""
import random
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu_torch.analysis import zerosync  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import engine as engine_mod  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk  # noqa: E402


@pytest.fixture(scope="module")
def cpu_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    return gk.load_library(gk.build_library(target="cpu"))


def _graph(rng, BW, K, chain_p=0.85):
    """[BW, K] preds: node i's pred is an older node (or -1), so chains
    are creation-ordered as the GC's sweep keeps them."""
    pred = np.full((BW, K), -1, np.int32)
    for k in range(K):
        for i in range(1, BW):
            if rng.random() < chain_p:
                pred[i, k] = rng.randrange(max(0, i - 6), i)
    return pred


def _frontier(rng, F, BW, K, holes=0.6):
    fr = np.full((F, K), -1, np.int32)
    for f in range(F):
        for k in range(K):
            if rng.random() >= holes:
                fr[f, k] = rng.randrange(BW)
    return fr


def _closed_seed(rng, pred, n_roots):
    """A pinned set closed under pred (as `pinned` is), plus the trash row."""
    BW, K = pred.shape
    seed = np.zeros((BW + 1, K), bool)
    for k in range(K):
        for _ in range(n_roots):
            i = rng.randrange(BW)
            while i >= 0 and not seed[i, k]:
                seed[i, k] = True
                i = pred[i, k]
    return seed


def _same(lib, seed, frontier, pred, label, **geometry):
    m, f, p = (torch.from_numpy(np.ascontiguousarray(a)) for a in (seed, frontier, pred))
    want = gk._walk(m, f, p)
    got = gk.launch(lib, m, f, p, **geometry)
    assert got.dtype == torch.bool and got.shape == want.shape, label
    bad = (got != want).nonzero()
    assert bad.numel() == 0, f"{label}: {bad.shape[0]} marks differ, first at {bad[:4].tolist()}"
    return want


@pytest.mark.parametrize("seed_no", range(4))
def test_random_page_and_lane_walks(cpu_lib, seed_no):
    rng = random.Random(100 + seed_no)
    BW, K = rng.choice([(300, 8), (517, 21), (64, 3), (1000, 16)])
    pred = _graph(rng, BW, K)
    pinned = _closed_seed(rng, pred, n_roots=2)
    page = _frontier(rng, 96, BW, K, holes=0.8)          # wider than a warp
    marked_pin = _same(cpu_lib, pinned, page, pred, f"page walk {seed_no}")
    lanes = _frontier(rng, 40, BW, K, holes=0.3)
    _same(cpu_lib, marked_pin.numpy(), lanes, pred, f"lane walk {seed_no}")
    # The card's geometries at this K: more keys a block, global bitmaps,
    # and one key alone (the K = 1 launch of DeviceNFA).
    kpb = (32, 4, 2, 16)[seed_no]
    _same(cpu_lib, marked_pin.numpy(), lanes, pred, f"lane walk {seed_no}, {kpb} keys a block",
          keys_per_block=kpb, global_bitmaps=seed_no % 2 == 1)
    _same(cpu_lib, pinned[:, :1], page[:, :1], pred[:, :1], f"page walk {seed_no}, K = 1")


def test_interval_seed_holes_and_meeting_chains(cpu_lib):
    rng = random.Random(7)
    BW, K = 400, 19
    pred = _graph(rng, BW, K, chain_p=0.95)
    # pin_interval: every valid id at or past each key's pend_min.
    valid = np.ones((BW + 1, K), bool)
    valid[BW] = False
    valid[rng.sample(range(BW), 50)] = False
    pend_min = np.array([rng.randrange(BW) for _ in range(K)])
    interval = (np.arange(BW + 1)[:, None] >= pend_min[None, :]) & valid
    lanes = _frontier(rng, 64, BW, K, holes=0.5)
    _same(cpu_lib, interval, lanes, pred, "interval seed")
    # A frontier of holes changes nothing.
    _same(cpu_lib, interval, np.full((33, K), -1, np.int32), pred, "all holes")
    # Long chains into a marked block: each walker must stop at it.
    chain = np.full((BW, K), -1, np.int32)
    chain[1:] = np.arange(BW - 1, dtype=np.int32)[:, None]
    seed = np.zeros((BW + 1, K), bool)
    seed[100:120] = True
    seed[BW] = True  # the trash row is given back as it came
    front = np.full((40, K), -1, np.int32)
    front[:, :] = np.array([rng.randrange(130, BW) for _ in range(40)], np.int32)[:, None]
    out = _same(cpu_lib, seed, front, chain, "chains into marks")
    assert bool(out[BW].all())
    top = int(front.max())
    assert bool(out[120:top + 1].all()) and not bool(out[:100].any())


def _broken_chain(rng, BW, K, breaks):
    pred = np.full((BW, K), -1, np.int32)
    pred[1:] = np.arange(BW - 1, dtype=np.int32)[:, None]
    pred[rng.sample(range(BW), breaks)] = -1
    return pred


#: The largest BW whose bitmap (one key) fits a block's 227 KB.
SMEM_ROWS = 227 * 1024 * 8


def test_region_past_shared_memory_uses_the_scratch(cpu_lib):
    rng = random.Random(11)
    BW, K = SMEM_ROWS + 40_416, 2
    # Past one key's shared memory the walk runs in place in the global
    # words; below it, in shared memory.
    assert int(cpu_lib.gc_mark_smem_bytes(BW, K)) == 0
    assert int(cpu_lib.gc_mark_smem_bytes(SMEM_ROWS, K)) == SMEM_ROWS // 8
    assert int(cpu_lib.gc_mark_smem_bytes(16_384, K)) > 0
    assert int(cpu_lib.gc_mark_words(BW, K)) == -(-BW // 32) * K
    pred = _broken_chain(rng, BW, K, 20_000)
    seed = np.zeros((BW + 1, K), bool)
    _same(cpu_lib, seed, _frontier(rng, 50, BW, K, holes=0.5), pred, "global scratch")


@pytest.mark.parametrize("BW", [90_000, 131_072])
def test_wide_regions_keep_their_bitmaps_in_shared_memory(cpu_lib, BW):
    """The wide stack's BW (65,536 nodes + its 65,536-row window) and the
    BW the global-scratch branch used to start below: bitmaps in shared
    memory at the wide stack's K = 512, and held to `_walk` at that
    launch's keys a block."""
    rng = random.Random(11)
    K = 3
    kpb = int(cpu_lib.gc_mark_keys_per_block(BW, 512))
    smem = int(cpu_lib.gc_mark_smem_bytes(BW, 512))
    assert 0 < smem <= 227 * 1024 and smem == kpb * ((BW + 31) // 32) * 4
    assert -(-512 // kpb) >= 64  # blocks enough for half the SMs at least
    pred = _broken_chain(rng, BW, K, 2000)
    seed = np.zeros((BW + 1, K), bool)
    _same(cpu_lib, seed, _frontier(rng, 50, BW, K, holes=0.5), pred, f"shared, BW {BW}",
          keys_per_block=kpb)


def _recorded_marks(monkeypatch, make_engine, batches):
    """Run a plain engine and record every mark its group flushes ask for."""
    calls = []

    def record(marked, frontier, pred):
        calls.append((marked, frontier.contiguous(), pred))
        return gk._walk(marked, frontier, pred)

    monkeypatch.setattr(engine_mod, "gc_mark", record)
    eng = make_engine()
    for batch in batches(eng):
        eng.advance(batch)
    monkeypatch.undo()
    return calls


def test_marks_of_real_flushes(cpu_lib, monkeypatch):
    pattern, fields, stream, cfg = CASES["stock"]
    q = P.compile_query(P.compile_pattern(pattern()), P.EventSchema(fields))
    keys = [f"k{i}" for i in range(8)]

    def stock_batches(eng):
        rng = random.Random(5)
        st = {k: stream(rng, 40) for k in keys}
        return [{k: s[b * 10:(b + 1) * 10] for k, s in st.items()} for b in range(4)]

    calls = _recorded_marks(monkeypatch, lambda: P.BatchedDeviceNFA(
        q, keys=keys, device="cpu", config=P.EngineConfig(**cfg)), stock_batches)
    assert len(calls) == 8  # a page walk and a lane walk per flush
    T = skip_any.FLAGSHIP_T
    fq = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    fcfg = P.EngineConfig(**{**skip_any.FLAGSHIP_CONFIG, "lanes": 96})
    assert fcfg.pin_interval

    def flag_batches(eng):
        rng = random.Random(7)
        st = {k: skip_any.skip_any8_stream(rng, 3 * T) for k in keys}
        return [{k: s[b * T:(b + 1) * T] for k, s in st.items()} for b in range(3)]

    flag_calls = _recorded_marks(monkeypatch, lambda: P.BatchedDeviceNFA(
        fq, keys=keys, device="cpu", config=fcfg), flag_batches)
    assert len(flag_calls) == 3  # the lane walk only
    marked_any = 0
    for i, (m, f, p) in enumerate(calls + flag_calls):
        out = _same(cpu_lib, m.numpy(), f.numpy(), p.numpy(), f"flush mark {i}")
        marked_any += int(out.sum()) - int(m.sum())
    assert marked_any > 0


def test_wrapper_takes_the_plain_walk_on_cpu_and_checks_inputs():
    rng = random.Random(3)
    pred = torch.from_numpy(_graph(rng, 50, 4))
    seed = torch.zeros((51, 4), dtype=torch.bool)
    front = torch.from_numpy(_frontier(rng, 10, 50, 4))
    before = gk.GcMark.launches
    assert torch.equal(gk.gc_mark(seed, front, pred), gk._walk(seed, front, pred))
    assert gk.GcMark.launches == before
    with pytest.raises(ValueError, match="marked"):
        gk.check_inputs(seed[:-1], front, pred)
    with pytest.raises(ValueError, match="frontier"):
        gk.check_inputs(seed, front.long(), pred)


def test_kernel_matches_plain_walk_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    rng = random.Random(5)
    pred = _graph(rng, 600, 40)
    seed = _closed_seed(rng, pred, 3)
    front = _frontier(rng, 70, 600, 40)
    m, f, p = (torch.from_numpy(a).cuda() for a in (seed, front, pred))
    got = gk.gc_mark(m, f, p)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gk._walk(m.cpu(), f.cpu(), p.cpu()))


# ---------------------------------------------------------------- zero sync
def test_deferred_advance_path_has_no_host_read():
    findings = zerosync.scan()
    assert findings == [], "\n".join(map(str, findings))
    # The exception is listed and still matches a function.
    assert set(zerosync.EXCEPTIONS) == {("ops/gc_kernel.py", "_walk")}
    assert zerosync.excepted_hits() == [("ops/gc_kernel.py", "_walk")]


OLD_WALK = '''
def _walk_old(marked, frontier, pred, BW):
    fr = frontier
    while True:
        for _ in range(8):
            live = fr >= 0
            cidx = torch.where(live, fr, torch.full_like(fr, BW)).long()
            already = torch.gather(marked, 0, cidx) & live
            marked = marked.scatter(0, cidx, torch.ones_like(already))
            nxt = torch.gather(pred, 0, cidx.clamp(max=BW - 1))
            fr = torch.where(live & ~already, nxt, torch.full_like(nxt, -1))
        if not bool((fr >= 0).any()):
            return marked
'''


def test_scan_fails_when_the_old_walk_is_back():
    src = zerosync.source("ops/engine.py")
    call = "marked = gc_mark(marked_pin, lane_roots, combined_pred)"
    assert call in src
    mutated = src.replace(call, "marked = _walk_old(marked_pin, lane_roots, combined_pred, BW)")
    mutated += OLD_WALK
    findings = zerosync.scan(overrides={"ops/engine.py": mutated})
    assert [(f.path, f.function) for f in findings] == [("ops/engine.py", "_walk_old")]
    assert "bool" in findings[0].construct
    # A host read of a tensor added straight into the advance is found too.
    batched = zerosync.source("parallel/batched.py")
    anchor = "        self._batches += 1\n"
    assert anchor in batched
    mutated = batched.replace(anchor, anchor + "        self._last_n = int(self.state['n_events'].sum())\n", 1)
    findings = zerosync.scan(overrides={"parallel/batched.py": mutated})
    assert [(f.function, f.construct) for f in findings] == [
        ("BatchedDeviceNFA.advance_packed", "int() of a tensor")]
