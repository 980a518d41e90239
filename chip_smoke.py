#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the step kernel from csrc/ with nvcc (one build per compiled query
and capacity, the flagship's grown shape and the fold query of phase 13
included; the event-time phases reuse the flagship's build), the GC mark
kernel (csrc/gc_mark.cu, one build) and the native
packer, decoder and CRC-32C from native/ with g++, all started together,
then:

  1. prints the card (`nvidia-smi --query-gpu=name,power.limit`);
  2. builds every kernel and the three native extensions and prints the
     build seconds, the Python include path, ptxas's registers and spills
     (step and mark), and the step kernel's resident blocks and warps per
     SM (one warp per key);
  3. holds the CUDA step bitwise equal to the plain PyTorch step on the
     card, on identical inputs, every state leaf and every w_* output:
     the three conformance cases (K=8, T=10, 3 batches), the multi-chunk
     cases of models/chunked.py (K=8, T=64, 3 batches: more than 32 live
     lanes in a key, lane overflow, folds across chunks), an entry state
     whose live lanes are not a prefix, a key whose events are all
     padding, and the flagship shape (K=2048, T=64, 3 batches); prints
     the flagship's live lanes per key and event (the plain step one
     event at a time over those 3 batches); times kernel and plain step
     at the flagship shape on the third batch's state;
  4. drives the engine, `BatchedDeviceNFA(engine="cuda")`, on the
     flagship skip_any8 deployment (2048 keys x 64 events per batch,
     2 warm + 8 timed batches, stream seed 7, each batch packed, advanced
     and drained in turn, as `advance()` does), prints events/s with and
     without the host packing, the ms per batch of each phase and the
     live lanes per key at batch ends, and checks: every pack took the
     native route, the first three batches' native columns equal the
     Python pack's bitwise, every drained table's native decode equals
     the Python walk's, the kernel's launch count equals the advances,
     the GC mark kernel's launch count equals the flushes' walks, the drop
     counters are 0, there are matches, and the final state, pool and the
     first 64 keys' matches equal the same run with engine="torch"; then
     times the kernel on the last batch's state;
  5. drives the same deployment through the streams API -- a
     `runtime="cuda"` topology fed record by record through
     `Topology.process`, 2 warm + 8 timed flushes of 131,072 records,
     matches to a `.to("matches")` sink -- and prints records/s and the
     ms per flush of enqueue, pack, advance, drain + decode and emit;
     checks that the matches per key equal phase 4's, the step kernel and
     the GC mark kernel launched once per flush, the drop counters are 0
     and the sink holds
     one record per match; then again with `sink_format="json"`, whose
     payloads must equal the objects run's JSON bytes;
  6. runs the stock demo golden through engine="cuda" (4 matches on each
     of 2 keys);
  7. and through a `runtime="cuda"` topology (4 matches);
  8. checkpoint: runs the flagship engine through batches 1-5, snapshots
     it, restores the snapshot into a fresh engine on the card and runs
     batches 6-10 on both; checks that final state, pool and every key's
     matches are bitwise equal (and equal to phase 4's); prints the
     snapshot's bytes, its ms split into flush + D2H, encode and CRC,
     and the restore ms;
  9. resize: after batch 5 grows the engine to lanes 640, nodes 16384
     (a kernel built for that shape), holds the kernel bitwise to the
     plain step at the grown shape on batch 6's inputs and times both,
     runs batches 6-7, shrinks back to the flagship capacity and runs
     8-10; checks that matches, state and pool equal phase 8's
     uninterrupted run and that a shrink below the live lanes raises
     `ShapeRestoreError` and leaves the engine as it was;
 10. overflow: the 10 batches deferred (`advance_packed(decode=False)`)
     with one drain at the end, three times: `auto_drain` on (drops 0,
     matches per key equal phase 4's; prints the ring-full drains and
     events/s over the 8 timed batches), `on_overflow="block"` with
     auto_drain off (drops 0, same matches; prints the backpressure
     count) and `on_overflow="raise"` with a ring below the busiest key's
     deferred matches (`CEPOverflowError`, carrying the drained matches);
     then counts the host synchronisations over 8 deferred advances with
     `torch.cuda.set_sync_debug_mode("warn")`, occupancy probe on and off,
     and fails unless both are 0;
 11. crash recovery: a `runtime="cuda"` topology on a file-backed
     `RecordLog` commits with `flush_stores()` after flushes 3 and 6,
     "crashes" inside flush 8 (builder, topology and engine dropped, the
     log closed), is built afresh on the same log, `restore_stores()`,
     replays the input from the committed offset and finishes; checks
     that the sink holds every match of phase 5's uninterrupted run
     exactly once, in order; prints the bytes and ms per commit and the
     time to recover (log reload, `restore_stores`, replay to the crash);
 12. the GC mark: captures the flagship's group flushes after batches 3
     and 10 (`pin_interval`, the lane walk) and after batch 3 of the same
     deployment with `pin_interval=False` (the page walk and the lane
     walk), holds the kernel bitwise to the plain walk `_walk` on every
     captured mark, and prints ms per launch (CUDA events), its byte bound
     (the seed and result marks, the frontier, and one pred read per newly
     marked node) and the group flush's ms with the kernel and with the
     plain walk on the same state;
 13. exact replay at K = 2048: a branchy fold query of
     tests/test_torch_replay.py's kind (models/cases.py `branchy_case`,
     seed 65: its keys fold-collide and each needs at most a few hundred
     runs, where seed 72's busiest key needs 4,910, past any lane count
     the engine would hold for 2048 keys) over 2048 keys, 20 events each,
     in 4 drained batches of 5 through
     `BatchedDeviceNFA(engine="cuda")` at its defaults: prints the
     collisions, replays and replay ms per drain, and holds the matches of
     every replayed key and of 64 sampled other keys equal to the host
     oracle (nfa/) run per key; then the same 4 batches pre-packed and
     advanced deferred: 0 host syncs over the 4 advances, and after one
     drain the same matches;
 14. event time at the flagship: the same deployment through a gated
     `runtime="cuda"` topology (reorder_capacity 256, lateness 6 ms; key
     k_i on partition i, the sources of a `MinMergeWatermark` over
     per-key `BoundedOutOfOrderness(6)`, all registered first), fed each
     key's stream shuffled within 6 ms (bench.py's `shuffled_within_bound`,
     seed 47) and, again, presorted; checks that the matches per key of
     both equal phase 4's, late 0, reorder overflow 0, drops 0, and
     `nfa_step` and `gc_mark` launched once per flush (group flush); prints
     records/s of both against phase 5's ungated objects run, the gate's
     ms per flush and the watermark lag p50/p99; holds the step kernel
     bitwise to the plain step on flush 3's batch, which carries the
     gate's "wm" column, and on the same batch with every clock pushed up
     to 16 ms ahead (expiry off the watermark), and times both there;
 15. LogDriver: the shuffled flagship records and one record that does not
     deserialize go through `produce()` into a file-backed `RecordLog`,
     then through a `LogDriver` over a gated `runtime="cuda"` topology
     (polls of one batch, 131,072 records, each followed by a flush; a
     commit every 3 polls); checks that every
     record was polled, the sink equals phase 14's matches, the poison
     record is in the dead-letter topic and `cep_match_latency_seconds`
     counted one sample per match; prints records/s through the driver,
     match latency p50/p99 and ms per commit; then on a copy of the log a
     driver is dropped after poll 7 (last commit after poll 6) with its
     topology and engine, and a fresh one restores from the files and
     finishes: its sink must equal the uninterrupted run's, every match
     once, in order, the poison record dead-lettered once; prints the
     time to recover;
 16. prints the kernel line (with the `wm` run's numbers under
     nfa_step), the card line, and last the ok line.

Each phase that drives the main path zeroes the kernels' launch counts
just before and reads them just after, and fails if a kernel was not
launched. Any failed phase raises (exit code 1) before the ok line is
printed. Without a card it exits 2 and prints nothing on stdout.
"""
from __future__ import annotations

import ctypes
import gc
import json
import random
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


T_START = time.perf_counter()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spread(values: torch.Tensor) -> str:
    v = values.double()
    return (f"mean {float(v.mean()):.2f}, p50 {float(v.quantile(0.5)):.0f}, "
            f"p90 {float(v.quantile(0.9)):.0f}, max {int(v.max())}")


class GcClock:
    """Seconds and passes of the interpreter's cyclic garbage collector
    while `on` (a gc.callbacks hook). The collector runs inside whatever
    phase allocates, so its time is part of the phases' walls, not an
    extra phase."""

    def __init__(self) -> None:
        self.on = False
        self.seconds = 0.0
        self.passes = [0, 0, 0]
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            if self.on:
                self.seconds += time.perf_counter() - self._t0
                self.passes[info["generation"]] += 1
            self._t0 = None

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)

    def summary(self, n: int) -> str:
        return (f"cyclic GC {self.seconds / n * 1e3:.2f} ms per batch inside those phases "
                f"(passes by generation {self.passes})")


def bytes_moved(state: dict, s_out: dict, ys: dict, keep: tuple) -> int:
    """Bytes one nfa_step launch must move: xi/xf and the state read once,
    the state (but gc_phase) and the ys written once."""
    xi, xf, _scratch = keep
    moved = xi.numel() * 4 + (xf.numel() * 4 if xf is not None else 0)
    moved += sum(state[n].numel() * state[n].element_size() for n in s_out if n in state)
    moved += sum(s_out[n].numel() * s_out[n].element_size() for n in s_out if n != "gc_phase")
    moved += sum(v.numel() * 4 for v in ys.values())
    return moved


def count_syncs(fn) -> int:
    """Host synchronisations the CUDA runtime reports while fn runs."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # The first switch to "warn" also emits a one-time notice that the
    # mode is a prototype: count only the reported operations.
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def max_abs_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over every leaf; raises if a leaf is not bitwise equal."""
    bad = [n for n in a if a[n].dtype != b[n].dtype or not torch.equal(a[n], b[n])]
    if bad:
        raise AssertionError(f"kernel != plain in {bad}")
    return max(float((a[n].double() - b[n].double()).abs().max()) for n in a if a[n].numel())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.models.cases import CASES, STOCK_FIELDS, branchy_case
    from kafkastreams_cep_tpu_torch.models.chunked import CHUNKED, CHUNKED_T, scatter_live_lanes
    from kafkastreams_cep_tpu_torch import native
    from kafkastreams_cep_tpu_torch.models.stocks import (
        GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
    )
    from kafkastreams_cep_tpu_torch.ops import engine as engine_mod
    from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk
    from kafkastreams_cep_tpu_torch.ops import step_kernel as sk
    from kafkastreams_cep_tpu_torch.ops.engine import DROP_COUNTER_KEYS
    from kafkastreams_cep_tpu_torch.ops.step import build_plain_step
    from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ----------------------------------------------------------
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 2. build every kernel (one nvcc per compiled query, in parallel) -----
    builds = {}
    for name, (pat, fields, stream, cfg) in CASES.items():
        q = P.compile_query(P.compile_pattern(pat()), P.EventSchema(fields) if fields else None)
        builds[name] = (q, P.EngineConfig(**cfg), stream)
    for name, (pat, fields, stream, _seed, cfg) in CHUNKED.items():
        q = P.compile_query(P.compile_pattern(pat()), P.EventSchema(fields) if fields else None)
        builds[name] = (q, P.EngineConfig(**cfg), stream)
    flag_q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    flag_cfg = P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    builds["skip_any8"] = (flag_q, flag_cfg, None)
    grown_cfg = replace(flag_cfg, lanes=640, nodes=16384)
    builds["skip_any8_grown"] = (flag_q, grown_cfg, None)
    gold_q = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    gold_cfg = P.EngineConfig(lanes=32, nodes=512, matches=64)
    builds["stock_golden"] = (gold_q, gold_cfg, None)
    # Phase 13's fold query: tests/test_torch_replay.py's kind at K = 2048.
    fold_keys = [f"k{i}" for i in range(skip_any.FLAGSHIP_KEYS)]
    fold_pattern, fold_streams = branchy_case(65, fold_keys)
    fold_q = P.compile_query(P.compile_pattern(fold_pattern), None)
    fold_cfg = P.EngineConfig(lanes=256, nodes=4096, matches=2048, matches_per_step=256)
    builds["branchy_fold"] = (fold_q, fold_cfg, None)
    def timed_build(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t

    t0 = time.perf_counter()
    natives = ("packer", "decoder", "crc32c")
    with ThreadPoolExecutor(max_workers=len(builds) + len(natives)) as ex:
        futs = {n: ex.submit(timed_build, sk.build_library, q, c)
                for n, (q, c, _) in builds.items()}
        nat_futs = {n: ex.submit(timed_build, native.build_ext, n) for n in natives}
        gc_fut = ex.submit(timed_build, gk.build_library)
        kernel_builds = {n: f.result() for n, f in futs.items()}
        nat_builds = {n: f.result() for n, f in nat_futs.items()}
        gc_path, gc_build_s = gc_fut.result()
    libs = {n: path for n, (path, _sec) in kernel_builds.items()}
    build_s = time.perf_counter() - t0
    log(f"built {len(libs)} step kernels, the GC mark kernel and the native packer, "
        f"decoder and CRC-32C in {build_s:.1f}s (nvcc and g++, in parallel); nvcc seconds "
        f"of the flagship {kernel_builds['skip_any8'][1]:.1f}, of its grown shape (lanes "
        f"640, nodes 16384) {kernel_builds['skip_any8_grown'][1]:.1f} and of gc_mark "
        f"{gc_build_s:.1f}; g++ seconds: " + ", ".join(
            f"{n} {sec:.2f} ({path.name})" for n, (path, sec) in nat_builds.items())
        + f"; Python headers: {native.python_include()}")
    for name, path in (("skip_any8", libs["skip_any8"]), ("gc_mark", gc_path)):
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas[{name}]: {line.strip()}")
    gc_lib = gk.load_library(gc_path)
    flag_lib = sk.load_library(libs["skip_any8"])
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    err = flag_lib.nfa_step_occupancy(ctypes.byref(blocks), ctypes.byref(threads))
    if err:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    log(f"occupancy[skip_any8]: {blocks.value} block(s) of {threads.value} threads per SM, "
        f"{blocks.value * threads.value // 32} warps (keys) per SM, "
        f"{blocks.value * threads.value // 32 * torch.cuda.get_device_properties(0).multi_processor_count}"
        f" keys resident on the card")

    # -- 3. kernel == plain step on the card ----------------------------------
    def compare(name, q, cfg, states_xs):
        """Kernel == plain step on every (state, xs); returns the largest
        |difference| (0 when equal) and the most live lanes a key holds
        after any of the steps."""
        lib = sk.load_library(libs[name])
        plain = build_plain_step(q, cfg)
        worst, live = 0.0, 0
        for state, xs in states_xs:
            s1, y1 = plain(state, xs)
            s2, y2 = sk.launch(lib, q, cfg, state, xs)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_diff(s1, s2), max_abs_diff(y1, y2))
            live = max(live, int(s1["active"].sum(0).max()))
        return worst, live

    def trajectory(name, q, cfg, make_stream, K, T, n_batches, seed):
        """(state, xs) pairs along a torch-engine run (the kernel is fed
        the same state the plain step starts from at every batch)."""
        eng = P.BatchedDeviceNFA(q, keys=[f"k{i}" for i in range(K)], config=cfg,
                                 device=dev, engine="torch")
        rng = random.Random(seed)
        streams = {k: make_stream(rng, T * n_batches) for k in eng.keys}
        out = []
        for b in range(n_batches):
            xs = eng.pack({k: s[b * T:(b + 1) * T] for k, s in streams.items()})
            out.append((eng.state, xs))
            eng.advance_packed(xs)
        return out

    for name in CASES:
        q, cfg, stream = builds[name]
        compare(name, q, cfg, trajectory(name, q, cfg, stream, 8, 10, 3, 5))
        log(f"kernel == plain on the card: {name} (K=8, T=10, 3 batches)")
    chunked_pairs = {}
    for name in CHUNKED:
        q, cfg, stream = builds[name]
        pairs = trajectory(name, q, cfg, stream, 8, CHUNKED_T, 3, CHUNKED[name][3])
        chunked_pairs[name] = pairs
        _, live = compare(name, q, cfg, pairs)
        log(f"kernel == plain on the card: {name} (K=8, T={CHUNKED_T}, 3 batches; "
            f"up to {live} of {cfg.lanes} live lanes in a key at a batch end)")
    # An entry state whose live lanes are not a prefix, run ids shared
    # across chunks in its fullest key; a key whose events are all padding.
    q, cfg, _ = builds["stock_lanes64"]
    state, xs = chunked_pairs["stock_lanes64"][1]
    k = int(state["active"].sum(0).argmax())
    live = torch.nonzero(state["active"][:, k]).flatten()
    state = {n: v.clone() for n, v in state.items()}
    state["seq"][live[32:], k] = state["seq"][live[: len(live) - 32], k]
    compare("stock_lanes64", q, cfg, [(scatter_live_lanes(state, 11), xs)])
    q, cfg, _ = builds["skip_any8_lanes96"]
    state, xs = chunked_pairs["skip_any8_lanes96"][1]
    xs = dict(xs, valid=xs["valid"].clone())
    xs["valid"][:, 3] = False
    compare("skip_any8_lanes96", q, cfg, [(scatter_live_lanes(state, 12), xs)])
    log("kernel == plain on the card: an entry state that is not a prefix, an all-padding key")
    del chunked_pairs

    K, T = skip_any.FLAGSHIP_KEYS, skip_any.FLAGSHIP_T
    flag_pairs = trajectory("skip_any8", flag_q, flag_cfg, skip_any.skip_any8_stream, K, T, 3, 7)
    max_err, _ = compare("skip_any8", flag_q, flag_cfg, flag_pairs)
    log(f"kernel == plain on the card: skip_any8 (K={K}, T={T}, 3 batches)")

    # Live lanes per key and event at the flagship shape: the plain step
    # one event at a time over the 3 batches, read before each valid event.
    plain = build_plain_step(flag_q, flag_cfg)
    per_event = []
    for state, xs in flag_pairs:
        for t in range(T):
            xs_t = {n: v[t:t + 1] for n, v in xs.items()}
            per_event.append(state["active"].sum(0)[xs_t["valid"][0]])
            state, _ = plain(state, xs_t)
    per_event = torch.cat(per_event)
    log(f"live lanes per key and event (K={K}, batches 1-3, {per_event.numel()} key-events): "
        f"{spread(per_event)}; chunks of 32 walked per key-event: mean "
        f"{float(((per_event + 31) // 32).double().mean()):.3f} of {(flag_cfg.lanes + 31) // 32}")

    # Times at the flagship shape, on the third batch's (state, xs).
    lib = flag_lib
    words = int(lib.nfa_step_scratch_words())
    state, xs = flag_pairs[-1]
    ptrs, T_, K_, s_out, ys, _keep = sk.prepare(flag_q, flag_cfg, state, xs, words)
    kernel_ms = cuda_ms(lambda: sk.call(lib, ptrs, T_, K_, dev), reps=20)
    plain_ms = cuda_ms(lambda: plain(state, xs), reps=2)
    scratch = _keep[2]
    moved = bytes_moved(state, s_out, ys, _keep)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"nfa_step at K={K} T={T}, third batch: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bytes moved {moved} -> bound {bound_ms:.4f} ms "
        f"({bound_ms / kernel_ms:.1%} of it); scratch {scratch.numel() * 4} B")
    del flag_pairs, state, xs, s_out, ys, _keep, scratch, per_event

    # -- 4. the main path: BatchedDeviceNFA(engine="cuda") at K=2048, T=64 ----
    n_warm, n_timed = 2, 8
    n_batches = n_warm + n_timed

    def flagship_streams(keys):
        rng = random.Random(7)
        return {k: skip_any.skip_any8_stream(rng, T * n_batches) for k in keys}

    def seqs_json(out):
        return {k: [P.sequence_to_json(s) for s in v] for k, v in out.items()}

    def flagship_run(engine: str, check_host: bool = False):
        """The flagship through `BatchedDeviceNFA`. check_host: every pack
        must take the native route; batches 1-3's columns are held to a
        Python-pack engine's (same keys, its own compiled query), every
        drained table's native decode to the Python walk's, outside the
        timed phases."""
        eng = P.BatchedDeviceNFA(flag_q, keys=[f"k{i}" for i in range(K)],
                                 config=flag_cfg, device=dev, engine=engine)
        streams = flagship_streams(eng.keys)
        py_pack = None
        if check_host:
            py_q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
            py_pack = P.BatchedDeviceNFA(py_q, keys=eng.keys, config=flag_cfg, device=dev,
                                         engine=engine, native=False)
        decode_checks, excluded = [0], [0.0]
        matches, lanes_peak, nodes_peak, live_ends, last = {}, 0, 0, [], None
        pack_s = adv_s = drain_s = 0.0
        # Per-phase host walls (each phase ends in a synchronize), summed
        # over the timed batches.
        phases = {"step": 0.0, "append": 0.0, "flush": 0.0, "probe+flatten+D2H": 0.0,
                  "decode": 0.0}
        timing = [False]

        def timed(name, fn):
            def run(*args):
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                if timing[0]:
                    phases[name] += time.perf_counter() - t
                return out
            return run

        eng._advance = timed("step", eng._advance)
        eng._append = timed("append", eng._append)
        eng._flush = timed("flush", eng._flush)
        eng._pull_raw_flat = timed("probe+flatten+D2H", eng._pull_raw_flat)
        decode = timed("decode", eng._decode_flat)

        def decode_and_check(raw, trigger="drain"):
            out = decode(raw, trigger)
            if check_host:
                t = time.perf_counter()
                clock_on, gc_clock.on = gc_clock.on, False
                counts = raw["counts"].astype("int32")
                planes = [raw["table"][i].transpose(2, 0, 1) for i in range(3)]
                ref = eng._decode_flat_python(counts, *planes)
                if seqs_json(out) != seqs_json(ref):
                    raise AssertionError("native decode != Python decode of a drained table")
                decode_checks[0] += 1
                gc_clock.on = clock_on
                excluded[0] += time.perf_counter() - t
            return out

        eng._decode_flat = decode_and_check
        torch.cuda.synchronize()
        gc_clock = GcClock()
        sk.NfaStep.launches = gk.GcMark.launches = 0
        with gc_clock:
            for b in range(n_batches):
                gc_clock.on = timing[0] = b >= n_warm
                batch = {k: s[b * T:(b + 1) * T] for k, s in streams.items()}
                t0 = time.perf_counter()
                xs = eng.pack(batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if check_host and eng.pack_route != "native":
                    raise AssertionError(f"batch {b} packed by the {eng.pack_route} route")
                if b == n_batches - 1:
                    last = (eng.state, xs)
                eng.advance_packed(xs, decode=False)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                excluded[0] = 0.0
                out = eng.drain()
                t3 = time.perf_counter() - excluded[0]
                gc_clock.on = False
                if b >= n_warm:
                    pack_s += t1 - t0
                    adv_s += t2 - t1
                    drain_s += t3 - t2
                if py_pack is not None and b < 3:
                    ref_xs = py_pack.pack(batch)
                    if py_pack.pack_route != "python":
                        raise AssertionError("the reference pack did not take the Python route")
                    bad = [n for n in xs if xs[n].dtype != ref_xs[n].dtype
                           or not torch.equal(xs[n], ref_xs[n])]
                    if bad or set(xs) != set(ref_xs) or eng._next_gidx != py_pack._next_gidx:
                        raise AssertionError(f"native pack != Python pack on batch {b}: {bad}")
                    if b == 2:
                        py_pack = None
                for key, seqs in out.items():
                    matches.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
                live_ends.append(eng.state["active"].sum(0))
                lanes_peak = max(lanes_peak, int(live_ends[-1].max()))
                nodes_peak = max(nodes_peak, int(eng.pool["node_count"].max()))
        launches, gc_launches = sk.NfaStep.launches, gk.GcMark.launches
        if check_host and decode_checks[0] != n_batches:
            raise AssertionError(f"{decode_checks[0]} decode checks for {n_batches} drains")
        return dict(eng=eng, matches=matches, adv_s=adv_s, drain_s=drain_s,
                    pack_s=pack_s, launches=launches, gc_launches=gc_launches,
                    lanes_peak=lanes_peak,
                    nodes_peak=nodes_peak, phases=phases, live_ends=torch.cat(live_ends),
                    last=last, gc=gc_clock)

    torch.cuda.reset_peak_memory_stats()
    run = flagship_run("cuda", check_host=True)
    peak_mem = torch.cuda.max_memory_allocated()
    eng = run["eng"]
    stats = eng.stats
    n_match = sum(len(v) for v in run["matches"].values())
    events = n_timed * T * K
    eps = events / (run["adv_s"] + run["drain_s"])
    e2e_eps = events / (run["pack_s"] + run["adv_s"] + run["drain_s"])
    log(f"main path: {events} events in {n_timed} timed batches: {e2e_eps:.0f} events/s "
        f"end to end (pack + advance + drain), {eps:.0f} events/s advance + drain; "
        f"ms per batch: pack {run['pack_s'] / n_timed * 1e3:.2f}, advance "
        f"{run['adv_s'] / n_timed * 1e3:.2f}, drain {run['drain_s'] / n_timed * 1e3:.2f}; "
        f"max_memory_allocated {peak_mem} B")
    log("main path breakdown, ms per timed batch: " + ", ".join(
        [f"pack {run['pack_s'] / n_timed * 1e3:.2f}"]
        + [f"{k} {v / n_timed * 1e3:.2f}" for k, v in run["phases"].items()])
        + "; " + run["gc"].summary(n_timed))
    log(f"main path: every pack native; batches 1-3 native pack == Python pack (every "
        f"column bitwise); native decode == Python decode on all {n_batches} drained tables")
    log(f"main path: {n_match} matches, stats {stats}, lanes peak "
        f"{run['lanes_peak']}/{flag_cfg.lanes}, node_count peak "
        f"{run['nodes_peak']}/{flag_cfg.nodes}, nfa_step launches {run['launches']}, "
        f"gc_mark launches {run['gc_launches']} ({run['eng'].flushes} group flushes)")
    log(f"main path: live lanes per key at the {n_batches} batch ends: {spread(run['live_ends'])}")
    if run["launches"] != n_batches:
        raise AssertionError(f"nfa_step launched {run['launches']} times for {n_batches} advances")
    # pin_interval: one walk (the lane walk) per group flush.
    if run["gc_launches"] != run["eng"].flushes or run["gc_launches"] == 0:
        raise AssertionError(f"gc_mark launched {run['gc_launches']} times for "
                             f"{run['eng'].flushes} flushes")
    drops = {k: stats[k] for k in DROP_COUNTER_KEYS}
    if any(drops.values()):
        raise AssertionError(f"drop counters are not 0: {drops}")
    if n_match == 0:
        raise AssertionError("the flagship run produced no matches")
    ref = flagship_run("torch")
    for name in eng.state:
        if not torch.equal(eng.state[name], ref["eng"].state[name]):
            raise AssertionError(f"final state[{name}] differs from engine='torch'")
    for name in eng.pool:
        if not torch.equal(eng.pool[name], ref["eng"].pool[name]):
            raise AssertionError(f"final pool[{name}] differs from engine='torch'")
    for key in eng.keys[:64]:
        if run["matches"].get(key, []) != ref["matches"].get(key, []):
            raise AssertionError(f"matches of {key} differ from engine='torch'")
    log(f"main path == engine='torch' run: final state, pool, first 64 keys' matches "
        f"(torch engine: advance {ref['adv_s'] / n_timed * 1e3:.1f} ms/batch)")
    del ref
    ptrs, T_, K_, _s, _y, _keep = sk.prepare(flag_q, flag_cfg, *run["last"], words)
    last_ms = cuda_ms(lambda: sk.call(lib, ptrs, T_, K_, dev), reps=20)
    log(f"nfa_step at K={K} T={T}, last ({n_batches}th) batch: kernel {last_ms:.4f} ms")
    del run["last"], _s, _y, _keep, eng
    # Phase 4's matches: the reference of phases 8-10.
    engine_matches = run.pop("matches")
    del run["eng"]

    # -- 5. the flagship through the runtime="cuda" topology ------------------
    def topology_run(sink_format: str):
        """The flagship deployment through `Topology.process`, one record at
        a time: each batch's 131,072 records in time order across keys,
        the last one filling the micro-batch and flushing it. Per timed
        flush: enqueue (the process() calls before the flushing one), the
        processor's lane map and batch (its flush minus the engine), pack
        (host pack and upload), advance (the engine's advance without its
        drain), drain + decode, and emit (the flushing process() call minus
        the flush: gate and sink)."""
        sink_log = P.RecordLog()
        builder = P.ComplexStreamsBuilder(log=sink_log)
        out = builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda",
            config=P.EngineConfig(**skip_any.FLAGSHIP_CONFIG), batch_size=K * T,
            initial_keys=K, sink_format=sink_format,
        ).to("matches")
        topo = builder.build()
        proc = out.node.processor
        teng = proc.engine
        walls = {"enqueue": 0.0, "lanes+batch": 0.0, "pack": 0.0, "advance": 0.0,
                 "drain+decode": 0.0, "emit": 0.0}
        inner = {"flush": 0.0, "pack": 0.0, "advance_packed": 0.0, "drain": 0.0}

        def timed(name, fn):
            def run_(*args, **kw):
                t = time.perf_counter()
                result = fn(*args, **kw)
                torch.cuda.synchronize()
                inner[name] += time.perf_counter() - t
                return result
            return run_

        proc.flush = timed("flush", proc.flush)
        teng.pack_host = timed("pack", teng.pack_host)
        teng.upload = timed("pack", teng.upload)
        teng.advance_packed = timed("advance_packed", teng.advance_packed)
        teng.drain = timed("drain", teng.drain)
        keys = [f"k{i}" for i in range(K)]
        streams = flagship_streams(keys)
        process = topo.process
        routes = set()
        timed_s = 0.0
        torch.cuda.synchronize()
        gc_clock = GcClock()
        sk.NfaStep.launches = gk.GcMark.launches = 0
        with gc_clock:
            for b in range(n_batches):
                order = [(k, streams[k][b * T + t]) for t in range(T) for k in keys]
                for name in inner:
                    inner[name] = 0.0
                gc_clock.on = b >= n_warm
                t0 = time.perf_counter()
                for key, e in order[:-1]:
                    process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)
                t1 = time.perf_counter()
                key, e = order[-1]
                process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)
                t2 = time.perf_counter()
                gc_clock.on = False
                routes.add(teng.pack_route)
                if b >= n_warm:
                    timed_s += t2 - t0
                    walls["enqueue"] += t1 - t0
                    walls["lanes+batch"] += (inner["flush"] - inner["pack"]
                                             - inner["advance_packed"])
                    walls["pack"] += inner["pack"]
                    walls["advance"] += inner["advance_packed"] - inner["drain"]
                    walls["drain+decode"] += inner["drain"]
                    walls["emit"] += (t2 - t1) - inner["flush"]
        launches, gc_launches = sk.NfaStep.launches, gk.GcMark.launches
        return dict(out=out, log=sink_log, proc=proc, walls=walls, timed_s=timed_s,
                    launches=launches, gc_launches=gc_launches, routes=routes, gc=gc_clock)

    def check_topology(res, label):
        out, proc = res["out"], res["proc"]
        n_records = n_timed * K * T
        res["rps"] = n_records / res["timed_s"]
        log(f"topology[{label}]: {n_records / res['timed_s']:.0f} records/s end to end over "
            f"{n_timed} timed flushes of {K * T} records; ms per flush: " + ", ".join(
                f"{k} {v / n_timed * 1e3:.2f}" for k, v in res["walls"].items())
            + "; " + res["gc"].summary(n_timed))
        if res["routes"] != {"native"}:
            raise AssertionError(f"topology packs took the routes {res['routes']}")
        if proc._flushes != n_batches or res["launches"] != n_batches:
            raise AssertionError(f"{res['launches']} nfa_step launches for {proc._flushes} "
                                 f"flushes ({n_batches} expected)")
        if res["gc_launches"] != proc.engine.flushes or res["gc_launches"] == 0:
            raise AssertionError(f"{res['gc_launches']} gc_mark launches for "
                                 f"{proc.engine.flushes} group flushes")
        tstats = proc.stats
        drops = {k: tstats[k] for k in DROP_COUNTER_KEYS}
        if any(drops.values()):
            raise AssertionError(f"topology drop counters are not 0: {drops}")
        n_sink = res["log"].end_offset("matches")
        if n_sink != len(out.records):
            raise AssertionError(f"sink holds {n_sink} records for {len(out.records)} matches")
        log(f"topology[{label}]: {len(out.records)} matches, {n_sink} sink records, "
            f"{res['launches']} nfa_step launches for {proc._flushes} flushes, "
            f"{res['gc_launches']} gc_mark launches, drops {drops}")

    topo_obj = topology_run("objects")
    check_topology(topo_obj, "objects")
    by_key = {}
    for r in topo_obj["out"].records:
        by_key.setdefault(r.key, []).append(P.sequence_to_json(r.value))
    if by_key != engine_matches:
        bad = [k for k in set(by_key) | set(engine_matches)
               if by_key.get(k) != engine_matches.get(k)]
        raise AssertionError(f"topology matches differ from the engine run on {len(bad)} keys")
    topo_launches = topo_obj["launches"]
    topo_rps = topo_obj["rps"]
    topo_gc_launches = topo_obj["gc_launches"]
    obj_rows = [(r.key, P.sequence_to_json(r.value).encode("utf-8"))
                for r in topo_obj["out"].records]
    # Phase 5's sink: the reference of phase 11.
    obj_sink = [(r.key, r.value) for r in topo_obj["log"].read("matches")]
    del topo_obj, by_key
    topo_json = topology_run("json")
    check_topology(topo_json, "json")
    json_rows = [(r.key, r.value.payload) for r in topo_json["out"].records]
    if not all(isinstance(r.value, P.SinkMatch) for r in topo_json["out"].records):
        raise AssertionError("the json topology emitted objects")
    if json_rows != obj_rows:
        raise AssertionError("json sink payloads differ from the objects run's JSON bytes")
    log(f"topology: matches per key == the engine run's; {len(json_rows)} json payloads == "
        "the objects run's sequence_to_json bytes")
    del topo_json, obj_rows, json_rows

    # -- 6. stock golden through the kernel -----------------------------------
    gold = P.BatchedDeviceNFA(gold_q, keys=["s1", "s2"], config=gold_cfg, device=dev,
                              engine="cuda")
    got = {"s1": [], "s2": []}
    for i, e in enumerate(GOLDEN_EVENTS):
        ev = P.Event("K", dict(e), 1_000_000 + i, "Stocks", 0, i)
        out = gold.advance({"s1": [ev], "s2": [ev]})
        for key, seqs in out.items():
            got[key].extend(P.sequence_to_json(s) for s in seqs)
    for key in got:
        if got[key] != GOLDEN_MATCHES:
            raise AssertionError(f"stock golden on {key}: {got[key]}")
    log("stock golden through engine='cuda': 4 matches on each of 2 keys")

    # -- 7. stock golden through a runtime="cuda" topology --------------------
    builder = P.ComplexStreamsBuilder()
    gold_out = builder.stream("stock-events").query(
        "Stocks", stocks_pattern(), P.Queried(schema=P.EventSchema(STOCK_FIELDS)),
        runtime="cuda", batch_size=3, config=gold_cfg)
    gold_topo = builder.build()
    for i, e in enumerate(GOLDEN_EVENTS):
        gold_topo.process("stock-events", "K1", e, timestamp=i)
    gold_topo.flush()
    got = [P.sequence_to_json(r.value) for r in gold_out.records]
    if got != GOLDEN_MATCHES:
        raise AssertionError(f"stock golden through runtime='cuda': {got}")
    log("stock golden through a runtime='cuda' topology (batch_size 3): 4 matches")

    keys = [f"k{i}" for i in range(K)]
    streams = flagship_streams(keys)

    def batch_of(b):
        return {k: s[b * T:(b + 1) * T] for k, s in streams.items()}

    def new_engine(cfg=flag_cfg, **kw):
        return P.BatchedDeviceNFA(flag_q, keys=keys, config=cfg, device=dev, engine="cuda", **kw)

    def run_batches(eng, lo, hi, out):
        """Batches lo..hi-1, each packed, advanced and drained in turn;
        the matches as JSON into out per key."""
        for b in range(lo, hi):
            eng.advance_packed(eng.pack(batch_of(b)), decode=False)
            for key, seqs in eng.drain().items():
                out.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)

    def same_engine(label, a, b):
        for what in ("state", "pool"):
            ta, tb = getattr(a, what), getattr(b, what)
            bad = [n for n in ta if not torch.equal(ta[n], tb[n])]
            if bad or set(ta) != set(tb):
                raise AssertionError(f"{label}: {what} differs in {bad}")

    def no_drops(label, eng):
        drops = {k: eng.stats[k] for k in DROP_COUNTER_KEYS}
        if any(drops.values()):
            raise AssertionError(f"{label}: drop counters are not 0: {drops}")

    def launched(label, n):
        if n <= 0:
            raise AssertionError(f"{label}: nfa_step was not launched")
        return n

    # -- 8. checkpoint: snapshot after batch 5, restore, batches 6-10 ---------
    from kafkastreams_cep_tpu_torch.state import serde

    sk.NfaStep.launches = 0
    unint, m_unint = new_engine(), {}
    run_batches(unint, 0, 5, m_unint)
    crc_s = [0.0]
    crc_native = serde.crc32c

    def timed_crc(data, crc=0):
        t = time.perf_counter()
        out = crc_native(data, crc)
        crc_s[0] += time.perf_counter() - t
        return out

    serde.crc32c = timed_crc
    try:
        t0 = time.perf_counter()
        arrays = unint._snapshot_arrays()
        t1 = time.perf_counter()
        blob = unint._encode_snapshot(arrays)
        t2 = time.perf_counter()
        snap_crc_s, crc_s[0] = crc_s[0], 0.0
        restored = P.BatchedDeviceNFA.restore(flag_q, blob, config=flag_cfg, device=dev,
                                              engine="cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        restore_crc_s = crc_s[0]
    finally:
        serde.crc32c = crc_native
    del arrays
    m_rest = {k: list(v) for k, v in m_unint.items()}
    run_batches(unint, 5, n_batches, m_unint)
    run_batches(restored, 5, n_batches, m_rest)
    ckpt_launches = launched("checkpoint", sk.NfaStep.launches)
    same_engine("restored engine vs uninterrupted", restored, unint)
    if m_rest != m_unint:
        raise AssertionError("the restored engine's matches differ from the uninterrupted run's")
    if m_unint != engine_matches:
        raise AssertionError("phase 8's matches differ from phase 4's")
    no_drops("checkpoint", restored)
    snapshot_bytes = len(blob)
    snapshot_ms = (t2 - t0) * 1e3
    restore_ms = (t3 - t2) * 1e3
    log(f"checkpoint: snapshot {snapshot_bytes} B in {snapshot_ms:.1f} ms (flush + D2H "
        f"{(t1 - t0) * 1e3:.1f}, encode {(t2 - t1 - snap_crc_s) * 1e3:.1f}, CRC-32C "
        f"{snap_crc_s * 1e3:.1f}); restore {restore_ms:.1f} ms (of which CRC-32C "
        f"{restore_crc_s * 1e3:.1f}); CRC-32C hardware {serde._crc_mod.hardware()}; "
        f"restored == uninterrupted after batches 6-10: state, pool and all {K} keys' "
        f"matches bitwise ({sum(map(len, m_rest.values()))}, == phase 4's); "
        f"nfa_step launches {ckpt_launches}")
    del restored, m_rest, blob

    # -- 9. resize: grow after batch 5, shrink back after batch 7 -------------
    sk.NfaStep.launches = 0
    rs, m_rs = new_engine(), {}
    run_batches(rs, 0, 5, m_rs)
    t0 = time.perf_counter()
    if not rs.resize(grown_cfg):
        raise AssertionError("resize to the grown shape did nothing")
    torch.cuda.synchronize()
    grow_ms = (time.perf_counter() - t0) * 1e3
    xs5 = rs.pack(batch_of(5))
    grown_lib = sk.load_library(libs["skip_any8_grown"])
    plain_g = build_plain_step(flag_q, grown_cfg)
    s1, y1 = plain_g(rs.state, xs5)
    s2, y2 = sk.launch(grown_lib, flag_q, grown_cfg, rs.state, xs5)
    torch.cuda.synchronize()
    grown_err = max(max_abs_diff(s1, s2), max_abs_diff(y1, y2))
    del s1, y1, s2, y2
    ptrs, T_, K_, s_out, ys, keep = sk.prepare(flag_q, grown_cfg, rs.state, xs5,
                                               int(grown_lib.nfa_step_scratch_words()))
    grown_ms = cuda_ms(lambda: sk.call(grown_lib, ptrs, T_, K_, dev), reps=20)
    grown_plain_ms = cuda_ms(lambda: plain_g(rs.state, xs5), reps=1)
    grown_moved = bytes_moved(rs.state, s_out, ys, keep)
    grown_bound_ms = grown_moved / HBM_BYTES_PER_S * 1e3
    del ptrs, s_out, ys, keep, plain_g
    before = sk.NfaStep.launches
    rs.advance_packed(xs5, decode=False)
    for key, seqs in rs.drain().items():
        m_rs.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
    run_batches(rs, 6, 7, m_rs)
    grown_launches = sk.NfaStep.launches - before
    lanes_grown = int(rs.state["active"].sum(0).max())
    t0 = time.perf_counter()
    if not rs.resize(flag_cfg):
        raise AssertionError("the shrink back did nothing")
    torch.cuda.synchronize()
    shrink_ms = (time.perf_counter() - t0) * 1e3
    run_batches(rs, 7, n_batches, m_rs)
    resize_launches = launched("resize", sk.NfaStep.launches)
    try:
        rs.resize(replace(flag_cfg, lanes=8))
    except serde.ShapeRestoreError as exc:
        refused = str(exc)
    else:
        raise AssertionError("a shrink to 8 lanes below the live lanes was not refused")
    if rs.config != flag_cfg or rs.state["active"].shape[0] != flag_cfg.lanes:
        raise AssertionError("the refused shrink changed the engine")
    if m_rs != m_unint:
        raise AssertionError("the resized run's matches differ from the uninterrupted run's")
    same_engine("resized engine vs uninterrupted", rs, unint)
    no_drops("resize", rs)
    log(f"resize: grow to lanes 640, nodes 16384 in {grow_ms:.1f} ms, shrink back in "
        f"{shrink_ms:.1f} ms (kernel built for the grown shape in "
        f"{kernel_builds['skip_any8_grown'][1]:.1f}s, with the other builds); "
        f"up to {lanes_grown} live lanes at the grown shape; matches, state and pool == "
        f"the uninterrupted run; shrink to 8 lanes refused ({refused[:90]}...); nfa_step "
        f"launches {resize_launches}, {grown_launches} at the grown shape")
    log(f"nfa_step at the grown shape (lanes 640, nodes 16384), batch 6's inputs: kernel == "
        f"plain bitwise, kernel {grown_ms:.4f} ms, plain {grown_plain_ms:.3f} ms, bytes moved "
        f"{grown_moved} -> bound {grown_bound_ms:.4f} ms ({grown_bound_ms / grown_ms:.1%} of it)")
    del rs, m_rs, unint, m_unint, xs5

    # -- 10. overflow policies on deferred decode -----------------------------
    def deferred_run(eng):
        """All batches deferred, one drain at the end; seconds of the timed
        batches (pack + advance + engine-initiated drains) and the drain."""
        t0 = None
        for b in range(n_batches):
            if b == n_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            eng.advance_packed(eng.pack(batch_of(b)), decode=False)
        out = eng.drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return {k: [P.sequence_to_json(s) for s in v] for k, v in out.items()}, secs

    sk.NfaStep.launches = 0
    ad = new_engine()
    m_ad, ad_s = deferred_run(ad)
    ad_launches = launched("auto_drain", sk.NfaStep.launches)
    ring_full = int(ad.metrics.get("cep_auto_drains_total").labels(trigger="ring_full").value)
    no_drops("auto_drain", ad)
    if m_ad != engine_matches:
        raise AssertionError("auto_drain: matches differ from phase 4's")
    if ring_full == 0:
        raise AssertionError("auto_drain: no ring-full drain on a ring of one page")
    ad_eps = n_timed * T * K / ad_s
    del ad, m_ad
    sk.NfaStep.launches = 0
    blk = new_engine(replace(flag_cfg, on_overflow="block"), auto_drain=False)
    m_blk, _blk_s = deferred_run(blk)
    blk_launches = launched("block", sk.NfaStep.launches)
    backpressure = int(blk.metrics.get("cep_overflow_backpressure_total").value)
    no_drops("block", blk)
    if m_blk != engine_matches:
        raise AssertionError("block: matches differ from phase 4's")
    if backpressure == 0:
        raise AssertionError("block: no backpressure on a ring of one page")
    del blk, m_blk
    from kafkastreams_cep_tpu_torch.streams.errors import CEPOverflowError

    busiest = max(map(len, engine_matches.values()))
    small_ring = 16
    sk.NfaStep.launches = 0
    rz = new_engine(replace(flag_cfg, on_overflow="raise", matches=small_ring))
    try:
        deferred_run(rz)
    except CEPOverflowError as exc:
        raised = exc
    else:
        raise AssertionError("raise: no CEPOverflowError on an overflowing ring")
    rz_launches = launched("raise", sk.NfaStep.launches)
    n_raised = sum(map(len, raised.matches.values()))
    if n_raised == 0:
        raise AssertionError("raise: the CEPOverflowError carries no drained matches")
    rz_drops = rz.stats["match_drops"]
    del rz, raised

    def sync_count(auto_drain: bool) -> int:
        """Host syncs over 8 deferred advances of pre-packed batches, on a
        ring of 8 pages: the probe runs, and no drain is due even by the
        guard's worst-case bound (the host runs ahead of the card, so a
        probe need not have landed by the next advance)."""
        eng = new_engine(replace(flag_cfg, matches=n_timed * flag_cfg.matches),
                         auto_drain=auto_drain)
        xs_list = [eng.pack(batch_of(b)) for b in range(n_timed)]
        torch.cuda.synchronize()

        def advances():
            for xs in xs_list:
                eng.advance_packed(xs, decode=False)

        n = count_syncs(advances)
        if auto_drain == (eng._pos_obs is None and not eng._pos_probes):
            raise AssertionError(f"occupancy probe ran: {not auto_drain}, asked: {auto_drain}")
        eng.drain()
        no_drops(f"sync count (auto_drain={auto_drain})", eng)
        return n

    syncs_probe, syncs_off = sync_count(True), sync_count(False)
    if syncs_probe or syncs_off:
        raise AssertionError(f"deferred advances synchronised the host: {syncs_probe} times "
                             f"with the occupancy probe, {syncs_off} without")
    log(f"overflow, auto_drain on: drops 0, matches == phase 4's, {ring_full} ring-full "
        f"drains, {ad_eps:.0f} events/s over the {n_timed} timed deferred batches and the "
        f"drain (pack included; phase 4 drains every batch); nfa_step launches {ad_launches}")
    log(f"overflow, on_overflow='block', auto_drain off: drops 0, matches == phase 4's, "
        f"backpressure {backpressure}; nfa_step launches {blk_launches}")
    log(f"overflow, on_overflow='raise', matches {small_ring} (busiest key: {busiest} matches "
        f"over the run): CEPOverflowError at the drain with {n_raised} drained matches, "
        f"match_drops {rz_drops}; nfa_step launches {rz_launches}")
    log(f"host syncs over {n_timed} deferred advances (set_sync_debug_mode): "
        f"{syncs_probe} with the occupancy probe, {syncs_off} without")

    # -- 11. crash recovery through the topology ------------------------------
    per_flush = K * T
    order = [(k, streams[k][b * T + t]) for b in range(n_batches) for t in range(T)
             for k in keys]
    crash_at = 7 * per_flush + per_flush // 2
    ds_topic = "app-skip_any8-streamscep-devicestate-changelog"

    def topo_on(log_):
        builder = P.ComplexStreamsBuilder(log=log_)
        out = builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda", config=flag_cfg,
            batch_size=per_flush, initial_keys=K,
        ).to("matches")
        return builder, builder.build(), out

    def feed(topo, recs):
        process = topo.process
        for key, e in recs:
            process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)

    sk.NfaStep.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_log_") as tmp:
        rlog = P.RecordLog(tmp)
        builder, topo, _out = topo_on(rlog)
        committed, commit_ms, commit_bytes = 0, [], []
        for n_done in (3 * per_flush, 6 * per_flush):
            feed(topo, order[committed:n_done])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            topo.flush_stores()
            rlog.flush()
            commit_ms.append((time.perf_counter() - t0) * 1e3)
            commit_bytes.append(len(rlog.read(ds_topic)[-1].value))
            committed = n_done
        feed(topo, order[committed:crash_at])
        rlog.close()
        del builder, topo, _out, rlog
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rlog = P.RecordLog(tmp)
        t1 = time.perf_counter()
        builder, topo, out = topo_on(rlog)
        n_restored = topo.restore_stores()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        feed(topo, order[committed:crash_at])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        feed(topo, order[crash_at:])
        topo.flush()
        crash_launches = launched("crash recovery", sk.NfaStep.launches)
        no_drops("crash recovery", out.node.processor)
        sink = [(r.key, r.value) for r in rlog.read("matches")]
        rlog.close()
        del builder, topo, out, rlog
    digests = [decode_sink_key(k)[1] for k, _v in sink]
    if len(set(digests)) != len(digests):
        raise AssertionError("the recovered sink holds a match twice")
    if sink != obj_sink:
        raise AssertionError(f"the recovered sink ({len(sink)} records) differs from phase "
                             f"5's uninterrupted sink ({len(obj_sink)})")
    log(f"crash recovery: commits after flushes 3 and 6 of {per_flush} records: "
        f"{commit_bytes} B of processor snapshot, flush_stores {commit_ms[0]:.1f} / "
        f"{commit_ms[1]:.1f} ms (log fsync included); crash at record {crash_at}; recovery: "
        f"log reload {(t1 - t0) * 1e3:.1f} ms, restore_stores {(t2 - t1) * 1e3:.1f} ms "
        f"({n_restored} changelog records), replay of {crash_at - committed} records to the "
        f"crash point {(t3 - t2) * 1e3:.1f} ms; time to recover {(t3 - t0) * 1e3:.1f} ms; "
        f"sink == phase 5's: {len(sink)} matches, each once; nfa_step launches "
        f"{crash_launches}")
    del obj_sink, sink, order

    # -- 12. the GC mark kernel against the plain walk ------------------------
    def capture_flushes(cfg, at, n):
        """The inputs of the group flushes numbered in `at` (1-based) of an
        engine run of n drained batches; the run itself goes on as usual."""
        eng = new_engine(cfg)
        flush, count, captured = eng._flush, [0], {}

        def capture(state, pool, ys, roots):
            count[0] += 1
            if count[0] in at:
                captured[count[0]] = (state, pool, ys, roots)
            return flush(state, pool, ys, roots)

        eng._flush = capture
        run_batches(eng, 0, n, {})
        return flush, captured

    def marks_of(flush, inputs):
        """The (seed, frontier, pred) of every mark one flush asks for."""
        calls, real = [], engine_mod.gc_mark

        def record(m, f, p):
            calls.append((m, f.contiguous(), p))
            return real(m, f, p)

        engine_mod.gc_mark = record
        try:
            flush(*inputs)
        finally:
            engine_mod.gc_mark = real
        return calls

    def plain_walk_flush(flush, inputs):
        engine_mod.gc_mark = gk._walk
        try:
            return flush(*inputs)
        finally:
            engine_mod.gc_mark = gk.gc_mark

    mark_rows, flush_rows, gc_err = [], [], 0.0
    page_cfg = replace(flag_cfg, pin_interval=False)
    for label, cfg, at, n in (("pin_interval", flag_cfg, (3, 10), n_batches),
                              ("pin_interval=False", page_cfg, (3,), 3)):
        flush, captured = capture_flushes(cfg, at, n)
        for b in at:
            inputs = captured[b]
            walks = marks_of(flush, inputs)
            names = ["lane"] if cfg.pin_interval else ["page", "lane"]
            for name, (m, f, pr) in zip(names, walks):
                got = gk.launch(gc_lib, m, f, pr)
                want = gk._walk(m, f, pr)
                torch.cuda.synchronize()
                gc_err = max(gc_err, float((got.int() - want.int()).abs().max()))
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"gc_mark != _walk on {label} batch {b} {name} walk: "
                                         f"{bad} marks differ")
                BW, Kk = pr.shape
                newly = int((got[:BW] & ~m[:BW]).sum())
                moved = 2 * m.numel() + f.numel() * 4 + newly * 4
                ms = cuda_ms(lambda: gk.launch(gc_lib, m, f, pr), reps=20)
                p_ms = cuda_ms(lambda: gk._walk(m, f, pr), reps=2)
                mark_rows.append(dict(label=label, batch=b, walk=name, BW=BW, F=f.shape[0],
                                      newly=newly, ms=ms, plain_ms=p_ms, bytes=moved,
                                      bound_ms=moved / HBM_BYTES_PER_S * 1e3))
                log(f"gc_mark == _walk bitwise ({label}, flush {b}, {name} walk, BW={BW}, "
                    f"F={f.shape[0]}, K={Kk}, {newly} newly marked): kernel {ms:.4f} ms, "
                    f"plain {p_ms:.3f} ms, bytes {moved} -> bound "
                    f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms "
                    f"({moved / HBM_BYTES_PER_S * 1e3 / ms:.1%} of it)")
            k_flush = cuda_ms(lambda: flush(*inputs), reps=5)
            p_flush = cuda_ms(lambda: plain_walk_flush(flush, inputs), reps=2)
            a = flush(*inputs)
            b_ = plain_walk_flush(flush, inputs)
            torch.cuda.synchronize()
            for tree_a, tree_b in zip(a, b_):
                if any(not torch.equal(tree_a[n], tree_b[n]) for n in tree_a):
                    raise AssertionError(f"the flush with gc_mark != with _walk ({label}, {b})")
            flush_rows.append(dict(label=label, batch=b, ms=k_flush, plain_ms=p_flush))
            log(f"group flush ({label}, flush {b}): {k_flush:.3f} ms with gc_mark, "
                f"{p_flush:.3f} ms with the plain walk; state and pool equal")
        del captured, flush
    gc_main = mark_rows[0]

    # -- 13. exact replay on a fold query at K = 2048 -------------------------
    from kafkastreams_cep_tpu_torch.nfa import NFA
    from kafkastreams_cep_tpu_torch.state.aggregates import AggregatesStore
    from kafkastreams_cep_tpu_torch.state.buffer import SharedVersionedBuffer

    fold_stages = P.compile_pattern(fold_pattern)
    per, n_fold = 5, 4

    def fold_batch(b):
        return {k: s[b * per:(b + 1) * per] for k, s in fold_streams.items()}

    def fold_engine(cfg=fold_cfg):
        return P.BatchedDeviceNFA(fold_q, keys=fold_keys, config=cfg, device=dev,
                                  engine="cuda")

    fe = fold_engine()
    if not fe.exact_replay:
        raise AssertionError("exact replay is not armed on the fold query")
    replay_s, hot_keys = [], set()
    boundary, replay_keys = fe._replay_boundary, fe._replay_keys

    def timed_boundary(out):
        t = time.perf_counter()
        res = boundary(out)
        replay_s.append(time.perf_counter() - t)
        return res

    def seen_keys(hot, out):
        hot_keys.update(fe.keys[k] for k in hot.tolist())
        return replay_keys(hot, out)

    fe._replay_boundary, fe._replay_keys = timed_boundary, seen_keys
    sk.NfaStep.launches = gk.GcMark.launches = 0
    fold_got = {}
    t0 = time.perf_counter()
    for b in range(n_fold):
        for key, seqs in fe.advance(fold_batch(b)).items():
            fold_got.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    fold_launches = launched("fold replay", sk.NfaStep.launches)
    fold_gc_launches = launched("fold replay (gc_mark)", gk.GcMark.launches)
    collisions = fe.stats["seq_collisions"]
    if fe.replays == 0:
        raise AssertionError("the fold query replayed nothing at K = 2048")
    no_drops("fold replay", fe)
    rng = random.Random(65)
    others = [k for k in fold_keys if k not in hot_keys]
    checked = sorted(hot_keys) + rng.sample(others, min(64, len(others)))
    for key in checked:
        oracle = NFA.build(fold_stages, AggregatesStore(), SharedVersionedBuffer())
        want = [P.sequence_to_json(s) for e in fold_streams[key] for s in oracle.match_pattern(e)]
        if fold_got.get(key, []) != want:
            raise AssertionError(f"fold replay: key {key} has {len(fold_got.get(key, []))} "
                                 f"matches, the oracle {len(want)}")
    n_fold_matches = sum(map(len, fold_got.values()))
    log(f"fold replay (K={len(fold_keys)}, 4 drained batches of {per} events): "
        f"{collisions} collisions, {fe.replays} replays of {len(hot_keys)} keys, replay ms "
        f"per drain {[round(x * 1e3, 2) for x in replay_s]}, {fold_s * 1e3:.1f} ms for the 4 "
        f"batches; {n_fold_matches} matches; the {len(hot_keys)} replayed keys and "
        f"{len(checked) - len(hot_keys)} sampled others == the host oracle; nfa_step "
        f"launches {fold_launches}, gc_mark launches {fold_gc_launches}")
    del fe
    # A ring for all 4 batches' worst case, so no ring-full drain is due.
    fd = fold_engine(replace(fold_cfg, matches=n_fold * per * fold_cfg.matches_per_step))
    xs_list = [fd.pack(fold_batch(b)) for b in range(n_fold)]
    torch.cuda.synchronize()

    def fold_advances():
        for xs in xs_list:
            fd.advance_packed(xs, decode=False)

    fold_syncs = count_syncs(fold_advances)
    deferred = {k: [P.sequence_to_json(s) for s in v] for k, v in fd.drain().items()}
    if fold_syncs:
        raise AssertionError(f"{fold_syncs} host syncs over {n_fold} deferred advances of "
                             "the replay-armed fold query")
    if {k: v for k, v in deferred.items() if v} != {k: v for k, v in fold_got.items() if v}:
        raise AssertionError("the deferred fold run's matches differ from the drained run's")
    log(f"fold replay, deferred: 0 host syncs over {n_fold} advances (replay armed); one "
        f"drain, {fd.replays} replays, matches == the drained run's")
    del fd, xs_list

    # -- 14. event time at the flagship ---------------------------------------
    from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry
    from kafkastreams_cep_tpu_torch.ops.engine import WM_NONE
    from kafkastreams_cep_tpu_torch.time import BoundedOutOfOrderness, MinMergeWatermark

    reorder_ms = 6
    gated_cfg = replace(flag_cfg, reorder_capacity=256, lateness_ms=reorder_ms)

    def shuffled_within_bound(events):
        """bench.py's bounded shuffle (a fresh Random(47) per stream):
        each arrival displaced by at most reorder_ms of event time."""
        sr = random.Random(47)
        order = sorted(range(len(events)),
                       key=lambda i: (events[i].timestamp + sr.randint(0, reorder_ms), i))
        return [events[i] for i in order]

    shuffled = {k: shuffled_within_bound(s) for k, s in streams.items()}

    def metric_total(reg, name):
        fam = reg.snapshot().get(name)
        return sum(v["value"] for v in fam["values"]) if fam else 0

    def gated_run(feeds, capture_flush=None):
        """The flagship through a gated runtime="cuda" topology: key k_i on
        partition i, one source of a min-merge over per-key
        BoundedOutOfOrderness(6) (every source registered first); each
        key's records numbered in arrival order and fed t-major across
        keys as in phase 5; a flush at every K*T released records and one
        at the end (flush_event_time). Returns the matches per key, the
        timed records' seconds (batches 3-10 and the end flush), the gate's
        seconds in them, the watermark lag once per round of K records and
        the (state, xs) the step got at flush `capture_flush`."""
        reg = MetricsRegistry()
        builder = P.ComplexStreamsBuilder()
        out = builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda", config=gated_cfg,
            batch_size=K * T, initial_keys=K, registry=reg,
            watermark_gen=MinMergeWatermark(per_source={
                ("letters", i): BoundedOutOfOrderness(reorder_ms) for i in range(K)}),
        )
        topo = builder.build()
        proc = out.node.processor
        gate, offer, gate_s = proc.gate, proc.gate.offer, [0.0]

        def timed_offer(event, source=None):
            t = time.perf_counter()
            res = offer(event, source)
            gate_s[0] += time.perf_counter() - t
            return res

        gate.offer = timed_offer
        captured, advance, calls = {}, proc.engine._advance, [0]

        def capture(state, xs):
            calls[0] += 1
            if calls[0] == capture_flush:
                captured["pair"] = (state, xs)
            return advance(state, xs)

        proc.engine._advance = capture
        process, lags = topo.process, []
        torch.cuda.synchronize()
        sk.NfaStep.launches = gk.GcMark.launches = 0
        for b in range(n_batches):
            if b == n_warm:
                torch.cuda.synchronize()
                gate_s[0], flushes0, t0 = 0.0, proc._flushes, time.perf_counter()
            for t in range(T):
                i_t = b * T + t
                for i, k in enumerate(keys):
                    e = feeds[k][i_t]
                    process("letters", k, e.value, timestamp=e.timestamp, partition=i,
                            offset=i_t)
                if b >= n_warm:
                    lags.append(gate.watermark_lag_ms)
        topo.flush_event_time()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, gc_launches = sk.NfaStep.launches, gk.GcMark.launches
        by_key = {}
        for r in out.records:
            by_key.setdefault(r.key, []).append(P.sequence_to_json(r.value))
        stats = proc.stats
        res = dict(matches=by_key, secs=secs, gate_s=gate_s[0], lags=lags,
                   timed_flushes=proc._flushes - flushes0, flushes=proc._flushes,
                   gc_flushes=proc.engine.flushes, launches=launches,
                   gc_launches=gc_launches, drops={k: stats[k] for k in DROP_COUNTER_KEYS},
                   late=metric_total(reg, "cep_late_dropped_total"),
                   overflow=metric_total(reg, "cep_reorder_overflow_dropped_total"),
                   occupancy=gate.occupancy, pair=captured.get("pair"))
        del out, topo, builder, proc, gate
        return res

    def check_gated(res, label):
        if res["launches"] != res["flushes"] or res["gc_launches"] != res["gc_flushes"] \
                or res["gc_launches"] == 0:
            raise AssertionError(
                f"gated[{label}]: {res['launches']} nfa_step launches for {res['flushes']} "
                f"flushes, {res['gc_launches']} gc_mark launches for {res['gc_flushes']} "
                "group flushes")
        if any(res["drops"].values()) or res["late"] or res["overflow"] or res["occupancy"]:
            raise AssertionError(f"gated[{label}]: drops {res['drops']}, late {res['late']}, "
                                 f"reorder overflow {res['overflow']}, left buffered "
                                 f"{res['occupancy']}")

    gated = gated_run(shuffled, capture_flush=3)
    check_gated(gated, "shuffled")
    gated_in_order = gated_run(streams)
    check_gated(gated_in_order, "presorted")
    if gated["matches"] != gated_in_order["matches"]:
        bad = [k for k in keys if gated["matches"].get(k) != gated_in_order["matches"].get(k)]
        raise AssertionError(f"event time: shuffled != presorted matches on {len(bad)} keys")
    if gated_in_order["matches"] != engine_matches:
        raise AssertionError("event time: the gated presorted run differs from phase 4's")
    n_gated_matches = sum(map(len, gated["matches"].values()))
    lags = torch.tensor([x for x in gated["lags"] if x is not None], dtype=torch.float64)
    rps, rps_sorted = (n_timed * K * T / r["secs"] for r in (gated, gated_in_order))
    log(f"event time (K={K}, reorder_capacity 256, lateness 6 ms, min-merge over {K} "
        f"per-key BoundedOutOfOrderness(6)): shuffled {rps:.0f} records/s, presorted "
        f"{rps_sorted:.0f}, ungated (phase 5, objects) {topo_rps:.0f}: "
        f"{(1 - rps / topo_rps) * 100:.1f} % below the ungated run; gate "
        f"{gated['gate_s'] / gated['timed_flushes'] * 1e3:.2f} ms per flush "
        f"({gated['gate_s'] / (n_timed * K * T) * 1e6:.2f} us per record) over "
        f"{gated['timed_flushes']} timed flushes; watermark lag p50 "
        f"{float(lags.quantile(0.5)):.1f} ms, p99 {float(lags.quantile(0.99)):.1f} ms, "
        f"max {float(lags.max()):.0f} ms ({lags.numel()} samples, one per round of {K} "
        f"records)")
    log(f"event time: {n_gated_matches} matches; shuffled == presorted == phase 4's per key; "
        f"late 0, reorder overflow 0, drops 0; nfa_step launches {gated['launches']} and "
        f"gc_mark launches {gated['gc_launches']} for {gated['flushes']} flushes "
        f"({gated['gc_flushes']} group flushes)")
    del gated_in_order, engine_matches

    # The step on flush 3's batch, which carries the gate's wm column; then
    # the same batch with every clock pushed up to 16 ms past its event
    # (window expiry off the watermark, the max(ts, wm) branch).
    state, xs = gated.pop("pair")
    valid = xs["valid"]
    n_wm = int((xs["wm"] != int(WM_NONE))[valid].sum())
    if n_wm != int(valid.sum()) or n_wm == 0:
        raise AssertionError(f"the gated batch carries {n_wm} clocks for "
                             f"{int(valid.sum())} events")
    plain_g = build_plain_step(flag_q, gated_cfg)
    s1, y1 = plain_g(state, xs)
    s2, y2 = sk.launch(flag_lib, flag_q, gated_cfg, state, xs)
    torch.cuda.synchronize()
    wm_err = max(max_abs_diff(s1, s2), max_abs_diff(y1, y2))
    gen = torch.Generator(device=dev).manual_seed(47)
    ahead = torch.randint(0, 17, xs["wm"].shape, generator=gen, device=dev,
                          dtype=torch.int32)
    xs_ahead = dict(xs, wm=torch.where(valid, torch.maximum(xs["wm"], xs["ts"]) + ahead,
                                       xs["wm"]))
    s3, y3 = plain_g(state, xs_ahead)
    s4, y4 = sk.launch(flag_lib, flag_q, gated_cfg, state, xs_ahead)
    torch.cuda.synchronize()
    wm_err = max(wm_err, max_abs_diff(s3, s4), max_abs_diff(y3, y4))
    expired = int(s1["n_expired"].sum() - state["n_expired"].sum())
    expired_ahead = int(s3["n_expired"].sum() - state["n_expired"].sum())
    del s1, y1, s2, y2, s3, y3, s4, y4
    ptrs, T_, K_, s_out, ys, keep = sk.prepare(flag_q, gated_cfg, state, xs, words)
    wm_ms = cuda_ms(lambda: sk.call(flag_lib, ptrs, T_, K_, dev), reps=20)
    wm_plain_ms = cuda_ms(lambda: plain_g(state, xs), reps=2)
    wm_moved = bytes_moved(state, s_out, ys, keep)
    wm_bound_ms = wm_moved / HBM_BYTES_PER_S * 1e3
    log(f"nfa_step with the gate's wm column (flush 3, T={xs['valid'].shape[0]}, K={K}, "
        f"{n_wm} clocks): kernel == plain bitwise, and with the clocks pushed ahead "
        f"(expired runs {expired} -> {expired_ahead}); kernel {wm_ms:.4f} ms, plain "
        f"{wm_plain_ms:.3f} ms, bytes moved {wm_moved} -> bound {wm_bound_ms:.4f} ms "
        f"({wm_bound_ms / wm_ms:.1%} of it)")
    wm_launches, gated_matches = gated["launches"], gated["matches"]
    del ptrs, s_out, ys, keep, state, xs, xs_ahead, plain_g, gated
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15. LogDriver: produce, poll, commit, restart, dead letters ---------
    import shutil

    from kafkastreams_cep_tpu_torch.streams.driver import dlq_topic

    # A poll of one flagship batch (the driver flushes after every poll):
    # 10 polls, commits after 3, 6 and 9; the restart after poll 7.
    poll_records, polls_per_commit, restart_after = K * T, 3, 7
    poison_at = poll_records + poll_records // 3  # committed before the restart
    poison = (b"\x00not a pickle", b"\x00nor this")
    arrivals = [(k, shuffled[k][b * T + t]) for b in range(n_batches) for t in range(T)
                for k in keys]
    del shuffled

    class LatencyRecorder:
        """Every match-latency observation of one query (the registry's
        reservoir keeps a recent window only)."""

        def __init__(self, child):
            self.child, self.values = child, []

        def observe(self, v):
            self.values.append(v)
            self.child.observe(v)

    def driver_on(log_):
        reg = MetricsRegistry()
        builder = P.ComplexStreamsBuilder(log=log_)
        out = builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda", config=gated_cfg,
            batch_size=per_flush, initial_keys=K, registry=reg,
        ).to("matches")
        topo = builder.build()
        latency = out.node._m_match_latency = LatencyRecorder(out.node._m_match_latency)
        t = time.perf_counter()
        driver = P.LogDriver(topo, group="g", registry=reg)
        return driver, latency, time.perf_counter() - t

    def pump(driver, commit_ms, polls, stop_after=None):
        """Poll until the log is consumed (or `stop_after` polls), a
        commit every `polls_per_commit` polls; returns records and polls."""
        n = 0
        while stop_after is None or polls < stop_after:
            got = driver.poll(max_records=poll_records, commit=False)
            if got == 0:
                break
            n, polls = n + got, polls + 1
            if polls % polls_per_commit == 0:
                torch.cuda.synchronize()
                t = time.perf_counter()
                driver.commit()
                commit_ms.append((time.perf_counter() - t) * 1e3)
        return n, polls

    def sink_of(log_):
        return [(r.key, r.value) for r in log_.read("matches")]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp:
        whole_dir, restart_dir = f"{tmp}/whole", f"{tmp}/restart"
        plog = P.RecordLog(whole_dir)
        t0 = time.perf_counter()
        for n, (key, e) in enumerate(arrivals):
            if n == poison_at:
                plog.append("letters", *poison, timestamp=e.timestamp)
            P.produce(plog, "letters", key, e.value, timestamp=e.timestamp)
        plog.flush()
        produce_s = time.perf_counter() - t0
        n_log = plog.end_offset("letters")
        plog.close()
        shutil.copytree(whole_dir, restart_dir)
        del arrivals

        # The uninterrupted run: the reference sink.
        sk.NfaStep.launches = gk.GcMark.launches = 0
        wlog = P.RecordLog(whole_dir)
        driver, latency, _ = driver_on(wlog)
        commit_ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_polled, whole_polls = pump(driver, commit_ms, 0)
        driver.drain_event_time()
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        drv_launches = launched("LogDriver", sk.NfaStep.launches)
        drv_gc_launches = launched("LogDriver (gc_mark)", gk.GcMark.launches)
        no_drops("LogDriver", driver.topology.queries[0][1].processor)
        whole_sink, whole_dlq = sink_of(wlog), wlog.read(dlq_topic("letters"))
        lat = torch.tensor(latency.values, dtype=torch.float64)
        health = driver.health()
        driver.close(commit=False)
        wlog.close()
        del driver, latency
        if n_polled != n_log:
            raise AssertionError(f"LogDriver polled {n_polled} of {n_log} records")
        if lat.numel() != len(whole_sink) or not whole_sink:
            raise AssertionError(f"cep_match_latency_seconds counted {lat.numel()} samples "
                                 f"for {len(whole_sink)} sink matches")
        if len(whole_dlq) != 1 or (whole_dlq[0].value != poison[1]):
            raise AssertionError(f"dead-letter topic holds {len(whole_dlq)} records")
        by_key = {}
        for k, v in whole_sink:
            by_key.setdefault(decode_sink_key(k)[0], []).append(v.decode())
        if by_key != gated_matches:
            raise AssertionError("the LogDriver's sink differs from phase 14's matches")
        del by_key, gated_matches

        # The same log (a copy) with a restart: after poll 7 (commits
        # after polls 3 and 6) the driver, topology and engine are
        # dropped and the log closed; all are built afresh on the files,
        # restored from the committed changelogs and offsets, and finish.
        sk.NfaStep.launches = gk.GcMark.launches = 0
        rlog = P.RecordLog(restart_dir)
        driver, _lat, _ = driver_on(rlog)
        restart_commit_ms = []
        _n, polls = pump(driver, restart_commit_ms, 0, stop_after=restart_after)
        del driver, _lat
        rlog.close()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rlog = P.RecordLog(restart_dir)
        t1 = time.perf_counter()
        driver, _lat, init_s = driver_on(rlog)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        resumed_at = driver.position("letters")
        pump(driver, restart_commit_ms, polls)
        driver.drain_event_time()
        restart_launches = launched("LogDriver restart", sk.NfaStep.launches)
        no_drops("LogDriver restart", driver.topology.queries[0][1].processor)
        restart_sink, restart_dlq = sink_of(rlog), rlog.read(dlq_topic("letters"))
        restored = driver.restored_records
        driver.close(commit=False)
        rlog.close()
        del driver, _lat
    digests = [decode_sink_key(k)[1] for k, _v in restart_sink]
    if len(set(digests)) != len(digests):
        raise AssertionError("the restarted driver's sink holds a match twice")
    if restart_sink != whole_sink:
        raise AssertionError(f"the restarted driver's sink ({len(restart_sink)} records) "
                             f"differs from the uninterrupted run's ({len(whole_sink)})")
    if len(restart_dlq) != 1 or restart_dlq[0].value != poison[1]:
        raise AssertionError(f"restart: dead-letter topic holds {len(restart_dlq)} records")
    log(f"LogDriver: produce() of {n_log} records ({n_log - 1} flagship records and 1 "
        f"poison) into a file-backed RecordLog in {produce_s:.1f} s; uninterrupted run: "
        f"{n_polled / drive_s:.0f} records/s through the driver ({whole_polls} polls of "
        f"{poll_records}, a commit every {polls_per_commit}, the gate as phase 14's with "
        f"its default watermark), {len(whole_sink)} sink matches, match latency p50 "
        f"{float(lat.quantile(0.5)) * 1e3:.1f} ms, p99 {float(lat.quantile(0.99)) * 1e3:.1f} "
        f"ms over {lat.numel()} samples (one per match); ms per commit "
        f"{[round(x, 1) for x in commit_ms]}; dead letters {health['dead_letters_by_reason']};"
        f" nfa_step launches {drv_launches}, gc_mark launches {drv_gc_launches}")
    log(f"LogDriver restart after poll {restart_after} (last commit after poll "
        f"{restart_after // polls_per_commit * polls_per_commit}): log reload "
        f"{(t1 - t0) * 1e3:.1f} ms, topology + LogDriver with restore {init_s * 1e3:.1f} ms "
        f"({restored} changelog records), resumed at offset {resumed_at}; time to recover "
        f"{(t2 - t0) * 1e3:.1f} ms; the sink == the uninterrupted run's, {len(restart_sink)} "
        f"matches each once, in order; the poison record once in the dead-letter topic; "
        f"ms per commit {[round(x, 1) for x in restart_commit_ms]}; nfa_step launches "
        f"{restart_launches}")
    del whole_sink, restart_sink, lat

    # -- 16. the kernel line, the card line, the ok line ----------------------
    log(f"chip_smoke ran {time.perf_counter() - T_START:.1f}s")
    kernels = [{
        "name": "nfa_step",
        "route": "cuda",
        "source": "kafkastreams_cep_tpu_torch/csrc/nfa_step.cu",
        "replaces": "kafkastreams_cep_tpu/ops/pallas_step.py:965",
        "launches": topo_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "grown": {
            "lanes": grown_cfg.lanes, "nodes": grown_cfg.nodes, "launches": grown_launches,
            "max_abs_err": grown_err, "ms": grown_ms, "plain_ms": grown_plain_ms,
            "bound_ms": grown_bound_ms, "bound_by": "bytes",
        },
        "wm": {
            "launches": wm_launches, "max_abs_err": wm_err, "ms": wm_ms,
            "plain_ms": wm_plain_ms, "bound_ms": wm_bound_ms, "bound_by": "bytes",
            "library_ms": None,
        },
    }, {
        "name": "gc_mark",
        "route": "cuda",
        "source": "kafkastreams_cep_tpu_torch/csrc/gc_mark.cu",
        "replaces": "kafkastreams_cep_tpu/ops/engine.py:1118-1134 (XLA while_loop, no Pallas)",
        "launches": topo_gc_launches,
        "max_abs_err": gc_err,
        "ms": gc_main["ms"],
        "plain_ms": gc_main["plain_ms"],
        "bound_ms": gc_main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "marks": mark_rows,
        "flushes": flush_rows,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
