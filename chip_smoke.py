#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the step kernel from csrc/ with nvcc (one build per compiled query)
and the native packer and decoder from native/ with g++, all started
together, then:

  1. prints the card (`nvidia-smi --query-gpu=name,power.limit`);
  2. builds every kernel and both native extensions and prints the build
     seconds, the Python include path, ptxas's registers and spills, and
     the kernel's resident blocks and warps per SM (one warp per key);
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
     the drop counters are 0, there are matches, and the final state,
     pool and the first 64 keys' matches equal the same run with
     engine="torch"; then times the kernel on the last batch's state;
  5. drives the same deployment through the streams API -- a
     `runtime="cuda"` topology fed record by record through
     `Topology.process`, 2 warm + 8 timed flushes of 131,072 records,
     matches to a `.to("matches")` sink -- and prints records/s and the
     ms per flush of enqueue, pack, advance, drain + decode and emit;
     checks that the matches per key equal phase 4's, the kernel
     launched once per flush, the drop counters are 0 and the sink holds
     one record per match; then again with `sink_format="json"`, whose
     payloads must equal the objects run's JSON bytes;
  6. runs the stock demo golden through engine="cuda" and through a
     `runtime="cuda"` topology (4 matches each);
  7. prints the kernel line, the card line, and last the ok line.

Any failed phase raises (exit code 1) before the ok line is printed.
Without a card it exits 2 and prints nothing on stdout.
"""
from __future__ import annotations

import ctypes
import gc
import json
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
    from kafkastreams_cep_tpu_torch.models.cases import CASES, STOCK_FIELDS
    from kafkastreams_cep_tpu_torch.models.chunked import CHUNKED, CHUNKED_T, scatter_live_lanes
    from kafkastreams_cep_tpu_torch import native
    from kafkastreams_cep_tpu_torch.models.stocks import (
        GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
    )
    from kafkastreams_cep_tpu_torch.ops import step_kernel as sk
    from kafkastreams_cep_tpu_torch.ops.engine import DROP_COUNTER_KEYS
    from kafkastreams_cep_tpu_torch.ops.step import build_plain_step

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
    gold_q = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    gold_cfg = P.EngineConfig(lanes=32, nodes=512, matches=64)
    builds["stock_golden"] = (gold_q, gold_cfg, None)
    def timed_build(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds) + 2) as ex:
        futs = {n: ex.submit(sk.build_library, q, c) for n, (q, c, _) in builds.items()}
        nat_futs = {n: ex.submit(timed_build, native.build_ext, n) for n in ("packer", "decoder")}
        libs = {n: f.result() for n, f in futs.items()}
        nat_builds = {n: f.result() for n, f in nat_futs.items()}
    build_s = time.perf_counter() - t0
    log(f"built {len(libs)} kernels and the native packer and decoder in {build_s:.1f}s "
        f"(nvcc and g++, in parallel); g++ seconds: " + ", ".join(
            f"{n} {sec:.2f} ({path.name})" for n, (path, sec) in nat_builds.items())
        + f"; Python headers: {native.python_include()}")
    for line in libs["skip_any8"].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"ptxas[skip_any8]: {line.strip()}")
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
    xi, xf, scratch = _keep
    moved = xi.numel() * 4 + (xf.numel() * 4 if xf is not None else 0)
    moved += sum(state[n].numel() * state[n].element_size() for n in s_out if n in state)
    moved += sum(s_out[n].numel() * s_out[n].element_size() for n in s_out
                 if n != "gc_phase")
    moved += sum(v.numel() * 4 for v in ys.values())
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"nfa_step at K={K} T={T}, third batch: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bytes moved {moved} -> bound {bound_ms:.4f} ms "
        f"({bound_ms / kernel_ms:.1%} of it); scratch {scratch.numel() * 4} B")
    del flag_pairs, state, xs, s_out, ys, _keep, xi, xf, scratch, per_event

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

        def decode_and_check(raw):
            out = decode(raw)
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
        sk.NfaStep.launches = 0
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
        launches = sk.NfaStep.launches
        if check_host and decode_checks[0] != n_batches:
            raise AssertionError(f"{decode_checks[0]} decode checks for {n_batches} drains")
        return dict(eng=eng, matches=matches, adv_s=adv_s, drain_s=drain_s,
                    pack_s=pack_s, launches=launches, lanes_peak=lanes_peak,
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
        f"{run['nodes_peak']}/{flag_cfg.nodes}, nfa_step launches {run['launches']}")
    log(f"main path: live lanes per key at the {n_batches} batch ends: {spread(run['live_ends'])}")
    if run["launches"] != n_batches:
        raise AssertionError(f"nfa_step launched {run['launches']} times for {n_batches} advances")
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
        sk.NfaStep.launches = 0
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
        launches = sk.NfaStep.launches
        return dict(out=out, log=sink_log, proc=proc, walls=walls, timed_s=timed_s,
                    launches=launches, routes=routes, gc=gc_clock)

    def check_topology(res, label):
        out, proc = res["out"], res["proc"]
        n_records = n_timed * K * T
        log(f"topology[{label}]: {n_records / res['timed_s']:.0f} records/s end to end over "
            f"{n_timed} timed flushes of {K * T} records; ms per flush: " + ", ".join(
                f"{k} {v / n_timed * 1e3:.2f}" for k, v in res["walls"].items())
            + "; " + res["gc"].summary(n_timed))
        if res["routes"] != {"native"}:
            raise AssertionError(f"topology packs took the routes {res['routes']}")
        if proc._flushes != n_batches or res["launches"] != n_batches:
            raise AssertionError(f"{res['launches']} nfa_step launches for {proc._flushes} "
                                 f"flushes ({n_batches} expected)")
        tstats = proc.stats
        drops = {k: tstats[k] for k in DROP_COUNTER_KEYS}
        if any(drops.values()):
            raise AssertionError(f"topology drop counters are not 0: {drops}")
        n_sink = res["log"].end_offset("matches")
        if n_sink != len(out.records):
            raise AssertionError(f"sink holds {n_sink} records for {len(out.records)} matches")
        log(f"topology[{label}]: {len(out.records)} matches, {n_sink} sink records, "
            f"{res['launches']} nfa_step launches for {proc._flushes} flushes, drops {drops}")

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
    obj_rows = [(r.key, P.sequence_to_json(r.value).encode("utf-8"))
                for r in topo_obj["out"].records]
    del topo_obj, by_key, engine_matches
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

    # -- 7. the kernel line, the card line, the ok line -----------------------
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
