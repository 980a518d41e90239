#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the step kernel from csrc/ with nvcc (one build per compiled query,
all started together), then:

  1. prints the card (`nvidia-smi --query-gpu=name,power.limit`);
  2. builds every kernel and prints the build seconds and ptxas's report;
  3. holds the CUDA step bitwise equal to the plain PyTorch step on the
     card, on identical inputs: the three conformance cases (K=8, T=10,
     3 batches) and the flagship shape (K=2048, T=64, 3 batches), every
     state leaf and every w_* output; times both at the flagship shape;
  4. drives the port's main path, `BatchedDeviceNFA(engine="cuda")`, on
     the flagship skip_any8 deployment (2048 keys x 64 events per batch,
     2 warm + 8 timed batches, stream seed 7, each batch packed, advanced
     and drained in turn, as `advance()` does), prints events/s with and
     without the host packing, and checks: the kernel's launch count
     equals the advances, the drop counters are 0, there are matches, and
     the final state, pool and the first 64 keys' matches equal the same
     run with engine="torch";
  5. runs the stock demo golden through engine="cuda" (4 matches);
  6. prints the kernel line, the card line, and last the ok line.

Any failed phase raises (exit code 1) before the ok line is printed.
Without a card it exits 2 and prints nothing on stdout.
"""
from __future__ import annotations

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
    flag_q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    flag_cfg = P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    builds["skip_any8"] = (flag_q, flag_cfg, None)
    gold_q = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    gold_cfg = P.EngineConfig(lanes=32, nodes=512, matches=64)
    builds["stock_golden"] = (gold_q, gold_cfg, None)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as ex:
        futs = {n: ex.submit(sk.build_library, q, c) for n, (q, c, _) in builds.items()}
        libs = {n: f.result() for n, f in futs.items()}
    build_s = time.perf_counter() - t0
    log(f"built {len(libs)} kernels in {build_s:.1f}s (nvcc, in parallel)")
    for line in libs["skip_any8"].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"ptxas[skip_any8]: {line.strip()}")

    # -- 3. kernel == plain step on the card ----------------------------------
    def compare(name, q, cfg, states_xs):
        lib = sk.load_library(libs[name])
        plain = build_plain_step(q, cfg)
        worst = 0.0
        for state, xs in states_xs:
            s1, y1 = plain(state, xs)
            s2, y2 = sk.launch(lib, q, cfg, state, xs)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_diff(s1, s2), max_abs_diff(y1, y2))
        return worst

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
    K, T = skip_any.FLAGSHIP_KEYS, skip_any.FLAGSHIP_T
    flag_pairs = trajectory("skip_any8", flag_q, flag_cfg, skip_any.skip_any8_stream, K, T, 3, 7)
    max_err = compare("skip_any8", flag_q, flag_cfg, flag_pairs)
    log(f"kernel == plain on the card: skip_any8 (K={K}, T={T}, 3 batches)")

    # Times at the flagship shape, on the third batch's (state, xs).
    lib = sk.load_library(libs["skip_any8"])
    state, xs = flag_pairs[-1]
    ptrs, T_, K_, s_out, ys, _keep = sk.prepare(flag_q, flag_cfg, state, xs)
    kernel_ms = cuda_ms(lambda: sk.call(lib, ptrs, T_, K_, dev), reps=20)
    plain = build_plain_step(flag_q, flag_cfg)
    plain_ms = cuda_ms(lambda: plain(state, xs), reps=2)
    xi, xf = _keep
    moved = xi.numel() * 4 + (xf.numel() * 4 if xf is not None else 0)
    moved += sum(state[n].numel() * state[n].element_size() for n in s_out if n in state)
    moved += sum(s_out[n].numel() * s_out[n].element_size() for n in s_out
                 if n != "gc_phase")
    moved += sum(v.numel() * 4 for v in ys.values())
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"nfa_step at K={K} T={T}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bytes moved {moved} -> bound {bound_ms:.4f} ms")
    del flag_pairs, state, xs, s_out, ys, _keep, xi, xf

    # -- 4. the main path: BatchedDeviceNFA(engine="cuda") at K=2048, T=64 ----
    n_warm, n_timed = 2, 8
    n_batches = n_warm + n_timed

    def flagship_run(engine: str):
        eng = P.BatchedDeviceNFA(flag_q, keys=[f"k{i}" for i in range(K)],
                                 config=flag_cfg, device=dev, engine=engine)
        rng = random.Random(7)
        streams = {k: skip_any.skip_any8_stream(rng, T * n_batches) for k in eng.keys}
        matches, lanes_peak, nodes_peak = {}, 0, 0
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
        eng._decode_flat = timed("decode", eng._decode_flat)
        torch.cuda.synchronize()
        sk.NfaStep.launches = 0
        for b in range(n_batches):
            timing[0] = b >= n_warm
            t0 = time.perf_counter()
            xs = eng.pack({k: s[b * T:(b + 1) * T] for k, s in streams.items()})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.advance_packed(xs, decode=False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = eng.drain()
            t3 = time.perf_counter()
            if b >= n_warm:
                pack_s += t1 - t0
                adv_s += t2 - t1
                drain_s += t3 - t2
            for key, seqs in out.items():
                matches.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
            lanes_peak = max(lanes_peak, int(eng.state["active"].sum(0).max()))
            nodes_peak = max(nodes_peak, int(eng.pool["node_count"].max()))
        launches = sk.NfaStep.launches
        return dict(eng=eng, matches=matches, adv_s=adv_s, drain_s=drain_s,
                    pack_s=pack_s, launches=launches, lanes_peak=lanes_peak,
                    nodes_peak=nodes_peak, phases=phases)

    torch.cuda.reset_peak_memory_stats()
    run = flagship_run("cuda")
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
        + [f"{k} {v / n_timed * 1e3:.2f}" for k, v in run["phases"].items()]))
    log(f"main path: {n_match} matches, stats {stats}, lanes peak "
        f"{run['lanes_peak']}/{flag_cfg.lanes}, node_count peak "
        f"{run['nodes_peak']}/{flag_cfg.nodes}, nfa_step launches {run['launches']}")
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

    # -- 5. stock golden through the kernel -----------------------------------
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

    # -- 6. the kernel line, the card line, the ok line -----------------------
    kernels = [{
        "name": "nfa_step",
        "route": "cuda",
        "source": "kafkastreams_cep_tpu_torch/csrc/nfa_step.cu",
        "replaces": "kafkastreams_cep_tpu/ops/pallas_step.py:965",
        "launches": run["launches"],
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
