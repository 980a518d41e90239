#!/usr/bin/env python3
"""Time step-kernel sources against each other on one card.

    python3 scripts/time_nfa_step.py [SOURCE ...] [--batches N] [--rounds N] [--reps N]

Each SOURCE is a CUDA file written to the step wrapper's interface: the
generated query header spliced in at `#include "nfa_query.cuh"`, the
exported `nfa_step_launch` taking the pointer array of
`ops/step_kernel.py::prepare` (a kernel may ignore the trailing scratch
pointer; one that exports `nfa_step_scratch_words` gets its scratch).
With no SOURCE the package's own csrc/nfa_step.cu is timed.

The script builds every source for the flagship query with nvcc, all at
once, runs the flagship deployment (skip_any8, K = 2048, T = 64, stream
seed 7) for `--batches` batches (default 3) through the plain PyTorch
step, holds every kernel bitwise to the plain step on each batch's
(state, xs), then times the kernels on the last batch's (state, xs) with
CUDA events, `--reps` launches a reading, in turns (forward, then
backward, `--rounds` times).
It prints one JSON line per source (every reading, the median, ptxas's
registers and spills) and the card's name and power limit. It needs a
card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import random
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_nfa_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.ops import step_kernel as sk
    from kafkastreams_cep_tpu_torch.ops.step import build_plain_step

    sources = args.sources or [sk.KERNEL_SOURCE]
    dev = torch.device("cuda")
    q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    cfg = P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    with ThreadPoolExecutor(len(sources)) as ex:
        paths = list(ex.map(lambda s: sk.build_library(q, cfg, source=s), sources))

    K, T = skip_any.FLAGSHIP_KEYS, skip_any.FLAGSHIP_T
    eng = P.BatchedDeviceNFA(q, keys=[f"k{i}" for i in range(K)], config=cfg, device=dev,
                             engine="torch")
    rng = random.Random(7)
    streams = {k: skip_any.skip_any8_stream(rng, args.batches * T) for k in eng.keys}
    pairs = []
    for b in range(args.batches):
        xs = eng.pack({k: s[b * T:(b + 1) * T] for k, s in streams.items()})
        pairs.append((eng.state, xs))
        eng.advance_packed(xs)
    plain = build_plain_step(q, cfg)
    expected = [plain(state, xs) for state, xs in pairs]

    kernels = []
    for src, path in zip(sources, paths):
        lib = ctypes.CDLL(str(path))
        lib.nfa_step_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.nfa_step_launch.restype = ctypes.c_int
        words = 0
        if hasattr(lib, "nfa_step_scratch_words"):
            lib.nfa_step_scratch_words.restype = ctypes.c_longlong
            words = int(lib.nfa_step_scratch_words())
        for b, ((state, xs), (s1, y1)) in enumerate(zip(pairs, expected)):
            ptrs, T_, K_, s2, y2, _keep = sk.prepare(q, cfg, state, xs, words)
            sk.call(lib, ptrs, T_, K_, dev)
            torch.cuda.synchronize()
            bad = [n for n in s1 if not torch.equal(s1[n], s2[n])]
            bad += [n for n in y1 if not torch.equal(y1[n], y2[n])]
            if bad:
                raise AssertionError(f"{src}: batch {b}: kernel != plain in {bad}")
        state, xs = pairs[-1]
        ptrs, T_, K_, _s, _y, keep = sk.prepare(q, cfg, state, xs, words)
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        kernels.append(dict(src=src, lib=lib, ptrs=ptrs, keep=keep, ms=[], ptxas=ptxas))

    def time_one(kern) -> float:
        fn = lambda: sk.call(kern["lib"], kern["ptrs"], T, K, dev)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    for r in range(args.rounds):
        for kern in (kernels if r % 2 == 0 else kernels[::-1]):
            kern["ms"].append(time_one(kern))
    for kern in kernels:
        print(json.dumps({
            "source": str(kern["src"]), "ms_median": statistics.median(kern["ms"]),
            "ms": kern["ms"], "reps": args.reps, "ptxas": kern["ptxas"],
            "K": K, "T": T, "batch": args.batches, "bitwise_equal_to_plain": True,
        }))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
