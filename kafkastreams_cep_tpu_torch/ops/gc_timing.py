"""Time the group flush's GC kernels on one card, at each block geometry.

    python -m kafkastreams_cep_tpu_torch.ops.gc_timing [--batches N] [--reps N] [--keys N]

Runs the flagship deployment (skip_any8, K = 2048, T = 64, stream seed 7,
`pin_interval`) through `BatchedDeviceNFA(engine="cuda")` for `--batches`
batches (default 3) and keeps the inputs of the last group flush. On
them it holds gc_mark (csrc/gc_mark.cu) bitwise to `_walk` and gc_sweep
(csrc/gc_sweep.cu) bitwise to `_sweep` at every keys-a-block the kernels
take (1-32, and the one the launch picks), times each with CUDA events
(`--reps` launches a reading, in turns forward then backward; the mark
also with an empty frontier, its seed and write-back alone), and times
the whole flush with both kernels, with the mark kernel and the plain
sweep, and with both plain versions. `--keys` cuts K (the flagship's
2048 by default). Prints one JSON line of readings and the card's name
and power limit. It needs a card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--keys", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gc_timing: no CUDA device", file=sys.stderr)
        return 2
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.ops import engine as engine_mod
    from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk
    from kafkastreams_cep_tpu_torch.ops import gc_sweep as gs

    dev = torch.device("cuda")
    K = args.keys or skip_any.FLAGSHIP_KEYS
    T = skip_any.FLAGSHIP_T
    q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    cfg = P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    mark_lib = gk.load_library(gk.build_library())
    sweep_lib = gs.load_library(gs.build_library())
    eng = P.BatchedDeviceNFA(q, keys=[f"k{i}" for i in range(K)], config=cfg, device=dev,
                             engine="cuda")
    rng = random.Random(7)
    streams = {k: skip_any.skip_any8_stream(rng, T * args.batches) for k in eng.keys}
    flush, last = eng._flush, {}

    def capture(*inputs):
        last["inputs"] = inputs
        return flush(*inputs)

    eng._flush = capture
    for b in range(args.batches):
        eng.advance({k: s[b * T:(b + 1) * T] for k, s in streams.items()})
    inputs = last["inputs"]

    marks, sweeps = [], []
    real_mark, real_sweep = engine_mod.gc_mark, engine_mod.gc_sweep

    def record_mark(m, f, p):
        marks.append((m, f.contiguous(), p))
        return real_mark(m, f, p)

    def record_sweep(*a):
        sweeps.append(a)
        return real_sweep(*a)

    engine_mod.gc_mark, engine_mod.gc_sweep = record_mark, record_sweep
    flush(*inputs)
    engine_mod.gc_mark, engine_mod.gc_sweep = real_mark, real_sweep
    (m, f, pr), (mk, mp, st, pl, ys) = marks[-1], sweeps[0]
    BW = pr.shape[0]
    want_m = gk._walk(m, f, pr)
    want_s = gs._sweep(mk, mp, st, pl, ys)

    def ms_of(fn):
        fn()
        torch.cuda.synchronize()
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z) / args.reps

    variants = {}
    for kpb in (0, 1, 2, 4, 8, 16, 32):
        got = gk.launch(mark_lib, m, f, pr, keys_per_block=kpb)
        if not torch.equal(got, want_m):
            raise AssertionError(f"gc_mark != _walk at {kpb} keys a block")
        got = gs.launch(sweep_lib, mk, mp, st, pl, ys, keys_per_block=kpb)
        if any(not torch.equal(got[n], want_s[n]) for n in want_s):
            raise AssertionError(f"gc_sweep != _sweep at {kpb} keys a block")
        variants[kpb] = (
            lambda kpb=kpb: gk.launch(mark_lib, m, f, pr, keys_per_block=kpb),
            lambda kpb=kpb: gs.launch(sweep_lib, mk, mp, st, pl, ys, keys_per_block=kpb),
        )
    readings = {f"{kernel}/{kpb}": [] for kpb in variants
                for kernel in ("mark", "mark_no_walk", "sweep")}
    order = list(variants)
    no_walk = f[:0]  # an empty frontier: the seed and the write-back alone
    for _round in range(3):
        for kpb in order + order[::-1]:
            readings[f"mark/{kpb}"].append(ms_of(variants[kpb][0]))
            readings[f"mark_no_walk/{kpb}"].append(ms_of(
                lambda: gk.launch(mark_lib, m, no_walk, pr, keys_per_block=kpb)))
            readings[f"sweep/{kpb}"].append(ms_of(variants[kpb][1]))

    def with_gc(mark, sweep):
        engine_mod.gc_mark, engine_mod.gc_sweep = mark, sweep
        try:
            return flush(*inputs)
        finally:
            engine_mod.gc_mark, engine_mod.gc_sweep = real_mark, real_sweep

    flush_ms = {
        "kernels": ms_of(lambda: flush(*inputs)),
        "mark_kernel_plain_sweep": ms_of(lambda: with_gc(gk.gc_mark, gs._sweep)),
        "plain": ms_of(lambda: with_gc(gk._walk, gs._sweep)),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "K": K, "BW": BW, "B": cfg.nodes, "kept": int(want_s["node_count"].sum()),
        "auto_keys_per_block": {"mark": int(mark_lib.gc_mark_keys_per_block(BW, K)),
                                "sweep": int(sweep_lib.gc_sweep_keys_per_block(BW, K))},
        "median_ms": {k: statistics.median(v) for k, v in readings.items()},
        "readings_ms": readings, "flush_ms": flush_ms,
    }))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
