#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the step kernel from csrc/ with nvcc (one build per compiled query
and capacity, the flagship's grown shape, phase 18's arm shape, the
fold query of phase 13, the stacked and single queries of phases
20-21, phase 25's soak hotspot and phase 26's dryrun included; the
event-time phases, phases 22-24 and phase 26's mesh reuse the
flagship's build, and the shapes phase 18's autosizer grows to build
inside that phase, timed), the group flush's GC mark and sweep kernels
(csrc/gc_mark.cu and csrc/gc_sweep.cu, one build each) and the native
packer, decoder and CRC-32C from native/ with g++, all started together
(phase 27's seeded capacity churn reuses the grown shape's build), then:

  1. prints the card (`nvidia-smi --query-gpu=name,power.limit`);
  2. builds every kernel and the three native extensions and prints the
     build seconds, the Python include path, ptxas's registers and spills
     (step, mark and sweep), and the step kernel's resident blocks and warps per
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
     the GC mark kernel's launch count equals the flushes' walks and the
     sweep kernel's the flushes, the drop
     counters are 0, there are matches, and the final state, pool and the
     first 64 keys' matches equal the same run with engine="torch"; then
     times the kernel on the last batch's state;
  5. drives the same deployment through the streams API -- a
     `runtime="cuda"` topology fed record by record through
     `Topology.process`, 2 warm + 8 timed flushes of 131,072 records,
     matches to a `.to("matches")` sink -- and prints records/s and the
     ms per flush of enqueue, pack, advance, drain + decode and emit;
     checks that the matches per key equal phase 4's, the step kernel and
     the GC mark and sweep kernels launched once per flush, the drop
     counters are 0
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
 12. the GC kernels: captures the flagship's group flushes after batches
     3 and 10 (`pin_interval`, the lane walk) and after batch 3 of the
     same deployment with `pin_interval=False` (the page walk and the lane
     walk), holds gc_mark bitwise to the plain walk `_walk` on every
     captured mark and gc_sweep bitwise to the plain sweep `_sweep` on
     every captured sweep, prints each launch's ms (CUDA events), block
     geometry (keys a block, blocks, shared memory) and byte bound (mark:
     the seed and result marks, the frontier, and one pred read per newly
     marked node; sweep: the marks, the kept nodes' rows, lanes and the
     ring below each cursor read, every output plane written), and holds
     the whole flush with both kernels equal to the flush with both plain
     versions, timed beside it and beside the flush with the mark kernel
     and the plain sweep (PR 9's flush, less its window copies);
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
     `nfa_step`, `gc_mark` and `gc_sweep` launched once per flush (group
     flush); prints
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
 16. the host runtime: the stock golden through a `runtime="host"`
     topology (4 matches, phase 7's output; no card);
 17. `runtime="auto"` at the flagship, with the JAX package's defaults
     (promote_after 64, buffer_max 65,536, autosize on; batch_size
     131,072): the full streams of 63 keys (40,320 records) on the host
     runtime, then the other 1,985 keys in phase 5's interleaved order; the
     64th key promotes the query and the ledger replays through the card.
     Checks: the sink equals phase 5's per key, each match once; one
     promotion, runtime "cuda"; drops 0; `nfa_step`, `gc_mark` and
     `gc_sweep` launched, the step kernel bitwise to the plain step on the first
     post-promotion batch. Prints the host phase's records/s, the
     promotion's wall and its replay share, the device phase's records/s
     beside phase 5's, match latency p50/p99 (ingest stamped per record as
     the driver does), the autosizer's and the DrainController's
     `state()`, and the nvcc builds;
 18. controllers on the engine: the flagship deferred
     (`advance_packed(decode=False)`, one drain at the end) from an arm
     shape of lanes 224, nodes 2048, a ring of 8 pages and gc_group 4,
     with a `CapacityAutosizer` ticked after every advance (its
     `DrainController` arms micro-drains, max_emit_ms 100, gc_group held
     at 4). The flagship's peaks (183 lanes, 1,609 nodes) sit above the
     75 % grow line: the autosizer must grow, and the phase must drop
     nothing. Checks: matches equal phase 4's; no micro-drain pull flushed
     the GC group, and every flush is on the G = 4 cadence or forced by
     region pressure or a resize. Prints the resizes, their walls and
     nvcc builds, the pulls by trigger, events/s with the decode worker
     (resize walls excluded) beside phase 4's, and for each grown shape
     the kernel held bitwise to the plain step and timed on its first
     batch there, with its bound; then the decode worker against inline
     decode (each pulled table decoded on the calling thread) on the
     flagship deferred with micro-drains, in the order worker, inline,
     inline, worker, each run's matches equal to phase 4's;
 19. the paced `LogDriver`: phase 15's log again, `pacing=True` (the
     `AdmissionPacer` sizes each poll), no commits: the sink must equal
     phase 15's per key (other poll sizes interleave the keys
     otherwise), each match once; prints records/s and the budgets the
     pacer chose;
 20. BASELINE config 4, N concurrent queries over one stream
     (bench.py:916-990): the four letter queries of models/stacked.py in
     one `StackedQueryEngine(engine="cuda")` over 1024 keys, T = 64, 2
     warm batches (each an advance and a drain, then a
     `CapacityAutosizer` tick; the engine starts at the EngineConfig
     defaults with `pin_interval`) and 8 pre-packed timed batches
     deferred, one drain; then each query on its own engine, run the same
     way. Checks: per key and query the stacked matches equal the
     independent engines', drops 0, both kernels launched, the step
     kernel bitwise to the plain step on the first timed batch's state.
     Prints events/s of both (stream events counted once) and the
     kernel's time and bound there;
 21. the wide stack: eight rotations of the flagship pattern stacked (72
     stages and 120 predicates: the kernel's two-word stage and
     predicate masks) at eight times the flagship's capacity (lanes 2560,
     nodes 65,536, the flagship's Dewey width) over 512 keys, 4 batches
     of T = 64, each advanced and drained. Checks: per key and query the
     matches equal eight independent flagship-capacity engines', drops 0,
     the kernel bitwise to the plain step on batch 3; prints ptxas's
     registers and spills for that build, the kernel's time and bound;
 22. `DeviceNFA` on the flagship stream, one key, T = 256 x 12 batches
     (bench.py:400-440's shape), each advance drained through its pool
     route (one host copy of the ring and the node planes, the native
     `decode_matches`, whose calls are counted): events/s; the
     matches, `runs` and live runs equal the host oracle's (nfa/), the
     matches, state and pool equal a plain-step `DeviceNFA` on the card;
     a snapshot after batch 6 restored into a fresh engine gives the same
     later matches and final state; the kernel at K = 1 timed against the
     plain step on batch 7; the stock golden through a `DeviceNFA` (4
     matches);
 23. the pool drain at the flagship: the deployment of phase 4 through
     `BatchedDeviceNFA(engine="cuda", drain_mode="pool")`, 2 warm + 4
     timed batches, each drained. Checks: the matches per key equal phase
     4's for the same batches, drops 0, gc_mark launched once a flush
     walk plus once a drain (the closure walk of `drain_compact`, counted
     apart), gc_sweep once a flush; on the first timed drain's pool the
     drain's gc_mark launch is bitwise `_walk`'s and `drain_compact`'s
     (pend_r, nodes3, pcount) with the kernel equal the same with
     `_walk`. Prints the ms a drain and the bytes pulled, that drain's
     probe, walk (CUDA events, beside its byte bound), compaction, host
     copy and decode, beside phase 4's flat drain. Then config 4's
     stacked engine, pool against flat over 2 batches: equal (qid,
     Sequence) pairs; and one flagship flat table through the native
     `decode_matches_arrow` and `decode_matches_json` (no pyarrow on the
     card): equal idents, Arrow rows == events. Prints the phase's
     seconds;
 24. a live shard migration at the flagship: phase 15's first
     FLEET_BATCHES (4) batches, all 2048 keys, through `produce()` into a
     `PartitionedRecordLog` over 3 in-process brokers (key k_i on
     partition i % 4); two `ShardPipeline`s own partitions {0, 1} and
     {2, 3}, a third owns all four (the reference: one pipeline, no
     migration), each the gated flagship query at initial_keys 2048
     (min-merge over its partitions); a round produces one batch and
     polls every pipeline. After round 2, shard 0 is fenced,
     checkpointed, restored on the card in a successor over another view
     and resumed. Checks: the union of the shards' sinks equals the
     reference's per key, each match once; the successor resumed at the
     committed positions, not at 0; its first group flush holds every
     gc_mark launch bitwise to `_walk` and the gc_sweep launch to
     `_sweep`, its first step bitwise to the plain step; late 0, drops
     0. Prints the checkpoint's bytes, the ms to fence, checkpoint,
     close, restore and resume, records/s of each pipeline before and
     after the move, and the launches;
 25. the soak entry: `python -m kafkastreams_cep_tpu_torch.faults soak
     --quick --runtime mixed --transport socket --brokers 3` in a
     subprocess (the hotspot on the card, loopback socket brokers, one
     seeded broker kill and salvage rebalance, FleetController, the
     scraper, chaos). Checks: exit 0, every SLO held
     (`emission_integrity` included), platform "cuda", the hotspot on
     "cuda", the artifact valid under faults/soak_schema.py, and the
     first launch of each kernel at every shape the soak meets bitwise
     to its plain version (`soak_child`); prints the summary line, each
     SLO's value, the shapes checked and the launches;
 26. the key mesh: the flagship engine of phase 4 on a `key_mesh` over
     every visible card, at least 2 shards (one card: a virtual mesh of 2
     shards on it), 2 warm + 8 timed batches, each packed, advanced and
     drained. Checks: the matches per key equal phase 4's, drops 0, each
     kernel launched once a shard an advance (the step) or a group flush
     (the mark and the sweep), and on each shard's first launch
     `nfa_step`, `gc_mark` and `gc_sweep` bitwise equal to
     `NfaStep._plain`, `_walk` and `_sweep` on the same inputs; the
     snapshot frame equals an unsharded engine's after the same 10
     batches; 0 host syncs over 8 deferred sharded advances; a sharded
     `runtime="cuda"` topology's sink over 2 flushes equals phase 5's
     first two flushes'; the dryrun (`parallel/dryrun.py`, stock query,
     merged device registries) on a mesh of the same shard count. Prints
     the mesh (devices, distinct count, virtual or not), events/s
     sharded beside the unsharded engine's in the same phase and phase
     4's, each kernel's ms a shard launch (CUDA events, on the shard's
     first inputs) beside its bound, the launches per flush and the
     phase's wall (`run_mesh_entry()` runs this phase alone, with its own
     references, on every visible card);
 27. the port's analysis, three checks, each in a child process of its
     own, the three started together; a child that fails has its last
     CHILD_TAIL lines printed on stderr with the phase and the check's
     name, and the script exits 1:
     (a) the static gate `python -m kafkastreams_cep_tpu_torch.analysis
     --all --json` exits 0 with no active finding;
     (b) `audit_child`: the kernel-build audit (analysis/kernel_audit.py)
     at the flagship width on the card -- after its warm epoch (advances,
     flushes, probes, a drain, a snapshot restored) the replay epochs
     (drains, snapshot/restore round trips, identical traffic re-packed)
     move none of cep_compiles_total{fn}, the compiler runs and the
     modules loaded per device, launch every kernel, and hold each
     kernel's first replay launch bitwise to its plain version; on a
     machine with several cards the audit runs again on `key_mesh()`
     over all of them; the seeded capacity churn reports CEP-J01;
     (c) `lockmon_child`: the port's lock monitor around a flagship
     `runtime="cuda"` topology pumped by a `LogDriver` with its
     introspection plane (serve, clock and profile threads), a
     `MetricsScraper` and the decode worker running together finds no
     lock-order cycle, and a seeded two-lock inversion in the same child
     is reported. Prints the counters, the launches, the lock graph's
     edges and sites, and each child's seconds (`run_analysis_entry()`
     runs this phase alone);
 28. prints the kernel line (with the `wm`, `auto`, `controllers`,
     `paced_driver`, `config4_stacked`, `wide_stack`, `single_key`,
     `fleet`, `mesh` and `kernel_audit` runs' numbers under nfa_step,
     gc_mark and gc_sweep, the grown shapes' times and bounds among
     them, and the pool drain's walk as gc_mark's `pool_drain` call
     site), the card line, and last the ok line.

Phases 20-22 each also hold both GC kernels to their plain versions on
one captured flush, as phase 12 does (the wide stack's bitmaps must stay
in shared memory), and count both kernels' launches.

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
import runpy
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
#: Phase 24's depth: the first batches of phase 15's records (all keys).
FLEET_BATCHES = 4
#: Phase 25's soak, as a user runs it.
SOAK_ARGS = ["soak", "--quick", "--runtime", "mixed", "--transport", "socket",
             "--brokers", "3"]
#: Phase 23's flagship batches through the pool drain (2 warm, 4 timed).
POOL_WARM, POOL_BATCHES = 2, 6


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


def sweep_bytes(marked, state, pool, want) -> int:
    """Bytes one gc_sweep launch must move on this data: the marks read
    once, the kept rows' event, name, pred and pin, the lanes, the ring
    below each cursor and the per-key scalars read; every output plane
    written once."""
    BW, Kk = marked.shape[0] - 1, marked.shape[1]
    B, R, M = pool["node_event"].shape[0], state["node"].shape[0], pool["pend"].shape[0]
    kept = int(want["node_count"].sum())
    below = int(pool["pend_pos"].clamp(0, M).sum())
    reads = BW * Kk + kept * 13 + 2 * R * Kk * 4 + below * 4 + 3 * Kk * 4
    writes = B * Kk * 13 + 2 * R * Kk * 4 + M * Kk * 4 + 3 * Kk * 4
    return reads + writes


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


def tree_copy(tree: dict) -> dict:
    return {n: v.clone() for n, v in tree.items()}


def tree_diff(a: dict, b: dict) -> float:
    """0 when every leaf is bitwise equal, else the largest |a - b| (inf
    where that is 0 or not a number)."""
    if set(a) != set(b):
        return float("inf")
    worst = 0.0
    for n in a:
        if a[n].dtype != b[n].dtype or a[n].shape != b[n].shape:
            return float("inf")
        if not torch.equal(a[n], b[n]):
            d = float((a[n].double() - b[n].double()).abs().max())
            worst = max(worst, d if d > 0 else float("inf"))
    return worst


def watch_kernels(fresh, record):
    """Wrap the three kernels' wrappers: a launch for which
    `fresh(kernel, key, device)` is true is held bitwise against its plain
    version -- `NfaStep._plain` (build_plain_step), `_walk`, `_sweep` --
    on a copy of the same inputs, and `record(kernel, shape, max_abs_err)`
    receives the result (0 when equal). The launch counts stay the
    wrappers' own: the plain versions launch nothing. Returns a function
    that puts the wrappers back."""
    from kafkastreams_cep_tpu_torch.ops import gc_kernel, gc_sweep, step_kernel

    calls = (step_kernel.NfaStep.__call__, gc_kernel.GcMark.__call__,
             gc_sweep.GcSweep.__call__)

    def step_watched(self, state, xs):
        (T, K), c = xs["valid"].shape, self.config
        shape = f"T={T} K={K} lanes={c.lanes} nodes={c.nodes} matches={c.matches}"
        if not fresh("nfa_step", (c, T, K), xs["valid"].device):
            return calls[0](self, state, xs)
        s_in, x_in = tree_copy(state), tree_copy(xs)
        s_out, ys = calls[0](self, state, xs)
        s_want, y_want = self._plain(s_in, x_in)
        torch.cuda.synchronize()
        record("nfa_step", shape, max(tree_diff(s_out, s_want), tree_diff(ys, y_want)))
        return s_out, ys

    def mark_watched(self, marked, frontier, pred):
        shape = f"BW={pred.shape[0]} K={pred.shape[1]}"
        if not fresh("gc_mark", shape, pred.device):
            return calls[1](self, marked, frontier, pred)
        m_in, f_in = marked.clone(), frontier.clone()
        got = calls[1](self, marked, frontier, pred)
        want = gc_kernel._walk(m_in, f_in, pred)
        torch.cuda.synchronize()
        record("gc_mark", shape, tree_diff({"marked": got}, {"marked": want}))
        return got

    def sweep_watched(self, marked, marked_pin, state, pool, ys):
        shape = (f"BW={marked.shape[0] - 1} K={marked.shape[1]} B={pool['node_event'].shape[0]}"
                 f" lanes={state['node'].shape[0]} M={pool['pend'].shape[0]}")
        if not fresh("gc_sweep", shape, pool["node_event"].device):
            return calls[2](self, marked, marked_pin, state, pool, ys)
        args = (marked.clone(), marked_pin.clone(), tree_copy(state), tree_copy(pool),
                tree_copy(ys))
        got = calls[2](self, marked, marked_pin, state, pool, ys)
        want = gc_sweep._sweep(*args)
        torch.cuda.synchronize()
        record("gc_sweep", shape, tree_diff(got, want))
        return got

    def restore():
        (step_kernel.NfaStep.__call__, gc_kernel.GcMark.__call__,
         gc_sweep.GcSweep.__call__) = calls

    step_kernel.NfaStep.__call__ = step_watched
    gc_kernel.GcMark.__call__ = mark_watched
    gc_sweep.GcSweep.__call__ = sweep_watched
    return restore


def soak_child(argv: list) -> None:
    """The body of phase 25's subprocess: `python -m
    kafkastreams_cep_tpu_torch.faults` with `argv`, run through runpy with
    the three kernels' wrappers watched (`watch_kernels`): the first call
    of each wrapper on the card at each shape it meets (the step at each
    engine shape the autosizer builds, the mark and the sweep at each
    pool shape) is held bitwise against its plain version. Prints the
    launches and the checks on stderr (LAUNCHES / CHECKS lines) and exits
    with the soak's code."""
    checks = {n: {"shapes": [], "max_abs_err": 0.0, "mismatches": []}
              for n in ("nfa_step", "gc_mark", "gc_sweep")}
    seen = set()

    def record(name, shape, err):
        row = checks[name]
        row["shapes"].append(shape)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if err != 0:
            row["mismatches"].append(shape)

    def fresh(name, key, device):
        if device.type != "cuda" or (name, key) in seen:
            return False
        seen.add((name, key))
        return True

    watch_kernels(fresh, record)
    sys.argv = ["-m"] + list(argv)
    try:
        runpy.run_module("kafkastreams_cep_tpu_torch.faults", run_name="__main__",
                         alter_sys=True)
        rc = 0
    except SystemExit as exc:
        rc = exc.code
    print("LAUNCHES " + json.dumps(kernel_launches()), file=sys.stderr)
    print("CHECKS " + json.dumps(checks), file=sys.stderr)
    sys.exit(rc)


def run_soak_entry() -> tuple:
    """Phase 25: `python -m kafkastreams_cep_tpu_torch.faults` with
    SOAK_ARGS in a subprocess (`soak_child`). Checks exit 0, every SLO
    held, platform "cuda", the hotspot on the "cuda" runtime, the
    artifact valid under faults/soak_schema.py, each kernel launched, and
    each kernel's first launch at every shape of the run bitwise to its
    plain version; returns the launch counts and those checks."""
    from kafkastreams_cep_tpu_torch.faults.soak_schema import validate_soak

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as tmp:
        out = f"{tmp}/SOAK.json"
        argv = SOAK_ARGS + ["--out", out, "--dir", f"{tmp}/work"]
        code = (f"import sys; sys.path.insert(0, {str(root)!r}); import chip_smoke; "
                f"chip_smoke.soak_child({argv!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                              capture_output=True, text=True, timeout=300)
        err = proc.stderr.splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"soak exited {proc.returncode}: " + "\n".join(err[-30:]))
        with open(out) as f:
            doc = json.load(f)
    launches = json.loads(next(line for line in err if line.startswith("LAUNCHES "))[9:])
    checks = json.loads(next(line for line in err if line.startswith("CHECKS "))[7:])
    summary = next(line for line in err if line.startswith("[soak] PASS") or
                   line.startswith("[soak] FAIL"))
    failed = [n for n, e in doc["slos"].items() if not e["ok"]]
    if not doc["passed"] or failed:
        raise AssertionError(f"soak: SLOs violated: {failed}")
    if doc["soak"]["platform"] != "cuda" or doc["scenarios"]["hotspot"]["runtime"] != "cuda":
        raise AssertionError(f"soak: platform {doc['soak']['platform']}, hotspot runtime "
                             f"{doc['scenarios']['hotspot']['runtime']}")
    errors = validate_soak(doc)
    if errors:
        raise AssertionError(f"soak artifact: {errors[:5]}")
    for name, n in launches.items():
        if int(n) <= 0:
            raise AssertionError(f"soak: {name} was not launched")
        row = checks[name]
        if not row["shapes"]:
            raise AssertionError(f"soak: no launch of {name} was held to its plain version")
        if row["mismatches"]:
            raise AssertionError(f"soak: {name} differs from its plain version (max |diff| "
                                 f"{row['max_abs_err']}) at shapes {row['mismatches']}")
    s = doc["soak"]
    log(f"soak ({' '.join(SOAK_ARGS)}): {summary}")
    log("soak SLOs: " + "; ".join(
        f"{n} {'ok' if e['ok'] else 'VIOLATED'} value={e['value']} bound={e['bound']}"
        + (" (excused)" if e["excused"] else "") for n, e in doc["slos"].items()))
    for name, row in checks.items():
        log(f"soak: {name} == its plain version bitwise at the first launch of each of the "
            f"run's {len(row['shapes'])} shapes: {'; '.join(row['shapes'])}")
    log(f"soak: platform {s['platform']}, hotspot runtime "
        f"{doc['scenarios']['hotspot']['runtime']} ({doc['scenarios']['hotspot']['matches']} "
        f"matches), {s['brokers']} brokers, {s['broker_kills']} broker kill(s), "
        f"{s['rebalance_partitions_moved']} partitions ({s['rebalance_records_moved']} records) "
        f"salvaged, {s['crashes']} crashes, controller ticks {doc['fleet'].get('ticks')}, "
        f"{s['scrapes']} scrapes; artifact valid; launches {launches}; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return launches, {n: {"checked_launches": len(row["shapes"]), "shapes": row["shapes"],
                          "max_abs_err": row["max_abs_err"]} for n, row in checks.items()}


def mesh_phase(flag_q, flag_cfg, streams: dict, n_warm: int, n_timed: int,
               ref_matches: dict = None, ref_sink: list = None,
               unsharded_eps: float = None) -> dict:
    """Phase 26: the flagship engine on `key_mesh` over every visible card,
    at least 2 shards (a virtual mesh of 2 on one card), against the
    unsharded engine on the same batches. `streams` holds every key's
    events; `ref_matches` (phase 4's, JSON per key) and `ref_sink` (phase
    5's sink) are the references when given, else an unsharded run and an
    unsharded 2-flush topology made here. Raises on a failed check;
    returns each kernel's `mesh` entry of the kernel line."""
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk
    from kafkastreams_cep_tpu_torch.ops import gc_sweep as gs
    from kafkastreams_cep_tpu_torch.ops import step_kernel as sk
    from kafkastreams_cep_tpu_torch.ops.engine import DROP_COUNTER_KEYS
    from kafkastreams_cep_tpu_torch.parallel import key_mesh
    from kafkastreams_cep_tpu_torch.parallel.dryrun import dryrun_multichip

    t_mesh = time.perf_counter()
    keys = list(streams)
    K, T = len(keys), skip_any.FLAGSHIP_T
    n_batches = n_warm + n_timed
    flag_lib = sk.load_library(sk.build_library(flag_q, flag_cfg))
    words = int(flag_lib.nfa_step_scratch_words())
    gc_lib = gk.load_library(gk.build_library())
    sweep_lib = gs.load_library(gs.build_library())

    def batch_of(b):
        return {k: st[b * T:(b + 1) * T] for k, st in streams.items()}

    def timed_run(eng):
        """The batches packed, advanced and drained in turn, as phase 4
        runs them: the matches (JSON per key), the host walls of the timed
        batches, and the matches after the first two batches."""
        out, walls, two = {}, {"pack": 0.0, "advance": 0.0, "drain": 0.0}, 0
        torch.cuda.synchronize()
        for b in range(n_batches):
            t0 = time.perf_counter()
            xs = eng.pack(batch_of(b))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.advance_packed(xs, decode=False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for key, seqs in eng.drain().items():
                out.setdefault(key, []).extend(P.sequence_to_json(sq) for sq in seqs)
            t3 = time.perf_counter()
            if b >= n_warm:
                walls["pack"] += t1 - t0
                walls["advance"] += t2 - t1
                walls["drain"] += t3 - t2
            if b == 1:
                two = sum(map(len, out.values()))
        return out, walls, two

    def no_drops(label, eng):
        drops = {k: eng.stats[k] for k in DROP_COUNTER_KEYS}
        if any(drops.values()):
            raise AssertionError(f"{label}: drop counters are not 0: {drops}")

    def launched(label, n):
        if n <= 0:
            raise AssertionError(f"{label}: the kernel was not launched")
        return n

    mesh = key_mesh(max(2, torch.cuda.device_count()))
    log(f"mesh: {mesh.describe()} ("
        + (f"virtual: {mesh.size} shards on one card" if mesh.virtual else "one shard a card")
        + ")")
    checks = {n: [] for n in ("nfa_step", "gc_mark", "gc_sweep")}
    inputs = {n: [] for n in checks}
    first_calls = {n: 0 for n in checks}
    real_step, real_mark, real_sweep = (sk.NfaStep.__call__, gk.GcMark.__call__,
                                        gs.GcSweep.__call__)

    def first_of_shard(name):
        """True for each kernel's first mesh.size calls: one a shard, in
        shard order (the engine maps its passes over the shards in turn)."""
        first_calls[name] += 1
        return first_calls[name] <= mesh.size

    def tree_err(a, b):
        bad = [n for n in a if a[n].dtype != b[n].dtype or not torch.equal(a[n], b[n])]
        return float("inf") if bad or set(a) != set(b) else 0.0

    def step_checked(self, state, xs):
        if not first_of_shard("nfa_step"):
            return real_step(self, state, xs)
        s_in = {n: v.clone() for n, v in state.items()}
        x_in = {n: v.clone() for n, v in xs.items()}
        s_out, ys = real_step(self, state, xs)
        s_want, y_want = self._plain(s_in, x_in)
        torch.cuda.synchronize()
        checks["nfa_step"].append(max(tree_err(s_out, s_want), tree_err(ys, y_want)))
        inputs["nfa_step"].append((s_in, x_in, s_out, ys))
        return s_out, ys

    def mark_checked(self, marked, frontier, pred):
        if not first_of_shard("gc_mark"):
            return real_mark(self, marked, frontier, pred)
        m_in, f_in = marked.clone(), frontier.contiguous().clone()
        got = real_mark(self, marked, frontier, pred)
        want = gk._walk(m_in, f_in, pred)
        torch.cuda.synchronize()
        checks["gc_mark"].append(tree_err({"m": got}, {"m": want}))
        inputs["gc_mark"].append((m_in, f_in, pred, got))
        return got

    def sweep_checked(self, marked, marked_pin, state, pool, ys):
        if not first_of_shard("gc_sweep"):
            return real_sweep(self, marked, marked_pin, state, pool, ys)
        args = (marked.clone(), marked_pin.clone(),
                {n: state[n].contiguous().clone() for n in gs.STATE_OUT},
                {n: v.clone() for n, v in pool.items()},
                {n: ys[n].contiguous().clone() for n in gs.WINDOW_PLANES})
        got = real_sweep(self, marked, marked_pin, state, pool, ys)
        want = gs._sweep(*args)
        torch.cuda.synchronize()
        checks["gc_sweep"].append(tree_err(got, want))
        inputs["gc_sweep"].append((args, want))
        return got

    # The sharded main path: counts zeroed just before, read just after.
    sk.NfaStep.__call__, gk.GcMark.__call__ = step_checked, mark_checked
    gs.GcSweep.__call__ = sweep_checked
    sharded = P.BatchedDeviceNFA(flag_q, keys=keys, config=flag_cfg, mesh=mesh, engine="cuda")
    try:
        sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
        m_mesh, walls, _ = timed_run(sharded)
        launches = {"nfa_step": sk.NfaStep.launches, "gc_mark": gk.GcMark.launches,
                    "gc_sweep": gs.GcSweep.launches}
        flushes = sharded.flushes
    finally:
        sk.NfaStep.__call__, gk.GcMark.__call__ = real_step, real_mark
        gs.GcSweep.__call__ = real_sweep
    for name, n in launches.items():
        launched(f"mesh {name}", n)
    if launches["nfa_step"] != n_batches * mesh.size:
        raise AssertionError(f"nfa_step launched {launches['nfa_step']} times for "
                             f"{n_batches} advances on {mesh.size} shards")
    if launches["gc_mark"] != flushes * mesh.size or launches["gc_sweep"] != flushes * mesh.size:
        raise AssertionError(f"gc_mark {launches['gc_mark']} / gc_sweep {launches['gc_sweep']} "
                             f"launches for {flushes} flushes on {mesh.size} shards")
    for name, errs in checks.items():
        if len(errs) != mesh.size or any(errs):
            raise AssertionError(f"mesh: {name} != its plain version on a shard's first "
                                 f"launch (errors {errs}, {mesh.size} shards)")
    no_drops("mesh", sharded)

    # The unsharded engine on the same batches, in the same phase: matches
    # (phase 4's where given), the snapshot frame and events/s.
    whole = P.BatchedDeviceNFA(flag_q, keys=keys, config=flag_cfg, engine="cuda")
    m_whole, whole_walls, two_flush_matches = timed_run(whole)
    for label, ref in (("the unsharded run's", m_whole), ("phase 4's", ref_matches)):
        if ref is not None and m_mesh != ref:
            bad = [k for k in keys if m_mesh.get(k) != ref.get(k)]
            raise AssertionError(f"mesh: matches differ from {label} on {len(bad)} keys")
    blob_whole = whole.snapshot()
    del whole
    if sharded.snapshot() != blob_whole:
        raise AssertionError("mesh: the sharded engine's snapshot != the unsharded engine's")
    del sharded, blob_whole
    eps = n_timed * K * T / sum(walls.values())
    whole_eps = n_timed * K * T / sum(whole_walls.values())
    log(f"mesh: {n_timed * K * T} events in {n_timed} timed batches, {eps:.0f} events/s end "
        f"to end on {mesh.size} shards, {whole_eps:.0f} unsharded in this phase (phase 4: "
        f"{unsharded_eps or 0:.0f}); ms per batch sharded / unsharded: " + ", ".join(
            f"{k} {v / n_timed * 1e3:.2f} / {whole_walls[k] / n_timed * 1e3:.2f}"
            for k, v in walls.items())
        + f"; matches == the unsharded run's per key"
        + (" == phase 4's" if ref_matches is not None else "")
        + f", drops 0, snapshot frame == the unsharded engine's, launches {launches} "
        f"({flushes} group flushes: per flush nfa_step {mesh.size}, gc_mark {mesh.size}, "
        f"gc_sweep {mesh.size}); every kernel == its plain version on each shard's first "
        f"launch")

    # Each kernel a shard launch, on the inputs of the shard's first launch.
    rows = {n: [] for n in checks}
    for sh, dev_s in enumerate(mesh.devices):
        with torch.cuda.device(dev_s):
            s_in, x_in, s_out, ys = inputs["nfa_step"][sh]
            ptrs, T_, K_, _s, _y, keep = sk.prepare(flag_q, flag_cfg, s_in, x_in, words)
            ms = cuda_ms(lambda: sk.call(flag_lib, ptrs, T_, K_, dev_s), reps=20)
            moved = bytes_moved(s_in, s_out, ys, keep)
            rows["nfa_step"].append(dict(
                shard=sh, device=str(dev_s), K=K_, ms=ms, bytes=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, max_abs_err=checks["nfa_step"][sh]))
            del _s, _y, keep
            m_in, f_in, pr, got = inputs["gc_mark"][sh]
            BW, Kk = pr.shape
            moved = 2 * m_in.numel() + f_in.numel() * 4 + int((got[:BW] & ~m_in[:BW]).sum()) * 4
            ms = cuda_ms(lambda: gk.launch(gc_lib, m_in, f_in, pr), reps=20)
            rows["gc_mark"].append(dict(
                shard=sh, device=str(dev_s), K=Kk, BW=BW, ms=ms, bytes=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, max_abs_err=checks["gc_mark"][sh]))
            args, want = inputs["gc_sweep"][sh]
            moved = sweep_bytes(args[0], args[2], args[3], want)
            ms = cuda_ms(lambda: gs.launch(sweep_lib, *args), reps=20)
            rows["gc_sweep"].append(dict(
                shard=sh, device=str(dev_s), K=Kk, ms=ms, bytes=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, max_abs_err=checks["gc_sweep"][sh]))
    del inputs
    for name, rs in rows.items():
        log(f"mesh {name}, ms a shard launch (CUDA events, its first inputs): " + "; ".join(
            f"shard {r['shard']} on {r['device']} {r['ms']:.4f} (bound {r['bound_ms']:.4f})"
            for r in rs))

    # 0 host syncs over 8 deferred sharded advances (pre-packed, a ring of
    # 8 pages: no drain is due).
    deferred = P.BatchedDeviceNFA(flag_q, keys=keys, mesh=mesh, engine="cuda",
                                  config=replace(flag_cfg, matches=n_timed * flag_cfg.matches))
    xs_list = [deferred.pack(batch_of(b)) for b in range(n_timed)]
    torch.cuda.synchronize()

    def deferred_advances():
        for xs_ in xs_list:
            deferred.advance_packed(xs_, decode=False)

    syncs = count_syncs(deferred_advances)
    deferred.drain()
    no_drops("mesh deferred", deferred)
    if syncs:
        raise AssertionError(f"{syncs} host syncs over {n_timed} deferred sharded advances")
    del deferred, xs_list

    # A sharded runtime="cuda" topology over 2 flushes: its sink equals the
    # unsharded topology's (phase 5's first two flushes where given).
    def topology_sink(mesh_):
        sink_log = P.RecordLog()
        builder = P.ComplexStreamsBuilder(log=sink_log)
        out = builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda",
            config=P.EngineConfig(**skip_any.FLAGSHIP_CONFIG), batch_size=K * T,
            initial_keys=K, mesh=mesh_, engine="cuda").to("matches")
        topo = builder.build()
        t0 = time.perf_counter()
        for b in range(2):
            for key, e in ((k, streams[k][b * T + t]) for t in range(T) for k in keys):
                topo.process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)
        wall = time.perf_counter() - t0
        if out.node.processor.engine.n_shards != (1 if mesh_ is None else mesh_.size):
            raise AssertionError("the topology's engine has the wrong shard count")
        return [(r.key, r.value) for r in sink_log.read("matches")], wall

    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    mesh_sink, topo_s = topology_sink(mesh)
    topo_launches = {"nfa_step": launched("mesh topology", sk.NfaStep.launches),
                     "gc_mark": launched("mesh topology gc_mark", gk.GcMark.launches),
                     "gc_sweep": launched("mesh topology gc_sweep", gs.GcSweep.launches)}
    ref = ref_sink[:two_flush_matches] if ref_sink is not None else topology_sink(None)[0]
    if len(mesh_sink) != two_flush_matches or mesh_sink != ref:
        raise AssertionError(f"mesh topology: {len(mesh_sink)} sink records, not the unsharded "
                             f"topology's first two flushes' ({two_flush_matches})")
    log(f"mesh topology: 2 flushes of {K * T} records, {2 * K * T / topo_s:.0f} records/s, "
        f"sink == the unsharded topology's" + (" (phase 5's first two flushes)"
                                                if ref_sink is not None else "")
        + f", {two_flush_matches} records; launches {topo_launches}")
    dry = dryrun_multichip(mesh.size)
    wall = time.perf_counter() - t_mesh
    log(f"mesh: dryrun on {dry['mesh']}: merged n_events {dry['n_events']}, runs per device "
        f"{dry['runs_per_device']}; host syncs over {n_timed} deferred sharded advances "
        f"{syncs}; phase {wall:.1f}s")
    return {n: {"shards": mesh.size, "devices": [str(d) for d in mesh.devices],
                "distinct_devices": mesh.distinct, "virtual": mesh.virtual,
                "launches": launches[n], "launches_per_flush": launches[n] / flushes,
                "topology_launches": topo_launches[n],
                "max_abs_err": max(r["max_abs_err"] for r in rows[n]),
                "ms": max(r["ms"] for r in rows[n]),
                "bound_ms": max(r["bound_ms"] for r in rows[n]),
                "bound_by": "bytes", "library_ms": None, "per_shard": rows[n],
                "events_per_s": eps, "unsharded_events_per_s": whole_eps,
                "phase4_events_per_s": unsharded_eps,
                "host_syncs_deferred": syncs, "phase_s": wall}
            for n in rows}


def run_mesh_entry() -> dict:
    """Phase 26 alone, with its own references (an unsharded run and an
    unsharded 2-flush topology), on every visible card: `python3 -c
    "import chip_smoke; chip_smoke.run_mesh_entry()"`. Prints each card's
    name and power limit and the kernels' `mesh` entries as JSON."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"cards: {out.splitlines()}; torch {torch.__version__}")
    flag_q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    flag_cfg = P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    rng = random.Random(7)
    keys = [f"k{i}" for i in range(skip_any.FLAGSHIP_KEYS)]
    streams = {k: skip_any.skip_any8_stream(rng, skip_any.FLAGSHIP_T * 10) for k in keys}
    entry = mesh_phase(flag_q, flag_cfg, streams, 2, 8)
    print(json.dumps({"mesh": entry}))
    return entry


#: Phase 27's kernel-build audit in `audit_child`: (epochs, batches an
#: epoch) of the same-shape replay, of the mesh replay (several cards)
#: and of the seeded capacity churn.
AUDIT_REPLAY, AUDIT_MESH, AUDIT_CHURN = (2, 1), (1, 1), (1, 1)
#: Phase 27's lock-monitored topology: polls, and events a key a poll
#: (each poll one flush of the flagship's 2048 keys).
LOCKMON_POLLS, LOCKMON_T = 2, 16
#: Lines of a failed phase-27 child printed before chip_smoke exits.
CHILD_TAIL = 60


def watch_first_launches():
    """`watch_kernels` for the first launch of each kernel on the card
    once the returned `arm` has been called. Returns (checks, arm,
    restore): `checks` fills with {kernel: {"shape", "max_abs_err"}}."""
    checks, armed = {}, [False]

    def fresh(name, key, device):
        if not armed[0] or device.type != "cuda" or name in checks:
            return False
        checks[name] = {"shape": None, "max_abs_err": None}
        return True

    def record(name, shape, err):
        checks[name] = {"shape": shape, "max_abs_err": err}

    def arm():
        armed[0] = True

    return checks, arm, watch_kernels(fresh, record)


def kernel_launches() -> dict:
    from kafkastreams_cep_tpu_torch.ops import gc_kernel, gc_sweep, step_kernel

    return {"nfa_step": step_kernel.NfaStep.launches, "gc_mark": gc_kernel.GcMark.launches,
            "gc_sweep": gc_sweep.GcSweep.launches}


def audit_child() -> None:
    """Phase 27 (b), in a child process: the kernel-build audit at the
    flagship width on the card. The same-shape replay must move no
    counter (compiles, builds, modules) and launch every kernel, the first
    replay launch of each bitwise to its plain version; with several
    cards it runs again on `key_mesh()` over all of them; the seeded
    capacity churn must report CEP-J01. Prints one `AUDIT {json}` line;
    exits 1 (cause on stderr) when a check fails."""
    from kafkastreams_cep_tpu_torch.analysis.kernel_audit import run_kernel_build_audit

    out, failures = {}, []
    checks, arm, restore = watch_first_launches()
    at_warm = {}

    def on_warm():
        at_warm.update(kernel_launches())
        arm()

    t0 = time.perf_counter()
    report = {}
    epochs, per_epoch = AUDIT_REPLAY
    found = run_kernel_build_audit(device="cuda", epochs=epochs, batches_per_epoch=per_epoch,
                                   on_warm=on_warm, report=report)
    restore()
    end = kernel_launches()
    out["replay"] = report
    out["launches"] = end
    out["replay_launches"] = {n: end[n] - at_warm[n] for n in end}
    out["first_replay_launch"] = checks
    out["replay_s"] = time.perf_counter() - t0
    failures += [f.render() for f in found]
    for name in end:
        if end[name] <= 0 or out["replay_launches"][name] <= 0:
            failures.append(f"{name} was not launched in the replay ({out['replay_launches']})")
        row = checks.get(name)
        if row is None or row["max_abs_err"] != 0:
            failures.append(f"{name}: first replay launch vs its plain version: {row}")
    if torch.cuda.device_count() > 1:
        from kafkastreams_cep_tpu_torch.parallel import key_mesh

        t0 = time.perf_counter()
        mesh_report = {}
        epochs, per_epoch = AUDIT_MESH
        found = run_kernel_build_audit(mesh=key_mesh(), epochs=epochs,
                                       batches_per_epoch=per_epoch, report=mesh_report)
        out["mesh"] = dict(mesh_report, seconds=time.perf_counter() - t0)
        failures += [f.render() for f in found]
    t0 = time.perf_counter()
    epochs, per_epoch = AUDIT_CHURN
    churn = run_kernel_build_audit(device="cuda", epochs=epochs, batches_per_epoch=per_epoch,
                                   vary_shapes=True)
    out["churn"] = [f.render() for f in churn]
    out["churn_s"] = time.perf_counter() - t0
    if not churn or any(f.code != "CEP-J01" for f in churn):
        failures.append(f"the seeded capacity churn reported {out['churn']} (want CEP-J01)")
    print("AUDIT " + json.dumps(out), flush=True)
    if failures:
        print("kernel audit failed:\n" + "\n".join(failures), file=sys.stderr)
        sys.exit(1)


def lockmon_child() -> None:
    """Phase 27 (c), in a child process: the port's lock monitor armed
    around a short flagship `runtime="cuda"` topology pumped by a
    `LogDriver` with its introspection plane served (the serve, clock and
    profile threads), a `MetricsScraper` over HTTP and the engine's decode
    worker, all running together; then a seeded two-lock inversion in
    the same process. The topology must show no lock-order cycle and the
    inversion must be reported. Prints one `LOCKMON {json}` line; exits 1
    (cause on stderr) when a check fails."""
    import urllib.request

    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.analysis.lockmon import lock_monitor
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.obs.scrape import MetricsScraper

    K, T = skip_any.FLAGSHIP_KEYS, LOCKMON_T
    rng = random.Random(7)
    keys = [f"k{i}" for i in range(K)]
    streams = {k: skip_any.skip_any8_stream(rng, T * LOCKMON_POLLS) for k in keys}
    out, failures, reports = {}, [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lockmon_") as tmp:
        log = P.RecordLog(tmp)
        for b in range(LOCKMON_POLLS):
            for t in range(T):
                for k in keys:
                    e = streams[k][b * T + t]
                    P.produce(log, "letters", k, e.value, timestamp=e.timestamp)
        with lock_monitor() as mon:
            reg = P.MetricsRegistry()
            builder = P.ComplexStreamsBuilder(log=log)
            builder.stream("letters").query(
                "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda",
                config=P.EngineConfig(**skip_any.FLAGSHIP_CONFIG), batch_size=K * T,
                initial_keys=K, registry=reg,
            ).to("matches")
            driver = P.LogDriver(builder.build(), group="g", registry=reg,
                                 report_every_s=0.05, reporter=reports.append)
            http = driver.serve_http(port=0)
            http.profile_dir = f"{tmp}/profile"
            scraper = MetricsScraper(url=http.url, every_s=0.05).start()
            threads = set()
            for poll in range(LOCKMON_POLLS):
                if poll == 1:
                    with urllib.request.urlopen(http.url + "/profilez?secs=0.2") as r:
                        out["profilez"] = json.loads(r.read())
                    threads |= {t.name for t in threading.enumerate()}
                driver.poll(max_records=K * T)
                threads |= {t.name for t in threading.enumerate()}
                for path in ("/metrics", "/healthz"):
                    with urllib.request.urlopen(http.url + path) as r:
                        r.read()
            driver.commit()
            scraper.stop()
            driver.close()
            torch.cuda.synchronize()
        out["records"] = log.end_offset("letters")
        out["matches"] = log.end_offset("matches")
        log.close()
    cycles = mon.cycles()
    nodes = {site for edge in mon.edges for site in edge}
    out.update(edges=len(mon.edges), edge_sites=len(nodes), lock_sites=len(mon.sites),
               acquires=mon.acquires, cycles=cycles, scrapes=scraper.scrapes,
               reports=len(reports), threads=sorted(threads),
               seconds=time.perf_counter() - t0)
    want = ("kct-introspect-http", "kct-introspect-clock", "kct-introspect-profile",
            "kct-soak-scraper", "cep-decode")
    missing = [w for w in want if not any(name.startswith(w) for name in threads)]
    if cycles:
        failures.append("lock-order cycle(s) in the topology run:\n" + mon.report())
    if missing:
        failures.append(f"threads never seen running together: {missing} (saw {sorted(threads)})")
    if out["matches"] <= 0 or scraper.scrapes <= 0 or not reports:
        failures.append(f"the topology run did no work: {out}")
    # The seeded inversion, in the same process: a -> b on one thread,
    # b -> a on another (in turn, so nothing deadlocks).
    with lock_monitor() as seeded:
        a = threading.Lock()
        b = threading.Lock()

        def inverted():
            with b:
                with a:
                    pass

        with a:
            with b:
                pass
        worker = threading.Thread(target=inverted, name="chip-smoke-inversion")
        worker.start()
        worker.join()
    out["seeded_cycles"] = seeded.cycles()
    if not any(len(set(c)) == 2 for c in out["seeded_cycles"]):
        failures.append("the seeded two-lock inversion was not reported:\n" + seeded.report())
    print("LOCKMON " + json.dumps(out), flush=True)
    if failures:
        print("lock monitor check failed:\n" + "\n".join(failures), file=sys.stderr)
        sys.exit(1)


def gate_cause(stdout: str) -> str:
    """The static gate's active findings, one line each, from its --json
    output (a long list of audited findings would push them out of the
    tail)."""
    try:
        doc = json.loads(stdout)
    except ValueError:
        return ""
    lines = [f"{f['path']}:{f['line']}: {f['code']} [{f['checker']}] {f['message']}"
             for f in doc.get("findings", ()) if not f["suppressed"] and not f["baselined"]]
    return f"the gate's {len(lines)} active finding(s):\n" + "\n".join(lines)


#: {check name: fn(stdout) -> its cause in a few lines}, printed after a
#: failed child's tail.
CHILD_CAUSE = {"static_gate": gate_cause}


def child_failed(phase: int, name: str, rc, stdout, stderr) -> None:
    """Print a failed child's cause on stderr -- the phase, the check, its
    last CHILD_TAIL lines and, for a check in CHILD_CAUSE, the cause it
    names -- and exit 1."""
    stdout, stderr = (x.decode(errors="replace") if isinstance(x, bytes) else (x or "")
                      for x in (stdout, stderr))
    tail = "\n".join((stdout + "\n" + stderr).splitlines()[-CHILD_TAIL:])
    cause = CHILD_CAUSE[name](stdout) if name in CHILD_CAUSE else ""
    print(f"chip_smoke: phase {phase} check {name} failed (exit {rc}); its last "
          f"{CHILD_TAIL} lines:\n{tail}" + (f"\n{cause}" if cause else ""),
          file=sys.stderr, flush=True)
    sys.exit(1)


def run_children(phase: int, argvs: dict, timeout: float) -> tuple:
    """Run each {name: argv} as a child process from the repo root, all
    at once, their output in files. Returns ({name: stdout}, {name: its
    seconds}). When one exits non-zero or the `timeout` passes, the others
    are killed and the failed one's cause printed (exit 1)."""
    root = str(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_children_") as tmp:
        procs, files, walls = {}, {}, {}
        t0 = time.perf_counter()
        try:
            for name, argv in argvs.items():
                files[name] = (open(f"{tmp}/{name}.out", "w+"), open(f"{tmp}/{name}.err", "w+"))
                procs[name] = subprocess.Popen(argv, cwd=root, stdout=files[name][0],
                                               stderr=files[name][1], text=True)
            failed = None
            while len(walls) < len(procs) and failed is None:
                time.sleep(0.1)
                for name, proc in procs.items():
                    if name not in walls and proc.poll() is not None:
                        walls[name] = time.perf_counter() - t0
                        if proc.returncode != 0:
                            failed = (name, proc.returncode)
                if failed is None and time.perf_counter() - t0 > timeout:
                    failed = (next(n for n in procs if n not in walls), f"timeout {timeout:.0f}s")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        texts = {}
        for name, (out, err) in files.items():
            out.seek(0)
            err.seek(0)
            texts[name] = (out.read(), err.read())
            out.close()
            err.close()
    if failed is not None:
        child_failed(phase, failed[0], failed[1], *texts[failed[0]])
    return {n: t[0] for n, t in texts.items()}, walls


def tagged(stdout: str, tag: str) -> dict:
    return json.loads(next(line for line in stdout.splitlines()
                           if line.startswith(tag + " "))[len(tag) + 1:])


def analysis_phase(phase: int) -> dict:
    """Phase 27: the port's analysis on the card, three checks, each in a
    child process of its own, the three run at once (a failed one prints
    its cause and ends the script; the others are stopped): (a) the static
    gate, `python -m kafkastreams_cep_tpu_torch.analysis --all --json`,
    must exit 0 with no active finding; (b) `audit_child`; (c)
    `lockmon_child`. Returns the three children's results."""
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    child = f"import sys; sys.path.insert(0, {str(root)!r}); import chip_smoke; chip_smoke."
    outs, walls = run_children(phase, {
        "kernel_audit": [sys.executable, "-c", child + "audit_child()"],
        "lock_monitor": [sys.executable, "-c", child + "lockmon_child()"],
        "static_gate": [sys.executable, "-m", "kafkastreams_cep_tpu_torch.analysis", "--all",
                        "--json"],
    }, 300)
    doc = json.loads(outs["static_gate"])
    if doc["active"] != 0:
        child_failed(phase, "static_gate", f"{doc['active']} active finding(s)",
                     outs["static_gate"], "")
    perf_md = root / "PERF.md"
    gate_res = {"active": doc["active"], "audited": sum(f["suppressed"] for f in doc["findings"]),
                "roots": doc["roots"],
                "perf_md_copy_checked": perf_md.exists() and "<!-- ceplint-torch:metrics-"
                "dictionary:begin -->" in perf_md.read_text(encoding="utf-8")}
    audit = tagged(outs["kernel_audit"], "AUDIT")
    lockmon = tagged(outs["lock_monitor"], "LOCKMON")
    rep = audit["replay"]
    log(f"analysis gate: exit 0, {gate_res['active']} active finding(s), "
        f"{gate_res['audited']} pragma-audited, roots {gate_res['roots']}; PERF.md's copy "
        f"of the metrics dictionary checked: {gate_res['perf_md_copy_checked']}")
    log(f"kernel audit at K={rep['keys']} T={rep['T']} lanes {rep['lanes']} nodes {rep['nodes']}"
        f" matches {rep['matches']} on {rep['device']}: counters after the warm epoch "
        f"{rep['warm']}, after each replay epoch {rep['epochs']}; replay launches "
        f"{audit['replay_launches']} (all {audit['launches']}); first replay launch vs plain "
        f"{audit['first_replay_launch']}; {rep['matches_drained']} matches drained; replay "
        f"{audit['replay_s']:.1f}s; seeded churn {audit['churn_s']:.1f}s: {audit['churn']}"
        + (f"; mesh {audit['mesh']}" if "mesh" in audit else ""))
    log(f"lock monitor over the flagship topology ({lockmon['records']} records, "
        f"{lockmon['matches']} matches, threads {lockmon['threads']}): {lockmon['cycles']} "
        f"cycle(s), {lockmon['edges']} edge(s) over {lockmon['edge_sites']} site(s), "
        f"{lockmon['lock_sites']} lock site(s), {lockmon['acquires']} acquires, "
        f"{lockmon['scrapes']} scrapes, {lockmon['reports']} reports, profilez "
        f"{lockmon['profilez']}; seeded inversion: {lockmon['seeded_cycles']}")
    wall = time.perf_counter() - t_phase
    log(f"phase {phase} {wall:.1f}s (children started together; each ended after "
        + ", ".join(f"{n} {w:.1f}s" for n, w in walls.items()) + ")")
    return {"gate": gate_res, "audit": audit, "lockmon": lockmon, "phase_s": wall,
            "child_s": walls}


def run_analysis_entry() -> dict:
    """Phase 27 alone on the card: builds the flagship's step kernel and
    its grown shape (the seeded churn's) and the GC kernels in parallel,
    then runs the phase: `python3 -c "import chip_smoke;
    chip_smoke.run_analysis_entry()"`."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk
    from kafkastreams_cep_tpu_torch.ops import gc_sweep as gs
    from kafkastreams_cep_tpu_torch.ops import step_kernel as sk

    log(f"card: {card_line()}")
    q = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    cfg = P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    with ThreadPoolExecutor(max_workers=4) as ex:
        futs = [ex.submit(sk.build_library, q, cfg),
                ex.submit(sk.build_library, q, replace(cfg, lanes=2 * cfg.lanes,
                                                       nodes=2 * cfg.nodes)),
                ex.submit(gk.build_library), ex.submit(gs.build_library)]
        for f in futs:
            f.result()
    out = analysis_phase(27)
    print(json.dumps({"analysis": {"gate": out["gate"], "phase_s": out["phase_s"]}}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models import skip_any
    from kafkastreams_cep_tpu_torch.models.cases import CASES, STOCK_FIELDS, branchy_case
    from kafkastreams_cep_tpu_torch.models.chunked import CHUNKED, CHUNKED_T, scatter_live_lanes
    from kafkastreams_cep_tpu_torch.models import cases as cases_models
    from kafkastreams_cep_tpu_torch.models import stacked as stacked_models
    from kafkastreams_cep_tpu_torch import native
    from kafkastreams_cep_tpu_torch.models.stocks import (
        GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
    )
    from kafkastreams_cep_tpu_torch.ops import engine as engine_mod
    from kafkastreams_cep_tpu_torch.ops import gc_kernel as gk
    from kafkastreams_cep_tpu_torch.ops import gc_sweep as gs
    from kafkastreams_cep_tpu_torch.ops import step_kernel as sk
    from kafkastreams_cep_tpu_torch.ops.engine import DROP_COUNTER_KEYS
    from kafkastreams_cep_tpu_torch.ops.step import build_plain_step
    from kafkastreams_cep_tpu_torch.parallel.batched import land_table, pow2_at_least
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
    # Phase 18's arm shape (its grown shapes build when the autosizer
    # resizes, inside the phase).
    arm_cfg = replace(flag_cfg, lanes=224, nodes=2048, matches=8 * flag_cfg.matches, gc_group=4)
    builds["skip_any8_arm"] = (flag_q, arm_cfg, None)
    gold_q = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    gold_cfg = P.EngineConfig(lanes=32, nodes=512, matches=64)
    builds["stock_golden"] = (gold_q, gold_cfg, None)
    # Phase 13's fold query: tests/test_torch_replay.py's kind at K = 2048.
    fold_keys = [f"k{i}" for i in range(skip_any.FLAGSHIP_KEYS)]
    fold_pattern, fold_streams = branchy_case(65, fold_keys)
    fold_q = P.compile_query(P.compile_pattern(fold_pattern), None)
    fold_cfg = P.EngineConfig(lanes=256, nodes=4096, matches=2048, matches_per_step=256)
    builds["branchy_fold"] = (fold_q, fold_cfg, None)
    # Phase 20's config 4 (the stacked letter queries and each on its own,
    # at the EngineConfig defaults the autosizer starts from) and phase
    # 21's wide stack (eight rotations of the flagship pattern, eight times
    # its capacity) and each rotation on its own at the flagship's. Phase
    # 22's DeviceNFA runs the flagship's and the stock golden's builds.
    c4_cfg = P.EngineConfig(pin_interval=True)
    c4_q = P.compile_multi_query(stacked_models.letter_queries())
    builds["config4_stacked"] = (c4_q, c4_cfg, None)
    c4_solo = {}
    for qname, pattern in stacked_models.letter_queries():
        c4_solo[qname] = P.compile_query(P.compile_pattern(pattern), None)
        builds[f"config4_{qname}"] = (c4_solo[qname], c4_cfg, None)
    wide_q = P.compile_multi_query(stacked_models.rotated_skip_any_queries())
    # digits = the flagship's own Dewey width (a run's version grows only
    # through its own query's 9 stages); the default would be 72 + 2.
    wide_cfg = replace(flag_cfg, lanes=8 * flag_cfg.lanes, nodes=8 * flag_cfg.nodes,
                       matches=8 * flag_cfg.matches,
                       matches_per_step=8 * flag_cfg.matches_per_step,
                       nodes_per_step=8 * flag_cfg.nodes_per_step,
                       digits=flag_cfg.dewey_width(flag_q))
    builds["wide_stack"] = (wide_q, wide_cfg, None)
    rot_q = {}
    for qname, pattern in stacked_models.rotated_skip_any_queries():
        rot_q[qname] = P.compile_query(P.compile_pattern(pattern), None)
        builds[f"rotation_{qname}"] = (rot_q[qname], flag_cfg, None)
    # The widest masks, at tests/test_torch_step.py's shapes: letter queries
    # stacked to 256 stages and 193 predicates (4 words of each), and
    # seventeen flagship rotations, 153 stages and 255 predicates (3 and 4).
    builds["stack256"] = (
        P.compile_multi_query(stacked_models.boundary_queries(256)),
        P.EngineConfig(lanes=128, nodes=2048, matches=1024, matches_per_step=128,
                       nodes_per_step=128), cases_models.letters_stream)
    builds["rotations17"] = (
        P.compile_multi_query(stacked_models.rotated_skip_any_queries(17)),
        replace(flag_cfg, lanes=512, matches_per_step=128, nodes_per_step=512),
        skip_any.skip_any8_stream)
    # Phase 25's soak: its hotspot query at its engine's shape (the
    # subprocess finds the library built).
    from kafkastreams_cep_tpu_torch.faults import soak as soak_mod
    from kafkastreams_cep_tpu_torch.streams.device_processor import DeviceCEPProcessor

    # Phase 26's dryrun (the stock query at its tiny shape).
    from kafkastreams_cep_tpu_torch.parallel.dryrun import dryrun_query

    builds["mesh_dryrun"] = (*dryrun_query(), None)
    hot = soak_mod.build_fleet(0, "mixed", True, device="cpu")[0]
    hot_eng = DeviceCEPProcessor(hot.query, hot.pattern_fn(), **hot.query_opts).engine
    builds["soak_hotspot"] = (hot_eng.query, hot_eng.config, None)
    del hot, hot_eng

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
        sweep_fut = ex.submit(timed_build, gs.build_library)
        kernel_builds = {n: f.result() for n, f in futs.items()}
        nat_builds = {n: f.result() for n, f in nat_futs.items()}
        gc_path, gc_build_s = gc_fut.result()
        sweep_path, sweep_build_s = sweep_fut.result()
    libs = {n: path for n, (path, _sec) in kernel_builds.items()}
    build_s = time.perf_counter() - t0
    log(f"built {len(libs)} step kernels, the GC mark and sweep kernels and the native "
        f"packer, decoder and CRC-32C in {build_s:.1f}s (nvcc and g++, in parallel); nvcc "
        f"seconds of the flagship {kernel_builds['skip_any8'][1]:.1f}, of its grown shape "
        f"(lanes 640, nodes 16384) {kernel_builds['skip_any8_grown'][1]:.1f}, of gc_mark "
        f"{gc_build_s:.1f} and of gc_sweep {sweep_build_s:.1f}; g++ seconds: " + ", ".join(
            f"{n} {sec:.2f} ({path.name})" for n, (path, sec) in nat_builds.items())
        + f"; Python headers: {native.python_include()}")
    ptxas = {}
    for name, path in (("skip_any8", libs["skip_any8"]), ("wide_stack", libs["wide_stack"]),
                       ("stack256", libs["stack256"]), ("rotations17", libs["rotations17"]),
                       ("gc_mark", gc_path), ("gc_sweep", sweep_path)):
        ptxas[name] = [line.strip() for line in path.with_suffix(".log").read_text().splitlines()
                       if "registers" in line or "spill" in line or "smem" in line]
        for line in ptxas[name]:
            log(f"ptxas[{name}]: {line}")
    gc_lib = gk.load_library(gc_path)
    sweep_lib = gs.load_library(sweep_path)
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
    envelope = {}
    for name, seed in (("stack256", 5), ("rotations17", 7)):
        q, cfg, stream = builds[name]
        err, live = compare(name, q, cfg, trajectory(name, q, cfg, stream, 8, CHUNKED_T, 2, seed))
        envelope[name] = dict(stages=q.n_stages, predicates=q.n_preds,
                              mask_words=[-(-q.n_stages // 64), -(-q.n_preds // 64)],
                              max_abs_err=err, ptxas=ptxas[name])
        log(f"kernel == plain on the card: {name} ({q.n_stages} stages, {q.n_preds} predicates; "
            f"K=8, T={CHUNKED_T}, 2 batches; up to {live} of {cfg.lanes} live lanes in a key)")
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
        lens = []  # matches per key after each batch
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

        def decode_and_check(raw, trigger="drain", events=None):
            # On the decode worker: the drain joins it, so its walls fall
            # inside the drain's.
            out = decode(raw, trigger, events)
            if check_host:
                t = time.perf_counter()
                clock_on, gc_clock.on = gc_clock.on, False
                counts = raw["counts"].astype("int32")
                planes = [raw["table"][i].transpose(2, 0, 1) for i in range(3)]
                ref = eng._decode_flat_python(counts, *planes, events)
                if seqs_json(out) != seqs_json(ref):
                    raise AssertionError("native decode != Python decode of a drained table")
                decode_checks[0] += 1
                gc_clock.on = clock_on
                excluded[0] += time.perf_counter() - t
            return out

        eng._decode_flat = decode_and_check
        torch.cuda.synchronize()
        gc_clock = GcClock()
        sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
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
                lens.append({key: len(v) for key, v in matches.items()})
                live_ends.append(eng.state["active"].sum(0))
                lanes_peak = max(lanes_peak, int(live_ends[-1].max()))
                nodes_peak = max(nodes_peak, int(eng.pool["node_count"].max()))
        launches, gc_launches = sk.NfaStep.launches, gk.GcMark.launches
        sweep_launches = gs.GcSweep.launches
        if check_host and decode_checks[0] != n_batches:
            raise AssertionError(f"{decode_checks[0]} decode checks for {n_batches} drains")
        return dict(eng=eng, matches=matches, adv_s=adv_s, drain_s=drain_s,
                    pack_s=pack_s, launches=launches, gc_launches=gc_launches,
                    sweep_launches=sweep_launches, lanes_peak=lanes_peak,
                    nodes_peak=nodes_peak, phases=phases, live_ends=torch.cat(live_ends),
                    last=last, gc=gc_clock, lens=lens)

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
        f"gc_mark launches {run['gc_launches']}, gc_sweep launches {run['sweep_launches']} "
        f"({run['eng'].flushes} group flushes)")
    log(f"main path: live lanes per key at the {n_batches} batch ends: {spread(run['live_ends'])}")
    if run["launches"] != n_batches:
        raise AssertionError(f"nfa_step launched {run['launches']} times for {n_batches} advances")
    # pin_interval: one walk (the lane walk) per group flush.
    if run["gc_launches"] != run["eng"].flushes or run["gc_launches"] == 0:
        raise AssertionError(f"gc_mark launched {run['gc_launches']} times for "
                             f"{run['eng'].flushes} flushes")
    if run["sweep_launches"] != run["eng"].flushes:
        raise AssertionError(f"gc_sweep launched {run['sweep_launches']} times for "
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
    # Phase 4's matches: the reference of phases 8-10; those of its first
    # POOL_BATCHES batches, phase 23's.
    engine_matches = run.pop("matches")
    del run["eng"]
    pool_ref = {k: v[:n] for k, v in engine_matches.items()
                if (n := run["lens"][POOL_BATCHES - 1].get(k, 0))}

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
        sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
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
                    launches=launches, gc_launches=gc_launches,
                    sweep_launches=gs.GcSweep.launches, routes=routes, gc=gc_clock)

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
        if res["gc_launches"] != proc.engine.flushes or res["gc_launches"] == 0 \
                or res["sweep_launches"] != proc.engine.flushes:
            raise AssertionError(f"{res['gc_launches']} gc_mark and {res['sweep_launches']} "
                                 f"gc_sweep launches for {proc.engine.flushes} group flushes")
        tstats = proc.stats
        drops = {k: tstats[k] for k in DROP_COUNTER_KEYS}
        if any(drops.values()):
            raise AssertionError(f"topology drop counters are not 0: {drops}")
        n_sink = res["log"].end_offset("matches")
        if n_sink != len(out.records):
            raise AssertionError(f"sink holds {n_sink} records for {len(out.records)} matches")
        log(f"topology[{label}]: {len(out.records)} matches, {n_sink} sink records, "
            f"{res['launches']} nfa_step launches for {proc._flushes} flushes, "
            f"{res['gc_launches']} gc_mark and {res['sweep_launches']} gc_sweep launches, "
            f"drops {drops}")

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
    topo_sweep_launches = topo_obj["sweep_launches"]
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
            raise AssertionError(f"{label}: the kernel was not launched")
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
    del sink, order

    # -- 12. the GC mark kernel against the plain walk ------------------------
    def watch_flushes(eng, at):
        """Wrap eng's group flush so that the inputs of its calls numbered in
        `at` (1-based, from now) are kept; the run itself goes on as usual.
        Returns the unwrapped flush and the inputs by call number."""
        flush, count, captured = eng._flush, [0], {}

        def capture(state, pool, ys, roots):
            count[0] += 1
            if count[0] in at:
                captured[count[0]] = (state, pool, ys, roots)
            return flush(state, pool, ys, roots)

        eng._flush = capture
        return flush, captured

    def capture_flushes(cfg, at, n):
        """The inputs of the group flushes numbered in `at` of an engine run
        of n drained batches."""
        eng = new_engine(cfg)
        flush, captured = watch_flushes(eng, at)
        run_batches(eng, 0, n, {})
        return flush, captured

    def gc_calls_of(flush, inputs):
        """The (seed, frontier, pred) of every mark and the inputs of the
        sweep one flush asks for."""
        marks, sweeps = [], []
        real_mark, real_sweep = engine_mod.gc_mark, engine_mod.gc_sweep

        def record_mark(m, f, p):
            marks.append((m, f.contiguous(), p))
            return real_mark(m, f, p)

        def record_sweep(marked, marked_pin, state, pool, ys):
            sweeps.append((marked, marked_pin,
                           {n: state[n].contiguous() for n in gs.STATE_OUT}, pool,
                           {n: ys[n].contiguous() for n in gs.WINDOW_PLANES}))
            return real_sweep(marked, marked_pin, state, pool, ys)

        engine_mod.gc_mark, engine_mod.gc_sweep = record_mark, record_sweep
        try:
            flush(*inputs)
        finally:
            engine_mod.gc_mark, engine_mod.gc_sweep = real_mark, real_sweep
        return marks, sweeps

    def flush_with(mark, sweep, flush, inputs):
        """The flush with the given mark and sweep in place of the kernels."""
        engine_mod.gc_mark, engine_mod.gc_sweep = mark, sweep
        try:
            return flush(*inputs)
        finally:
            engine_mod.gc_mark, engine_mod.gc_sweep = gk.gc_mark, gs.gc_sweep

    mark_rows, sweep_rows, flush_rows, gc_err, sweep_err = [], [], [], 0.0, 0.0

    def check_flush(label, flush, inputs, b, pin_interval):
        """Every gc_mark launch of one captured flush bitwise == `_walk` and
        its gc_sweep launch bitwise == `_sweep` on the same inputs, each
        timed beside its byte bound; then the whole flush with both kernels
        == the same flush with both plain versions, timed beside the flush
        with the mark kernel and the plain sweep. Rows go to mark_rows,
        sweep_rows and flush_rows; returns this flush's (mark rows, sweep
        row)."""
        nonlocal gc_err, sweep_err
        walks, sweeps = gc_calls_of(flush, inputs)
        names = ["lane"] if pin_interval else ["page", "lane"]
        if len(walks) != len(names) or len(sweeps) != 1:
            raise AssertionError(f"{label} flush {b}: {len(walks)} marks and {len(sweeps)} "
                                 f"sweeps, expected {len(names)} and 1")
        rows = []
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
            kpb = int(gc_lib.gc_mark_keys_per_block(BW, Kk))
            smem = int(gc_lib.gc_mark_smem_bytes(BW, Kk))
            rows.append(dict(label=label, batch=b, walk=name, BW=BW, F=f.shape[0], K=Kk,
                             bitmaps="shared" if smem else "global", keys_per_block=kpb,
                             blocks=-(-Kk // kpb), smem_bytes=smem, newly=newly, ms=ms,
                             plain_ms=p_ms, bytes=moved,
                             bound_ms=moved / HBM_BYTES_PER_S * 1e3))
            log(f"gc_mark == _walk bitwise ({label}, flush {b}, {name} walk, BW={BW}, "
                f"F={f.shape[0]}, K={Kk}, {kpb} keys a block, {-(-Kk // kpb)} blocks, "
                f"{'shared' if smem else 'global'}-memory bitmaps ({smem} B a block), "
                f"{newly} newly marked): kernel {ms:.4f} ms, plain {p_ms:.3f} ms, bytes "
                f"{moved} -> bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms "
                f"({moved / HBM_BYTES_PER_S * 1e3 / ms:.1%} of it)")
        mk, mp, st, pl, ys = sweeps[0]
        got = gs.launch(sweep_lib, mk, mp, st, pl, ys)
        want = gs._sweep(mk, mp, st, pl, ys)
        torch.cuda.synchronize()
        bad = [n for n in want if got[n].dtype != want[n].dtype or not torch.equal(got[n], want[n])]
        if bad or set(got) != set(want):
            raise AssertionError(f"gc_sweep != _sweep on {label} batch {b}: {bad}")
        sweep_err = max(sweep_err, max_abs_diff(got, want))
        BW, Kk = mk.shape[0] - 1, mk.shape[1]
        moved = sweep_bytes(mk, st, pl, want)
        s_ms = cuda_ms(lambda: gs.launch(sweep_lib, mk, mp, st, pl, ys), reps=20)
        sp_ms = cuda_ms(lambda: gs._sweep(mk, mp, st, pl, ys), reps=3)
        kpb = int(sweep_lib.gc_sweep_keys_per_block(BW, Kk))
        smem = int(sweep_lib.gc_sweep_smem_bytes(BW, Kk))
        kept = int(want["node_count"].sum())
        sweep_row = dict(label=label, batch=b, BW=BW, K=Kk, B=pl["node_event"].shape[0],
                         kept=kept, bitmaps="shared" if smem else "global",
                         keys_per_block=kpb, blocks=-(-Kk // kpb), smem_bytes=smem, ms=s_ms,
                         plain_ms=sp_ms, bytes=moved, bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        log(f"gc_sweep == _sweep bitwise ({label}, flush {b}, BW={BW}, K={Kk}, {kept} nodes "
            f"kept, {kpb} keys a block, {-(-Kk // kpb)} blocks, {smem} B of shared memory a "
            f"block): kernel {s_ms:.4f} ms, plain {sp_ms:.3f} ms, bytes {moved} -> bound "
            f"{sweep_row['bound_ms']:.4f} ms ({sweep_row['bound_ms'] / s_ms:.1%} of it)")
        k_flush = cuda_ms(lambda: flush(*inputs), reps=5)
        m_flush = cuda_ms(lambda: flush_with(gk.gc_mark, gs._sweep, flush, inputs), reps=2)
        p_flush = cuda_ms(lambda: flush_with(gk._walk, gs._sweep, flush, inputs), reps=2)
        a = flush(*inputs)
        b_ = flush_with(gk._walk, gs._sweep, flush, inputs)
        torch.cuda.synchronize()
        for tree_a, tree_b in zip(a, b_):
            if set(tree_a) != set(tree_b) or any(
                    not torch.equal(tree_a[n], tree_b[n]) for n in tree_a):
                raise AssertionError(f"the flush with the kernels != with the plain versions "
                                     f"({label}, {b})")
        mark_rows.extend(rows)
        sweep_rows.append(sweep_row)
        flush_rows.append(dict(label=label, batch=b, ms=k_flush, plain_ms=p_flush,
                               mark_kernel_plain_sweep_ms=m_flush))
        log(f"group flush ({label}, flush {b}): {k_flush:.3f} ms with gc_mark and gc_sweep, "
            f"{m_flush:.3f} ms with gc_mark and the plain sweep, {p_flush:.3f} ms with both "
            f"plain versions; state and pool equal")
        return rows, sweep_row

    page_cfg = replace(flag_cfg, pin_interval=False)
    for label, cfg, at, n in (("pin_interval", flag_cfg, (3, 10), n_batches),
                              ("pin_interval=False", page_cfg, (3,), 3)):
        flush, captured = capture_flushes(cfg, at, n)
        for b in at:
            check_flush(label, flush, captured[b], b, cfg.pin_interval)
        del captured, flush
    gc_main, sweep_main = mark_rows[0], sweep_rows[0]

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
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    fold_got = {}
    t0 = time.perf_counter()
    for b in range(n_fold):
        for key, seqs in fe.advance(fold_batch(b)).items():
            fold_got.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    fold_launches = launched("fold replay", sk.NfaStep.launches)
    fold_gc_launches = launched("fold replay (gc_mark)", gk.GcMark.launches)
    fold_sweep_launches = launched("fold replay (gc_sweep)", gs.GcSweep.launches)
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
        f"launches {fold_launches}, gc_mark launches {fold_gc_launches}, gc_sweep launches "
        f"{fold_sweep_launches}")
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
        sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
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
                   gc_launches=gc_launches, sweep_launches=gs.GcSweep.launches,
                   drops={k: stats[k] for k in DROP_COUNTER_KEYS},
                   late=metric_total(reg, "cep_late_dropped_total"),
                   overflow=metric_total(reg, "cep_reorder_overflow_dropped_total"),
                   occupancy=gate.occupancy, pair=captured.get("pair"))
        del out, topo, builder, proc, gate
        return res

    def check_gated(res, label):
        if res["launches"] != res["flushes"] or res["gc_launches"] != res["gc_flushes"] \
                or res["gc_launches"] == 0 or res["sweep_launches"] != res["gc_flushes"]:
            raise AssertionError(
                f"gated[{label}]: {res['launches']} nfa_step launches for {res['flushes']} "
                f"flushes, {res['gc_launches']} gc_mark and {res['sweep_launches']} gc_sweep "
                f"launches for {res['gc_flushes']} group flushes")
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
        f"gc_mark launches {gated['gc_launches']} and gc_sweep launches "
        f"{gated['sweep_launches']} for {gated['flushes']} flushes ({gated['gc_flushes']} "
        f"group flushes)")
    del gated_in_order

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
    fleet_arrivals = arrivals[:FLEET_BATCHES * K * T]  # phase 24's
    del shuffled

    class LatencyRecorder:
        """Every match-latency observation of one query (the registry's
        reservoir keeps a recent window only)."""

        def __init__(self, child):
            self.child, self.values = child, []

        def observe(self, v):
            self.values.append(v)
            self.child.observe(v)

    def driver_on(log_, pacing=None):
        reg = MetricsRegistry()
        builder = P.ComplexStreamsBuilder(log=log_)
        out = builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda", config=gated_cfg,
            batch_size=per_flush, initial_keys=K, registry=reg,
        ).to("matches")
        topo = builder.build()
        latency = out.node._m_match_latency = LatencyRecorder(out.node._m_match_latency)
        t = time.perf_counter()
        driver = P.LogDriver(topo, group="g", registry=reg, pacing=pacing)
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

    paced_tmp = tempfile.mkdtemp(prefix="chip_smoke_paced_")
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
        shutil.copytree(whole_dir, f"{paced_tmp}/log")  # phase 19's
        del arrivals

        # The uninterrupted run: the reference sink.
        sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
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
        drv_sweep_launches = launched("LogDriver (gc_sweep)", gs.GcSweep.launches)
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
        sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
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
        f" nfa_step launches {drv_launches}, gc_mark launches {drv_gc_launches}, gc_sweep "
        f"launches {drv_sweep_launches}")
    log(f"LogDriver restart after poll {restart_after} (last commit after poll "
        f"{restart_after // polls_per_commit * polls_per_commit}): log reload "
        f"{(t1 - t0) * 1e3:.1f} ms, topology + LogDriver with restore {init_s * 1e3:.1f} ms "
        f"({restored} changelog records), resumed at offset {resumed_at}; time to recover "
        f"{(t2 - t0) * 1e3:.1f} ms; the sink == the uninterrupted run's, {len(restart_sink)} "
        f"matches each once, in order; the poison record once in the dead-letter topic; "
        f"ms per commit {[round(x, 1) for x in restart_commit_ms]}; nfa_step launches "
        f"{restart_launches}")
    del restart_sink, lat

    # -- 16. the host runtime: the stock golden through runtime="host" -------
    builder = P.ComplexStreamsBuilder()
    host_out = builder.stream("stock-events").query(
        "Stocks", stocks_pattern(), P.Queried(schema=P.EventSchema(STOCK_FIELDS)),
        runtime="host")
    host_topo = builder.build()
    for i, e in enumerate(GOLDEN_EVENTS):
        host_topo.process("stock-events", "K1", e, timestamp=i)
    got = [P.sequence_to_json(r.value) for r in host_out.records]
    if got != GOLDEN_MATCHES:
        raise AssertionError(f"stock golden through runtime='host': {got}")
    log("stock golden through a runtime='host' topology: 4 matches, == phase 7's "
        "runtime='cuda' output")
    del builder, host_out, host_topo

    # -- 17. runtime="auto" at the flagship: host phase, promotion, card -----
    from kafkastreams_cep_tpu_torch.ops import kernel_build

    from kafkastreams_cep_tpu_torch.streams.auto_router import AutoRoutingProcessor

    n_host_keys = AutoRoutingProcessor.PROMOTE_AFTER - 1  # the last host-phase key count
    auto_reg, auto_log = MetricsRegistry(), P.RecordLog()
    builder = P.ComplexStreamsBuilder(log=auto_log)
    auto_out = builder.stream("letters").query(
        "skip_any8", skip_any.skip_any8_pattern(), runtime="auto", config=flag_cfg,
        batch_size=K * T, initial_keys=K, registry=auto_reg,
    ).to("matches")
    auto_topo = builder.build()
    router = auto_out.node.processor
    auto_lat = auto_out.node._m_match_latency = LatencyRecorder(auto_out.node._m_match_latency)
    stamp, process = auto_topo.stamp_ingest, auto_topo.process
    host_recs = [(k, e) for k in keys[:n_host_keys] for e in streams[k]]
    dev_recs = [(k, streams[k][b * T + t]) for b in range(n_batches) for t in range(T)
                for k in keys[n_host_keys:]]
    builds0 = len(kernel_build.BUILDS)
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    t0 = time.perf_counter()
    for key, e in host_recs:
        stamp("letters", 0, key, e.offset, time.perf_counter())
        process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)
    host_s = time.perf_counter() - t0
    if router.runtime != "host" or sk.NfaStep.launches:
        raise AssertionError(f"auto: {router.runtime} with {sk.NfaStep.launches} launches "
                             f"after the {n_host_keys} host keys")
    key, e = dev_recs[0]
    t1 = time.perf_counter()
    stamp("letters", 0, key, e.offset, time.perf_counter())
    process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t1
    if router.runtime != "cuda":
        raise AssertionError(f"auto: key {n_host_keys + 1} did not promote the query")
    promo = dict(router.promotion)
    # One post-promotion batch for the kernel check: the next step's inputs.
    captured, advance = {}, router.engine._advance

    def capture_once(state, xs):
        router.engine._advance = advance
        captured["pair"] = (state, xs)
        return advance(state, xs)

    router.engine._advance = capture_once
    t2 = time.perf_counter()
    for key, e in dev_recs[1:]:
        stamp("letters", 0, key, e.offset, time.perf_counter())
        process("letters", key, e.value, timestamp=e.timestamp, offset=e.offset)
    auto_topo.flush()
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t2
    auto_launches = launched("auto", sk.NfaStep.launches)
    auto_gc_launches = launched("auto (gc_mark)", gk.GcMark.launches)
    auto_sweep_launches = launched("auto (gc_sweep)", gs.GcSweep.launches)
    auto_builds = kernel_build.BUILDS[builds0:]
    no_drops("auto", router.device)
    auto_state = router.state()
    promotions = auto_reg.get("cep_auto_promotions_total").labels(query="skip_any8").value
    runtime_gauge = auto_reg.get("cep_auto_runtime")
    if promotions != 1 or runtime_gauge.labels(query="skip_any8", runtime="cuda").value != 1:
        raise AssertionError(f"auto: {promotions} promotions, runtime {auto_state['runtime']}")
    auto_sink = [(r.key, r.value) for r in auto_log.read("matches")]
    digests = [decode_sink_key(k)[1] for k, _v in auto_sink]
    if len(set(digests)) != len(digests):
        raise AssertionError("auto: the sink holds a match twice")
    by_key = {}
    for k, v in auto_sink:
        by_key.setdefault(decode_sink_key(k)[0], []).append(v.decode())
    if by_key != engine_matches:
        bad = [k for k in keys if by_key.get(k) != engine_matches.get(k)]
        raise AssertionError(f"auto: the sink differs from phase 5's on {len(bad)} keys")
    state, xs = captured.pop("pair")
    plain_a = build_plain_step(flag_q, flag_cfg)
    s1, y1 = plain_a(state, xs)
    s2, y2 = sk.launch(flag_lib, flag_q, flag_cfg, state, xs)
    torch.cuda.synchronize()
    auto_err = max(max_abs_diff(s1, s2), max_abs_diff(y1, y2))
    del s1, y1, s2, y2, state, xs, plain_a
    auto_lat_t = torch.tensor(auto_lat.values, dtype=torch.float64)
    if auto_lat_t.numel() != len(auto_sink):
        raise AssertionError(f"auto: {auto_lat_t.numel()} latency samples for "
                             f"{len(auto_sink)} sink matches")
    dev_rps = (len(dev_recs) - 1) / dev_s
    log(f"auto (promote_after {n_host_keys + 1}, buffer_max 65,536, autosize on; batch_size "
        f"{K * T}): host "
        f"phase {len(host_recs)} records of {n_host_keys} keys at "
        f"{len(host_recs) / host_s:.0f} records/s; promotion at key {n_host_keys + 1} in "
        f"{promote_s * 1e3:.1f} ms ({promo['wall_s'] * 1e3:.1f} ms in the router, ledger "
        f"replay {promo['replay_s'] * 1e3:.1f} ms = {promo['replay_s'] / promo['wall_s']:.1%}; "
        f"{promo['ledger']} ledger records, {promo['replayed_matches']} replayed matches, "
        f"{promo['host_matches']} already emitted by the host); device phase "
        f"{len(dev_recs) - 1} records at {dev_rps:.0f} records/s (phase 5, objects, same "
        f"run: {topo_rps:.0f}); match latency p50 "
        f"{float(auto_lat_t.quantile(0.5)) * 1e3:.1f} ms, p99 "
        f"{float(auto_lat_t.quantile(0.99)) * 1e3:.1f} ms over {auto_lat_t.numel()} samples")
    log(f"auto: {len(auto_sink)} sink matches == phase 5's per key, each once; 1 promotion, "
        f"runtime cuda; drops 0; nfa_step launches {auto_launches}, gc_mark launches "
        f"{auto_gc_launches}, gc_sweep launches {auto_sweep_launches}; the step kernel == "
        f"plain bitwise on the first post-promotion batch; nvcc builds {[(n, round(sec, 1)) for n, _t, sec in auto_builds]}; autosizer "
        f"{json.dumps(auto_state['autosizer'])}; DrainController knobs "
        f"{json.dumps(router.autosizer.cadence.state())}; engine signatures "
        f"{router.engine.compile_watch.builds()}")
    del auto_topo, auto_out, router, auto_log, auto_sink, by_key, builder, host_recs, dev_recs
    gc.collect()
    torch.cuda.empty_cache()

    # -- 18. controllers on the engine: autosizer + micro-drains, deferred ---
    arm = new_engine(arm_cfg)
    autosizer = P.parallel.CapacityAutosizer(arm, max_emit_ms=100.0, gc_group_min=4,
                                             gc_group_max=4)
    pulls, flush_log, in_micro = [], [], [False]
    pull_raw, flush_group, resize = arm._pull_raw, arm._flush_group, arm.resize

    def counting_pull(trigger="drain"):
        in_micro[0] = trigger == "micro_drain"
        before = arm.flushes
        try:
            return pull_raw(trigger=trigger)
        finally:
            in_micro[0] = False
            pulls.append((trigger, arm.flushes - before))

    def classified_flush():
        n = len(arm._group_ys)
        flush_group()
        if n:
            flush_log.append("micro" if in_micro[0] else ("cadence" if n == arm.gc_group
                                                          else "forced"))

    resize_walls, resized_pairs = [], {}

    def timed_resize(cfg):
        t = time.perf_counter()
        out = resize(cfg)
        resize_walls.append(time.perf_counter() - t)
        return out

    arm._pull_raw, arm._flush_group, arm.resize = counting_pull, classified_flush, timed_resize
    step = arm._advance

    def capture_shape(state, xs):
        shape = (arm.config.lanes, arm.config.nodes)
        resized_pairs.setdefault(shape, (arm.config, state, xs))
        return arm._advance_inner(state, xs)

    builds0 = len(kernel_build.BUILDS)
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    m_ctl, t0 = {}, None
    for b in range(n_batches):
        if b == n_warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resize_walls.clear()
        arm._advance_inner = arm._advance
        arm._advance = capture_shape
        arm.advance_packed(arm.pack(batch_of(b)), decode=False)
        arm._advance = arm._advance_inner
        autosizer.observe(events=K * T, t=T)
    for key, seqs in arm.drain().items():
        m_ctl.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
    torch.cuda.synchronize()
    ctl_s = time.perf_counter() - t0 - sum(resize_walls)
    ctl_launches = launched("controllers", sk.NfaStep.launches)
    ctl_gc_launches = launched("controllers (gc_mark)", gk.GcMark.launches)
    ctl_sweep_launches = launched("controllers (gc_sweep)", gs.GcSweep.launches)
    ctl_builds = kernel_build.BUILDS[builds0:]
    no_drops("controllers", arm)
    if m_ctl != engine_matches:
        bad = [k for k in keys if m_ctl.get(k) != engine_matches.get(k)]
        raise AssertionError(f"controllers: matches differ from phase 4's on {len(bad)} keys")
    micro = [f for trig, f in pulls if trig == "micro_drain"]
    if "micro" in flush_log or any(micro):
        raise AssertionError("controllers: a micro-drain flushed the GC group")
    if arm.flushes != len(flush_log):
        raise AssertionError(f"controllers: {arm.flushes} flushes, {len(flush_log)} logged")
    ctl_state = autosizer.state()
    triggers = {t: sum(1 for trig, _f in pulls if trig == t) for t, _f in pulls}
    resized_rows = []
    for (lanes, nodes), (cfg, state, xs) in sorted(resized_pairs.items()):
        if (lanes, nodes) == (arm_cfg.lanes, arm_cfg.nodes):
            continue
        r_lib = sk.load_library(sk.build_library(flag_q, cfg))
        plain_r = build_plain_step(flag_q, cfg)
        s1, y1 = plain_r(state, xs)
        s2, y2 = sk.launch(r_lib, flag_q, cfg, state, xs)
        torch.cuda.synchronize()
        r_err = max(max_abs_diff(s1, s2), max_abs_diff(y1, y2))
        del s1, y1, s2, y2
        ptrs, T_, K_, s_out, ys, keep = sk.prepare(flag_q, cfg, state, xs,
                                                   int(r_lib.nfa_step_scratch_words()))
        r_ms = cuda_ms(lambda: sk.call(r_lib, ptrs, T_, K_, dev), reps=20)
        r_plain_ms = cuda_ms(lambda: plain_r(state, xs), reps=1)
        r_moved = bytes_moved(state, s_out, ys, keep)
        resized_rows.append(dict(lanes=lanes, nodes=nodes, max_abs_err=r_err, ms=r_ms,
                                 plain_ms=r_plain_ms, bound_ms=r_moved / HBM_BYTES_PER_S * 1e3,
                                 bound_by="bytes"))
        del ptrs, s_out, ys, keep, plain_r
    del resized_pairs
    if ctl_state["resizes"] == 0:
        raise AssertionError("controllers: the autosizer did not grow at the arm shape")
    ctl_eps = n_timed * T * K / ctl_s
    log(f"controllers (deferred, arm lanes {arm_cfg.lanes} nodes {arm_cfg.nodes} matches "
        f"{arm_cfg.matches} gc_group {arm_cfg.gc_group}; CapacityAutosizer with a "
        f"DrainController, max_emit_ms 100, gc_group held at 4): matches == phase 4's, drops 0; "
        f"autosizer {json.dumps({k: v for k, v in ctl_state.items() if k != 'cadence'})}; "
        f"resize walls {[round(x, 2) for x in resize_walls]} s; nvcc builds "
        f"{[(n, round(sec, 1)) for n, _t, sec in ctl_builds]}; engine signatures "
        f"{arm.compile_watch.builds()}")
    log(f"controllers: pulls by trigger {triggers} (micro-drains {len(micro)}, none of them "
        f"flushed); {arm.flushes} group flushes for {n_batches} advances at G=4 "
        f"({flush_log.count('cadence')} on the cadence, {flush_log.count('forced')} forced by "
        f"region pressure, a resize or the drain); {ctl_eps:.0f} events/s over the "
        f"{n_timed} timed deferred batches with the decode worker, resize walls excluded "
        f"(phase 4, same run: {e2e_eps:.0f}); DrainController "
        f"{json.dumps(ctl_state['cadence'])}; nfa_step launches {ctl_launches}, gc_mark "
        f"launches {ctl_gc_launches}, gc_sweep launches {ctl_sweep_launches}")
    for row in resized_rows:
        log(f"nfa_step at the autosizer's shape lanes {row['lanes']} nodes {row['nodes']} "
            f"(its first batch there): kernel == plain bitwise, kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_ms'] / row['ms']:.1%} of it)")
    arm.close()
    del arm, autosizer, m_ctl

    # The decode worker against inline decode: the same deferred run
    # (flagship shape, an 8-page ring, micro-drains every 50 ms), once
    # with the worker and once with each pulled table decoded on the
    # calling thread.
    import concurrent.futures

    def micro_run(inline: bool):
        eng = new_engine(replace(flag_cfg, matches=8 * flag_cfg.matches), target_emit_ms=100.0)
        if inline:
            def submit_inline(raw):
                fut = concurrent.futures.Future()
                fut.set_result(eng._decode_job(raw, eng._events))
                eng._decode_futs.append(fut)

            eng._submit_decode = submit_inline
        out, t0 = {}, None
        for b in range(n_batches):
            if b == n_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            eng.advance_packed(eng.pack(batch_of(b)), decode=False)
        for key, seqs in eng.drain().items():
            out.setdefault(key, []).extend(P.sequence_to_json(s) for s in seqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        decode_s = eng.metrics.get("cep_decode_seconds").sum
        micro_n = eng.metrics.get("cep_auto_drains_total").labels(trigger="micro_drain").value
        eng.close()
        return out, secs, decode_s, micro_n

    overlap = {False: [], True: []}
    for inline in (False, True, True, False):
        m_run, secs, dec_s, n_micro = micro_run(inline)
        if m_run != engine_matches:
            raise AssertionError(f"decode {'inline' if inline else 'worker'}: matches differ "
                                 "from phase 4's")
        overlap[inline].append((secs, dec_s, n_micro))
    del m_run

    def overlap_str(rows):
        return "; ".join(f"{n_timed * T * K / secs:.0f} events/s ({secs * 1e3:.1f} ms, decode "
                         f"{dec * 1e3:.1f} ms, {n:.0f} micro-drains)" for secs, dec, n in rows)

    log(f"decode worker vs inline decode (flagship, deferred, micro-drains at "
        f"target_emit_ms 100, runs in the order worker, inline, inline, worker; "
        f"{n_timed} timed batches): worker {overlap_str(overlap[False])}; inline "
        f"{overlap_str(overlap[True])}; the native decoder holds the GIL while it builds "
        f"the matches")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 19. the paced LogDriver: phase 15's log again, pacing=True ----------
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    plog = P.RecordLog(f"{paced_tmp}/log")
    driver, _lat, _ = driver_on(plog, pacing=True)
    budgets = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_paced = 0
    while True:
        budgets.append(driver.pacer.suggest_batch())
        got = driver.poll(commit=False)
        if got == 0:
            budgets.pop()
            break
        n_paced += got
    driver.drain_event_time(commit=False)
    torch.cuda.synchronize()
    paced_s = time.perf_counter() - t0
    paced_launches = launched("paced LogDriver", sk.NfaStep.launches)
    no_drops("paced LogDriver", driver.topology.queries[0][1].processor)
    paced_sink = sink_of(plog)
    driver.close(commit=False)
    plog.close()
    del driver, _lat
    shutil.rmtree(paced_tmp, ignore_errors=True)
    if n_paced != n_log:
        raise AssertionError(f"paced LogDriver polled {n_paced} of {n_log} records")
    # Other poll sizes flush other micro-batches, so the keys interleave
    # otherwise in the sink: each key's records, in order, must be phase
    # 15's, and each match once.
    def per_key(sink):
        out = {}
        for k, v in sink:
            out.setdefault(decode_sink_key(k)[0], []).append((k, v))
        return out

    if per_key(paced_sink) != per_key(whole_sink) or len(paced_sink) != len(whole_sink):
        raise AssertionError(f"the paced driver's sink ({len(paced_sink)} records) differs "
                             f"from phase 15's ({len(whole_sink)}) per key")
    digests = [decode_sink_key(k)[1] for k, _v in paced_sink]
    if len(set(digests)) != len(digests):
        raise AssertionError("the paced driver's sink holds a match twice")
    log(f"paced LogDriver (AdmissionPacer defaults: 100 ms a poll, budgets 32-8192): "
        f"{n_paced / paced_s:.0f} records/s over {len(budgets)} polls (phase 15: "
        f"{n_polled / drive_s:.0f} over {whole_polls} polls of {poll_records}); budgets: first "
        f"{budgets[:12]}, then {sorted(set(budgets[12:]))}; sink == phase 15's per key, "
        f"{len(paced_sink)} matches each once; nfa_step launches {paced_launches}")
    del paced_sink, whole_sink

    # Kernel vs plain step on one (state, xs) of a new path, timed both
    # ways, with the byte bound of the launch.
    def kernel_point(lib, q, cfg, state, xs, reps=20, plain_reps=2):
        plain_step = build_plain_step(q, cfg)
        s1, y1 = plain_step(state, xs)
        s2, y2 = sk.launch(lib, q, cfg, state, xs)
        torch.cuda.synchronize()
        err = max(max_abs_diff(s1, s2), max_abs_diff(y1, y2))
        ptrs_, T_, K_, s_out_, ys_, keep_ = sk.prepare(
            q, cfg, state, xs, int(lib.nfa_step_scratch_words()))
        ms = cuda_ms(lambda: sk.call(lib, ptrs_, T_, K_, dev), reps=reps)
        p_ms = cuda_ms(lambda: plain_step(state, xs), reps=plain_reps)
        moved = bytes_moved(state, s_out_, ys_, keep_)
        del s1, y1, s2, y2, s_out_, ys_, keep_
        return {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bytes": moved}

    def per_query(acc, out):
        for k, by_q in out.items():
            for qname, seqs in by_q.items():
                acc.setdefault((k, qname), []).extend(P.sequence_to_json(s) for s in seqs)

    # -- 20. config 4: four letter queries over one stream, 1024 keys --------
    # bench.py:916-990: the stacked engine at the EngineConfig defaults with
    # pin_interval, settled by a CapacityAutosizer over the 2 warm batches
    # (an advance and drain, then a tick, each), then 8 pre-packed batches
    # deferred and one drain; against each query on its own engine, run
    # the same way, in the same process.
    c4_keys = [f"k{i}" for i in range(stacked_models.CONFIG4_KEYS)]
    c4_T = stacked_models.CONFIG4_T
    rng = random.Random(13)
    c4_streams = {k: cases_models.letters_stream(rng, c4_T * n_batches) for k in c4_keys}

    def c4_run(eng, split):
        """(matches per (key, query), timed seconds, autosizer state,
        state and xs of the first timed batch, the stacked run's flush
        and the inputs of its second timed group flush)."""
        bat = eng.engine if split else eng
        packed = [eng.pack({k: s[b * c4_T:(b + 1) * c4_T] for k, s in c4_streams.items()})
                  for b in range(n_batches)]
        auto = P.parallel.CapacityAutosizer(bat)
        got = {}

        def take(out):
            if split:
                per_query(got, out)
            else:
                for k, seqs in out.items():
                    got.setdefault(k, []).extend(P.sequence_to_json(s) for s in seqs)

        for b in range(n_warm):
            take(eng.advance_packed(packed[b]))
            auto.observe(events=c4_T * len(c4_keys), t=c4_T)
        point = (bat.state, packed[n_warm])
        # Installed after the autosizer's resizes, which rebuild the flush.
        watched = watch_flushes(bat, (2,)) if split else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(n_warm, n_batches):
            eng.advance_packed(packed[b], decode=False)
        take(eng.drain())
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, auto.state(), point, watched

    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    c4_eng = P.StackedQueryEngine(stacked_models.letter_queries(), keys=c4_keys, config=c4_cfg,
                                  device=dev, engine="cuda")
    c4_got, c4_s, c4_auto, (c4_state, c4_xs), (c4_flush, c4_fl_in) = c4_run(c4_eng, split=True)
    c4_launches = launched("config 4 (stacked)", sk.NfaStep.launches)
    c4_gc_launches = launched("config 4 (stacked, gc_mark)", gk.GcMark.launches)
    c4_sweep_launches = launched("config 4 (stacked, gc_sweep)", gs.GcSweep.launches)
    no_drops("config 4 (stacked)", c4_eng.engine)
    c4_point = kernel_point(c4_eng.engine._advance.library(), c4_eng.query, c4_eng.config,
                            c4_state, c4_xs)
    c4_final_cfg = c4_eng.config
    c4_marks, c4_sweep = check_flush("config4_stacked", c4_flush, c4_fl_in[2], 2,
                                     c4_final_cfg.pin_interval)
    del c4_eng, c4_state, c4_xs, c4_flush, c4_fl_in
    solo_s, solo_launches = 0.0, 0
    for qname, q in c4_solo.items():
        sk.NfaStep.launches = 0
        solo = P.BatchedDeviceNFA(q, keys=c4_keys, config=c4_cfg, device=dev, engine="cuda")
        got, secs, _auto, _point, _watched = c4_run(solo, split=False)
        solo_launches += launched(f"config 4 ({qname} alone)", sk.NfaStep.launches)
        no_drops(f"config 4 ({qname} alone)", solo)
        solo_s += secs
        for k in c4_keys:
            if c4_got.get((k, qname), []) != got.get(k, []):
                raise AssertionError(f"config 4: {qname} on key {k} differs from its own engine")
        del solo, got
    c4_matches = sum(len(v) for v in c4_got.values())
    if c4_matches == 0:
        raise AssertionError("config 4: no matches")
    c4_events = n_timed * c4_T * len(c4_keys)  # stream events counted once
    log(f"config 4 (4 letter queries stacked, {len(c4_keys)} keys, T={c4_T}, {n_warm} warm + "
        f"{n_timed} timed batches deferred, settled shape lanes {c4_final_cfg.lanes} nodes "
        f"{c4_final_cfg.nodes} matches {c4_final_cfg.matches}): {c4_events / c4_s:.0f} events/s "
        f"stacked vs {c4_events / solo_s:.0f} as 4 independent engines (same stream events, "
        f"the 4 timed passes summed); {c4_matches} matches, per key and query == the "
        f"independent engines, drops 0; kernel == plain on the first timed batch "
        f"({c4_point['ms']:.4f} ms vs plain {c4_point['plain_ms']:.3f} ms, bound "
        f"{c4_point['bound_ms']:.4f} ms); nfa_step launches {c4_launches} stacked, "
        f"{solo_launches} independent; gc_mark {c4_gc_launches} (== _walk on timed flush 2, "
        f"{c4_marks[-1]['ms']:.4f} ms, bound {c4_marks[-1]['bound_ms']:.4f} ms); gc_sweep "
        f"{c4_sweep_launches} (== _sweep there, {c4_sweep['ms']:.4f} ms, bound "
        f"{c4_sweep['bound_ms']:.4f} ms); autosizer "
        f"{json.dumps(c4_auto)}")
    del c4_streams, c4_got
    gc.collect()
    torch.cuda.empty_cache()

    # -- 21. the wide stack: 72 stages, 120 predicates, 512 keys -------------
    wide_keys = [f"k{i}" for i in range(512)]
    wide_batches = 4
    rng = random.Random(7)
    wide_streams = {k: skip_any.skip_any8_stream(rng, T * wide_batches) for k in wide_keys}
    wide_chunks = [{k: s[b * T:(b + 1) * T] for k, s in wide_streams.items()}
                   for b in range(wide_batches)]
    torch.cuda.reset_peak_memory_stats()
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    wide_eng = P.StackedQueryEngine(stacked_models.rotated_skip_any_queries(), keys=wide_keys,
                                    config=wide_cfg, device=dev, engine="cuda")
    wide_bytes = sum(v.numel() * v.element_size() for tree in (wide_eng.engine.state,
                                                                wide_eng.engine.pool)
                     for v in tree.values())
    wide_got, wide_point_in = {}, None
    wide_flush, wide_fl_in = watch_flushes(wide_eng.engine, (3,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, chunk in enumerate(wide_chunks):
        if b == 2:
            xs_w = wide_eng.pack(chunk)
            wide_point_in = (wide_eng.engine.state, xs_w)
            per_query(wide_got, wide_eng.advance_packed(xs_w))
        else:
            per_query(wide_got, wide_eng.advance(chunk))
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_launches = launched("wide stack", sk.NfaStep.launches)
    wide_gc_launches = launched("wide stack (gc_mark)", gk.GcMark.launches)
    wide_sweep_launches = launched("wide stack (gc_sweep)", gs.GcSweep.launches)
    no_drops("wide stack", wide_eng.engine)
    wide_live = int(wide_eng.engine.state["active"].sum(0).max())
    wide_peak = torch.cuda.max_memory_allocated()
    wide_point = kernel_point(wide_eng.engine._advance.library(), wide_q, wide_cfg,
                              *wide_point_in, reps=5, plain_reps=1)
    # Its BW (nodes + the group window), the largest of the run: both
    # kernels keep their bitmaps in shared memory there too.
    wide_marks, wide_sweep = check_flush("wide_stack", wide_flush, wide_fl_in[3], 3,
                                         wide_cfg.pin_interval)
    if wide_marks[-1]["bitmaps"] != "shared" or wide_sweep["bitmaps"] != "shared":
        raise AssertionError("wide stack: the GC's bitmaps left shared memory")
    del wide_eng, wide_point_in, xs_w, wide_flush, wide_fl_in
    gc.collect()
    torch.cuda.empty_cache()
    for qname, q in rot_q.items():
        solo = P.BatchedDeviceNFA(q, keys=wide_keys, config=flag_cfg, device=dev, engine="cuda")
        got = {}
        for chunk in wide_chunks:
            for k, seqs in solo.advance(chunk).items():
                got.setdefault(k, []).extend(P.sequence_to_json(s) for s in seqs)
        no_drops(f"wide stack ({qname} alone)", solo)
        for k in wide_keys:
            if wide_got.get((k, qname), []) != got.get(k, []):
                raise AssertionError(f"wide stack: {qname} on key {k} differs from its own engine")
        del solo, got
    wide_matches = sum(len(v) for v in wide_got.values())
    if wide_matches == 0:
        raise AssertionError("wide stack: no matches")
    log(f"wide stack (8 flagship rotations: {wide_q.n_stages} stages, {wide_q.n_preds} "
        f"predicates, masks of 2 words; {len(wide_keys)} keys, T={T}, {wide_batches} batches, "
        f"lanes {wide_cfg.lanes} nodes {wide_cfg.nodes}): {wide_matches} matches, per key and "
        f"query == 8 independent engines, drops 0, up to {wide_live} live lanes in a key; "
        f"state + pool {wide_bytes / 1e9:.3f} GB, peak allocated {wide_peak / 1e9:.2f} GB; "
        f"{len(wide_keys) * T * wide_batches / wide_s:.0f} events/s (pack and drain included); "
        f"kernel == plain on batch 3 ({wide_point['ms']:.4f} ms vs plain "
        f"{wide_point['plain_ms']:.3f} ms, {wide_point['bytes']} B -> bound "
        f"{wide_point['bound_ms']:.4f} ms); ptxas {ptxas['wide_stack']}; nfa_step launches "
        f"{wide_launches}, gc_mark {wide_gc_launches} (== _walk on flush 3, BW "
        f"{wide_marks[-1]['BW']}, {wide_marks[-1]['bitmaps']}-memory bitmaps, "
        f"{wide_marks[-1]['ms']:.4f} ms, bound {wide_marks[-1]['bound_ms']:.4f} ms), gc_sweep "
        f"{wide_sweep_launches} (== _sweep there, {wide_sweep['bitmaps']}-memory bitmaps, "
        f"{wide_sweep['ms']:.4f} ms, bound {wide_sweep['bound_ms']:.4f} ms)")
    del wide_streams, wide_chunks, wide_got
    gc.collect()
    torch.cuda.empty_cache()

    # -- 22. DeviceNFA: the flagship stream on one key, T = 256 x 12 ---------
    from kafkastreams_cep_tpu_torch.nfa import NFA as HostNFA
    from kafkastreams_cep_tpu_torch.state.aggregates import AggregatesStore as HostAggs
    from kafkastreams_cep_tpu_torch.state.buffer import SharedVersionedBuffer as HostBuffer

    single_T, single_batches = 256, 12
    single_stream = skip_any.skip_any8_stream(random.Random(7), single_T * single_batches)
    single_chunks = [single_stream[b * single_T:(b + 1) * single_T] for b in range(single_batches)]

    def single_run(dn, chunks):
        out = []
        for c in chunks:
            out += [P.sequence_to_json(s) for s in dn.advance(c)]
        return out

    class CountingDecoder:
        """The native decoder, counting DeviceNFA's pool decodes; it has
        no flat entry point, so a flat drain would raise."""

        def __init__(self):
            self.calls = 0

        def decode_matches(self, *args):
            self.calls += 1
            return native.load_decoder().decode_matches(*args)

    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    dn = P.DeviceNFA(flag_q, config=flag_cfg, device=dev, engine="cuda")
    dn._decoder = single_decoder = CountingDecoder()
    single_flush, single_fl_in = watch_flushes(dn, (7,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single_got = single_run(dn, single_chunks)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_launches = launched("DeviceNFA", sk.NfaStep.launches)
    single_gc_launches = launched("DeviceNFA (gc_mark)", gk.GcMark.launches)
    single_sweep_launches = launched("DeviceNFA (gc_sweep)", gs.GcSweep.launches)
    no_drops("DeviceNFA", dn)
    oracle = HostNFA.build(P.compile_pattern(skip_any.skip_any8_pattern()), HostAggs(),
                           HostBuffer(), strict_windows=flag_cfg.strict_windows)
    want = [P.sequence_to_json(s) for e in single_stream for s in oracle.match_pattern(e)]
    if single_got != want or not want:
        raise AssertionError(f"DeviceNFA: {len(single_got)} matches, the oracle {len(want)}")
    if not 0 < single_decoder.calls <= single_batches:
        raise AssertionError(f"DeviceNFA: {single_decoder.calls} decode_matches calls for "
                             f"{single_batches} drains")
    if dn.runs != oracle.runs or dn.n_live != len(oracle.computation_stages):
        raise AssertionError("DeviceNFA: runs or live runs differ from the oracle's")
    # The GC kernels run on the card whatever the step engine is, so the
    # plain-step DeviceNFA below does not check them: flush 7 against the
    # plain versions.
    single_marks, single_sweep = check_flush("single_key", single_flush, single_fl_in[7], 7,
                                             flag_cfg.pin_interval)
    del single_flush, single_fl_in
    plain_dn = P.DeviceNFA(flag_q, config=flag_cfg, device=dev, engine="torch")
    if single_run(plain_dn, single_chunks) != single_got:
        raise AssertionError("DeviceNFA: the plain step's matches differ")
    same_engine("DeviceNFA vs the plain step", dn, plain_dn)
    # A snapshot after batch 6, restored into a fresh engine on the card.
    half = single_batches // 2
    first = P.DeviceNFA(flag_q, config=flag_cfg, device=dev, engine="cuda")
    got_a = single_run(first, single_chunks[:half])
    blob = first.snapshot()
    second = P.DeviceNFA.restore(flag_q, blob, config=flag_cfg, device=dev, engine="cuda")
    got_b = single_run(second, single_chunks[half:])
    if got_a + got_b != single_got:
        raise AssertionError("DeviceNFA: the snapshot round trip changed the matches")
    same_engine("DeviceNFA restored vs uninterrupted", dn, second)
    # The kernel at K = 1 on batch 7's inputs from the restored state.
    probe = P.DeviceNFA.restore(flag_q, blob, config=flag_cfg, device=dev, engine="cuda")
    single_point = kernel_point(probe._advance.library(), flag_q, flag_cfg, probe.state,
                                probe._pack(single_chunks[half], None), reps=50)
    gold = P.DeviceNFA(gold_q, config=gold_cfg, device=dev, engine="cuda")
    gold_out = []
    for i, e in enumerate(GOLDEN_EVENTS):
        gold_out += gold.match_pattern(P.Event("K1", e, i, "t", 0, i))
    if [P.sequence_to_json(s) for s in gold_out] != GOLDEN_MATCHES:
        raise AssertionError("DeviceNFA: the stock golden differs")
    single_eps = len(single_stream) / single_s
    log(f"DeviceNFA (flagship pattern, one key, T={single_T} x {single_batches}): "
        f"{single_eps:.0f} events/s (pack, step, post and a pool drain per advance: "
        f"{single_decoder.calls} decode_matches calls, each on one host copy of the ring and "
        f"the three node planes, {3 * flag_cfg.nodes * 4} B of planes); {len(single_got)} matches == the host oracle's (runs {dn.runs}, "
        f"{dn.n_live} live) == a plain-step DeviceNFA's, state and pool bitwise; snapshot after "
        f"batch {half} ({len(blob)} B) restored: matches and final state equal; kernel at "
        f"K=1 {single_point['ms']:.4f} ms vs plain {single_point['plain_ms']:.3f} ms, bound "
        f"{single_point['bound_ms']:.5f} ms ({single_point['bytes']} B); stock golden 4 matches; "
        f"nfa_step launches {single_launches}, gc_mark {single_gc_launches} (== _walk on "
        f"flush 7, K=1, {single_marks[-1]['ms']:.4f} ms, bound "
        f"{single_marks[-1]['bound_ms']:.5f} ms), gc_sweep {single_sweep_launches} (== _sweep "
        f"there, {single_sweep['ms']:.4f} ms, bound {single_sweep['bound_ms']:.5f} ms)")
    del dn, plain_dn, first, second, probe, gold, oracle

    # -- 23. the pool drain at the flagship ----------------------------------
    # BatchedDeviceNFA(drain_mode="pool"): each drain reads the [2, K]
    # probe, marks the pend-reachable closure with gc_mark (the drain's own
    # launch, apart from the flushes' walks), compacts it to rank space and
    # copies the ring and the closure's planes to the host once.
    t_pool = time.perf_counter()
    pool_keys = [f"k{i}" for i in range(K)]
    pool_streams = flagship_streams(pool_keys)
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    peng = P.BatchedDeviceNFA(flag_q, keys=pool_keys, config=flag_cfg, device=dev,
                              engine="cuda", drain_mode="pool")
    real_compact, compacts, pool_in = peng._drain_compact, [0], {}

    def counted_compact(pool, maxpos):
        compacts[0] += 1
        if compacts[0] == POOL_WARM + 1:  # the first timed drain's inputs
            # The registry by reference: later drains prune into a new dict.
            pool_in.update(pool=pool, maxpos=maxpos, events=peng._events)
        return real_compact(pool, maxpos)

    peng._drain_compact = counted_compact
    pool_got, pool_drain_s, pool_bytes = {}, 0.0, []
    real_pull = peng._pull_raw_pool

    def measured_pull():
        raw = real_pull()
        if raw is not None:
            pool_bytes.append(raw["bytes"])
        return raw

    peng._pull_raw_pool = measured_pull
    for b in range(POOL_BATCHES):
        peng.advance_packed(peng.pack({k: st[b * T:(b + 1) * T] for k, st in pool_streams.items()}),
                            decode=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = peng.drain()
        if b >= POOL_WARM:
            pool_drain_s += time.perf_counter() - t0
        for key, seqs in out.items():
            pool_got.setdefault(key, []).extend(P.sequence_to_json(x) for x in seqs)
    pool_launches = launched("pool drain", sk.NfaStep.launches)
    pool_gc_launches = launched("pool drain (gc_mark)", gk.GcMark.launches)
    pool_sweep_launches = launched("pool drain (gc_sweep)", gs.GcSweep.launches)
    no_drops("pool drain", peng)
    if pool_got != pool_ref:
        bad = [k for k in set(pool_got) | set(pool_ref) if pool_got.get(k) != pool_ref.get(k)]
        raise AssertionError(f"pool drain: matches differ from phase 4's on {len(bad)} keys")
    # pin_interval: one walk (the lane walk) a flush, plus the drain's own.
    walks_per_flush = 1 if flag_cfg.pin_interval else 2
    if (pool_launches != POOL_BATCHES or pool_sweep_launches != peng.flushes
            or pool_gc_launches != walks_per_flush * peng.flushes + compacts[0]
            or compacts[0] != POOL_BATCHES):
        raise AssertionError(
            f"pool drain: nfa_step {pool_launches}, gc_mark {pool_gc_launches}, gc_sweep "
            f"{pool_sweep_launches} launches for {POOL_BATCHES} advances, {peng.flushes} "
            f"flushes and {compacts[0]} compacted drains")
    # The captured drain: its gc_mark launch == _walk on the same card
    # tensors, and drain_compact with the kernel == with _walk.
    ppool, maxpos = pool_in["pool"], pool_in["maxpos"]
    pred = ppool["node_pred"]
    B_, K_ = pred.shape
    seed = torch.zeros((B_ + 1, K_), dtype=torch.bool, device=dev)
    frontier = ppool["pend"][:maxpos].contiguous()
    got_mark = gk.launch(gc_lib, seed, frontier, pred)
    want_mark = gk._walk(seed, frontier, pred)
    torch.cuda.synchronize()
    if not torch.equal(got_mark, want_mark):
        raise AssertionError(f"pool drain: gc_mark != _walk ({int((got_mark != want_mark).sum())} "
                             "marks differ)")
    drain_mark_err = float((got_mark.int() - want_mark.int()).abs().max())
    newly = int(got_mark[:B_].sum())
    mark_bytes = 2 * seed.numel() + frontier.numel() * 4 + newly * 4
    walk_ms = cuda_ms(lambda: gk.launch(gc_lib, seed, frontier, pred), reps=20)
    walk_plain_ms = cuda_ms(lambda: gk._walk(seed, frontier, pred), reps=2)
    with_kernel = engine_mod.drain_compact(ppool, maxpos)
    engine_mod.gc_mark = gk._walk
    try:
        with_walk = engine_mod.drain_compact(ppool, maxpos)
        compact_plain_ms = cuda_ms(lambda: engine_mod.drain_compact(ppool, maxpos), reps=2)
    finally:
        engine_mod.gc_mark = gk.gc_mark
    torch.cuda.synchronize()
    if any(a.dtype != b_.dtype or not torch.equal(a, b_) for a, b_ in zip(with_kernel, with_walk)):
        raise AssertionError("pool drain: drain_compact with gc_mark != with _walk")
    compact_ms = cuda_ms(lambda: engine_mod.drain_compact(ppool, maxpos), reps=10)
    # The drain's other parts on the same pool, host walls over a few reps.
    def host_wall(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    probe_ms = host_wall(lambda: torch.stack([ppool["pend_count"], ppool["pend_pos"]]).cpu())
    pend_r, nodes3, pcount = with_kernel
    counts_np = ppool["pend_count"].cpu().numpy()
    Bb = pow2_at_least(int(pcount.max()), B_)
    Mb = pow2_at_least(int(counts_np.max()), ppool["pend"].shape[0])
    front_ms = cuda_ms(lambda: engine_mod.compact_valid_front(pend_r), reps=10)
    compacted, _ = engine_mod.compact_valid_front(pend_r)
    copy_ms = host_wall(lambda: (int(pcount.max()), nodes3[:, :Bb].cpu(), compacted[:Mb].cpu()))
    pulled = nodes3[:, :Bb].cpu().numpy()
    pend_np = compacted[:Mb].cpu().numpy()
    raw = {"counts": counts_np, "pend": pend_np.T, "node_event": pulled[0].T,
           "node_name": pulled[1].T, "node_pred": pulled[2].T}
    t0 = time.perf_counter()
    decoded = peng._decode_pool_raw(raw, events=pool_in["events"])
    decode_ms = (time.perf_counter() - t0) * 1e3
    if sum(map(len, decoded.values())) == 0:
        raise AssertionError("pool drain: the captured drain decoded no match")
    flat_ms = run["phases"]["probe+flatten+D2H"] / n_timed * 1e3
    flat_decode_ms = run["phases"]["decode"] / n_timed * 1e3
    pool_row = dict(
        call_site="kafkastreams_cep_tpu_torch/ops/engine.py drain_compact",
        launches=compacts[0], max_abs_err=drain_mark_err, ms=walk_ms, plain_ms=walk_plain_ms,
        bound_ms=mark_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
        BW=B_, F=int(frontier.shape[0]), K=K_, newly=newly, bytes=mark_bytes,
        bitmaps="shared" if gc_lib.gc_mark_smem_bytes(B_, K_) else "global")
    log(f"pool drain at the flagship (K={K}, T={T}, {POOL_WARM} warm + "
        f"{POOL_BATCHES - POOL_WARM} timed batches, each drained): matches per key == phase "
        f"4's first {POOL_BATCHES} batches ({sum(map(len, pool_got.values()))}), drops 0; "
        f"{pool_drain_s / (POOL_BATCHES - POOL_WARM) * 1e3:.2f} ms a drain (the pull "
        f"synchronous, the decode on the worker), bytes pulled a drain "
        f"{pool_bytes[POOL_WARM:]}; nfa_step {pool_launches}, gc_mark {pool_gc_launches} "
        f"({walks_per_flush * peng.flushes} flush walks + {compacts[0]} drain walks), "
        f"gc_sweep {pool_sweep_launches}")
    log(f"pool drain, the first timed drain's parts (F={frontier.shape[0]} ring rows, B={B_}, "
        f"{newly} nodes in the closure, Bb={Bb}, Mb={Mb}): probe {probe_ms:.3f} ms, walk "
        f"(gc_mark, CUDA events) {walk_ms:.4f} ms (plain walk {walk_plain_ms:.3f} ms; bytes "
        f"{mark_bytes} -> bound {pool_row['bound_ms']:.4f} ms, {pool_row['bitmaps']}-memory "
        f"bitmaps), drain_compact with the walk {compact_ms:.3f} ms (compaction "
        f"{compact_ms - walk_ms:.3f} ms; with _walk {compact_plain_ms:.3f} ms), "
        f"compact_valid_front {front_ms:.3f} ms, host copy {copy_ms:.3f} ms "
        f"({pulled.nbytes + pend_np.nbytes} B), decode {decode_ms:.2f} ms; gc_mark == _walk "
        f"bitwise, drain_compact with the kernel == with _walk; phase 4's flat drain: "
        f"probe+flatten+D2H {flat_ms:.2f} ms, decode {flat_decode_ms:.2f} ms a batch")
    del peng, pool_in, ppool, with_kernel, with_walk, pend_r, nodes3, compacted, pool_streams
    # Config 4's stacked engine, pool against flat over 2 batches: the same
    # (qid, Sequence) pairs per key and query.
    rng = random.Random(13)
    c4_two = {k: cases_models.letters_stream(rng, c4_T * n_batches)[:2 * c4_T] for k in c4_keys}
    c4_pair = {}
    for mode in ("pool", "flat"):
        sk.NfaStep.launches = gk.GcMark.launches = 0
        eng4 = P.StackedQueryEngine(stacked_models.letter_queries(), keys=c4_keys, config=c4_cfg,
                                    device=dev, engine="cuda", drain_mode=mode)
        got4 = {}
        for b in range(2):
            per_query(got4, eng4.advance({k: st[b * c4_T:(b + 1) * c4_T]
                                          for k, st in c4_two.items()}))
        c4_pair[mode] = (got4, launched(f"config 4 {mode} (nfa_step)", sk.NfaStep.launches),
                         launched(f"config 4 {mode} (gc_mark)", gk.GcMark.launches),
                         eng4.engine.stats)
        del eng4
    if c4_pair["pool"][0] != c4_pair["flat"][0] or not c4_pair["pool"][0]:
        raise AssertionError("config 4: the pool drain's (qid, Sequence) pairs differ from "
                             "the flat drain's")
    log(f"pool drain, config 4 stacked ({len(c4_keys)} keys, 2 batches of T={c4_T}): "
        f"{sum(map(len, c4_pair['pool'][0].values()))} (qid, Sequence) matches == the flat "
        f"drain's per key and query; gc_mark launches {c4_pair['pool'][2]} pool, "
        f"{c4_pair['flat'][2]} flat; drops "
        f"{ {k: c4_pair['pool'][3][k] for k in DROP_COUNTER_KEYS} }")
    # The Arrow decode needs no pyarrow: one flagship flat table through
    # the native decode_matches_arrow and decode_matches_json.
    feng = P.BatchedDeviceNFA(flag_q, keys=pool_keys, config=flag_cfg, device=dev,
                              engine="cuda")
    fstreams = flagship_streams(pool_keys)
    feng.advance_packed(feng.pack({k: st[:T] for k, st in fstreams.items()}), decode=False)
    fraw = feng._pull_raw("drain")
    land_table(fraw)
    ftable = fraw["table"]
    fplanes = [np.moveaxis(ftable[i], -1, 0) for i in range(3)]
    fcounts = np.ascontiguousarray(fraw["counts"], np.int32)
    dec = native.load_decoder()
    from kafkastreams_cep_tpu_torch.core.sequence import Sequence as Seq_, Staged as Staged_
    from kafkastreams_cep_tpu_torch.streams.serde import json_fragment

    dec_args = (fcounts, *fplanes, flag_q.name_of_id, feng._events, Staged_, Seq_, json_fragment)
    t0 = time.perf_counter()
    by_json = dec.decode_matches_json(*dec_args)
    json_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    by_arrow = dec.decode_matches_arrow(*dec_args)
    arrow_ms = (time.perf_counter() - t0) * 1e3
    n_arrow = 0
    for k, (js, ars) in enumerate(zip(by_json, by_arrow)):
        if len(js) != len(ars):
            raise AssertionError(f"arrow decode: key {k} has {len(ars)} matches, json {len(js)}")
        for (payload, ident, _last), (so, sd, vo, vd, rows, a_ident, _a_last) in zip(js, ars):
            n_events = sum(len(g["events"]) for g in json.loads(payload)["events"])
            if a_ident != ident or rows != n_events or len(so) != 4 * (rows + 1):
                raise AssertionError(f"arrow decode: key {k}: ident or row count differs")
            n_arrow += 1
    if n_arrow == 0:
        raise AssertionError("arrow decode: no matches")
    log(f"Arrow decode of a flagship flat table (batch 1, no pyarrow on this machine): "
        f"{n_arrow} matches, every ident == the JSON decode's, rows == events; native "
        f"decode_matches_arrow {arrow_ms:.2f} ms, decode_matches_json {json_ms:.2f} ms")
    del feng, fraw, ftable, fplanes
    pool_phase_s = time.perf_counter() - t_pool
    log(f"pool drain phase: {pool_phase_s:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 24. live shard migration at the flagship: partitioned brokers -------
    # Phase 15's first FLEET_BATCHES batches (all K keys, arrival order)
    # go through produce() into a PartitionedRecordLog over 3 in-process
    # brokers, key k_i on partition i % 4. Two ShardPipelines own
    # partitions {0, 1} and {2, 3}; a third pipeline owns all four (the
    # reference: the same records through one pipeline, no migration).
    # Each pipeline's query is phase 15's gated flagship at full width
    # (initial_keys K, the flagship EngineConfig, runtime="cuda"), its
    # watermark a min-merge over its partitions. Each round produces one
    # batch and polls every pipeline once; after round FLEET_BATCHES // 2
    # shard 0 is fenced, checkpointed, restored on the card in a successor
    # over another view of the brokers, and resumed.
    from kafkastreams_cep_tpu_torch.state import serde as state_serde
    from kafkastreams_cep_tpu_torch.streams.partition import PartitionedRecordLog
    from kafkastreams_cep_tpu_torch.streams.rebalance import ShardPipeline

    t_fleet = time.perf_counter()
    shard_parts = {"s0": (0, 1), "s1": (2, 3), "ref": (0, 1, 2, 3)}
    part_of = {k: i % 4 for i, k in enumerate(keys)}
    brokers = [P.RecordLog() for _ in range(3)]
    fleet_regs = {sid: MetricsRegistry() for sid in shard_parts}

    def fleet_topology(log_, sid):
        builder = P.ComplexStreamsBuilder(log=log_, app_id=f"fleet-{sid}")
        builder.stream("letters").query(
            "skip_any8", skip_any.skip_any8_pattern(), runtime="cuda", config=gated_cfg,
            batch_size=per_flush, initial_keys=K, registry=fleet_regs[sid],
            watermark_gen=MinMergeWatermark(per_source={
                ("letters", p): BoundedOutOfOrderness(reorder_ms) for p in shard_parts[sid]}),
        ).to(f"matches-{sid}")
        return builder.build()

    def fleet_view():
        return PartitionedRecordLog(brokers, registry=fleet_regs["ref"])

    view_a = fleet_view()
    pipes = {sid: ShardPipeline(sid, fleet_topology, view_a,
                                partitions={"letters": shard_parts[sid]},
                                registry=fleet_regs[sid])
             for sid in shard_parts}
    polled = {(sid, half): [0, 0.0] for sid in ("s0", "s1", "ref") for half in (0, 1)}
    migrate_round = FLEET_BATCHES // 2
    produce_s, move = 0.0, {}
    sk.NfaStep.launches = gk.GcMark.launches = gs.GcSweep.launches = 0
    for rnd in range(FLEET_BATCHES):
        t0 = time.perf_counter()
        for key, e in fleet_arrivals[rnd * K * T:(rnd + 1) * K * T]:
            P.produce(view_a, "letters", key, e.value, timestamp=e.timestamp,
                      partition=part_of[key])
        produce_s += time.perf_counter() - t0
        half = int(rnd >= migrate_round)
        for sid in ("s0", "s1", "ref"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = pipes[sid].poll(commit=False)
            torch.cuda.synchronize()
            if sid == "s0" and "first_poll_ms" not in move and "restore_ms" in move:
                move["first_poll_ms"] = (time.perf_counter() - t0) * 1e3
            polled[(sid, half)][0] += n
            polled[(sid, half)][1] += time.perf_counter() - t0
        if rnd + 1 == migrate_round:
            # The move: fence, checkpoint (a commit, then the frame),
            # close the source, restore the successor on the card over a
            # second view, then resume (its first poll, next round).
            src = pipes["s0"]
            t0 = time.perf_counter()
            src.fence()
            t1 = time.perf_counter()
            blob = src.checkpoint()
            t2 = time.perf_counter()
            committed = dict(src.driver.positions())
            src.driver.close(commit=False)  # the checkpoint committed
            t3 = time.perf_counter()
            view_b = PartitionedRecordLog(brokers, registry=fleet_regs["ref"],
                                          assignment=view_a.assignment())
            succ = ShardPipeline("s0", fleet_topology, view_b, registry=fleet_regs["s0"],
                                 checkpoint=blob)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            move.update(fence_ms=(t1 - t0) * 1e3, checkpoint_ms=(t2 - t1) * 1e3,
                        close_ms=(t3 - t2) * 1e3, restore_ms=(t4 - t3) * 1e3,
                        bytes=len(blob))
            frame = state_serde.decode_shard_checkpoint(blob)
            resumed = {tp: succ.driver.position(*tp) for tp in frame["positions"]}
            if resumed != committed or not any(resumed.values()):
                raise AssertionError(f"the successor resumed at {resumed}, the source "
                                     f"committed {committed}")
            eng = succ.topology.queries[0][1].processor.engine
            if eng.device.type != "cuda":
                raise AssertionError(f"the successor's engine is on {eng.device}")
            succ_flush, succ_flushes = watch_flushes(eng, {1})
            step_in, real_advance, advances = {}, eng._advance, [0]

            def first_advance(state, xs):
                advances[0] += 1
                if advances[0] == 1:
                    step_in["pair"] = (state, xs)
                return real_advance(state, xs)

            eng._advance = first_advance
            pipes["s0"] = succ
            del src, blob, frame
    for sid in ("s0", "s1", "ref"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipes[sid].driver.drain_event_time(commit=False)
        torch.cuda.synchronize()
        polled[(sid, 1)][1] += time.perf_counter() - t0
    fleet_launches = {"nfa_step": launched("fleet migration", sk.NfaStep.launches),
                      "gc_mark": launched("fleet migration (gc_mark)", gk.GcMark.launches),
                      "gc_sweep": launched("fleet migration (gc_sweep)", gs.GcSweep.launches)}
    for sid, pipe in pipes.items():
        proc = pipe.topology.queries[0][1].processor
        no_drops(f"fleet {sid}", proc)
        late = sum(v["value"] for v in (fleet_regs[sid].snapshot().get(
            "cep_late_dropped_total") or {"values": []})["values"])
        if late or proc.gate.occupancy:
            raise AssertionError(f"fleet {sid}: {late} late drops, {proc.gate.occupancy} "
                                 f"records left in the gate")

    def sink_by_key(topics):
        out, digests = {}, []
        for topic in topics:
            for r in view_a.read(topic):
                k, d = decode_sink_key(r.key)
                out.setdefault(k, []).append(r.value)
                digests.append(d)
        return out, digests

    union, union_digests = sink_by_key(["matches-s0", "matches-s1"])
    ref, ref_digests = sink_by_key(["matches-ref"])
    if len(set(union_digests)) != len(union_digests):
        raise AssertionError("fleet: the shards' sinks hold a match twice")
    if union != ref or set(union_digests) != set(ref_digests) or not ref:
        bad = [k for k in keys if union.get(k) != ref.get(k)]
        raise AssertionError(f"fleet: the shards' sinks differ from the reference on "
                             f"{len(bad)} keys")

    # The successor's first group flush: each gc_mark launch bitwise the
    # plain walk, the gc_sweep launch bitwise the plain sweep; its first
    # step after the restore bitwise the plain step.
    if 1 not in succ_flushes or "pair" not in step_in:
        raise AssertionError("fleet: the successor flushed or stepped no batch")
    marks0, sweeps0 = len(mark_rows), len(sweep_rows)
    check_flush("fleet", succ_flush, succ_flushes[1], 1, True)
    fleet_marks, fleet_sweep = mark_rows[marks0:], sweep_rows[sweeps0]
    state, xs = step_in.pop("pair")
    plain_g = build_plain_step(flag_q, gated_cfg)
    s1, y1 = plain_g(state, xs)
    s2, y2 = sk.launch(flag_lib, flag_q, gated_cfg, state, xs)
    torch.cuda.synchronize()
    fleet_step_err = max(max_abs_diff(s1, s2), max_abs_diff(y1, y2))
    if fleet_step_err != 0:
        raise AssertionError(f"fleet: the successor's first step differs from the plain "
                             f"step by {fleet_step_err}")
    fleet_step_ms = cuda_ms(lambda: sk.launch(flag_lib, flag_q, gated_cfg, state, xs), reps=20)
    fleet_plain_ms = cuda_ms(lambda: plain_g(state, xs), reps=2)
    ptrs, T_, K_, s_out, ys, keep = sk.prepare(flag_q, gated_cfg, state, xs, words)
    fleet_bound_ms = bytes_moved(state, s_out, ys, keep) / HBM_BYTES_PER_S * 1e3
    del s1, y1, s2, y2, ptrs, s_out, ys, keep, state, xs, plain_g
    fleet_check = {
        "nfa_step": dict(max_abs_err=fleet_step_err, ms=fleet_step_ms, plain_ms=fleet_plain_ms,
                         bound_ms=fleet_bound_ms, bound_by="bytes", library_ms=None),
        "gc_mark": dict(max_abs_err=0.0, library_ms=None, **fleet_marks[-1]),
        "gc_sweep": dict(max_abs_err=0.0, library_ms=None, **fleet_sweep),
    }
    rates = {k: (n / s if s else 0.0) for k, (n, s) in polled.items()}
    n_matches = sum(map(len, union.values()))
    log(f"fleet (phase 15's first {FLEET_BATCHES} batches: {FLEET_BATCHES * K * T} records "
        f"of {K} keys through produce() into a PartitionedRecordLog over 3 in-process "
        f"brokers, 4 partitions, {produce_s:.1f} s; shards s0 = partitions {{0, 1}}, s1 = "
        f"{{2, 3}}, each a gated flagship pipeline at initial_keys {K}): s0 migrated after "
        f"round {migrate_round}: checkpoint {move['bytes']} B; fence {move['fence_ms']:.3f} ms, "
        f"checkpoint {move['checkpoint_ms']:.1f} ms (a commit, then the frame), source close "
        f"(no commit) {move['close_ms']:.1f} ms, restore on the card {move['restore_ms']:.1f} ms, resume "
        f"(the successor's first poll, to its end) {move['first_poll_ms']:.1f} ms; the "
        f"successor resumed at the committed positions {committed}")
    log(f"fleet records/s before / after the move: s0 {rates[('s0', 0)]:.0f} / "
        f"{rates[('s0', 1)]:.0f} (the successor), s1 {rates[('s1', 0)]:.0f} / "
        f"{rates[('s1', 1)]:.0f}; the reference pipeline (all 4 partitions) "
        f"{rates[('ref', 0)]:.0f} / {rates[('ref', 1)]:.0f}")
    log(f"fleet: union of the shards' sinks == the reference's per key, {n_matches} matches, "
        f"each once; late 0, drops 0; the successor's first flush: gc_mark == _walk and "
        f"gc_sweep == _sweep bitwise, its first step == the plain step bitwise (kernel "
        f"{fleet_step_ms:.4f} ms, plain {fleet_plain_ms:.3f} ms, bound {fleet_bound_ms:.4f} "
        f"ms); launches: nfa_step {fleet_launches['nfa_step']}, gc_mark "
        f"{fleet_launches['gc_mark']}, gc_sweep {fleet_launches['gc_sweep']}; phase "
        f"{time.perf_counter() - t_fleet:.1f}s")
    for pipe in pipes.values():
        pipe.driver.close(commit=False)
    del pipes, succ, eng, brokers, view_a, view_b, union, ref, fleet_arrivals
    gc.collect()
    torch.cuda.empty_cache()

    # -- 25. the soak entry on the card ---------------------------------------
    soak_launches, soak_checks = run_soak_entry()
    fleet = {n: {"launches": fleet_launches[n] + soak_launches[n],
                 "migration_launches": fleet_launches[n], "soak_launches": soak_launches[n],
                 "soak_check": soak_checks[n]}
             for n in fleet_launches}
    for n in fleet:
        fleet[n].update(fleet_check[n])
        fleet[n]["migration_max_abs_err"] = fleet_check[n]["max_abs_err"]
        fleet[n]["max_abs_err"] = max(fleet_check[n]["max_abs_err"],
                                      soak_checks[n]["max_abs_err"])

    # -- 26. the key mesh: the flagship sharded over a KeyMesh ---------------
    mesh_entry = mesh_phase(flag_q, flag_cfg, streams, n_warm, n_timed,
                            ref_matches=engine_matches, ref_sink=obj_sink, unsharded_eps=e2e_eps)
    del obj_sink, engine_matches

    # -- 27. the port's analysis: static gate, kernel audit, lock monitor ----
    analysis = analysis_phase(27)
    audit = analysis["audit"]
    audit_rows = {n: {"launches": audit["replay_launches"][n],
                      "all_launches": audit["launches"][n],
                      "max_abs_err": audit["first_replay_launch"][n]["max_abs_err"],
                      "checked_shape": audit["first_replay_launch"][n]["shape"],
                      "counters_warm": audit["replay"]["warm"],
                      "counters_replayed": audit["replay"]["epochs"][-1]}
                  for n in audit["launches"]}

    # -- 28. the kernel line, the card line, the ok line ----------------------
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
        "auto": {"launches": auto_launches, "max_abs_err": auto_err},
        "controllers": {"launches": ctl_launches, "resized": resized_rows},
        "paced_driver": {"launches": paced_launches},
        "config4_stacked": {"launches": c4_launches, "library_ms": None,
                            "independent_launches": solo_launches, **c4_point},
        "wide_stack": {"launches": wide_launches, "stages": wide_q.n_stages,
                       "predicates": wide_q.n_preds, "ptxas": ptxas["wide_stack"],
                       "library_ms": None, **wide_point},
        "single_key": {"launches": single_launches, "library_ms": None, **single_point},
        "fleet": fleet["nfa_step"],
        "mesh": mesh_entry["nfa_step"],
        "kernel_audit": audit_rows["nfa_step"],
        "envelope": envelope,
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
        "auto": {"launches": auto_gc_launches},
        "controllers": {"launches": ctl_gc_launches},
        "config4_stacked": {"launches": c4_gc_launches, "library_ms": None, **c4_marks[-1]},
        "wide_stack": {"launches": wide_gc_launches, "library_ms": None, **wide_marks[-1]},
        "single_key": {"launches": single_gc_launches, "library_ms": None,
                       **single_marks[-1]},
        "pool_drain": pool_row,
        "fleet": fleet["gc_mark"],
        "mesh": mesh_entry["gc_mark"],
        "kernel_audit": audit_rows["gc_mark"],
    }, {
        "name": "gc_sweep",
        "route": "cuda",
        "source": "kafkastreams_cep_tpu_torch/csrc/gc_sweep.cu",
        "replaces": "kafkastreams_cep_tpu/ops/engine.py:1178-1232 and :1237-1282 (the "
                    "compaction and remaps of build_gc and remap_pend_blocks: XLA, no Pallas)",
        "launches": topo_sweep_launches,
        "max_abs_err": sweep_err,
        "ms": sweep_main["ms"],
        "plain_ms": sweep_main["plain_ms"],
        "bound_ms": sweep_main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "sweeps": sweep_rows,
        "auto": {"launches": auto_sweep_launches},
        "controllers": {"launches": ctl_sweep_launches},
        "config4_stacked": {"launches": c4_sweep_launches, "library_ms": None, **c4_sweep},
        "wide_stack": {"launches": wide_sweep_launches, "library_ms": None, **wide_sweep},
        "single_key": {"launches": single_sweep_launches, "library_ms": None, **single_sweep},
        "fleet": fleet["gc_sweep"],
        "mesh": mesh_entry["gc_sweep"],
        "kernel_audit": audit_rows["gc_sweep"],
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
