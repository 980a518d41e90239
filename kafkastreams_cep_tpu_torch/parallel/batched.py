"""Multi-key batched driver: thousands of per-key NFAs advanced on one card.

The port's counterpart of the JAX package's `parallel/batched.py`: pack
per-key event lists into [T, K] columns (the native packer,
native/packer.cc), advance every key through the step (the CUDA kernel on
the card), append each advance's matches to the pending ring, fold the
node window back with the group-flush GC, and drain. The key axis grows
with `add_keys`.

Drains (`drain_mode`, the JAX engine's two):
  * "flat" (the default) walks every pending chain on the device into one
    dense [3, Mb, Cb, K] table (ops/engine.py `build_chain_flatten`),
    copied to the host once and decoded by the native decoder
    (native/decoder.cc) into `Sequence`s or, with `sink_format="json"` or
    `"arrow"`, straight into sink bytes (`SinkMatch`);
  * "pool", the JAX package's semantic reference drain: the group is
    flushed, a [2, K] probe (counts, cursors) is read, the pend-reachable
    closure is marked from the ring by `gc_mark` (the kernel of
    csrc/gc_mark.cu on the card) and compacted to its rank space
    (ops/engine.py `drain_compact`), and the ring and the closure's three
    node planes are copied to the host, sliced to pow2 buckets of the
    largest count and closure, for the native `decode_matches` to walk.
    The pull is synchronous on the calling thread, as in the JAX engine;
    its decode goes to the worker. Bytes sinks need the flat drain.
Both give every key's matches in the same order.

Capacity contract (the JAX engine's): with `auto_drain=True` (the
default) a guard before every advance pulls the pending-match ring off
the device whenever that advance's worst case could overflow it (or
undrained pins squeeze the node region), so deferred decode
(`advance_packed(decode=False)`) loses nothing; the guard reads an
asynchronous probe of the ring cursor and never synchronizes the
advance. `EngineConfig.on_overflow` is "drop" (drops counted, and loud in
`cep_overflow_dropped_total`), "raise" (`CEPOverflowError` at the next
drain, carrying the drained matches) or "block" (a forced drain before
any advance that could overflow).

Decode worker (the JAX engine's `_submit_decode`): every pulled table --
a drain's, an auto-drain's, a micro-drain's -- is decoded on one FIFO
worker thread. On the card the pull starts the table's copy into pinned
host memory without waiting and records a CUDA event; the worker waits on
that event, not on the device, so the copy and the decode overlap the
next advance. `drain()` joins the worker in submission order: matches of
earlier engine-initiated pulls land ahead of the drain's own in every
key's list, and exact replay's boundary runs after the join. An error on
the worker re-raises from the join; nothing decodes a table a second way.
`resize` and `close` shut the worker down (its results stay queued for
the next drain); a restored engine starts without one.

Micro-drain dial (`target_emit_ms`, the JAX engine's): with it set, a
deferred advance pulls the ring once half the emit budget has passed
since the last pull, unless the freshest landed probe saw an empty ring;
the pull reads the region ++ window view, so it forces no group flush
(`flushes` stays advances / gc_group), and counts in
`cep_auto_drains_total{trigger="micro_drain"}`. The dial is a sync by
design, only when armed and due; unset (the default), a deferred advance
stays free of host syncs. `DrainController` (parallel/drain_sched.py)
arms and steers it.

Kernel builds: `compile_watch` (obs/compile.py) counts the step kernel's
signatures -- one per (query, config) the engine installs an advance for,
at construction and at each `resize` -- as `cep_compiles_total{fn}`.
With `compile_telemetry=False` there is no watch (`compile_watch` is
None) and the series is never registered; the kernel is built all the
same.

Durability: `snapshot()` / `restore()` write and read the JAX engine's
CRC-sealed frame byte for byte (state/serde.py), across capacities (a
graft) and across the JAX Pallas engine's key padding; `resize()`
re-shapes the capacity in place and builds the kernel for the new shape
first, so a failed build leaves the engine as it was.

Exact replay (`exact_replay=True`, the default, armed only for a query
with folds): the step keeps fold registers per lane, the reference per
run, and the two part when lanes that share a run id both fold in one
event -- the step counts each such event in `seq_collisions`. At every
`drain()` each key whose counter moved since the last one replays the
interval through the host oracle (ops/replay.py, nfa/): the oracle's
matches replace the engine's for that key and its device state is
rebuilt from the oracle. The interval starts at the last `drain()` (the
snapshot `_snap` is a reference to that generation of state and pool:
no pass writes either in place) and its events are the host copies of
each advanced batch's gidx/valid columns, at most
`REPLAY_LEDGER_MAX_BATCHES` batches. With replay off on such a query the
first collision warns once and sets `cep_fold_divergence_detected`.

Metrics (`self.metrics`, obs/registry.py, the JAX engine's `cep_*`
names): dispatch, drain, pull and decode walls and the batch, drain,
slot, match and byte totals through `BatchTimings` (ops/profiling.py);
GC flushes and phase; the ring, region, lane and chain-depth gauges read
from the probes the engine pulls anyway; auto-drains, backpressure and
drops; replays and the two replay gauges. No update on the advance path
reads the device. `profile_every=N` (or `profile_sync=True`, every
advance) records CUDA events around the step and the post pass of every
N-th advance and feeds `cep_advance_compute_seconds{phase}` once they
complete, without synchronizing (on the CPU: the walls).

`native=False` packs and decodes in Python instead: the reference the
tests hold the native code to. With `native=True` a schema whose fields
are not all int32/float32 packs in Python too (the packer writes only
4-byte columns); `pack_route` says which route the last pack took.

Provenance (`provenance_sample=r`, `provenance_ring=N`): every 1/r-th
decoded match (a stride accumulator, deterministic) gets a
`MatchProvenance` derived from its host Sequence -- a JSON-sink match is
re-walked through the object path for it and also carries its explain
`lineage` -- and lands in a bounded ring read by `provenance_exemplars()`
(counted in `cep_provenance_sampled_total`). Sampling reads only the
pulled table: no device work.

Fault sites (faults/injection.py, a no-op unless a harness armed one):
`engine.device_step` around the step dispatch (transient: retried, exact
because the step is functional) and `engine.mid_drain` after the ring was
pulled and cleared, before its matches are decoded.

Event time: `pack(..., watermarks=)` threads the gate's release clocks
into the step as a "wm" column; the gate itself (time/gate.py) lives in
the processor (streams/device_processor.py).

Stacked queries (ops/tables.py `compile_multi_query`): the matches of a
stacked table set decode to `(qid, Sequence)` pairs, the query read off
the chain's stage-name id (`qid_of_name_id`), in the native decoder and
the Python walk alike; parallel/stacked.py splits them by query. Such a
table set has no host stages, so exact replay stays off, and the bytes
sinks are refused (their bytes carry no query).

Key mesh (`mesh=`, parallel/key_shard.py `KeyMesh`; the JAX engine's
`mesh=`): the key axis is padded to a multiple of the mesh's shard count
(`K_padded`; padding keys never receive a valid event) and cut into
contiguous blocks, one a shard. Each shard's state, pool, packed columns
and group window live on its device, and every device pass -- the step,
the pend append, the group flush with `gc_mark` and `gc_sweep`, the
probes, the flat flatten and the pool drain's compaction -- runs once a
shard on that shard's block, with no collective. The host side runs once
for the whole key axis: keys, event registry, pack, decode, replay and
the capacity guards, whose bounds (the probes' maxima, the drain
tables' extents) are maxima over every shard, so a sharded engine pulls
the tables, and gives the matches, state and snapshot frames, of the
unsharded one. `self.state` / `self.pool` read the shards gathered on
the first shard's device (a whole tree assigned to them is split); the
per-shard trees are `_state` / `_pool`. `stats` sums the shards,
`shard_stats()` gives per-shard totals (`cep_shard_state_counter`), and
`device_registries()` one registry a shard for obs/merge.py. `add_keys`,
`restore(mesh=)` and `resize` re-partition: a frame taken at one shard
count restores at any other, or without a mesh.

`compile_cost_estimates=True` raises ValueError: an nvcc build has no
cost model to read.

The device is explicit: `device=None` means "cuda", and a missing card
raises instead of running on the CPU. `engine="cuda"` (the default on the
card) runs the hand-written kernel; `engine="torch"` runs the plain step,
which is also what CPU tensors get.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from ..core.event import Event
from ..core.sequence import Sequence, Staged
from ..faults import injection as _flt
from ..faults.injection import CEPOverflowError, TransientFault, with_retry
from ..obs.compile import CompileWatch
from ..obs.registry import MetricsRegistry, next_instance_id
from ..ops.engine import (
    DROP_COUNTER_KEYS,
    STATE_COUNTER_KEYS,
    WM_NONE,
    EngineConfig,
    build_append_post,
    build_chain_flatten,
    build_flush_post,
    compact_valid_front,
    concat_group_window,
    drain_compact,
    drain_pend,
    drain_probe,
    eval_stateless_preds,
)
from ..ops.gc_sweep import window_planes
from ..ops.profiling import BatchTimings
from ..ops.replay import device_to_oracle, oracle_to_device, supports_replay
from ..ops.runtime import (
    decode_chains,
    materialize_sequence,
    rebase_watermarks,
    sequence_provenance,
)
from ..ops.schema import EventSchema
from ..ops.step_kernel import NfaStep, kernel_signature
from ..ops.tables import CompiledQuery, compile_query
from ..pattern.stages import Stages
from ..state import serde
from ..streams.serde import (
    SinkMatch,
    arrow_ipc_from_columns,
    arrow_sink_schema,
    json_fragment,
    match_lineage,
    sink_match_from_sequence,
)
from .key_shard import (
    ENGINES,
    STAT_KEYS,
    KeyMesh,
    build_batched_advance,
    gather_state,
    init_batched_pool,
    init_batched_state,
    padded_extent,
    shard_state,
    shard_xs,
)

#: Rebase margin: keys first seen after the base is fixed may start up to
#: this much earlier and still rebase non-negative.
TS_REBASE_MARGIN_MS = 1 << 20

SINK_FORMATS = ("objects", "json", "arrow")
DRAIN_MODES = ("flat", "pool")


def pow2_at_least(n: int, cap: int) -> int:
    """The smallest power of two >= max(n, 1), capped at `cap`: a pulled
    table's bucketed extent."""
    b = 1
    while b < max(n, 1):
        b <<= 1
    return min(b, cap)


def resolve_device(device: Any = None) -> torch.device:
    """`None` -> the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch step on the CPU"
        )
    return dev


# The drain and flush policy that BatchedDeviceNFA and the single-key
# DeviceNFA (ops/device_nfa.py) share; each engine passes itself.

def check_drop_counters(eng: Any, totals: Seq[int], drained: Any) -> None:
    """Drain-boundary overflow-policy check: `totals` are eng's drop
    counters in DROP_COUNTER_KEYS order (one pull; the drain is already a
    sync point). Any delta past `eng._drop_base` is made loud in
    `cep_overflow_dropped_total{counter}`; under on_overflow "raise"
    (always) or "block" (a drop under backpressure broke the loss-free
    promise) a CEPOverflowError escalates, carrying the drained matches
    (the ring was already pulled and cleared)."""
    overflow: Dict[str, int] = {}
    for name, v in zip(DROP_COUNTER_KEYS, totals):
        delta = int(v) - eng._drop_base.get(name, 0)
        if delta > 0:
            overflow[name] = delta
            eng._drop_base[name] = int(v)
            eng._m_dropped.labels(counter=name).inc(delta)
    if overflow and eng.config.on_overflow in ("raise", "block"):
        exc = CEPOverflowError(
            f"engine capacity overflow since the last drain: {overflow} "
            f"(policy {eng.config.on_overflow!r}; size EngineConfig "
            "lanes/nodes/matches or use on_overflow='block')"
        )
        exc.matches = drained
        raise exc


def replay_ledger_overflowed(eng: Any, bound: str) -> None:
    """The exact-replay ledger went past its bound (`bound` names it): the
    interval degrades to collision detection, with one warning per
    interval, and under on_overflow="raise" a CEPOverflowError."""
    if not eng._interval_overflow:
        warnings.warn(
            f"exact-replay event ledger exceeded {bound} without a drain; "
            "this interval degrades to collision detection only -- "
            "drain() more often to keep replay armed",
            RuntimeWarning,
        )
    eng._interval_overflow = True
    if eng.config.on_overflow == "raise":
        raise CEPOverflowError(
            f"exact-replay event ledger overflowed ({bound} without a drain); "
            "drain() more often or raise the bound"
        )


def pruned_events(events: Dict[int, Event], pools: Seq[Dict[str, torch.Tensor]], threshold: int,
                  hwm: Optional[int] = None) -> Dict[int, Event]:
    """The host event registry bounded, once it outgrows `threshold`, to
    the events the pools (one a shard) reference (and any packed past
    `hwm`): a new dict, or `events` itself below the threshold. The
    distinct referenced ids are found on each pool's device: only they
    cross to the host, not the whole node plane."""
    if len(events) <= threshold:
        return events
    live_gidx = set()
    for pool in pools:
        ev = pool["node_event"]
        live_gidx.update(torch.unique(ev[ev >= 0]).cpu().tolist())
    return {g: e for g, e in events.items()
            if g in live_gidx or (hwm is not None and g > hwm)}


def land_table(raw: Dict[str, Any]) -> None:
    """A flat pull's table on the host: wait for each shard's copy (its
    CUDA event), drop the device tables the copies read, and join the
    shards' parts along the key axis into `raw["table"]`, a [3, Mb, Cb, K]
    numpy array (the one part itself without a mesh)."""
    for event in raw.pop("events", ()):
        event.synchronize()
    raw.pop("sources", None)
    tables = raw.pop("tables", None)
    if tables is not None:
        parts = [t.numpy() if isinstance(t, torch.Tensor) else t for t in tables]
        raw["table"] = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)


class BatchedDeviceNFA:
    """K independent per-key NFAs advanced as one [T, K] program."""

    #: Exact-replay ledger bound: batches per drain interval. Past it the
    #: interval degrades to collision detection only.
    REPLAY_LEDGER_MAX_BATCHES = 256

    def __init__(
        self,
        stages_or_query: Any,
        keys: Seq[Any],
        schema: Optional[EventSchema] = None,
        config: Optional[EngineConfig] = None,
        device: Any = None,
        mesh: Optional[KeyMesh] = None,
        engine: Optional[str] = None,
        events_prune_threshold: int = 1 << 16,
        native: bool = True,
        sink_format: str = "objects",
        auto_drain: bool = True,
        exact_replay: bool = True,
        drain_mode: str = "flat",
        target_emit_ms: Optional[float] = None,
        profile_sync: bool = False,
        profile_every: Optional[int] = None,
        compile_telemetry: bool = True,
        compile_cost_estimates: bool = False,
        registry: Optional[MetricsRegistry] = None,
        provenance_sample: float = 0.0,
        provenance_ring: int = 256,
        query_name: Optional[str] = None,
    ) -> None:
        if drain_mode not in DRAIN_MODES:
            raise ValueError(f"unknown drain_mode {drain_mode!r} (expected one of {DRAIN_MODES})")
        if sink_format not in SINK_FORMATS:
            raise ValueError(f"unknown sink_format {sink_format!r} (expected one of {SINK_FORMATS})")
        if compile_cost_estimates:
            raise ValueError(
                "compile_cost_estimates=True has nothing to read here: an nvcc "
                "build of the step kernel has no cost model (the JAX engine reads "
                "XLA's cost_analysis)")
        if isinstance(stages_or_query, CompiledQuery):
            self.query = stages_or_query
        else:
            assert isinstance(stages_or_query, Stages)
            self.query = compile_query(stages_or_query, schema)
        if sink_format != "objects":
            if drain_mode != "flat":
                raise ValueError(
                    f"sink_format {sink_format!r} requires drain_mode='flat' (the "
                    "bytes decode walks the chain-flatten table)")
            if self.query.qid_of_name_id is not None:
                raise ValueError(
                    f"sink_format {sink_format!r} does not support stacked "
                    "multi-query engines (qid attribution needs the object path)"
                )
            if sink_format == "arrow":
                arrow_sink_schema()  # ImportError without pyarrow
        self.config = config if config is not None else EngineConfig()
        if mesh is not None and not isinstance(mesh, KeyMesh):
            raise TypeError(f"mesh must be a KeyMesh (parallel/key_shard.py key_mesh), got "
                            f"{type(mesh).__name__}")
        #: The key mesh (module doc) or None; its first device is the
        #: engine's `device`, where gathered reads land.
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.devices[0].type:
                raise ValueError(f"device {device!r} is not of the mesh's type ({mesh!r})")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        #: One device a shard: the mesh's, or the engine's device alone.
        self._devices: List[torch.device] = (
            list(mesh.devices) if mesh is not None else [self.device])
        self.n_shards = len(self._devices)
        if engine is None:
            engine = "cuda" if self.device.type == "cuda" else "torch"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")
        self.engine = engine
        self.native = bool(native)
        self.sink_format = sink_format
        #: "flat" or "pool" (module doc).
        self.drain_mode = drain_mode
        #: The pool drain's device half (ops/engine.py `drain_compact`).
        self._drain_compact = drain_compact
        #: "native" or "python": the route the last `pack` took.
        self.pack_route: Optional[str] = None
        self._packer = None
        self._decoder = None
        self.keys: List[Any] = list(keys)
        if not self.keys:
            raise ValueError("BatchedDeviceNFA needs at least one key")
        self.K = len(self.keys)
        #: The key extent the device holds: K padded to a multiple of the
        #: shard count (K without a mesh).
        self.K_padded = padded_extent(self.K, self.n_shards)
        self.key_index: Dict[Any, int] = {k: i for i, k in enumerate(self.keys)}
        #: One (state, pool) tree a shard, each on its shard's device;
        #: every pass builds new lists (the replay snapshot keeps old ones).
        self._state = self._place(init_batched_state(self.query, self.config, self.K_padded))
        self._pool = self._place(init_batched_pool(self.query, self.config, self.K_padded))
        self._advance = build_batched_advance(self.query, self.config, engine)
        self._append = build_append_post(self.config)
        self._flush = build_flush_post(self.query, self.config)
        #: GC group cadence: the pend append runs every advance, the
        #: mark/sweep folds the accumulated window back every G-th. The
        #: window holds, per advance, one entry a shard.
        self.gc_group = max(int(self.config.gc_group), 1)
        self._group_ys: List[List[Dict[str, torch.Tensor]]] = []
        self._group_roots: List[List[torch.Tensor]] = []
        self.events_prune_threshold = events_prune_threshold
        self._events: Dict[int, Event] = {}
        self._next_gidx = 0
        self._processed_gidx = -1
        self._pack_hwms: deque = deque()
        self._ts_base: Optional[int] = None
        #: Advances so far (rides the snapshot).
        self._batches = 0
        #: In-place capacity re-shapes performed (`resize`).
        self.resizes = 0
        #: Capacity guard against silent match loss: a non-decoding
        #: advance appends at most T * matches_per_step ids per key, so
        #: draining whenever the worst-case running total could exceed the
        #: ring keeps overflow impossible. `_pend_accum` is that running
        #: total since the last drain; the async probes below replace it
        #: with the observed cursor plus the caps since the observation.
        self.auto_drain = bool(auto_drain)
        self._pend_accum = 0
        #: (drain epoch, accum at dispatch, [pos, fill, lanes] host
        #: tensor, CUDA event or None) per dispatched probe; a ring clear
        #: bumps the epoch and so retires probes in flight.
        self._pos_probes: deque = deque()
        self._pos_obs: Optional[Tuple[int, int, int]] = None
        self._drain_epoch = 0
        #: Freshest probed max live-run count per key (None before any
        #: probe lands).
        self.lane_obs: Optional[int] = None
        #: Set after a region-pressure drain that pulled nothing; cleared
        #: when a probe next observes a real match.
        self._region_backoff = False
        #: Micro-drain dial (module doc): None disarms it; 0 pulls on
        #: every deferred advance. `_last_pull_t` is the last pull's wall.
        self.target_emit_ms = target_emit_ms
        self._last_pull_t = time.perf_counter()
        #: The decode worker (module doc) and its futures, FIFO: each
        #: yields (matches, pull/decode walls and bytes).
        self._decode_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._decode_futs: List[concurrent.futures.Future] = []
        #: Drop-counter totals already reported: the overflow policy acts
        #: on deltas (a restored engine carries historic totals).
        self._drop_base: Dict[str, int] = {k: 0 for k in DROP_COUNTER_KEYS}
        #: Group flushes so far (mark/sweep passes).
        self.flushes = 0
        #: Exact replay (module doc): armed only when the query folds.
        self.exact_replay = bool(exact_replay) and supports_replay(self.query)
        self.replays = 0
        self._warned_collisions = False
        #: The interval's starting generation (state, pool), one tree a
        #: shard each, by reference; None while replay is off, so no dead
        #: generation stays alive.
        self._snap_shards: Optional[Tuple[List[Dict[str, torch.Tensor]], List[Dict[str, torch.Tensor]]]] = (
            (self._state, self._pool) if self.exact_replay else None)
        #: The interval's event ledger: (gidx [T, K], valid [T, K]) of each
        #: advanced batch, host arrays from `pack_host` (or the device
        #: columns of externally packed xs, one a shard, read at the drain).
        self._interval_packs: List[Tuple[Any, Any]] = []
        self._interval_overflow = False
        #: Host (gidx, valid) of packed batches not yet advanced, FIFO.
        self._pack_meta: deque = deque()
        #: seq_collisions per key at the interval's start.
        self._collision_base = np.zeros(self.K_padded, np.int64)
        if profile_every is not None and int(profile_every) < 1:
            raise ValueError(f"profile_every must be >= 1, got {profile_every}")
        #: Sampled compute timing: every advance with profile_sync, every
        #: profile_every-th otherwise (None: never).
        self.profile_every = 1 if profile_sync else (
            None if profile_every is None else int(profile_every))
        #: (start, after step, after post) events of sampled advances on
        #: the card, read once they complete.
        self._profiles: deque = deque()
        #: The engine's metrics, under the JAX engine's names. Private
        #: unless the caller passes `registry=` to aggregate.
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.timings = BatchTimings(registry=self.metrics)
        #: The step kernel's signatures (module doc); None with
        #: compile_telemetry off.
        self.compile_watch = CompileWatch(self.metrics) if compile_telemetry else None
        self._watch_advance(self._advance)
        if not 0.0 <= float(provenance_sample) <= 1.0:
            raise ValueError(f"provenance_sample must be in [0, 1], got {provenance_sample}")
        #: Provenance sampling (module doc): the stride accumulator, the
        #: owning query's name for the exemplars, and the bounded ring of
        #: (key, MatchProvenance). Readers (an HTTP scrape thread) take
        #: the lock to snapshot the ring.
        self.provenance_sample = float(provenance_sample)
        self.query_name = query_name
        self._prov_acc = 0.0
        self._prov_ring: deque = deque(maxlen=max(1, int(provenance_ring)))
        self._prov_lock = threading.Lock()
        self._init_metrics()

    def _init_metrics(self) -> None:
        """Register the engine's instruments on `self.metrics`. Gauges of
        one engine carry its `instance` label (two engines on one registry
        never share a series); counters are unlabelled totals."""
        r = self.metrics
        self.instance_id = next_instance_id()
        inst = self.instance_id
        r.gauge(
            "cep_engine_info",
            "Engine identity (value 1; labels carry the resolved config)",
            labels=("instance", "engine", "drain_mode"),
        ).labels(instance=inst, engine=self.engine, drain_mode=self.drain_mode).set(1)

        def gauge(name: str, doc: str):
            return r.gauge(name, doc, labels=("instance",)).labels(instance=inst)

        self._m_gc_phase = gauge("cep_gc_phase", "Advances accumulated since the last group flush")
        self._m_flushes = r.counter("cep_gc_flushes_total", "GC group flushes (mark/sweep passes)")
        self._m_auto_drains = r.counter(
            "cep_auto_drains_total",
            "Engine-initiated ring pulls by trigger "
            "(ring_full | region_pressure | micro_drain)",
            labels=("trigger",),
        )
        self._m_pend_occupancy = gauge(
            "cep_pend_occupancy", "Freshest probed max ring cursor (true pending-match count)")
        self._m_region_fill = gauge("cep_region_fill", "Freshest probed max node-region fill")
        self._m_lane_occupancy = gauge(
            "cep_lane_occupancy",
            "Freshest probed max live-run count per key (the capacity "
            "autosizer's lane-cap signal; rides the async ring probe)",
        )
        self._m_resizes = r.counter(
            "cep_engine_resizes_total",
            "In-place capacity re-shapes (graft restores at a new "
            "lane/node/match extent; each one builds the step for it)",
        )
        self._m_pending = gauge("cep_pending_matches", "Pending matches at the last drain probe")
        self._m_chain_depth = gauge(
            "cep_chain_depth_max", "Max chain depth at the last flat drain probe")
        self._m_ledger_overflow = gauge(
            "cep_replay_ledger_overflow",
            "1 while the exact-replay event ledger overflowed this interval",
        )
        self._m_divergence = gauge(
            "cep_fold_divergence_detected",
            "1 once fold divergence was detected with replay unavailable "
            "(persists after the one-shot warning)",
        )
        self._m_replays = r.counter(
            "cep_replays_total", "Per-key oracle replays at drain boundaries")
        self._m_state = r.gauge(
            "cep_engine_state_counter",
            "Engine state counter totals from the last stats pull "
            "(updated on the explicit stats sync, never on the advance path)",
            labels=("instance", "counter"),
        )
        self._m_backpressure = r.counter(
            "cep_overflow_backpressure_total",
            "Blocked admissions under on_overflow='block' (forced early "
            "drain + group flush before the advance)",
        )
        self._m_dropped = r.counter(
            "cep_overflow_dropped_total",
            "Engine drop-counter deltas observed at drain boundaries "
            "(silent capacity loss made loud; see EngineConfig.on_overflow)",
            labels=("counter",),
        )
        q = self.query_name or "q"
        self._m_prov = r.counter(
            "cep_provenance_sampled_total",
            "Decoded matches that received a sampled lineage exemplar",
            labels=("query",),
        ).labels(query=q)
        sink_matches = r.counter(
            "cep_sink_matches_total",
            "Matches decoded straight to sink bytes (sink_format json/arrow)",
            labels=("query", "format"),
        )
        sink_bytes = r.counter(
            "cep_sink_bytes_total",
            "Sink payload bytes produced by the sink-to-bytes decode",
            labels=("query", "format"),
        )
        if self.sink_format != "objects":
            self._m_sink_matches = sink_matches.labels(query=q, format=self.sink_format)
            self._m_sink_bytes = sink_bytes.labels(query=q, format=self.sink_format)
        compute = r.histogram(
            "cep_advance_compute_seconds",
            "Compute wall of sampled advances by phase "
            "(profile_sync or every profile_every-th advance)",
            labels=("instance", "phase"),
        )
        self._m_compute_advance = compute.labels(instance=inst, phase="advance")
        self._m_compute_post = compute.labels(instance=inst, phase="post")

    # ------------------------------------------------------------ shards
    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The engine state, every key: the one shard's tree, or the
        shards gathered on the first shard's device (a copy)."""
        return self._state[0] if self.n_shards == 1 else gather_state(self._state)

    @state.setter
    def state(self, tree) -> None:
        self._state = self._place(tree)

    @property
    def pool(self) -> Dict[str, torch.Tensor]:
        """The node pool and pending-match ring, as `state` reads."""
        return self._pool[0] if self.n_shards == 1 else gather_state(self._pool)

    @pool.setter
    def pool(self, tree) -> None:
        self._pool = self._place(tree)

    def _place(self, tree) -> List[Dict[str, Any]]:
        """One tree a shard on its device: a whole K_padded tree (tensors
        or numpy) is split into the shards' blocks; a list of per-shard
        trees is taken as it is."""
        if isinstance(tree, (list, tuple)):
            if len(tree) != self.n_shards:
                raise ValueError(f"{len(tree)} shard trees for {self.n_shards} shards")
            return list(tree)
        if self.mesh is None:
            return [{k: torch.as_tensor(v).to(self.device) for k, v in tree.items()}]
        return shard_state(tree, self.mesh)

    def _map_shards(self, fn, *per_shard: Seq[Any]) -> List[Any]:
        """fn over the shards (the port's shard_map): one call a shard, on
        that shard's trees, in shard order."""
        return [fn(*args) for args in zip(*per_shard)]

    def _shard_of(self, key: Any) -> Tuple[int, int]:
        """(shard, column within the shard) of a key."""
        return divmod(self.key_index[key], self.K_padded // self.n_shards)

    def _host_tree(self, trees: Seq[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
        """Per-shard trees joined on the host: one numpy array a leaf."""
        return {k: np.concatenate([t[k].cpu().numpy() for t in trees], axis=-1)
                for k in trees[0]}

    def _host_counter(self, name: str) -> np.ndarray:
        """One [K_padded] counter of every shard on the host, int64."""
        return np.concatenate([st[name].cpu().numpy() for st in self._state]).astype(np.int64)

    def _counter_totals(self, names: Seq[str]) -> np.ndarray:
        """[n_shards, len(names)] int64 sums of [K] counters, one host
        copy a shard."""
        return np.stack([
            torch.stack([st[n].sum() for n in names]).cpu().numpy().astype(np.int64)
            for st in self._state])

    # ------------------------------------------------------------------ API
    def add_keys(self, new_keys: Seq[Any]) -> None:
        """Grow the key axis: fresh engine state and pool for each new key,
        concatenated on the trailing key axis (and, under a mesh, the key
        axis re-partitioned into the new blocks, so keys move between
        shards, as the JAX engine's `shard_state` re-shards). The group
        window is flushed first: it carries the old key extent. The kernel
        takes K at each launch, so nothing is rebuilt; callers grow
        geometrically all the same (streams/device_processor.py doubles)."""
        new_keys = list(new_keys)
        for k in new_keys:
            if k in self.key_index:
                raise KeyError(f"key {k!r} already assigned")
        self._flush_group()
        k_pad = padded_extent(self.K + len(new_keys), self.n_shards)
        n = k_pad - self.K_padded

        def grown(trees, fresh):
            whole = gather_state(trees)
            return self._place({k: torch.cat([v, fresh[k].to(v.device)], dim=-1)
                                for k, v in whole.items()})

        if n > 0:
            fresh_state = init_batched_state(self.query, self.config, n, self.device)
            fresh_pool = init_batched_pool(self.query, self.config, n, self.device)
            self._state = grown(self._state, fresh_state)
            self._pool = grown(self._pool, fresh_pool)
            if self.exact_replay:
                # The new keys' interval starts at their init state.
                snap_s, snap_p = self._snap_shards
                self._snap_shards = (grown(snap_s, fresh_state), grown(snap_p, fresh_pool))
                self._collision_base = np.concatenate(
                    [self._collision_base, np.zeros(n, np.int64)])
            self.K_padded = k_pad
        self.keys.extend(new_keys)
        self.K = len(self.keys)
        self.key_index = {k: i for i, k in enumerate(self.keys)}

    @property
    def stats(self) -> Dict[str, int]:
        """Cross-key counter totals (a reduction a shard, summed on the
        host); the `cep_engine_state_counter` gauges ride this explicit
        pull."""
        totals = self._counter_totals(STATE_COUNTER_KEYS).sum(axis=0)
        out = {k: int(v) for k, v in zip(STATE_COUNTER_KEYS, totals)}
        for k, v in out.items():
            self._m_state.labels(instance=self.instance_id, counter=k).set(v)
        return out

    def shard_stats(self) -> Dict[str, np.ndarray]:
        """Per-shard counter totals, [n_shards] a counter (the counters of
        `global_stats`, `runs` among them; one shard without a mesh). An
        explicit pull; the `cep_shard_state_counter{counter, shard}`
        gauges ride it, and `device_registries()` is built from it."""
        totals = self._counter_totals(STAT_KEYS)
        gauge = self.metrics.gauge(
            "cep_shard_state_counter",
            "Engine state counter totals per mesh shard (explicit pull)",
            labels=("instance", "counter", "shard"),
        )
        out = {name: totals[:, i] for i, name in enumerate(STAT_KEYS)}
        for name, arr in out.items():
            for sh in range(arr.shape[0]):
                gauge.labels(instance=self.instance_id, counter=name, shard=str(sh)).set(int(arr[sh]))
        return out

    def device_registries(self) -> Dict[str, MetricsRegistry]:
        """One MetricsRegistry a mesh shard, keyed by the shard index
        ("0".."n-1"): its counters as `cep_device_state_total{counter}` and
        its live runs as the `cep_device_runs` gauge, the shapes
        obs/merge.py merges (counters sum to the global totals, gauges
        keep a `device` label). One `shard_stats` pull feeds them all."""
        pulled = self.shard_stats()
        out: Dict[str, MetricsRegistry] = {}
        for sh in range(self.n_shards):
            reg = MetricsRegistry()
            counters = reg.counter(
                "cep_device_state_total", "Engine state counter totals on one device",
                labels=("counter",),
            )
            for name, arr in pulled.items():
                if name == "runs":
                    reg.gauge("cep_device_runs", "Live runs resident on one device").set(
                        int(arr[sh]))
                else:
                    counters.labels(counter=name).inc(int(arr[sh]))
            out[str(sh)] = reg
        return out

    def runs(self, key: Any) -> int:
        sh, j = self._shard_of(key)
        return int(self._state[sh]["runs"][j])

    def n_live(self, key: Any) -> int:
        sh, j = self._shard_of(key)
        return int(self._state[sh]["active"][:, j].sum())

    def pack(
        self,
        events_by_key: Mapping[Any, Seq[Event]],
        watermarks: Optional[Any] = None,
    ) -> Dict[str, torch.Tensor]:
        """Pack per-key event lists into time-major [T, K] device columns:
        `upload(pack_host(...))`."""
        return self.upload(self.pack_host(events_by_key, watermarks))

    def pack_host(
        self,
        events_by_key: Mapping[Any, Seq[Event]],
        watermarks: Optional[Any] = None,
    ) -> Dict[str, np.ndarray]:
        """The host half of `pack`: [T, K] numpy columns, each event
        registered under its global id.

        Ragged keys pad at the tail with valid=False steps; keys absent
        from the mapping are all padding. `watermarks` (a scalar or a
        per-key mapping) threads an event-time "wm" column into the step;
        omitted, expiry runs on the event timestamps. A record the schema
        cannot pack raises here, and the engine is left as it was.
        """
        lists: List[Seq[Event]] = [() for _ in range(self.K_padded)]
        T = 0
        min_first: Optional[int] = None
        for key, evs in events_by_key.items():
            idx = self.key_index.get(key)
            if idx is None:
                raise KeyError(f"unknown key {key!r} (add it with add_keys)")
            lists[idx] = evs
            T = max(T, len(evs))
            if evs:
                ts0 = int(evs[0].timestamp)
                min_first = ts0 if min_first is None else min(min_first, ts0)
        if T == 0 or min_first is None:
            raise ValueError("empty batch")
        gidx_before = self._next_gidx
        ts_base_before = self._ts_base
        if self._ts_base is None:
            # One rebase for all keys: the batch's earliest first timestamp
            # minus a margin, so keys that start a little earlier stay >= 0.
            self._ts_base = min_first - TS_REBASE_MARGIN_MS

        K = self.K_padded
        schema = self.query.schema
        cols: Dict[str, np.ndarray] = {
            f"f:{name}": np.zeros((T, K), dtype) for name, dtype in schema.fields.items()
        }
        cols["ts"] = np.zeros((T, K), np.int32)
        cols["topic"] = np.zeros((T, K), np.int32)
        valid = np.zeros((T, K), bool)
        gidx = np.full((T, K), -1, np.int32)
        try:
            if self._native_pack_ok():
                self.pack_route = "native"
                self._pack_native(lists, cols, valid, gidx)
            else:
                self.pack_route = "python"
                self._pack_python(lists, cols, valid, gidx)
            if int(cols["ts"].min()) < 0:
                raise ValueError(
                    f"event timestamp rebases negative (margin "
                    f"{TS_REBASE_MARGIN_MS} ms): an event arrived more than the "
                    "margin earlier than the first batch's earliest event"
                )
            if watermarks is not None:
                cols["wm"] = self._wm_column(lists, watermarks, T)
        except BaseException:
            # Roll the registry, the id counter and the base back, so a
            # caller that skips the bad batch (or isolates its records)
            # leaks nothing; every registry id at or past gidx_before
            # belongs to this pack.
            g = gidx_before
            while self._events.pop(g, None) is not None:
                g += 1
            self._next_gidx = gidx_before
            self._ts_base = ts_base_before
            raise
        cols["gidx"] = gidx
        cols["valid"] = valid
        self._pack_hwms.append(self._next_gidx - 1)
        if self.exact_replay:
            # The batch's event ledger, taken into the replay interval when
            # the batch is advanced (FIFO, in advance order).
            self._pack_meta.append((gidx, valid))
        return cols

    def upload(self, cols: Dict[str, np.ndarray]) -> Any:
        """Copy `pack_host`'s columns to the device and evaluate the
        stateless predicates there. Under a mesh: one dict a shard, its
        key block on its device (what `advance_packed` takes)."""
        shards = ([{k: torch.from_numpy(v).to(self.device) for k, v in cols.items()}]
                  if self.mesh is None else shard_xs(cols, self.mesh))
        for xs in shards:
            xs["spred"] = eval_stateless_preds(self.query, xs)
        return shards[0] if self.mesh is None else shards

    def _wm_column(self, lists, watermarks, T: int) -> np.ndarray:
        wm_col = np.full((T, self.K_padded), WM_NONE, np.int32)
        if np.isscalar(watermarks):
            for k, evs in enumerate(lists):
                if evs:
                    wm_col[: len(evs), k] = rebase_watermarks(
                        watermarks, len(evs), self._ts_base
                    )
        else:
            for key, wms in watermarks.items():
                idx = self.key_index.get(key)
                if idx is None:
                    raise KeyError(f"unknown key {key!r} (add it with add_keys)")
                n = len(lists[idx])
                if n:
                    wm_col[:n, idx] = rebase_watermarks(wms, n, self._ts_base)
        return wm_col

    def _native_pack_ok(self) -> bool:
        """The native route: asked for, and every field a 4-byte int32 or
        float32 column (the packer writes nothing else)."""
        return self.native and all(
            np.dtype(dt) in (np.dtype(np.int32), np.dtype(np.float32))
            for dt in self.query.schema.fields.values()
        )

    def _pack_native(self, lists, cols, valid, gidx) -> None:
        """One C call packs every (key, event, field): extraction, string
        tokens, topic ids, ts rebase, validity, gidx and the registry."""
        if self._packer is None:
            from ..native import load_packer

            self._packer = load_packer()
        schema = self.query.schema
        names = tuple(schema.fields.keys())
        self._next_gidx = self._packer.pack_batch(
            [list(evs) for evs in lists],
            names,
            tuple(np.dtype(dt) == np.float32 for dt in schema.fields.values()),
            schema._vocab,
            schema._rev_vocab,
            schema._topic_vocab,
            int(self._ts_base),
            tuple(cols[f"f:{n}"] for n in names),
            cols["ts"],
            cols["topic"],
            valid,
            gidx,
            int(self._next_gidx),
            self._events,
        )

    def _pack_python(self, lists, cols, valid, gidx) -> None:
        """The Python pack: the reference for `_pack_native`."""
        schema = self.query.schema
        for k, evs in enumerate(lists):
            if not evs:
                continue
            n = len(evs)
            key_cols = schema.pack(
                [e.value for e in evs],
                [e.timestamp for e in evs],
                topics=[e.topic for e in evs],
                ts_base=self._ts_base,
            )
            for name, arr in key_cols.items():
                cols[name][:n, k] = arr
            ids = np.arange(self._next_gidx, self._next_gidx + n, dtype=np.int32)
            gidx[:n, k] = ids
            self._next_gidx += n
            for g, e in zip(ids.tolist(), evs):
                self._events[g] = e
            valid[:n, k] = True

    def advance(
        self,
        events_by_key: Mapping[Any, Seq[Event]],
        watermarks: Optional[Any] = None,
    ) -> Dict[Any, List[Sequence]]:
        """Pack, advance all keys one micro-batch, decode per-key matches."""
        return self.advance_packed(self.pack(events_by_key, watermarks))

    def advance_packed(
        self, xs: Any, decode: bool = True
    ) -> Dict[Any, List[Sequence]]:
        """Advance with pre-packed columns (`pack`'s: under a mesh one dict
        a shard; a whole [T, K_padded] dict is split here). With
        decode=False no host sync happens on the advance itself; matches
        wait in the ring until `drain()` (or an auto-drain pulls them, see
        the module doc)."""
        xs = self._shard_xs(xs)
        T = int(xs[0]["valid"].shape[0])
        step_cap = T * self.config.matches_per_step
        if self.config.on_overflow == "block":
            self._block_admission(step_cap)
        # The guard applies when a whole per-advance page fits the ring
        # (step_cap <= matches); past that the compact append places what
        # fits and counts the rest in match_drops (loud).
        if self.auto_drain and step_cap <= self.config.matches:
            occ, fill, probed_pos = self._occupancy_bound()
            # Region pressure only counts when a drain can reclaim
            # something: gate on the freshest probed true cursor, never on
            # the worst-case bound (nonzero after every advance).
            region_pressure = (
                probed_pos is not None
                and probed_pos > 0
                and not self._region_backoff
                and fill > (3 * self.config.nodes) // 4
            )
            ring_full = occ + step_cap > self.config.matches
            if ring_full or region_pressure:
                # The pulled table decodes on the worker, overlapping the
                # advance dispatched below.
                trigger = "ring_full" if ring_full else "region_pressure"
                self._m_auto_drains.labels(trigger=trigger).inc()
                if not self._pull_and_decode(trigger) and region_pressure and not ring_full:
                    self._region_backoff = True
                if region_pressure:
                    # Only the mark/sweep reclaims region space.
                    self._flush_group()
                self._pend_accum = 0
        if self._pack_hwms:
            self._processed_gidx = max(self._processed_gidx, self._pack_hwms.popleft())
        if self.exact_replay:
            self._ledger_append(xs)
        self._read_profiles()
        sampled = self.profile_every is not None and self._batches % self.profile_every == 0
        t0 = time.perf_counter()
        marks = [self._profile_mark()] if sampled else None
        if _flt.ACTIVE is None:
            stepped = self._map_shards(self._advance, self._state, xs)
        else:
            # `engine.device_step` transient site: the step is functional
            # (state reassigned only on success), so a bounded retry is
            # exact.
            def _step():
                _flt.ACTIVE.fire("engine.device_step")
                return self._map_shards(self._advance, self._state, xs)

            stepped = with_retry(
                _step, site="engine.device_step",
                retry_on=(TransientFault,), registry=self.metrics,
            )
        self._state = [st for st, _ys in stepped]
        ys = [y for _st, y in stepped]
        t_adv = time.perf_counter()
        if sampled:
            marks.append(self._profile_mark())
        appended = self._map_shards(self._append, self._state, self._pool, ys)
        self._state = [st for st, _pl, _r in appended]
        self._pool = [pl for _st, pl, _r in appended]
        self._group_ys.append([{k: y[k] for k in ("w_event", "w_name", "w_pred")} for y in ys])
        self._group_roots.append([r for _st, _pl, r in appended])
        if len(self._group_ys) >= self.gc_group:
            self._flush_group()
        self._m_gc_phase.set(len(self._group_ys))
        if sampled:
            marks.append(self._profile_mark())
            self._profiles.append(marks)
            self._read_profiles()
        self._batches += 1
        self._pend_accum += step_cap
        if self.auto_drain and step_cap <= self.config.matches:
            self._dispatch_pos_probe()
        # Slots from the shape: counting valid events would read the device.
        self.timings.record_advance(
            t_adv - t0, sum(int(np.prod(tuple(x["valid"].shape))) for x in xs),
            post_s=time.perf_counter() - t_adv,
        )
        if (
            self.target_emit_ms is not None
            and not decode
            and (time.perf_counter() - self._last_pull_t) * 1e3 >= self.target_emit_ms / 2
        ):
            # The micro-drain (module doc), gated on the freshest probed
            # true cursor like the region-pressure trigger: a probe that
            # saw an empty ring means the pull would be a no-op sync. A
            # pull retires the probes in flight, so on a busy stream every
            # due advance pulls; a quiet one goes probe-silent.
            _, _, probed_pos = self._occupancy_bound()
            if probed_pos is None or probed_pos > 0:
                self._m_auto_drains.labels(trigger="micro_drain").inc()
                self._pull_and_decode("micro_drain")
        return self.drain() if decode else {}

    def drain(self) -> Dict[Any, List[Any]]:
        """Decode and clear all pending matches (a host sync point):
        `Sequence`s, or `SinkMatch`es with sink_format="json"/"arrow". Matches of
        earlier engine-initiated drains come first in every key's list.
        With exact replay armed, the keys whose folds diverged in the
        interval get the oracle's matches instead (`_replay_boundary`).
        Ends with the overflow-policy check (`_check_drop_counters`)."""
        t0 = time.perf_counter()
        out: Dict[Any, List[Any]] = {}
        self._pend_accum = 0
        self._pull_and_decode("drain")
        if _flt.ACTIVE is not None:
            # `engine.mid_drain` crash site: the ring was pulled and
            # cleared on the device but the worker has not handed its
            # matches back -- a crash here loses every in-flight match
            # unless the pipeline above recovers from its last commit.
            _flt.ACTIVE.fire("engine.mid_drain")
        # Join the worker: one thread, so futures complete in submission
        # order and earlier pulls' matches land first in every key's list.
        pull_s = decode_s = 0.0
        n_bytes = 0
        futs, self._decode_futs = self._decode_futs, []
        for fut in futs:
            decoded, meta = fut.result()
            for k, v in decoded.items():
                out.setdefault(k, []).extend(v)
            pull_s += meta["pull_s"]
            decode_s += meta["decode_s"]
            n_bytes += meta["bytes"]
        if self.exact_replay:
            out = self._replay_boundary(out)
        elif self.query.agg_slots and not self._warned_collisions:
            self._detect_divergence()
        # The prune runs after the replay: the oracle reads the interval's
        # events from the registry.
        if not self._group_ys:
            self._prune_events()
        self._read_profiles()
        self.timings.record_drain(
            time.perf_counter() - t0, sum(len(v) for v in out.values()),
            pull_s=pull_s, decode_s=decode_s, bytes_pulled=n_bytes,
        )
        self._check_drop_counters(drained=out)
        return out

    # --------------------------------------------------------- checkpointing
    #: Config fields whose change re-shapes the engine (and its kernel).
    _SHAPE_FIELDS = (
        "lanes", "nodes", "matches", "matches_per_step", "nodes_per_step",
    )

    def snapshot(self) -> bytes:
        """The engine as one CRC-sealed frame, byte for byte the JAX
        engine's: the pickled key list, the state and pool array trees,
        the event registry, the next event id, the timestamp base and the
        advance count. Flushes the GC group first (the window lives
        outside the pool), so gc_phase is 0 in every snapshot."""
        return self._encode_snapshot(self._snapshot_arrays())

    def _snapshot_arrays(self) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Flush the group and copy state and pool (every shard, joined
        along the key axis) to the host."""
        self._flush_group()
        return self._host_tree(self._state), self._host_tree(self._pool)

    def _encode_snapshot(self, arrays) -> bytes:
        state_np, pool_np = arrays
        w = serde._Writer()
        w._buf.write(serde.MAGIC)
        w.blob(serde.dumps(self.keys))
        w.blob(serde.encode_array_tree(state_np))
        w.blob(serde.encode_array_tree(pool_np))
        w.blob(serde.encode_event_registry(self._events))
        w.i64(self._next_gidx)
        w.i64(self._ts_base if self._ts_base is not None else -1)
        w.i64(self._batches)
        return serde.seal_frame(w.getvalue())

    @classmethod
    def restore(
        cls,
        stages_or_query: Any,
        data: bytes,
        schema: Optional[EventSchema] = None,
        config: Optional[EngineConfig] = None,
        **opts: Any,
    ) -> "BatchedDeviceNFA":
        """A new engine from a `snapshot()` of either package's engine
        (`opts` as the constructor's, `mesh=` among them).

        A snapshot taken at other capacities grafts into `config`'s shape,
        or raises `ShapeRestoreError` when its live state does not fit. A
        JAX Pallas engine pads its key axis to a multiple of 8, and an
        engine on a mesh to a multiple of its shard count: padding columns
        must hold the init state (a column that does not raises
        `CheckpointError`). The restored engine holds one state column per
        key, padded with init columns to its own `K_padded`, so a frame
        taken at one shard count restores at any other, or without a
        mesh."""
        r = serde._Reader(serde.open_frame(data))
        serde.read_magic(r)
        keys = serde.loads(r.blob())
        tree = serde.decode_array_tree(r.blob())
        pool_tree = serde.decode_array_tree(r.blob())
        serde.upgrade_checkpoint_trees(tree, pool_tree)
        bat = cls(stages_or_query, keys=keys, schema=schema, config=config, **opts)
        k_snap = int(tree["active"].shape[-1])
        if k_snap < bat.K:
            raise serde.CheckpointError(
                f"snapshot holds {k_snap} key columns for {bat.K} keys")
        init_s = {k: v.numpy() for k, v in
                  init_batched_state(bat.query, bat.config, k_snap).items()}
        init_p = {k: v.numpy() for k, v in
                  init_batched_pool(bat.query, bat.config, k_snap).items()}
        mismatch = any(
            name in src and tuple(src[name].shape[:-1]) != tuple(ref.shape[:-1])
            for src, tgt in ((tree, init_s), (pool_tree, init_p))
            for name, ref in tgt.items()
        )
        if mismatch:
            serde.check_restore_capacity(
                tree, pool_tree, lanes=bat.config.lanes, nodes=bat.config.nodes,
                matches=bat.config.matches, where="BatchedDeviceNFA.restore",
            )
            tree = serde.graft_array_tree(tree, {k: v.copy() for k, v in init_s.items()})
            pool_tree = serde.graft_array_tree(pool_tree, {k: v.copy() for k, v in init_p.items()})
        if k_snap > bat.K:
            for src, ref in ((tree, init_s), (pool_tree, init_p)):
                for name in ref:
                    if not np.array_equal(src[name][..., bat.K:], ref[name][..., bat.K:]):
                        raise serde.CheckpointError(
                            f"key padding column of {name!r} holds live state")
        n_pad = bat.K_padded - bat.K
        pads = (init_batched_state(bat.query, bat.config, n_pad),
                init_batched_pool(bat.query, bat.config, n_pad))
        for attr, src, ref, pad in (("state", tree, init_s, pads[0]),
                                    ("pool", pool_tree, init_p, pads[1])):
            setattr(bat, attr, {k: np.concatenate([src[k][..., :bat.K], pad[k].numpy()], axis=-1)
                                for k in ref})
        bat._events = serde.decode_event_registry(r.blob())
        bat._next_gidx = r.i64()
        bat._processed_gidx = bat._next_gidx - 1  # no pre-packed xs survive
        ts_base = r.i64()
        # -1 is the frame's "no base yet"; any other value, negative too,
        # is the base (the JAX engine reads every negative value as none
        # and re-bases the next batch: equal matches, other lane times).
        bat._ts_base = None if ts_base == -1 else ts_base
        bat._batches = r.i64()
        r.expect_end()
        # The restored ring may hold undrained matches: seed the capacity
        # guard with its cursor, and re-baseline the drop counters (the
        # policy acts on deltas, not on historic totals).
        bat._pend_accum = max(int(pl["pend_pos"].max()) for pl in bat._pool)
        drops = bat._counter_totals(DROP_COUNTER_KEYS).sum(axis=0)
        bat._drop_base = {k: int(v) for k, v in zip(DROP_COUNTER_KEYS, drops)}
        if bat.exact_replay:
            # The next interval starts at the restored generation.
            bat._snap_shards = (bat._state, bat._pool)
            bat._collision_base = bat._host_counter("seq_collisions")
        return bat

    def resize(self, config: EngineConfig) -> bool:
        """Re-shape the capacity caps in place: flush, check that the live
        state fits (`ShapeRestoreError` if not), build the step for the
        new shape (the CUDA kernel's lanes and node region are compile-time
        constants: a new nvcc build), then graft state and pool into
        freshly initialised trees of the new shape. The key axis, the
        stream position and the ring's contents are kept; a shrink back
        is bitwise what never having grown gives. A refused shrink or a
        failed build leaves the engine at its old shape and state.
        Returns True when a re-shape happened."""
        if all(getattr(config, f) == getattr(self.config, f) for f in self._SHAPE_FIELDS):
            self.config = config
            return False
        # Pulled tables in flight keep decoding to the end; their results
        # stay queued for the next drain.
        self._shutdown_worker()
        self._flush_group()

        to_host = self._host_tree
        state_np, pool_np = to_host(self._state), to_host(self._pool)
        serde.check_restore_capacity(
            state_np, pool_np, lanes=config.lanes, nodes=config.nodes,
            matches=config.matches, where="resize",
        )
        snap_np = None
        if self._snap_shards is not None:
            # The interval replays from this generation: it must fit too.
            snap_np = (to_host(self._snap_shards[0]), to_host(self._snap_shards[1]))
            serde.check_restore_capacity(
                snap_np[0], snap_np[1], lanes=config.lanes, nodes=config.nodes,
                matches=config.matches, where="resize (replay snapshot)",
            )
        advance = build_batched_advance(self.query, config, self.engine)
        # On the card the nvcc build runs here: it raises before anything
        # changes.
        self._watch_advance(advance)

        def graft(src_state, src_pool):
            tgt_s = {k: v.numpy().copy() for k, v in
                     init_batched_state(self.query, config, self.K_padded).items()}
            tgt_p = {k: v.numpy().copy() for k, v in
                     init_batched_pool(self.query, config, self.K_padded).items()}
            serde.graft_array_tree(src_state, tgt_s)
            serde.graft_array_tree(src_pool, tgt_p)
            return self._place(tgt_s), self._place(tgt_p)

        self._state, self._pool = graft(state_np, pool_np)
        if snap_np is not None:
            self._snap_shards = graft(*snap_np)
        self.config = config
        self._advance = advance
        self._append = build_append_post(config)
        self._flush = build_flush_post(self.query, config)
        # Probes in flight read the old arrays; the worst-case accumulator
        # stays valid (the ring was grafted, not drained).
        self._drain_epoch += 1
        self._pos_obs = None
        self.lane_obs = None
        self.resizes += 1
        self._m_resizes.inc()
        return True

    def close(self) -> None:
        """Shut the decode worker down (pending decodes finish; their
        matches stay queued for a `drain()`)."""
        self._shutdown_worker()

    # ------------------------------------------------------------ internals
    def _watch_advance(self, advance: Any) -> None:
        """Count the step kernel's signature in `compile_watch` (when
        there is one); on the card build (or load) it now, timed, so a
        failed build raises here. The plain step (engine="torch") has no
        kernel."""
        if not isinstance(advance, NfaStep):
            return
        seconds = None
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            advance.library()
            seconds = time.perf_counter() - t0
        if self.compile_watch is not None:
            self.compile_watch.observe(
                "nfa_step", kernel_signature(self.query, advance.config), seconds)

    def _shutdown_worker(self) -> None:
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True)
            self._decode_pool = None

    def _check_drop_counters(self, drained: Optional[Dict] = None) -> None:
        """The overflow policy (`check_drop_counters`) on the counters
        summed over the keys."""
        totals = self._counter_totals(DROP_COUNTER_KEYS).sum(axis=0).tolist()
        check_drop_counters(self, totals, drained if drained is not None else {})

    def _block_admission(self, step_cap: int) -> None:
        """on_overflow="block": hold the advance until its worst case fits.
        Each forced round drains the ring (decoded into the FIFO) and
        flushes the group, bounded by `block_retries` with linear backoff;
        a residual drop escalates at the next drain. When a page exceeds
        the ring (step_cap > matches) admission needs an empty ring."""
        cfg = self.config
        for attempt in range(cfg.block_retries + 1):
            occ, fill, _ = self._occupancy_bound()
            if step_cap <= cfg.matches:
                need = occ + step_cap > cfg.matches or fill > (3 * cfg.nodes) // 4
            else:
                need = occ > 0
            if not need or attempt == cfg.block_retries:
                return
            self._m_backpressure.inc()
            self._pull_and_decode("backpressure")
            self._flush_group()
            if cfg.block_backoff_s > 0:
                time.sleep(cfg.block_backoff_s * (attempt + 1))

    def _pull_and_decode(self, trigger: str) -> bool:
        """Pull the ring and queue its table on the decode worker; the
        matches come out of the next `drain()`. Returns whether anything
        was pending."""
        raw = self._pull_raw(trigger=trigger)
        if raw is None:
            return False
        self._submit_decode(raw)
        return True

    def _pull_raw(self, trigger: str = "drain") -> Optional[Dict[str, Any]]:
        """Pull and clear the ring; `trigger` names the dial that pulled
        (drain | ring_full | region_pressure | micro_drain | backpressure)
        and rides the table to the worker. Mid-group the flat drain reads
        the region ++ window view, so a pull keeps the GC cadence; with
        exact replay armed it flushes the group first instead, so the
        interval's snapshot (taken at a drain) resolves every node id
        against its own pool. The pool drain flushes the group too."""
        self._last_pull_t = time.perf_counter()
        if self.drain_mode == "flat" and not self.exact_replay:
            raw = self._pull_raw_flat(self._window_pool_view())
        else:
            self._flush_group()
            if self.drain_mode == "flat":
                raw = self._pull_raw_flat(self._pool)
            else:
                raw = self._pull_raw_pool()
        if raw is not None:
            raw["trigger"] = trigger
        return raw

    def _submit_decode(self, raw: Dict[str, Any]) -> None:
        """Queue a pulled table on the single worker thread. The event
        registry is captured by reference: packs add to it in place and
        `_prune_events` rebinds a new dict, so a decode in flight sees
        every event its chains name."""
        if self._decode_pool is None:
            self._decode_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cep-decode")
        self._decode_futs.append(self._decode_pool.submit(self._decode_job, raw, self._events))

    def _decode_job(
        self, raw: Dict[str, Any], events: Dict[int, Event],
    ) -> Tuple[Dict[Any, List[Any]], Dict[str, float]]:
        """On the worker: wait for the flat table's copies (their CUDA
        events), then decode the pulled table (provenance sampled under the
        pull's trigger). Returns the matches and the pull's (copy wait
        included) and decode's walls and bytes."""
        t0 = time.perf_counter()
        land_table(raw)
        t1 = time.perf_counter()
        trigger = raw.get("trigger", "drain")
        if "table" in raw:
            decoded = self._decode_flat(raw, trigger, events)
        else:
            decoded = self._decode_pool_raw(raw, trigger, events)
        return decoded, {"pull_s": raw["pull_s"] + (t1 - t0),
                         "decode_s": time.perf_counter() - t1, "bytes": raw["bytes"]}

    # ------------------------------------------------------------ exact replay
    def _ledger_append(self, xs: List[Dict[str, torch.Tensor]]) -> None:
        """Take the advancing batch's event ledger into the interval: the
        host copies `pack_host` made, or, for externally packed xs (one
        dict a shard), the device columns themselves (read at the drain,
        so the advance does not synchronize). Past
        `REPLAY_LEDGER_MAX_BATCHES` the interval degrades to detection:
        one warning, the overflow gauge, and under on_overflow="raise" a
        `CEPOverflowError`."""
        entry = (self._pack_meta.popleft() if self._pack_meta else
                 (tuple(x["gidx"] for x in xs), tuple(x["valid"] for x in xs)))
        if len(self._interval_packs) < self.REPLAY_LEDGER_MAX_BATCHES:
            self._interval_packs.append(entry)
            return
        self._m_ledger_overflow.set(1)
        self._interval_packs = []
        replay_ledger_overflowed(self, f"{self.REPLAY_LEDGER_MAX_BATCHES} batches")

    def _shard_columns(self, trees: Seq[Dict[str, torch.Tensor]], names: Seq[str],
                       keys: np.ndarray) -> Dict[str, np.ndarray]:
        """The columns of the global key indices `keys` (ascending) of
        every leaf in `names`, host numpy in that order: one gather and
        one copy a leaf a shard that holds any of them."""
        span = self.K_padded // self.n_shards
        parts: Dict[str, List[np.ndarray]] = {n: [] for n in names}
        for sh, tree in enumerate(trees):
            local = keys[(keys >= sh * span) & (keys < (sh + 1) * span)] - sh * span
            if local.size == 0:
                continue
            idx = torch.as_tensor(local, dtype=torch.long, device=self._devices[sh])
            for n in names:
                parts[n].append(tree[n].index_select(-1, idx).cpu().numpy())
        return {n: np.concatenate(p, axis=-1) for n, p in parts.items()}

    def _replay_boundary(self, out: Dict[Any, List[Any]]) -> Dict[Any, List[Any]]:
        """At a drain: each key whose seq_collisions moved since the
        interval's start replays the interval through the host oracle,
        built from the interval's snapshot; the oracle's matches replace
        the key's drained ones and its device state is rebuilt from the
        oracle. Then the next interval starts here."""
        cur = self._host_counter("seq_collisions")
        hot = np.flatnonzero(cur > self._collision_base[: cur.shape[0]])
        if hot.size:
            self._m_divergence.set(1)
        if hot.size and self._interval_overflow:
            warnings.warn(
                "fold-divergence detected but the replay ledger overflowed "
                "this interval; affected keys' matches are engine-computed "
                "(not oracle-replayed) for this interval only",
                RuntimeWarning,
            )
        if hot.size and self._interval_packs and not self._interval_overflow:
            self._replay_keys(hot, out)
        self._collision_base = cur
        self._snap_shards = (self._state, self._pool)
        self._interval_packs = []
        self._interval_overflow = False
        self._m_ledger_overflow.set(0)
        return out

    def _replay_keys(self, hot: np.ndarray, out: Dict[Any, List[Any]]) -> None:
        """Replay the interval of the keys `hot` (a drain-time host step:
        one gather and one copy per leaf a shard for all of them)."""
        snap_state, snap_pool = self._snap_shards
        s_np = self._shard_columns(snap_state, list(snap_state[0]), hot)
        p_np = self._shard_columns(
            snap_pool, ("node_event", "node_name", "node_pred", "node_count"), hot)
        c_np = self._shard_columns(self._state, STATE_COUNTER_KEYS, hot)
        packs = [tuple(a if isinstance(a, np.ndarray) else
                       np.concatenate([t.cpu().numpy() for t in a], axis=-1) for a in e)
                 for e in self._interval_packs]
        ts_base = self._ts_base if self._ts_base is not None else 0
        writes: Dict[int, Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]] = {}
        for j, k in enumerate(hot.tolist()):
            key = self.keys[k]
            # Batches packed before the key was added have no column for it.
            interval = [g for g_arr, v_arr in packs if k < g_arr.shape[1]
                        for g in g_arr[v_arr[:, k], k].tolist()]
            try:
                # The oracle keeps fold cells under the events' record key,
                # which is not the engine's key when that is a lane handle
                # (streams/device_processor.py).
                rec_key = self._events[interval[0]].key if interval else key
                oracle, ev_gidx = device_to_oracle(
                    self.query, self.config, {n: v[..., j] for n, v in s_np.items()},
                    {n: v[..., j] for n, v in p_np.items()}, self._events, ts_base,
                    rec_key,
                )
                matches: List[Any] = []
                for g in interval:
                    e = self._events[g]
                    ev_gidx[e] = g
                    matches.extend(oracle.match_pattern(e))
            except KeyError as exc:
                warnings.warn(
                    f"exact-replay skipped for key {key!r}: event {exc} missing "
                    "from the registry (snapshot or oracle feed); this interval's "
                    "matches are engine-computed and fold values may diverge from "
                    "the oracle for it"
                )
                continue
            self.replays += 1
            self._m_replays.inc()
            if matches and self.sink_format != "objects":
                matches = [sink_match_from_sequence(m, self.sink_format) for m in matches]
            if matches:
                out[key] = matches
            else:
                out.pop(key, None)
            try:
                writes[k] = oracle_to_device(
                    self.query, self.config, oracle, rec_key, ev_gidx, ts_base,
                    {n: v[..., j] for n, v in c_np.items()},
                )
            except (ValueError, KeyError) as exc:
                warnings.warn(
                    f"exact-replay resync failed for key {key!r} ({exc}); device "
                    "state kept -- this interval is oracle-exact but later ones "
                    "fall back to detection"
                )
        if writes:
            self._write_key_state(writes)

    def _write_key_state(
        self, writes: Dict[int, Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]
    ) -> None:
        """Write resynced keys' columns ({key index: (state, pool)}, numpy
        per key) into new state and pool tensors, one `index_copy` per
        leaf of each shard that holds any: the old tensors, which the
        interval snapshot may hold, are never written."""
        span = self.K_padded // self.n_shards
        for which, attr in enumerate(("_state", "_pool")):
            trees = list(getattr(self, attr))
            for sh in range(self.n_shards):
                ks = [k for k in sorted(writes) if k // span == sh]
                if not ks:
                    continue
                idx = torch.as_tensor([k - sh * span for k in ks], dtype=torch.long,
                                      device=self._devices[sh])
                tree = dict(trees[sh])
                for name, leaf in tree.items():
                    cols = np.stack([np.asarray(writes[k][which][name]) for k in ks], axis=-1)
                    src = torch.as_tensor(cols).to(dtype=leaf.dtype, device=leaf.device)
                    tree[name] = leaf.index_copy(leaf.dim() - 1, idx, src)
                trees[sh] = tree
            setattr(self, attr, trees)

    def _detect_divergence(self) -> None:
        """Replay off on a folding query: the first drain that sees a
        collision warns once and sets the persistent gauge; under
        on_overflow="raise" it raises."""
        if not self._counter_totals(("seq_collisions",)).any():
            return
        self._warned_collisions = True
        self._m_divergence.set(1)
        if supports_replay(self.query):
            remedy = "Re-enable exact_replay (default) to recover exactness."
        else:
            remedy = ("This engine cannot replay (no host-stage oracle for this "
                      "compiled query, e.g. stacked multi-query); run the "
                      "affected query on its own engine for oracle-exact folds.")
        warnings.warn(
            "seq_collisions > 0 with exact replay unavailable: fold registers "
            "have diverged from the reference's per-run semantics for at least "
            "one key; matches may differ from the host oracle. " + remedy,
            RuntimeWarning,
        )
        if self.config.on_overflow == "raise":
            raise CEPOverflowError(
                "fold divergence detected with exact replay unavailable; "
                "matches may differ from the oracle. " + remedy
            )

    # ------------------------------------------------------------- profiling
    def _profile_mark(self) -> Any:
        """A timing mark of a sampled advance: a CUDA event recorded on
        the current stream on the card (the first shard's device: with
        shards on several cards it times that card's work), the wall clock
        on the CPU (where the passes run synchronously)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def _read_profiles(self) -> None:
        """Feed `cep_advance_compute_seconds` from the sampled advances
        whose last event has completed (an event query, never a wait)."""
        while self._profiles:
            start, mid, end = self._profiles[0]
            if isinstance(end, float):
                adv, post = mid - start, end - mid
            elif end.query():
                adv, post = start.elapsed_time(mid) / 1e3, mid.elapsed_time(end) / 1e3
            else:
                return
            self._profiles.popleft()
            self._m_compute_advance.observe(adv)
            self._m_compute_post.observe(post)

    def _dispatch_pos_probe(self) -> None:
        """Start an asynchronous copy of [max ring cursor, max region fill,
        max live lanes per key] of each shard to the host: a pinned buffer
        and an event a shard on the card (no synchronization), the result
        itself on the CPU. The read takes the maxima over the shards."""
        hosts, events = [], []
        for st, pl in zip(self._state, self._pool):
            arr = torch.stack([
                pl["pend_pos"].max().to(torch.int64),
                pl["node_count"].max().to(torch.int64),
                st["active"].sum(0).max(),
            ])
            if arr.device.type == "cuda":
                host = torch.empty(3, dtype=torch.int64, pin_memory=True)
                host.copy_(arr, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(arr.device))
                arr = host
                events.append(event)
            hosts.append(arr)
        self._pos_probes.append((self._drain_epoch, self._pend_accum, hosts, events))

    def _occupancy_bound(self) -> Tuple[int, int, Optional[int]]:
        """(worst-case ring occupancy, freshest observed region fill,
        freshest probed true cursor -- None while no probe has landed).

        Occupancy is the freshest landed cursor probe plus the per-advance
        caps since it (the pure worst-case accumulator while none has
        landed). A probe whose events have not all completed is left for
        later: reading it would synchronize. A probe that a ring clear
        retired (an older drain epoch) still reads the live-lane count,
        which no pull changes: with a pull at every advance (micro-drains,
        a processor that drains every flush) no probe outlives its epoch,
        and the autosizer would never see the lanes. (The JAX engine drops
        such probes whole.)"""
        while self._pos_probes:
            epoch, acc, hosts, events = self._pos_probes[0]
            if not all(event.query() for event in events):
                break
            self._pos_probes.popleft()
            pos, fill, lanes = np.max([host.tolist() for host in hosts], axis=0).tolist()
            self.lane_obs = lanes
            self._m_lane_occupancy.set(lanes)
            if epoch == self._drain_epoch:
                self._pos_obs = (acc, pos, fill)
                self._m_pend_occupancy.set(pos)
                self._m_region_fill.set(fill)
                if pos > 0:
                    self._region_backoff = False  # a real match re-arms it
        if self._pos_obs is not None:
            acc, pos, fill = self._pos_obs
            return pos + (self._pend_accum - acc), fill, pos
        return self._pend_accum, 0, None

    def _ring_cleared(self) -> None:
        """The ring was just drained: retire probes in flight (new epoch),
        reset the worst-case accumulator, and blank the group's
        accumulated page roots, whose matches were all pulled (re-pinning
        them at the flush would retain garbage)."""
        self._drain_epoch += 1
        self._pos_obs = None
        self._pend_accum = 0
        if self._group_roots:
            self._group_roots = [[torch.full_like(r, -1) for r in roots]
                                 for roots in self._group_roots]

    def _shard_xs(self, xs: Any) -> List[Dict[str, torch.Tensor]]:
        """`advance_packed`'s columns as one dict a shard: `upload`'s list
        as it is, a whole [T, K_padded] dict split into the key blocks."""
        if isinstance(xs, (list, tuple)):
            if len(xs) != self.n_shards:
                raise ValueError(f"{len(xs)} column shards for {self.n_shards} shards")
            return list(xs)
        return [xs] if self.mesh is None else shard_xs(xs, self.mesh)

    def _flush_group(self) -> None:
        """Fold the accumulated group window back into the node region:
        the group flush once a shard, on that shard's window."""
        if not self._group_ys:
            return
        windows = [concat_group_window([ys[sh] for ys in self._group_ys],
                                       [roots[sh] for roots in self._group_roots])
                   for sh in range(self.n_shards)]
        self._group_ys = []
        self._group_roots = []
        flushed = self._map_shards(lambda st, pl, win: self._flush(st, pl, *win),
                                   self._state, self._pool, windows)
        self._state = [st for st, _pl in flushed]
        self._pool = [pl for _st, pl in flushed]
        self.flushes += 1
        self._m_flushes.inc()
        self._m_gc_phase.set(0)

    def _window_pool_view(self) -> List[Dict[str, torch.Tensor]]:
        """Mid-group drain view, one a shard: node planes with the group's
        window segments appended past the region (padded to the full group
        extent with invalid rows), so window ids index it directly."""
        if not self._group_ys:
            return self._pool
        planes = {"node_event": "w_event", "node_name": "w_name", "node_pred": "w_pred"}
        n_pad = self.gc_group - len(self._group_ys)
        views = []
        for sh, pool in enumerate(self._pool):
            out = dict(pool)
            segs_by_plane = {p: [pool[p]] for p in planes}
            for ys in self._group_ys:
                win = window_planes(ys[sh])
                for plane, wkey in planes.items():
                    segs_by_plane[plane].append(win[wkey])
            for plane, segs in segs_by_plane.items():
                if n_pad > 0:
                    segs.append(torch.full(
                        (n_pad * segs[1].shape[0],) + tuple(segs[1].shape[1:]), -1,
                        dtype=segs[1].dtype, device=segs[1].device,
                    ))
                out[plane] = torch.cat(segs, dim=0)
            views.append(out)
        return views

    def _pull_raw_flat(self, views: List[Dict[str, torch.Tensor]]) -> Optional[Dict[str, Any]]:
        """One [3, K] probe (counts, cursors, chain-depth bound; a [3, K/n]
        part a shard), then the chain-flatten table sized to pow2 buckets
        of the probed maxima over every key, one [3, Mb, Cb, K/n] part a
        shard, each copied to the host once. Clears the ring. The pending,
        ring and chain-depth gauges ride the probe."""
        t0 = time.perf_counter()
        # The depth bound is walked on every shard when any key is pending
        # (so the table's Cb is the unsharded engine's).
        pending = None if len(views) == 1 else any(
            bool((v["pend_count"] > 0).any()) for v in views)
        probe = np.concatenate([drain_probe(v, pending).cpu().numpy() for v in views], axis=-1)
        counts = probe[0]
        self._m_pending.set(int(counts.sum()))
        self._m_pend_occupancy.set(int(probe[1].max()))
        self._m_chain_depth.set(int(probe[2].max()))
        if counts.sum() == 0:
            if int(probe[1].max()) > 0:
                self._pool = [drain_pend(pl) for pl in self._pool]
            self._ring_cleared()
            return None
        Mb = pow2_at_least(int(counts.max()), views[0]["pend"].shape[0])
        Cb = pow2_at_least(int(probe[2].max()), views[0]["node_event"].shape[0])
        flatten = build_chain_flatten(Mb, Cb)
        sources = [flatten(v) for v in views]
        tables, events = [], []
        for source in sources:
            if source.device.type == "cuda":
                # The copy into pinned memory is queued, not waited on: the
                # worker waits on the event. The ring clear below runs
                # after it on the same stream.
                table = torch.empty(source.shape, dtype=source.dtype, pin_memory=True)
                table.copy_(source, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(source.device))
                events.append(event)
            else:
                table = source.numpy()
            tables.append(table)
        self._pool = [drain_pend(pl) for pl in self._pool]
        self._ring_cleared()
        raw = {"counts": counts, "tables": tables, "events": events, "sources": sources,
               "pull_s": time.perf_counter() - t0,
               "bytes": int(probe.nbytes + sum(t.numel() * t.element_size() for t in sources))}
        if not events:
            land_table(raw)  # on the CPU the table is on the host already
        return raw

    def _pull_raw_pool(self) -> Optional[Dict[str, Any]]:
        """The pool drain's pull (module doc): one [2, K] probe (counts,
        cursors), then `drain_compact` on each shard -- the closure marked
        from the ring's occupied prefix, whose extent (the largest cursor
        over every key) the probe gives, and compacted to its rank space
        -- and the remapped ring's valid ids moved to each key's front;
        the ring sliced at pow2(max count) and the closure's [3, Bb, K]
        planes at pow2(max closure), both over every key, are copied to
        the host, synchronously, and joined along the key axis. Clears the
        ring. The pending and ring gauges ride the probe."""
        t0 = time.perf_counter()
        both = np.concatenate([torch.stack([pl["pend_count"], pl["pend_pos"]]).cpu().numpy()
                               for pl in self._pool], axis=-1)
        counts = both[0]
        self._m_pending.set(int(counts.sum()))
        self._m_pend_occupancy.set(int(both[1].max()))
        if counts.sum() == 0:
            if int(both[1].max()) > 0:
                self._pool = [drain_pend(pl) for pl in self._pool]
            self._ring_cleared()
            return None
        B, M = self._pool[0]["node_event"].shape[0], self._pool[0]["pend"].shape[0]
        maxpos = int(both[1].max())
        compacts = [self._drain_compact(pl, maxpos) for pl in self._pool]
        Bb = pow2_at_least(max(int(pcount.max()) for _p, _n, pcount in compacts), B)
        Mb = pow2_at_least(int(counts.max()), M)
        # One [3, Bb, K/n] and one [Mb, K/n] copy a shard.
        pulled = np.concatenate([nodes3[:, :Bb].cpu().numpy() for _p, nodes3, _c in compacts],
                                axis=-1)
        pend_np = np.concatenate([compact_valid_front(pend_r)[0][:Mb].cpu().numpy()
                                  for pend_r, _n, _c in compacts], axis=-1)
        self._pool = [drain_pend(pl) for pl in self._pool]
        self._ring_cleared()
        return {
            "counts": counts,
            "pend": pend_np.T,                  # [K, Mb]
            "node_event": pulled[0].T,          # [K, Bb], closure-rank ids
            "node_name": pulled[1].T,
            "node_pred": pulled[2].T,
            "pull_s": time.perf_counter() - t0,
            "bytes": int(pulled.nbytes + pend_np.nbytes + both.nbytes),
        }

    def _decode_flat(
        self, raw: Dict[str, Any], trigger: str = "drain",
        events: Optional[Dict[int, Event]] = None,
    ) -> Dict[Any, List[Any]]:
        """Decode the flat [3, Mb, Cb, K] table (host numpy) into per-key
        `Sequence`s (`SinkMatch`es with a bytes sink_format) against the
        event registry `events` (default: the engine's): hops are
        newest-first, hops with gidx < 0 (a GC-dropped put) are skipped
        while the chain goes on, and an all-dead chain decodes to nothing.
        Sampled matches get their provenance here."""
        if events is None:
            events = self._events
        table = raw["table"]
        counts = np.ascontiguousarray(raw["counts"], np.int32)
        # [3, Mb, Cb, K] -> per-plane [K, Mb, Cb] strided views (no copy).
        gidx, name, live = (np.moveaxis(table[i], -1, 0) for i in range(3))
        if self.sink_format != "objects":
            out = self._decode_flat_bytes(counts, gidx, name, live, events)
            if self.provenance_sample > 0.0 and out:
                self._sample_bytes_provenance(trigger, counts, gidx, name, live, out, events)
            return out
        if not self.native:
            out = self._decode_flat_python(counts, gidx, name, live, events)
        else:
            qid_tab = self.query.qid_of_name_id
            per_key = self._native_decoder().decode_matches_flat(
                counts, gidx, name, live, self.query.name_of_id, events,
                Staged, Sequence,
                None if qid_tab is None else np.ascontiguousarray(qid_tab, np.int32))
            out = {self.keys[k]: seqs for k, seqs in enumerate(per_key) if seqs}
        self._attach_provenance(out, trigger)
        return out

    def _decode_pool_raw(
        self, raw: Dict[str, Any], trigger: str = "drain",
        events: Optional[Dict[int, Event]] = None,
    ) -> Dict[Any, List[Any]]:
        """Decode a pool drain's pulled ring ([K, Mb]) and closure planes
        ([K, Bb]) into per-key `Sequence`s (stacked queries: `(qid,
        Sequence)` pairs): the native `decode_matches`, or the vectorized
        Python walk (`decode_chains`, native=False), the JAX engine's
        reference. Each key's first counts[k] ring entries walk in ring
        order; a -1 entry (a chain a GC nulled under region overflow,
        which node_drops counts) and an all-dead chain decode to nothing.
        Sampled matches get their provenance here."""
        if events is None:
            events = self._events
        qid_tab = self.query.qid_of_name_id
        counts = np.ascontiguousarray(raw["counts"], np.int32)
        if self.native:
            per_key = self._native_decoder().decode_matches(
                counts, raw["pend"], raw["node_event"], raw["node_name"], raw["node_pred"],
                self.query.name_of_id, events, Staged, Sequence,
                None if qid_tab is None else np.ascontiguousarray(qid_tab, np.int32))
            out = {self.keys[k]: seqs for k, seqs in enumerate(per_key) if seqs}
        else:
            out = self._decode_pool_raw_python(raw, events)
        self._attach_provenance(out, trigger)
        return out

    def _decode_pool_raw_python(self, raw: Dict[str, Any],
                            events: Dict[int, Event]) -> Dict[Any, List[Any]]:
        """The pool walk in numpy + Python: every key's planes flattened
        into one index space, every chain walked in one vectorized pass."""
        qid_tab = self.query.qid_of_name_id
        pend, node_event = raw["pend"], raw["node_event"]
        node_name, node_pred = raw["node_name"], raw["node_pred"]
        K, B = node_event.shape
        key_base = (np.arange(K, dtype=np.int64) * B)[:, None]
        flat_pred = np.where(node_pred >= 0, node_pred + key_base, -1).reshape(-1)
        counts = np.asarray(raw["counts"], np.int64)
        jmask = np.arange(pend.shape[1])[None, :] < counts[:, None]
        ks, js = np.nonzero(jmask)  # row-major: each key's ring order
        vals = pend[ks, js].astype(np.int64)
        starts = np.where(vals >= 0, vals + ks * B, -1)
        chains = decode_chains(starts, node_name.reshape(-1), node_event.reshape(-1), flat_pred)
        out: Dict[Any, List[Any]] = {}
        for k, chain in zip(ks.tolist(), chains):
            if not chain:
                continue
            seq = materialize_sequence(chain, self.query.name_of_id, events)
            out.setdefault(self.keys[k], []).append(
                seq if qid_tab is None else (int(qid_tab[chain[0][0]]), seq))
        return out

    def _native_decoder(self):
        if self._decoder is None:
            from ..native import load_decoder

            self._decoder = load_decoder()
        return self._decoder

    def _decode_flat_bytes(self, counts, gidx, name, live, events) -> Dict[Any, List[SinkMatch]]:
        """The sink-to-bytes decode: JSON payloads, or Arrow column
        buffers wrapped into IPC streams, and ident frames from the native
        decoder (or `sink_match_from_sequence` of the Python walk),
        counted in `cep_sink_matches_total`/`cep_sink_bytes_total`."""
        fmt = self.sink_format
        if not self.native:
            out = {k: [sink_match_from_sequence(s, fmt) for s in v]
                   for k, v in self._decode_flat_python(counts, gidx, name, live, events).items()}
        else:
            dec = self._native_decoder()
            fn = dec.decode_matches_json if fmt == "json" else dec.decode_matches_arrow
            per_key = fn(counts, gidx, name, live, self.query.name_of_id, events,
                         Staged, Sequence, json_fragment)
            out = {}
            for k, items in enumerate(per_key):
                if not items:
                    continue
                if fmt == "json":
                    out[self.keys[k]] = [SinkMatch(fmt, *item) for item in items]
                else:
                    out[self.keys[k]] = [
                        SinkMatch(fmt, arrow_ipc_from_columns(so, sd, vo, vd, rows), ident, last)
                        for so, sd, vo, vd, rows, ident, last in items]
        n_matches = sum(len(v) for v in out.values())
        if n_matches:
            self._m_sink_matches.inc(n_matches)
            self._m_sink_bytes.inc(sum(len(sm.payload) for v in out.values() for sm in v))
        return out

    # ------------------------------------------------------------- provenance
    def _attach_provenance(self, decoded: Dict[Any, List[Any]], trigger: str) -> None:
        """Attach a `MatchProvenance` to every 1/provenance_sample-th
        decoded Sequence and keep it in the ring. A stacked query's
        `(qid, Sequence)` pair is named by its query."""
        if self.provenance_sample <= 0.0 or not decoded:
            return
        names = self.query.query_names
        for key, seqs in decoded.items():
            for item in seqs:
                self._prov_acc += self.provenance_sample
                if self._prov_acc < 1.0:
                    continue
                self._prov_acc -= 1.0
                if isinstance(item, tuple):
                    qid, seq = item
                    qname = (names[qid] if names is not None and 0 <= qid < len(names)
                             else f"q{qid}")
                else:
                    seq, qname = item, self.query_name or "q"
                prov = sequence_provenance(seq, query=qname, trigger=trigger)
                seq.provenance = prov
                with self._prov_lock:
                    self._prov_ring.append((key, prov))
                self._m_prov.inc()

    def _sample_bytes_provenance(
        self, trigger: str, counts, gidx, name, live, out: Dict[Any, List[SinkMatch]],
        events: Dict[int, Event],
    ) -> None:
        """Provenance for the JSON decode: the stride accumulator advances
        per match as on the object path, and each sampled SinkMatch
        re-walks its chain through `materialize_sequence` for the
        exemplar, attached as `.sequence` with its explain `.lineage`."""
        qname = self.query_name or "q"
        Mb, Cb = gidx.shape[1], gidx.shape[2]
        for k in range(min(gidx.shape[0], len(self.keys))):
            sms = out.get(self.keys[k])
            if not sms:
                continue
            want: Dict[int, SinkMatch] = {}
            for pos in range(len(sms)):
                self._prov_acc += self.provenance_sample
                if self._prov_acc >= 1.0:
                    self._prov_acc -= 1.0
                    want[pos] = sms[pos]
            if not want:
                continue
            pos = 0
            for j in range(min(int(counts[k]), Mb)):
                chain: List[Tuple[int, int]] = []
                for c in range(Cb):
                    if not live[k, j, c]:
                        break
                    g = int(gidx[k, j, c])
                    if g >= 0:
                        chain.append((int(name[k, j, c]), g))
                if not chain:
                    continue
                sm = want.get(pos)
                pos += 1
                if sm is None:
                    continue
                chain.reverse()
                seq = materialize_sequence(chain, self.query.name_of_id, events)
                prov = sequence_provenance(seq, query=qname, trigger=trigger)
                seq.provenance = prov
                sm.sequence = seq
                sm.lineage = match_lineage(seq, prov)
                with self._prov_lock:
                    self._prov_ring.append((self.keys[k], prov))
                self._m_prov.inc()

    def provenance_exemplars(self, limit: int = 64) -> List[Dict[str, Any]]:
        """Recent sampled match-lineage exemplars as JSON-ready dicts,
        newest first; a lane handle's key is unwrapped to the record key."""
        with self._prov_lock:
            snap = list(self._prov_ring)
        out: List[Dict[str, Any]] = []
        for key, prov in snap[::-1][: max(0, limit)]:
            entry = prov.to_dict()
            entry["key"] = str(getattr(key, "key", key))
            out.append(entry)
        return out

    def _decode_flat_python(
        self, counts, gidx, name, live, events: Optional[Dict[int, Event]] = None,
    ) -> Dict[Any, List[Sequence]]:
        """The Python walk over the flat table: the reference for the
        native decoder. A stacked query's matches come out as
        `(qid, Sequence)` pairs (chains never span queries)."""
        if events is None:
            events = self._events
        qid_tab = self.query.qid_of_name_id
        K, Mb, _ = gidx.shape
        out: Dict[Any, List[Sequence]] = {}
        for k in np.flatnonzero(counts[:K]).tolist():
            n = min(int(counts[k]), Mb)
            # Python lists per key: list reads cost far less than numpy
            # scalar indexing in the hop loop.
            g_rows, n_rows, l_rows = (a[k, :n].tolist() for a in (gidx, name, live))
            seqs: List[Any] = []
            for j in range(n):
                chain: List[Tuple[int, int]] = []
                for g, nm, lv in zip(g_rows[j], n_rows[j], l_rows[j]):
                    if not lv:
                        break
                    if g >= 0:
                        chain.append((nm, g))
                if not chain:
                    continue
                chain.reverse()
                seq = materialize_sequence(chain, self.query.name_of_id, events)
                seqs.append(seq if qid_tab is None else (int(qid_tab[chain[0][0]]), seq))
            if seqs:
                out[self.keys[k]] = seqs
        return out

    def _prune_events(self) -> None:
        """Bound the host event registry: keep pool-referenced events plus
        anything packed ahead of the processed watermark."""
        self._events = pruned_events(self._events, self._pool, self.events_prune_threshold,
                                     self._processed_gidx)
