"""Multi-key batched driver: thousands of per-key NFAs advanced on one card.

The port's counterpart of the JAX package's `parallel/batched.py`: pack
per-key event lists into [T, K] columns (the native packer,
native/packer.cc), advance every key through the step (the CUDA kernel on
the card), append each advance's matches to the pending ring, fold the
node window back with the group-flush GC, and drain by walking every
pending chain on the device into one dense table that is copied to the
host once and decoded by the native decoder (native/decoder.cc) into
`Sequence`s or, with `sink_format="json"`, straight into JSON sink bytes
(`SinkMatch`). The key axis grows with `add_keys`.

Capacity contract (the JAX engine's): with `auto_drain=True` (the
default) a guard before every advance pulls the pending-match ring off
the device whenever that advance's worst case could overflow it (or
undrained pins squeeze the node region), so deferred decode
(`advance_packed(decode=False)`) loses nothing; the guard reads an
asynchronous probe of the ring cursor and never synchronizes the
advance. `EngineConfig.on_overflow` is "drop" (drops counted, and loud in
`cep_overflow_dropped_total`), "raise" (`CEPOverflowError` at the next
drain, carrying the drained matches) or "block" (a forced drain before
any advance that could overflow). The port decodes an auto-drained table
on the calling thread and hands it out ahead of the next `drain()`'s own
matches, so every key's matches keep their order.

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

Left for later slices (see ROADMAP.md): the capacity autosizer, Arrow
sinks, the decode worker thread, compile telemetry and the mesh. The JAX
engine's options for them are not parameters here, so passing one raises
TypeError (`sink_format="arrow"` raises ValueError).

The device is explicit: `device=None` means "cuda", and a missing card
raises instead of running on the CPU. `engine="cuda"` (the default on the
card) runs the hand-written kernel; `engine="torch"` runs the plain step,
which is also what CPU tensors get.
"""
from __future__ import annotations

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
from ..obs.registry import MetricsRegistry, next_instance_id
from ..ops.engine import (
    DROP_COUNTER_KEYS,
    STATE_COUNTER_KEYS,
    WM_NONE,
    EngineConfig,
    build_append_post,
    build_chain_flatten,
    build_flush_post,
    concat_group_window,
    drain_pend,
    drain_probe,
    eval_stateless_preds,
    window_planes,
)
from ..ops.profiling import BatchTimings
from ..ops.replay import device_to_oracle, oracle_to_device, supports_replay
from ..ops.runtime import materialize_sequence, rebase_watermarks, sequence_provenance
from ..ops.schema import EventSchema
from ..ops.tables import CompiledQuery, compile_query
from ..pattern.stages import Stages
from ..state import serde
from ..streams.serde import SinkMatch, json_fragment, match_lineage, sink_match_from_sequence
from .key_shard import (
    ENGINES,
    build_batched_advance,
    global_stats,
    init_batched_pool,
    init_batched_state,
)

#: Rebase margin: keys first seen after the base is fixed may start up to
#: this much earlier and still rebase non-negative.
TS_REBASE_MARGIN_MS = 1 << 20

SINK_FORMATS = ("objects", "json")


def resolve_device(device: Any = None) -> torch.device:
    """`None` -> the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch step on the CPU"
        )
    return dev


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
        engine: Optional[str] = None,
        events_prune_threshold: int = 1 << 16,
        native: bool = True,
        sink_format: str = "objects",
        auto_drain: bool = True,
        exact_replay: bool = True,
        profile_sync: bool = False,
        profile_every: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        provenance_sample: float = 0.0,
        provenance_ring: int = 256,
        query_name: Optional[str] = None,
    ) -> None:
        if sink_format == "arrow":
            raise ValueError("sink_format='arrow' is not ported (ROADMAP.md item 5e)")
        if sink_format not in SINK_FORMATS:
            raise ValueError(f"unknown sink_format {sink_format!r} (expected one of {SINK_FORMATS})")
        if isinstance(stages_or_query, CompiledQuery):
            self.query = stages_or_query
        else:
            assert isinstance(stages_or_query, Stages)
            self.query = compile_query(stages_or_query, schema)
        self.config = config if config is not None else EngineConfig()
        self.device = resolve_device(device)
        if engine is None:
            engine = "cuda" if self.device.type == "cuda" else "torch"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")
        self.engine = engine
        self.native = bool(native)
        self.sink_format = sink_format
        #: "native" or "python": the route the last `pack` took.
        self.pack_route: Optional[str] = None
        self._packer = None
        self._decoder = None
        self.keys: List[Any] = list(keys)
        if not self.keys:
            raise ValueError("BatchedDeviceNFA needs at least one key")
        self.K = len(self.keys)
        self.key_index: Dict[Any, int] = {k: i for i, k in enumerate(self.keys)}
        self.state = init_batched_state(self.query, self.config, self.K, self.device)
        self.pool = init_batched_pool(self.query, self.config, self.K, self.device)
        self._advance = build_batched_advance(self.query, self.config, engine)
        self._append = build_append_post(self.config)
        self._flush = build_flush_post(self.query, self.config)
        #: GC group cadence: the pend append runs every advance, the
        #: mark/sweep folds the accumulated window back every G-th.
        self.gc_group = max(int(self.config.gc_group), 1)
        self._group_ys: List[Dict[str, torch.Tensor]] = []
        self._group_roots: List[torch.Tensor] = []
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
        #: Decoded matches of engine-initiated drains (auto-drain,
        #: backpressure) with their pull/decode walls and bytes, FIFO,
        #: handed out ahead of the next `drain()`'s.
        self._auto_out: List[Tuple[Dict[Any, List[Any]], Dict[str, float]]] = []
        #: Drop-counter totals already reported: the overflow policy acts
        #: on deltas (a restored engine carries historic totals).
        self._drop_base: Dict[str, int] = {k: 0 for k in DROP_COUNTER_KEYS}
        #: Group flushes so far (mark/sweep passes).
        self.flushes = 0
        #: Exact replay (module doc): armed only when the query folds.
        self.exact_replay = bool(exact_replay) and supports_replay(self.query)
        self.replays = 0
        self._warned_collisions = False
        #: The interval's starting generation (state, pool), by reference;
        #: None while replay is off, so no dead generation stays alive.
        self._snap: Optional[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]] = (
            (self.state, self.pool) if self.exact_replay else None)
        #: The interval's event ledger: (gidx [T, K], valid [T, K]) of each
        #: advanced batch, host arrays from `pack_host` (or the device
        #: columns of externally packed xs, read at the drain).
        self._interval_packs: List[Tuple[Any, Any]] = []
        self._interval_overflow = False
        #: Host (gidx, valid) of packed batches not yet advanced, FIFO.
        self._pack_meta: deque = deque()
        #: seq_collisions per key at the interval's start.
        self._collision_base = np.zeros(self.K, np.int64)
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
        ).labels(instance=inst, engine=self.engine, drain_mode="flat").set(1)

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
            "Matches decoded straight to sink bytes (sink_format json)",
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

    # ------------------------------------------------------------------ API
    def add_keys(self, new_keys: Seq[Any]) -> None:
        """Grow the key axis: fresh engine state and pool for each new key,
        concatenated on the trailing key axis. The group window is flushed
        first: it carries the old key extent. The kernel takes K at each
        launch, so nothing is rebuilt; callers grow geometrically all the
        same (streams/device_processor.py doubles)."""
        new_keys = list(new_keys)
        for k in new_keys:
            if k in self.key_index:
                raise KeyError(f"key {k!r} already assigned")
        self._flush_group()
        n = len(new_keys)
        fresh_state = init_batched_state(self.query, self.config, n, self.device)
        fresh_pool = init_batched_pool(self.query, self.config, n, self.device)
        self.state = {k: torch.cat([v, fresh_state[k]], dim=-1) for k, v in self.state.items()}
        self.pool = {k: torch.cat([v, fresh_pool[k]], dim=-1) for k, v in self.pool.items()}
        if self.exact_replay:
            # The new keys' interval starts at their init state.
            snap_s, snap_p = self._snap
            self._snap = (
                {k: torch.cat([v, fresh_state[k]], dim=-1) for k, v in snap_s.items()},
                {k: torch.cat([v, fresh_pool[k]], dim=-1) for k, v in snap_p.items()},
            )
            self._collision_base = np.concatenate(
                [self._collision_base, np.zeros(n, np.int64)])
        self.keys.extend(new_keys)
        self.K = len(self.keys)
        self.key_index = {k: i for i, k in enumerate(self.keys)}

    @property
    def stats(self) -> Dict[str, int]:
        """Cross-key counter totals (one reduction + one host copy); the
        `cep_engine_state_counter` gauges ride this explicit pull."""
        pulled = {k: int(v) for k, v in global_stats(self.state).items()}
        out = {k: pulled[k] for k in STATE_COUNTER_KEYS}
        for k, v in out.items():
            self._m_state.labels(instance=self.instance_id, counter=k).set(v)
        return out

    def runs(self, key: Any) -> int:
        return int(self.state["runs"][self.key_index[key]])

    def n_live(self, key: Any) -> int:
        return int(self.state["active"][:, self.key_index[key]].sum())

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
        lists: List[Seq[Event]] = [() for _ in range(self.K)]
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

        K = self.K
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

    def upload(self, cols: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Copy `pack_host`'s columns to the device and evaluate the
        stateless predicates there."""
        xs = {k: torch.from_numpy(v).to(self.device) for k, v in cols.items()}
        xs["spred"] = eval_stateless_preds(self.query, xs)
        return xs

    def _wm_column(self, lists, watermarks, T: int) -> np.ndarray:
        wm_col = np.full((T, self.K), WM_NONE, np.int32)
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
        self, xs: Dict[str, torch.Tensor], decode: bool = True
    ) -> Dict[Any, List[Sequence]]:
        """Advance with pre-packed columns. With decode=False no host sync
        happens on the advance itself; matches wait in the ring until
        `drain()` (or an auto-drain pulls them, see the module doc)."""
        T = int(xs["valid"].shape[0])
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
            self.state, ys = self._advance(self.state, xs)
        else:
            # `engine.device_step` transient site: the step is functional
            # (state reassigned only on success), so a bounded retry is
            # exact.
            def _step():
                _flt.ACTIVE.fire("engine.device_step")
                return self._advance(self.state, xs)

            self.state, ys = with_retry(
                _step, site="engine.device_step",
                retry_on=(TransientFault,), registry=self.metrics,
            )
        t_adv = time.perf_counter()
        if sampled:
            marks.append(self._profile_mark())
        self.state, self.pool, page_roots = self._append(self.state, self.pool, ys)
        self._group_ys.append({k: ys[k] for k in ("w_event", "w_name", "w_pred")})
        self._group_roots.append(page_roots)
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
            t_adv - t0, int(np.prod(tuple(xs["valid"].shape))),
            post_s=time.perf_counter() - t_adv,
        )
        return self.drain() if decode else {}

    def drain(self) -> Dict[Any, List[Any]]:
        """Decode and clear all pending matches (a host sync point):
        `Sequence`s, or `SinkMatch`es with sink_format="json". Matches of
        earlier engine-initiated drains come first in every key's list.
        With exact replay armed, the keys whose folds diverged in the
        interval get the oracle's matches instead (`_replay_boundary`).
        Ends with the overflow-policy check (`_check_drop_counters`)."""
        t0 = time.perf_counter()
        out: Dict[Any, List[Any]] = {}
        pending, self._auto_out = self._auto_out, []
        self._pend_accum = 0
        raw = self._pull_raw()
        if _flt.ACTIVE is not None:
            # `engine.mid_drain` crash site: the ring was pulled and
            # cleared on the device but not decoded -- a crash here loses
            # every in-flight match unless the pipeline above recovers
            # from its last commit.
            _flt.ACTIVE.fire("engine.mid_drain")
        if raw is not None:
            pending.append(self._decode_raw(raw, "drain"))
        pull_s = decode_s = 0.0
        n_bytes = 0
        for decoded, meta in pending:
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
        """Flush the group and copy state and pool to the host."""
        self._flush_group()
        return ({k: v.cpu().numpy() for k, v in self.state.items()},
                {k: v.cpu().numpy() for k, v in self.pool.items()})

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
        """A new engine from a `snapshot()` of either package's engine.

        A snapshot taken at other capacities grafts into `config`'s shape,
        or raises `ShapeRestoreError` when its live state does not fit. A
        JAX Pallas engine pads its key axis to a multiple of 8: padding
        columns must hold the init state and are dropped (a column that
        does not raises `CheckpointError`). The restored engine holds
        exactly one state column per key."""
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
        bat.state = {k: torch.from_numpy(np.ascontiguousarray(tree[k][..., :bat.K])).to(bat.device)
                     for k in init_s}
        bat.pool = {k: torch.from_numpy(np.ascontiguousarray(pool_tree[k][..., :bat.K])).to(bat.device)
                    for k in init_p}
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
        bat._pend_accum = int(bat.pool["pend_pos"].max())
        bat._drop_base = {k: int(bat.state[k].sum()) for k in DROP_COUNTER_KEYS}
        if bat.exact_replay:
            # The next interval starts at the restored generation.
            bat._snap = (bat.state, bat.pool)
            bat._collision_base = bat.state["seq_collisions"].cpu().numpy().astype(np.int64)
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
        self._flush_group()

        def to_host(tree):
            return {k: v.cpu().numpy() for k, v in tree.items()}

        state_np, pool_np = to_host(self.state), to_host(self.pool)
        serde.check_restore_capacity(
            state_np, pool_np, lanes=config.lanes, nodes=config.nodes,
            matches=config.matches, where="resize",
        )
        snap_np = None
        if self._snap is not None:
            # The interval replays from this generation: it must fit too.
            snap_np = (to_host(self._snap[0]), to_host(self._snap[1]))
            serde.check_restore_capacity(
                snap_np[0], snap_np[1], lanes=config.lanes, nodes=config.nodes,
                matches=config.matches, where="resize (replay snapshot)",
            )
        advance = build_batched_advance(self.query, config, self.engine)
        if self.engine == "cuda" and self.device.type == "cuda":
            advance.library()  # the nvcc build: raises before anything changes

        def graft(src_state, src_pool):
            tgt_s = {k: v.numpy().copy() for k, v in
                     init_batched_state(self.query, config, self.K).items()}
            tgt_p = {k: v.numpy().copy() for k, v in
                     init_batched_pool(self.query, config, self.K).items()}
            serde.graft_array_tree(src_state, tgt_s)
            serde.graft_array_tree(src_pool, tgt_p)
            return ({k: torch.from_numpy(v).to(self.device) for k, v in tgt_s.items()},
                    {k: torch.from_numpy(v).to(self.device) for k, v in tgt_p.items()})

        self.state, self.pool = graft(state_np, pool_np)
        if snap_np is not None:
            self._snap = graft(*snap_np)
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

    # ------------------------------------------------------------ internals
    def _check_drop_counters(self, drained: Optional[Dict] = None) -> None:
        """Drain-boundary overflow-policy check: pull the three drop
        counters (the drain is already a sync point), make any delta loud
        in `cep_overflow_dropped_total{counter}`, and escalate under
        on_overflow "raise" (always) or "block" (a drop under
        backpressure broke the loss-free promise)."""
        vals = torch.stack([self.state[k].sum() for k in DROP_COUNTER_KEYS]).tolist()
        overflow: Dict[str, int] = {}
        for name, v in zip(DROP_COUNTER_KEYS, vals):
            delta = int(v) - self._drop_base[name]
            if delta > 0:
                overflow[name] = delta
                self._drop_base[name] = int(v)
                self._m_dropped.labels(counter=name).inc(delta)
        if overflow and self.config.on_overflow in ("raise", "block"):
            # The ring was already pulled and cleared: the drained matches
            # ride the exception.
            exc = CEPOverflowError(
                f"engine capacity overflow since the last drain: {overflow} "
                f"(policy {self.config.on_overflow!r}; size EngineConfig "
                "lanes/nodes/matches or use on_overflow='block')"
            )
            exc.matches = drained if drained is not None else {}
            raise exc

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
        """An engine-initiated drain: pull the ring and queue its decoded
        matches for the next `drain()`. Returns whether anything was
        pending."""
        raw = self._pull_raw()
        if raw is None:
            return False
        self._auto_out.append(self._decode_raw(raw, trigger))
        return True

    def _pull_raw(self) -> Optional[Dict[str, Any]]:
        """Pull and clear the ring. Mid-group the flat drain reads the
        region ++ window view, so a drain keeps the GC cadence; with exact
        replay armed it flushes the group first instead, so the interval's
        snapshot (taken at a drain) resolves every node id against its own
        pool."""
        if self.exact_replay:
            self._flush_group()
            return self._pull_raw_flat(self.pool)
        return self._pull_raw_flat(self._window_pool_view())

    def _decode_raw(
        self, raw: Dict[str, Any], trigger: str,
    ) -> Tuple[Dict[Any, List[Any]], Dict[str, float]]:
        """Decode a pulled table (provenance sampled under `trigger`, the
        drain that pulled it); returns the matches and the pull's and
        decode's walls and bytes."""
        t0 = time.perf_counter()
        decoded = self._decode_flat(raw, trigger)
        return decoded, {"pull_s": raw["pull_s"], "decode_s": time.perf_counter() - t0,
                         "bytes": raw["bytes"]}

    # ------------------------------------------------------------ exact replay
    def _ledger_append(self, xs: Dict[str, torch.Tensor]) -> None:
        """Take the advancing batch's event ledger into the interval: the
        host copies `pack_host` made, or, for externally packed xs, the
        device columns themselves (read at the drain, so the advance does
        not synchronize). Past `REPLAY_LEDGER_MAX_BATCHES` the interval
        degrades to detection: one warning, the overflow gauge, and under
        on_overflow="raise" a `CEPOverflowError`."""
        entry = self._pack_meta.popleft() if self._pack_meta else (xs["gidx"], xs["valid"])
        if len(self._interval_packs) < self.REPLAY_LEDGER_MAX_BATCHES:
            self._interval_packs.append(entry)
            return
        if not self._interval_overflow:
            warnings.warn(
                "exact-replay event ledger exceeded "
                f"{self.REPLAY_LEDGER_MAX_BATCHES} batches without a drain; "
                "this interval degrades to collision detection only -- "
                "drain() more often to keep replay armed",
                RuntimeWarning,
            )
        self._interval_overflow = True
        self._m_ledger_overflow.set(1)
        self._interval_packs = []
        if self.config.on_overflow == "raise":
            raise CEPOverflowError(
                "exact-replay event ledger overflowed "
                f"({self.REPLAY_LEDGER_MAX_BATCHES} batches without a drain); "
                "drain() more often or raise the bound"
            )

    def _replay_boundary(self, out: Dict[Any, List[Any]]) -> Dict[Any, List[Any]]:
        """At a drain: each key whose seq_collisions moved since the
        interval's start replays the interval through the host oracle,
        built from the interval's snapshot; the oracle's matches replace
        the key's drained ones and its device state is rebuilt from the
        oracle. Then the next interval starts here."""
        cur = self.state["seq_collisions"].cpu().numpy().astype(np.int64)
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
        self._snap = (self.state, self.pool)
        self._interval_packs = []
        self._interval_overflow = False
        self._m_ledger_overflow.set(0)
        return out

    def _replay_keys(self, hot: np.ndarray, out: Dict[Any, List[Any]]) -> None:
        """Replay the interval of the keys `hot` (a drain-time host step:
        one gather and one copy per leaf for all of them)."""
        idx = torch.as_tensor(hot, dtype=torch.long, device=self.device)

        def columns(tree, names):
            return {n: tree[n].index_select(-1, idx).cpu().numpy() for n in names}

        snap_state, snap_pool = self._snap
        s_np = columns(snap_state, snap_state.keys())
        p_np = columns(snap_pool, ("node_event", "node_name", "node_pred", "node_count"))
        c_np = columns(self.state, STATE_COUNTER_KEYS)
        packs = [tuple(a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in e)
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
            if matches and self.sink_format == "json":
                matches = [sink_match_from_sequence(m, "json") for m in matches]
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
        leaf: the old tensors, which the interval snapshot may hold, are
        never written."""
        ks = sorted(writes)
        idx = torch.as_tensor(ks, dtype=torch.long, device=self.device)
        for which, attr in enumerate(("state", "pool")):
            tree = dict(getattr(self, attr))
            for name, leaf in tree.items():
                cols = np.stack([np.asarray(writes[k][which][name]) for k in ks], axis=-1)
                src = torch.as_tensor(cols).to(dtype=leaf.dtype, device=leaf.device)
                tree[name] = leaf.index_copy(leaf.dim() - 1, idx, src)
            setattr(self, attr, tree)

    def _detect_divergence(self) -> None:
        """Replay off on a folding query: the first drain that sees a
        collision warns once and sets the persistent gauge; under
        on_overflow="raise" it raises."""
        if int(self.state["seq_collisions"].sum()) == 0:
            return
        self._warned_collisions = True
        self._m_divergence.set(1)
        if supports_replay(self.query):
            remedy = "Re-enable exact_replay (default) to recover exactness."
        else:
            remedy = ("This engine cannot replay (no host-stage oracle for this "
                      "compiled query); run the affected query on its own engine "
                      "for oracle-exact folds.")
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
        the current stream on the card, the wall clock on the CPU (where
        the passes run synchronously)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
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
        max live lanes per key] to the host: a pinned buffer and an event
        on the card (no synchronization), the result itself on the CPU."""
        arr = torch.stack([
            self.pool["pend_pos"].max().to(torch.int64),
            self.pool["node_count"].max().to(torch.int64),
            self.state["active"].sum(0).max(),
        ])
        event = None
        if arr.device.type == "cuda":
            host = torch.empty(3, dtype=torch.int64, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            arr = host
        self._pos_probes.append((self._drain_epoch, self._pend_accum, arr, event))

    def _occupancy_bound(self) -> Tuple[int, int, Optional[int]]:
        """(worst-case ring occupancy, freshest observed region fill,
        freshest probed true cursor -- None while no probe has landed).

        Occupancy is the freshest landed cursor probe plus the per-advance
        caps since it (the pure worst-case accumulator while none has
        landed). A probe whose event has not completed is left for later:
        reading it would synchronize."""
        while self._pos_probes:
            epoch, acc, host, event = self._pos_probes[0]
            if event is not None and not event.query():
                break
            self._pos_probes.popleft()
            if epoch == self._drain_epoch:
                pos, fill, lanes = host.tolist()
                self._pos_obs = (acc, pos, fill)
                self.lane_obs = lanes
                self._m_pend_occupancy.set(pos)
                self._m_region_fill.set(fill)
                self._m_lane_occupancy.set(lanes)
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
            self._group_roots = [torch.full_like(r, -1) for r in self._group_roots]

    def _flush_group(self) -> None:
        """Fold the accumulated group window back into the node region."""
        if not self._group_ys:
            return
        ys_cat, roots_cat = concat_group_window(self._group_ys, self._group_roots)
        self._group_ys = []
        self._group_roots = []
        self.state, self.pool = self._flush(self.state, self.pool, ys_cat, roots_cat)
        self.flushes += 1
        self._m_flushes.inc()
        self._m_gc_phase.set(0)

    def _window_pool_view(self) -> Dict[str, torch.Tensor]:
        """Mid-group drain view: node planes with the group's window
        segments appended past the region (padded to the full group
        extent with invalid rows), so window ids index it directly."""
        if not self._group_ys:
            return self.pool
        planes = {"node_event": "w_event", "node_name": "w_name", "node_pred": "w_pred"}
        out = dict(self.pool)
        n_pad = self.gc_group - len(self._group_ys)
        segs_by_plane = {p: [self.pool[p]] for p in planes}
        for ys in self._group_ys:
            win = window_planes(ys)
            for plane, wkey in planes.items():
                segs_by_plane[plane].append(win[wkey])
        for plane, segs in segs_by_plane.items():
            if n_pad > 0:
                segs.append(torch.full(
                    (n_pad * segs[1].shape[0],) + tuple(segs[1].shape[1:]), -1,
                    dtype=segs[1].dtype, device=segs[1].device,
                ))
            out[plane] = torch.cat(segs, dim=0)
        return out

    def _pull_raw_flat(self, pool_view) -> Optional[Dict[str, Any]]:
        """One [3, K] probe (counts, cursors, chain-depth bound), then the
        chain-flatten table sized to pow2 buckets of the probed maxima,
        copied to the host once. Clears the ring. The pending, ring and
        chain-depth gauges ride the probe."""
        t0 = time.perf_counter()
        probe = drain_probe(pool_view).cpu().numpy()
        counts = probe[0]
        self._m_pending.set(int(counts.sum()))
        self._m_pend_occupancy.set(int(probe[1].max()))
        self._m_chain_depth.set(int(probe[2].max()))
        if counts.sum() == 0:
            if int(probe[1].max()) > 0:
                self.pool = drain_pend(self.pool)
            self._ring_cleared()
            return None
        Mb = 1
        while Mb < max(int(counts.max()), 1):
            Mb <<= 1
        Mb = min(Mb, pool_view["pend"].shape[0])
        Cb = 1
        while Cb < max(int(probe[2].max()), 1):
            Cb <<= 1
        Cb = min(Cb, pool_view["node_event"].shape[0])
        table = build_chain_flatten(Mb, Cb)(pool_view).cpu().numpy()
        self.pool = drain_pend(self.pool)
        self._ring_cleared()
        return {"counts": counts, "table": table, "pull_s": time.perf_counter() - t0,
                "bytes": int(probe.nbytes + table.nbytes)}

    def _decode_flat(self, raw: Dict[str, Any], trigger: str = "drain") -> Dict[Any, List[Any]]:
        """Decode the flat [3, Mb, Cb, K] table into per-key `Sequence`s
        (`SinkMatch`es with sink_format="json"): hops are newest-first,
        hops with gidx < 0 (a GC-dropped put) are skipped while the chain
        goes on, and an all-dead chain decodes to nothing. Sampled matches
        get their provenance here."""
        table = raw["table"]
        counts = np.ascontiguousarray(raw["counts"], np.int32)
        # [3, Mb, Cb, K] -> per-plane [K, Mb, Cb] strided views (no copy).
        gidx, name, live = (np.moveaxis(table[i], -1, 0) for i in range(3))
        if self.sink_format == "json":
            out = self._decode_flat_json(counts, gidx, name, live)
            if self.provenance_sample > 0.0 and out:
                self._sample_bytes_provenance(trigger, counts, gidx, name, live, out)
            return out
        if not self.native:
            out = self._decode_flat_python(counts, gidx, name, live)
        else:
            per_key = self._native_decoder().decode_matches_flat(
                counts, gidx, name, live, self.query.name_of_id, self._events,
                Staged, Sequence)
            out = {self.keys[k]: seqs for k, seqs in enumerate(per_key) if seqs}
        self._attach_provenance(out, trigger)
        return out

    def _native_decoder(self):
        if self._decoder is None:
            from ..native import load_decoder

            self._decoder = load_decoder()
        return self._decoder

    def _decode_flat_json(self, counts, gidx, name, live) -> Dict[Any, List[SinkMatch]]:
        """The sink-to-bytes decode: JSON payloads and ident frames from
        the native decoder (or `sink_match_from_sequence` of the Python
        walk), counted in `cep_sink_matches_total`/`cep_sink_bytes_total`."""
        if not self.native:
            out = {k: [sink_match_from_sequence(s, "json") for s in v]
                   for k, v in self._decode_flat_python(counts, gidx, name, live).items()}
        else:
            per_key = self._native_decoder().decode_matches_json(
                counts, gidx, name, live, self.query.name_of_id, self._events,
                Staged, Sequence, json_fragment)
            out = {self.keys[k]: [SinkMatch("json", *item) for item in items]
                   for k, items in enumerate(per_key) if items}
        n_matches = sum(len(v) for v in out.values())
        if n_matches:
            self._m_sink_matches.inc(n_matches)
            self._m_sink_bytes.inc(sum(len(sm.payload) for v in out.values() for sm in v))
        return out

    # ------------------------------------------------------------- provenance
    def _attach_provenance(self, decoded: Dict[Any, List[Sequence]], trigger: str) -> None:
        """Attach a `MatchProvenance` to every 1/provenance_sample-th
        decoded Sequence and keep it in the ring."""
        if self.provenance_sample <= 0.0 or not decoded:
            return
        qname = self.query_name or "q"
        for key, seqs in decoded.items():
            for seq in seqs:
                self._prov_acc += self.provenance_sample
                if self._prov_acc < 1.0:
                    continue
                self._prov_acc -= 1.0
                prov = sequence_provenance(seq, query=qname, trigger=trigger)
                seq.provenance = prov
                with self._prov_lock:
                    self._prov_ring.append((key, prov))
                self._m_prov.inc()

    def _sample_bytes_provenance(
        self, trigger: str, counts, gidx, name, live, out: Dict[Any, List[SinkMatch]],
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
                seq = materialize_sequence(chain, self.query.name_of_id, self._events)
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

    def _decode_flat_python(self, counts, gidx, name, live) -> Dict[Any, List[Sequence]]:
        """The Python walk over the flat table: the reference for the
        native decoder."""
        K, Mb, _ = gidx.shape
        out: Dict[Any, List[Sequence]] = {}
        for k in np.flatnonzero(counts[:K]).tolist():
            n = min(int(counts[k]), Mb)
            # Python lists per key: list reads cost far less than numpy
            # scalar indexing in the hop loop.
            g_rows, n_rows, l_rows = (a[k, :n].tolist() for a in (gidx, name, live))
            seqs: List[Sequence] = []
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
                seqs.append(materialize_sequence(chain, self.query.name_of_id, self._events))
            if seqs:
                out[self.keys[k]] = seqs
        return out

    def _prune_events(self) -> None:
        """Bound the host event registry: keep pool-referenced events plus
        anything packed ahead of the processed watermark."""
        if len(self._events) <= self.events_prune_threshold:
            return
        # The distinct referenced gidx are found on the device: only they
        # cross to the host, not the whole node plane.
        ev = self.pool["node_event"]
        live_gidx = set(torch.unique(ev[ev >= 0]).cpu().tolist())
        hwm = self._processed_gidx
        self._events = {
            g: e for g, e in self._events.items() if g > hwm or g in live_gidx
        }
