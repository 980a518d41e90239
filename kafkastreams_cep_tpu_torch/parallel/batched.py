"""Multi-key batched driver: thousands of per-key NFAs advanced on one card.

The port's counterpart of the JAX package's `parallel/batched.py`, cut to
the core loop of the main path: pack per-key event lists into [T, K]
columns (the native packer, native/packer.cc), advance every key through
the step (the CUDA kernel on the card), append each advance's matches to
the pending ring, fold the node window back with the group-flush GC, and
drain by walking every pending chain on the device into one dense table
that is copied to the host once and decoded by the native decoder
(native/decoder.cc) into `Sequence`s or, with `sink_format="json"`,
straight into JSON sink bytes (`SinkMatch`). The key axis grows with
`add_keys`.

`native=False` packs and decodes in Python instead: the reference the
tests hold the native code to. With `native=True` a schema whose fields
are not all int32/float32 packs in Python too (the packer writes only
4-byte columns); `pack_route` says which route the last pack took.

Left for later slices (see ROADMAP.md): the capacity autosizer,
`auto_drain` and `on_overflow` policies, snapshot/restore/resize, exact
replay, Arrow sinks, provenance sampling, metrics, the decode worker
thread and the mesh. The JAX engine's options for them are not
parameters here, so passing one raises TypeError (`sink_format="arrow"`
and `on_overflow` other than "drop" raise ValueError); the parity tests
build the JAX engine with them off (`auto_drain=False`,
`exact_replay=False`, `provenance_sample=0`, `drain_mode="flat"`).

The device is explicit: `device=None` means "cuda", and a missing card
raises instead of running on the CPU. `engine="cuda"` (the default on the
card) runs the hand-written kernel; `engine="torch"` runs the plain step,
which is also what CPU tensors get.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from ..core.event import Event
from ..core.sequence import Sequence, Staged
from ..ops.engine import (
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
from ..ops.runtime import materialize_sequence, rebase_watermarks
from ..ops.schema import EventSchema
from ..ops.tables import CompiledQuery, compile_query
from ..pattern.stages import Stages
from ..streams.serde import SinkMatch, json_fragment, sink_match_from_sequence
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
        if self.config.on_overflow != "drop":
            raise ValueError(
                "on_overflow 'raise'/'block' is not ported yet; drops are "
                "counted in lane_drops/node_drops/match_drops"
            )
        if self.config.reorder_capacity > 0:
            raise ValueError("the event-time reorder gate is not ported yet")
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
        self.keys.extend(new_keys)
        self.K = len(self.keys)
        self.key_index = {k: i for i, k in enumerate(self.keys)}

    @property
    def stats(self) -> Dict[str, int]:
        """Cross-key counter totals (one reduction + one host copy)."""
        pulled = {k: int(v) for k, v in global_stats(self.state).items()}
        return {k: pulled[k] for k in STATE_COUNTER_KEYS}

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
        happens; matches wait in the ring until `drain()`. Size
        `EngineConfig.matches` for the interval (overflow shows in
        `stats["match_drops"]`)."""
        if self._pack_hwms:
            self._processed_gidx = max(self._processed_gidx, self._pack_hwms.popleft())
        self.state, ys = self._advance(self.state, xs)
        self.state, self.pool, page_roots = self._append(self.state, self.pool, ys)
        self._group_ys.append({k: ys[k] for k in ("w_event", "w_name", "w_pred")})
        self._group_roots.append(page_roots)
        if len(self._group_ys) >= self.gc_group:
            self._flush_group()
        return self.drain() if decode else {}

    def drain(self) -> Dict[Any, List[Any]]:
        """Decode and clear all pending matches (a host sync point):
        `Sequence`s, or `SinkMatch`es with sink_format="json"."""
        out: Dict[Any, List[Any]] = {}
        raw = self._pull_raw_flat(self._window_pool_view())
        if raw is not None:
            out = self._decode_flat(raw)
        if not self._group_ys:
            self._prune_events()
        return out

    # ------------------------------------------------------------ internals
    def _ring_cleared(self) -> None:
        """The ring was just drained: blank the group's accumulated page
        roots, whose matches were all pulled (re-pinning them at the
        flush would retain garbage)."""
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
        copied to the host once. Clears the ring."""
        probe = drain_probe(pool_view).cpu().numpy()
        counts = probe[0]
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
        return {"counts": counts, "table": table}

    def _decode_flat(self, raw: Dict[str, Any]) -> Dict[Any, List[Any]]:
        """Decode the flat [3, Mb, Cb, K] table into per-key `Sequence`s
        (`SinkMatch`es with sink_format="json"): hops are newest-first,
        hops with gidx < 0 (a GC-dropped put) are skipped while the chain
        goes on, and an all-dead chain decodes to nothing."""
        table = raw["table"]
        counts = np.ascontiguousarray(raw["counts"], np.int32)
        # [3, Mb, Cb, K] -> per-plane [K, Mb, Cb] strided views (no copy).
        gidx, name, live = (np.moveaxis(table[i], -1, 0) for i in range(3))
        if not self.native:
            seqs = self._decode_flat_python(counts, gidx, name, live)
            if self.sink_format == "json":
                return {k: [sink_match_from_sequence(s, "json") for s in v]
                        for k, v in seqs.items()}
            return seqs
        if self._decoder is None:
            from ..native import load_decoder

            self._decoder = load_decoder()
        args = (counts, gidx, name, live, self.query.name_of_id, self._events,
                Staged, Sequence)
        if self.sink_format == "json":
            per_key = self._decoder.decode_matches_json(*args, json_fragment)
            return {self.keys[k]: [SinkMatch("json", *item) for item in items]
                    for k, items in enumerate(per_key) if items}
        per_key = self._decoder.decode_matches_flat(*args)
        return {self.keys[k]: seqs for k, seqs in enumerate(per_key) if seqs}

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
