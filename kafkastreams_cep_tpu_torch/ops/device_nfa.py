"""Single-key device NFA: the device counterpart of nfa/nfa.py.

The port's `DeviceNFA` (the JAX package's `ops/runtime.py` class of that
name, re-exported from the port's ops/runtime.py): one stream, whatever
its events' keys, advanced batch by batch with its run and buffer state
kept on the device between batches; only match chains (at a drain) and
the oracle's rebuild (at an exact replay) cross to the host.

Design: state and pool are the batched engine's layout at K = 1 -- the
JAX batched state is the single-key `init_state` broadcast along a
trailing key axis (parallel/key_shard.py), so the single-key frame is its
K = 1 slice. Each advance runs what `BatchedDeviceNFA` runs: the step (the
hand-written kernel of csrc/nfa_step.cu on the card, through
ops/step_kernel.py's `NfaStep`; the plain step on CPU tensors), the pend
append, and every `gc_group`-th advance the group flush, whose mark is
the kernel of csrc/gc_mark.cu on the card (ops/gc_kernel.py). The drain
is the JAX class's pool route (its ops/runtime.py `_decode_matches`):
the group flush, a read of the ring's count and cursor, one host copy of
the ring's occupied prefix and the three node planes, and the native
`decode_matches` at K = 1, which walks each chain back through the
planes; `native=False` walks them in Python instead (`decode_chains`,
the JAX class's other route), the reference the tests hold the native
one to. It has no flat drain. Matches come out in the JAX engine's
order.

What differs from `BatchedDeviceNFA` and follows the JAX class: the
timestamp base is the first event's own timestamp (no rebase margin),
every event joins the one stream whatever its key, exact replay keys the
oracle's fold cells by the interval's first event's key and bounds its
ledger by events (`REPLAY_LEDGER_MAX_EVENTS`), and `snapshot()` writes the
JAX single-key frame (MAGIC, state tree, pool tree, event registry, next
event id, timestamp base, batches), the key axis squeezed out, so either
package's snapshot restores on the other.

The device is explicit, as in the batched engine: `device=None` means
"cuda" (a missing card raises); `engine="cuda"` (the default on the card)
runs the kernels, `engine="torch"` the plain step.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.event import Event
from ..core.sequence import Sequence, Staged
from ..faults import injection as _flt
from ..faults.injection import TransientFault, with_retry
from ..obs.registry import MetricsRegistry, next_instance_id
from ..parallel.batched import (
    check_drop_counters,
    fold_group_window,
    pruned_events,
    replay_ledger_overflowed,
    resolve_device,
)
from ..parallel.key_shard import ENGINES, build_batched_advance, init_batched_pool, init_batched_state
from ..pattern.stages import Stages
from ..state import serde
from .engine import (
    DROP_COUNTER_KEYS,
    STATE_COUNTER_KEYS,
    WINDOW_PLANES,
    EngineConfig,
    build_append_post,
    build_flush_post,
    drain_pend,
    eval_stateless_preds,
)
from .replay import device_to_oracle, oracle_to_device, supports_replay
from .runtime import decode_chains, materialize_sequence, rebase_watermarks
from .schema import EventSchema
from .tables import CompiledQuery, compile_query


class DeviceNFA:
    """Single-key device NFA (module doc)."""

    #: exact-replay event-ledger bound (events per drain interval).
    REPLAY_LEDGER_MAX_EVENTS = 1 << 20

    def __init__(
        self,
        stages_or_query: Any,
        schema: Optional[EventSchema] = None,
        config: Optional[EngineConfig] = None,
        events_prune_threshold: int = 1 << 16,
        exact_replay: bool = True,
        registry: Optional[MetricsRegistry] = None,
        device: Any = None,
        engine: Optional[str] = None,
        native: bool = True,
    ) -> None:
        if isinstance(stages_or_query, CompiledQuery):
            self.query = stages_or_query
        else:
            assert isinstance(stages_or_query, Stages)
            self.query = compile_query(stages_or_query, schema)
        self.device = resolve_device(device)
        if engine is None:
            engine = "cuda" if self.device.type == "cuda" else "torch"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")
        self.engine = engine
        self.native = bool(native)
        self._decoder = None
        # Single-key engines share the batched driver's gauge naming; the
        # registry is private unless one is passed.
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.instance_id = next_instance_id()
        self._m_state = self.metrics.gauge(
            "cep_engine_state_counter",
            "Engine state counter totals from the last stats pull "
            "(updated on the explicit stats sync, never on the advance path)",
            labels=("instance", "counter"),
        )
        self._m_dropped = self.metrics.counter(
            "cep_overflow_dropped_total",
            "Engine drop-counter deltas observed at drain boundaries "
            "(silent capacity loss made loud; see EngineConfig.on_overflow)",
            labels=("counter",),
        )
        #: Overflow-policy baselines (deltas, not totals: a restore carries
        #: historic totals that must not re-escalate).
        self._drop_base: Dict[str, int] = {}
        self.config = config if config is not None else EngineConfig()
        self._advance = build_batched_advance(self.query, self.config, engine)
        self._append = build_append_post(self.config)
        self._flush = build_flush_post(self.query, self.config)
        # GC groups: the pend append runs every advance, the mark/sweep
        # only on the G-th; drains, snapshots and `live_runs` flush early
        # (node ids are region-stable only through the flush's remap).
        self.gc_group = max(int(self.config.gc_group), 1)
        self._group_ys: List[Dict[str, torch.Tensor]] = []
        self._group_roots: List[torch.Tensor] = []
        self.flushes = 0
        self.events_prune_threshold = events_prune_threshold
        self.state = init_batched_state(self.query, self.config, 1, self.device)
        self.pool = init_batched_pool(self.query, self.config, 1, self.device)
        self._events: Dict[int, Event] = {}
        self._next_gidx = 0
        self._ts_base: Optional[int] = None
        self._batches = 0
        #: Exact replay (ops/replay.py): a seq_collisions increment replays
        #: the interval since the last drain through the host oracle. Armed
        #: only for queries that fold.
        self.exact_replay = bool(exact_replay) and supports_replay(self.query)
        self.replays = 0
        # None when disarmed, so no dead generation stays referenced.
        self._snap = (self.state, self.pool) if self.exact_replay else None
        self._interval_events: List[Event] = []
        self._interval_overflow = False
        self._interval_start_gidx = 0
        self._collision_base = 0

    # ------------------------------------------------------------------ API
    @property
    def runs(self) -> int:
        """Run counter: parity with NFA.runs for conformance asserts."""
        return int(self.state["runs"][0])

    @property
    def n_live(self) -> int:
        """Live lane count: parity with len(NFA.computation_stages)."""
        return int(self.state["active"].sum())

    @property
    def stats(self) -> Dict[str, int]:
        """Counter totals (one host copy); the `cep_engine_state_counter`
        gauges ride this explicit pull."""
        vals = torch.stack([self.state[k][0] for k in STATE_COUNTER_KEYS]).tolist()
        out = dict(zip(STATE_COUNTER_KEYS, (int(v) for v in vals)))
        for k, v in out.items():
            self._m_state.labels(instance=self.instance_id, counter=k).set(v)
        return out

    def match_pattern(self, event: Event) -> List[Sequence]:
        """Single-event convenience API mirroring NFA.match_pattern."""
        return self.advance([event])

    def live_runs(self) -> List[Dict[str, Any]]:
        """Queue snapshot in order: (stage name, run id, last event,
        version), the device analog of inspecting NFA.computation_stages
        (reference: NFATest.assertNFA, NFATest.java:836-840)."""
        self._flush_group()  # lane nodes may point into the group window
        host = {n: self.state[n][..., 0].cpu().numpy()
                for n in ("active", "src", "seq", "node", "ver", "vlen")}
        node_event = self.pool["node_event"][:, 0].cpu().numpy()
        out = []
        for i in np.flatnonzero(host["active"]).tolist():
            name = self.query.name_of_id[int(self.query.name_id[host["src"][i]])]
            node = int(host["node"][i])
            last = self._events.get(int(node_event[node])) if node >= 0 else None
            out.append(dict(
                stage=name,
                sequence=int(host["seq"][i]),
                last_event=last,
                version=".".join(str(d) for d in host["ver"][i][: host["vlen"][i]]),
            ))
        return out

    def advance(
        self,
        events: List[Event],
        decode: bool = True,
        watermark_ms: Optional[Any] = None,
    ) -> List[Sequence]:
        """Process a micro-batch; returns completed matches in oracle order.

        decode=False defers match materialization (no host sync): matches
        wait in the pending ring, whose chains stay pinned, until
        `drain()`. `watermark_ms` threads the event-time watermark into the
        step (a scalar or a per-event sequence of absolute ms; None entries
        fall back to the event's own timestamp); omitted, expiry runs on
        the event timestamps."""
        if not events:
            return []
        xs = self._pack(events, watermark_ms)
        if _flt.ACTIVE is None:
            self.state, ys = self._advance(self.state, xs)
        else:
            # `engine.device_step` transient site: the step is functional,
            # so a bounded retry is exact.
            def _step():
                _flt.ACTIVE.fire("engine.device_step")
                return self._advance(self.state, xs)

            self.state, ys = with_retry(
                _step, site="engine.device_step",
                retry_on=(TransientFault,), registry=self.metrics,
            )
        self.state, self.pool, page_roots = self._append(self.state, self.pool, ys)
        self._group_ys.append({k: ys[k] for k in WINDOW_PLANES})
        self._group_roots.append(page_roots)
        if len(self._group_ys) >= self.gc_group:
            self._flush_group()
        self._batches += 1
        if self.exact_replay:
            self._ledger_append(events)
        if not decode:
            return []
        return self.drain()

    def drain(self) -> List[Sequence]:
        """Decode and clear all pending matches (a host sync point). Flushes
        the group first: pending matches may name window node ids that the
        pool planes do not cover mid-group."""
        self._flush_group()
        matches = self._decode_matches()
        if self.exact_replay:
            matches = self._replay_boundary(matches)
        self._prune_events()
        self._check_drop_counters(drained=matches)
        return matches

    # --------------------------------------------------------- checkpointing
    def snapshot(self) -> bytes:
        """The engine as the JAX single-key frame, byte for byte: the state
        and pool trees with the key axis squeezed out, the event registry,
        the next event id, the timestamp base and the advance count. Flushes
        the group first (gc_phase is 0 in every snapshot)."""
        self._flush_group()
        w = serde._Writer()
        w._buf.write(serde.MAGIC)
        w.blob(serde.encode_array_tree({k: v[..., 0].cpu().numpy() for k, v in self.state.items()}))
        w.blob(serde.encode_array_tree({k: v[..., 0].cpu().numpy() for k, v in self.pool.items()}))
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
    ) -> "DeviceNFA":
        """A new DeviceNFA from a `snapshot()` of either package's
        single-key engine (older frames upgraded). The capacity must be the
        snapshot's: a leaf of another shape raises `CheckpointError`."""
        dev = cls(stages_or_query, schema=schema, config=config, **opts)
        r = serde._Reader(serde.open_frame(data))
        serde.read_magic(r)
        tree = serde.decode_array_tree(r.blob())
        pool_tree = serde.decode_array_tree(r.blob())
        serde.upgrade_checkpoint_trees(tree, pool_tree)

        def load(src: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor]):
            # A scalar leaf is 0-d in the JAX encoder's frames and in this
            # one's; the port's older frames hold it as shape (1,). Both read.
            out = {}
            for name, leaf in ref.items():
                arr = np.asarray(src[name])
                want = tuple(leaf.shape[:-1])
                if arr.shape not in (want, want or (1,)) or arr.dtype != leaf.cpu().numpy().dtype:
                    raise serde.CheckpointError(
                        f"snapshot leaf {name!r} is {arr.dtype} {arr.shape}, the "
                        f"engine's {want}: restore with the snapshot's EngineConfig")
                out[name] = torch.from_numpy(
                    np.ascontiguousarray(arr).reshape(tuple(leaf.shape))).to(dev.device)
            return out

        dev.state = load(tree, dev.state)
        dev.pool = load(pool_tree, dev.pool)
        dev._events = serde.decode_event_registry(r.blob())
        dev._next_gidx = r.i64()
        ts_base = r.i64()
        # -1 is the frame's "no base yet" (the JAX class reads any negative
        # value so); any other value is the base.
        dev._ts_base = None if ts_base == -1 else ts_base
        dev._batches = r.i64()
        r.expect_end()
        if dev.exact_replay:
            dev._snap = (dev.state, dev.pool)
            dev._interval_start_gidx = dev._next_gidx
            dev._collision_base = int(dev.state["seq_collisions"][0])
        dev._drop_base = {k: int(dev.state[k][0]) for k in DROP_COUNTER_KEYS}
        return dev

    # ------------------------------------------------------------ internals
    def _pack(self, events: List[Event], watermark_ms: Optional[Any]) -> Dict[str, torch.Tensor]:
        """[T, 1] columns of one micro-batch, each event registered under
        its global id; the first event's timestamp is the base."""
        if self._ts_base is None:
            self._ts_base = int(events[0].timestamp)
        cols = self.query.schema.pack(
            [e.value for e in events],
            [e.timestamp for e in events],
            topics=[e.topic for e in events],
            ts_base=self._ts_base,
        )
        T = len(events)
        gidx = np.arange(self._next_gidx, self._next_gidx + T, dtype=np.int32)
        for g, e in zip(gidx.tolist(), events):
            self._events[g] = e
        self._next_gidx += T
        cols["gidx"] = gidx
        cols["valid"] = np.ones(T, bool)
        if watermark_ms is not None:
            cols["wm"] = rebase_watermarks(watermark_ms, T, self._ts_base)
        xs = {k: torch.from_numpy(np.ascontiguousarray(v).reshape(T, 1)).to(self.device)
              for k, v in cols.items()}
        xs["spred"] = eval_stateless_preds(self.query, xs)
        return xs

    def _ledger_append(self, events: List[Event]) -> None:
        """Take the batch's events into the replay interval. Past
        `REPLAY_LEDGER_MAX_EVENTS` the interval degrades to collision
        detection: one warning, and under on_overflow="raise" a
        `CEPOverflowError`."""
        if len(self._interval_events) + len(events) <= self.REPLAY_LEDGER_MAX_EVENTS:
            self._interval_events.extend(events)
            return
        self._interval_events = []
        replay_ledger_overflowed(self, f"{self.REPLAY_LEDGER_MAX_EVENTS} events")

    def _flush_group(self) -> None:
        """Fold the accumulated group window back into the node region."""
        fold_group_window(self)

    def _native_decoder(self):
        if self._decoder is None:
            from ..native import load_decoder

            self._decoder = load_decoder()
        return self._decoder

    def _decode_matches(self) -> List[Sequence]:
        """Pull and clear the pending ring, the JAX class's way: the ring's
        [0, pend_pos) entries in emission order without its -1 holes
        (chains a GC nulled under region overflow; node_drops counts
        them) and the three node planes in one host copy, each chain
        walked back through the planes by the native `decode_matches`,
        or (native=False) by `decode_chains`."""
        count, pos = (int(v) for v in torch.stack(
            [self.pool["pend_count"][0], self.pool["pend_pos"][0]]).tolist())
        if count == 0:
            if pos > 0:
                self.pool = drain_pend(self.pool)  # reclaim hole pages
            return []
        B = self.pool["node_event"].shape[0]
        host = torch.cat([self.pool["pend"][:pos, 0]] + [
            self.pool[n][:, 0] for n in ("node_event", "node_name", "node_pred")
        ]).cpu().numpy()
        pend = host[:pos]
        pend = pend[pend >= 0]
        node_event, node_name, node_pred = (host[pos + i * B: pos + (i + 1) * B] for i in range(3))
        if self.native:
            out = self._native_decoder().decode_matches(
                np.asarray([len(pend)], np.int32), pend[None, :], node_event[None, :],
                node_name[None, :], node_pred[None, :], self.query.name_of_id, self._events,
                Staged, Sequence)[0]
        else:
            chains = decode_chains(pend, node_name, node_event, node_pred)
            # Empty chains: all of a chain's puts were GC-dropped.
            out = [materialize_sequence(chain, self.query.name_of_id, self._events)
                   for chain in chains if chain]
        self.pool = drain_pend(self.pool)
        return out

    def _check_drop_counters(self, drained: Optional[List] = None) -> None:
        """The overflow policy (parallel/batched.py `check_drop_counters`)."""
        totals = torch.stack([self.state[k][0] for k in DROP_COUNTER_KEYS]).tolist()
        check_drop_counters(self, totals, drained if drained is not None else [])

    def _replay_boundary(self, matches: List[Sequence]) -> List[Sequence]:
        """At a drain: if the fold-divergence detector fired in the
        interval, the host oracle's matches replace the engine's and the
        device state is rebuilt from the oracle (ops/replay.py). Then the
        next interval starts here."""
        cur = int(self.state["seq_collisions"][0])
        if cur > self._collision_base and self._interval_overflow:
            warnings.warn(
                "fold-divergence detected but the replay ledger overflowed "
                "this interval; matches are engine-computed for it",
                RuntimeWarning,
            )
        if cur > self._collision_base and self._interval_events and not self._interval_overflow:
            matches = self._replay_interval(matches)
        self._collision_base = int(self.state["seq_collisions"][0])
        self._snap = (self.state, self.pool)
        self._interval_events = []
        self._interval_overflow = False
        self._interval_start_gidx = self._next_gidx
        return matches

    def _replay_interval(self, engine_matches: List[Sequence]) -> List[Sequence]:
        """Replay the interval through an oracle built from its snapshot;
        the oracle's fold cells sit under the interval's first event's
        key (the one stream's key, as the JAX class keys them)."""
        self.replays += 1
        snap_state = {k: v[..., 0].cpu().numpy() for k, v in self._snap[0].items()}
        snap_pool = {k: v[..., 0].cpu().numpy() for k, v in self._snap[1].items()}
        key = self._interval_events[0].key
        ts_base = self._ts_base if self._ts_base is not None else 0
        try:
            oracle, ev_gidx = device_to_oracle(
                self.query, self.config, snap_state, snap_pool, self._events, ts_base, key)
            matches: List[Sequence] = []
            for i, e in enumerate(self._interval_events):
                ev_gidx[e] = self._interval_start_gidx + i
                matches.extend(oracle.match_pattern(e))
        except KeyError as exc:
            warnings.warn(
                f"exact-replay skipped: event {exc} missing from the registry "
                "(snapshot or oracle feed); this interval's matches are "
                "engine-computed and fold values may diverge from the oracle for it"
            )
            return engine_matches
        counters = {k: self.state[k][..., 0].cpu().numpy() for k in STATE_COUNTER_KEYS}
        try:
            new_state, new_pool = oracle_to_device(
                self.query, self.config, oracle, key, ev_gidx, ts_base, counters)
        except (ValueError, KeyError) as exc:
            warnings.warn(
                f"exact-replay resync failed ({exc}); device state kept -- this "
                "interval's matches are oracle-exact but later intervals fall "
                "back to collision detection only"
            )
            return matches

        def to_device(tree, ref):
            return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(tree[k])[..., None]))
                    .to(dtype=ref[k].dtype, device=self.device) for k in ref}

        self.state = to_device(new_state, self.state)
        self.pool = to_device(new_pool, self.pool)
        return matches

    def _prune_events(self) -> None:
        """Bound the host event registry to the pool-referenced events,
        once it outgrows its threshold (the pull is a sync point)."""
        self._events = pruned_events(self._events, self.pool, self.events_prune_threshold)
