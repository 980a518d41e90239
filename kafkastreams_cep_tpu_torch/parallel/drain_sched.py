"""Adaptive drain scheduler: closed-loop cadence and capacity control.

A copy of the JAX package's `parallel/drain_sched.py` (stdlib only; the
code is unchanged). The drain cadence knobs -- `target_emit_ms` (the
micro-drain dial), `gc_group` (GC fold cadence) and the caller's batch
extent `T` -- are steered per engine from signals the metrics already
publish, with no device sync:

  * the live `cep_match_latency_seconds{query}` histogram (ingest ->
    sink emission wall, streams/builder.py);
  * the fused probe's pend-ring occupancy and node-region fill
    (`BatchedDeviceNFA._occupancy_bound()` -- async probes, never a
    device sync);
  * the sampled `profile_every` compute walls
    (`cep_advance_compute_seconds{instance, phase}`).

What the controllers read and move on the engine, each with the JAX
engine's meaning in the port: `config`, `gc_group`, `keys`,
`target_emit_ms`, `metrics`, `compile_watch`, `instance_id`,
`lane_obs`, `_flush_group()`, `_occupancy_bound()` and `resize()`. On the
card a capacity step is a new step-kernel source, so a resize pays an
nvcc build (counted by `compile_watch`); a `gc_group` step changes no
kernel source and builds nothing.

Control law, deliberately boring (AIMD with hysteresis):

  * `target_emit_ms` is a pure host knob (no recompile): multiplicative
    decrease whenever observed p99 overshoots the target or the pend
    ring runs hot, slow multiplicative increase back toward the relaxed
    ceiling when there is latency headroom AND the ring is cool --
    fewer forced syncs on quiet streams, tight cadence under load.
  * `gc_group` moves in power-of-two steps (halve when the node region
    runs hot -- fold more often so the region stays compact; double when
    the region is cool and the sampled post wall dominates the advance
    wall -- amortize the fold). Changes are BUDGETED: at most
    `compile_budget` over the controller's lifetime, each preceded by an
    explicit `engine._flush_group()` (node ids are only region-stable
    through the flush), with a cooldown between steps. Budget exhausted
    == knob frozen == steady state is compile-flat (CompileWatch counts
    stay the loud backstop).
  * `T` is advisory (`suggest_t()`): sized so one packed advance covers
    about half the emit budget at the observed ingest rate -- callers
    that own their batching (bench drivers, faults soak) read it per
    iteration; the engine never resizes itself.

The controller exposes `cep_drain_controller_*` gauges so the chosen
knobs are first-class telemetry (the soak/bench artifacts record
`state()` directly).
"""
from __future__ import annotations

import time as _time
from typing import Any, Dict, Optional

__all__ = ["AdmissionPacer", "CapacityAutosizer", "DrainController"]


def _pow2_down(n: int) -> int:
    return max(1, n // 2)


def _pow2_up(n: int) -> int:
    return max(2, n * 2)


def _pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (>= 1). Shared quantizer: every
    adaptive extent moves on the pow2 lattice so the set of distinct
    compile signatures a run can visit stays logarithmic."""
    return 1 << max(0, int(n) - 1).bit_length()


class DrainController:
    """Closed-loop drain cadence for one `BatchedDeviceNFA`.

    Call `observe(events=N)` once per drive iteration (after the advance
    or drain); the controller re-reads its signals, moves the knobs, and
    returns the current `state()`. All reads are host-side -- the
    controller never syncs the device.
    """

    def __init__(
        self,
        engine: Any,
        *,
        target_p99_ms: float = 500.0,
        min_emit_ms: float = 2.0,
        max_emit_ms: float = 1000.0,
        compile_budget: int = 6,
        gc_group_min: int = 1,
        gc_group_max: int = 64,
        cooldown: int = 16,
        t_min: int = 8,
        t_max: int = 8192,
        registry: Optional[Any] = None,
    ) -> None:
        if target_p99_ms <= 0:
            raise ValueError(f"target_p99_ms must be > 0, got {target_p99_ms}")
        if not 0 < min_emit_ms <= max_emit_ms:
            raise ValueError(
                f"need 0 < min_emit_ms <= max_emit_ms, got "
                f"({min_emit_ms}, {max_emit_ms})"
            )
        self.engine = engine
        self.query = getattr(engine, "query_name", None) or "q"
        self.target_p99_ms = float(target_p99_ms)
        self.min_emit_ms = float(min_emit_ms)
        self.max_emit_ms = float(max_emit_ms)
        self.compile_budget = int(compile_budget)
        self.gc_group_min = max(1, int(gc_group_min))
        self.gc_group_max = max(self.gc_group_min, int(gc_group_max))
        self.cooldown = max(1, int(cooldown))
        self.t_min = max(1, int(t_min))
        self.t_max = max(self.t_min, int(t_max))
        self.metrics = registry if registry is not None else engine.metrics
        # Arm the micro-drain dial if the engine ran without one: the
        # controller owns this knob from here on.
        if engine.target_emit_ms is None:
            engine.target_emit_ms = self.max_emit_ms
        self._adjustments = 0
        self._gc_changes = 0
        self._ticks = 0
        self._last_gc_tick = -self.cooldown
        self._last_p99_ms: Optional[float] = None
        self._rate_t = _time.perf_counter()
        self._rate_ev_s = 0.0  # EWMA of the observed ingest rate
        lab = dict(query=self.query)
        self._m_emit = self.metrics.gauge(
            "cep_drain_controller_target_emit_ms",
            "Micro-drain emit budget chosen by the adaptive drain "
            "controller",
            labels=("query",),
        ).labels(**lab)
        self._m_gc = self.metrics.gauge(
            "cep_drain_controller_gc_group",
            "GC fold cadence chosen by the adaptive drain controller",
            labels=("query",),
        ).labels(**lab)
        self._m_p99 = self.metrics.gauge(
            "cep_drain_controller_p99_ms",
            "Freshest match-latency p99 the drain controller acted on",
            labels=("query",),
        ).labels(**lab)
        self._m_occ = self.metrics.gauge(
            "cep_drain_controller_occupancy_ratio",
            "Pend-ring occupancy fraction the drain controller acted on",
            labels=("query",),
        ).labels(**lab)
        self._m_adjust = self.metrics.counter(
            "cep_drain_controller_adjustments_total",
            "Knob moves by the adaptive drain controller",
            labels=("query", "knob"),
        )
        self._m_emit.set(float(engine.target_emit_ms))
        self._m_gc.set(float(engine.gc_group))

    # -------------------------------------------------------------- signals
    def _p99_ms(self) -> Optional[float]:
        """Freshest p99 (ms) from the live match-latency histogram; None
        before the emission path has observed anything."""
        fam = self.metrics.get("cep_match_latency_seconds")
        if fam is None:
            return None
        try:
            p = fam.labels(query=self.query).percentile(99)
        except (ValueError, TypeError):
            return None
        return None if p is None else p * 1e3

    def _occupancy(self) -> tuple:
        """(ring occupancy fraction, region fill fraction) from the async
        probe bound -- both upper bounds, never a sync."""
        occ, fill, _pos = self.engine._occupancy_bound()
        ring = max(1, int(self.engine.config.matches))
        nodes = max(1, int(self.engine.config.nodes))
        return min(1.0, occ / ring), min(1.0, fill / nodes)

    def _post_dominates(self) -> bool:
        """True when the sampled GC/fold (post) wall exceeds the advance
        wall -- the amortization signal for doubling gc_group. False with
        no samples (profiling off)."""
        fam = self.metrics.get("cep_advance_compute_seconds")
        if fam is None:
            return False
        inst = getattr(self.engine, "instance_id", None)
        if inst is None:
            return False
        try:
            adv = fam.labels(instance=inst, phase="advance").mean()
            post = fam.labels(instance=inst, phase="post").mean()
        except (ValueError, TypeError):
            return False
        return adv is not None and post is not None and post > adv

    # -------------------------------------------------------------- control
    def observe(self, events: int = 0) -> Dict[str, Any]:
        """One control tick: fold `events` into the rate estimate, re-read
        the signals, move the knobs. Returns `state()`."""
        self._ticks += 1
        now = _time.perf_counter()
        dt = now - self._rate_t
        if events > 0 and dt > 0:
            inst = events / dt
            self._rate_ev_s = (
                inst if self._rate_ev_s == 0.0
                else 0.8 * self._rate_ev_s + 0.2 * inst
            )
        self._rate_t = now

        p99 = self._p99_ms()
        occ, fill = self._occupancy()
        self._last_p99_ms = p99
        if p99 is not None:
            self._m_p99.set(p99)
        self._m_occ.set(occ)

        self._tune_emit(p99, occ)
        self._tune_gc_group(fill)
        return self.state()

    def _tune_emit(self, p99: Optional[float], occ: float) -> None:
        cur = float(self.engine.target_emit_ms)
        new = cur
        if (p99 is not None and p99 > self.target_p99_ms) or occ > 0.5:
            new = max(self.min_emit_ms, cur * 0.5)
        elif occ < 0.1 and (p99 is None or p99 < self.target_p99_ms * 0.5):
            new = min(self.max_emit_ms, cur * 1.25)
        if new != cur:
            self.engine.target_emit_ms = new
            self._adjustments += 1
            self._m_adjust.labels(query=self.query, knob="target_emit_ms").inc()
            self._m_emit.set(new)

    def _tune_gc_group(self, fill: float) -> None:
        if self._gc_changes >= self.compile_budget:
            return  # budget spent: knob frozen, steady state compile-flat
        if self._ticks - self._last_gc_tick < self.cooldown:
            return  # hysteresis between retrace-risking steps
        cur = int(self.engine.gc_group)
        new = cur
        if fill > 0.75 and cur > self.gc_group_min:
            new = _pow2_down(cur)
        elif fill < 0.25 and cur < self.gc_group_max and self._post_dominates():
            new = min(self.gc_group_max, _pow2_up(cur))
        if new == cur:
            return
        # Node ids are only region-stable through the fold: flush the
        # accumulated window under the OLD cadence before changing it
        # (also keeps the G vs G=1 bitwise contract intact).
        self.engine._flush_group()
        self.engine.gc_group = new
        self._gc_changes += 1
        self._last_gc_tick = self._ticks
        self._adjustments += 1
        self._m_adjust.labels(query=self.query, knob="gc_group").inc()
        self._m_gc.set(float(new))

    def suggest_t(self) -> int:
        """Advisory packed-batch extent: cover about half the emit budget
        per advance at the observed ingest rate (so the micro-drain dial
        keeps firing between advances), clamped to [t_min, t_max]."""
        if self._rate_ev_s <= 0:
            return self.t_min
        per_key = self._rate_ev_s / max(1, len(self.engine.keys))
        t = int(per_key * (float(self.engine.target_emit_ms) / 2e3))
        return max(self.t_min, min(self.t_max, t))

    def state(self) -> Dict[str, Any]:
        """The chosen knobs + freshest signals, JSON-ready (recorded into
        the bench `sink` block and the soak scenario artifacts)."""
        cw = getattr(self.engine, "compile_watch", None)
        return {
            "target_emit_ms": float(self.engine.target_emit_ms),
            "gc_group": int(self.engine.gc_group),
            "suggest_t": self.suggest_t(),
            "p99_ms": self._last_p99_ms,
            "rate_ev_s": self._rate_ev_s,
            "ticks": self._ticks,
            "adjustments": self._adjustments,
            "gc_changes": self._gc_changes,
            "compile_budget": self.compile_budget,
            "compiles_seen": None if cw is None else cw.seen_count,
        }


#: Drop-counter family -> the EngineConfig axis whose cap it exhausts.
_DROP_AXIS = {
    "lane_drops": "lanes",
    "node_drops": "nodes",
    "match_drops": "matches",
}


class CapacityAutosizer:
    """Zero-knob capacity control for one `BatchedDeviceNFA`.

    Composes a `DrainController` (cadence knobs: emit budget, gc_group,
    advisory T) and adds the CAPACITY law on top: the lane/node/match
    caps auto-grow and auto-shrink from the same sync-free signals --
    the fused probe's ring occupancy / region fill, the piggybacked
    lane-occupancy probe, and the `cep_overflow_dropped_total{counter}`
    deltas the engine latches at drain boundaries. A move is a single
    `engine.resize()` (flush -> capacity check -> graft), so every step
    builds the step kernel for the new shape: steps are pow2-quantized,
    budgeted (`compile_budget`), cooled down and hysteretic exactly like
    the drain controller's gc_group law -- steady state is compile-flat.

    Law per axis:

      * GROW (reactive): a nonzero drop delta doubles the exhausted axis
        immediately -- drops are loss, budget or not (the resize still
        counts against the budget; a budget raised this way means the
        workload genuinely outgrew the window, which the artifact makes
        visible via `resizes`). A match drop can come from the pend ring
        OR the per-(key,step) emission cap, and the counter cannot tell
        them apart, so a match drop doubles `matches_per_step` alongside
        `matches` (capped at the ring size): the wrong cap growing once
        is cheap, staying lossy is not.
      * GROW (proactive): occupancy above `grow_frac` of the cap doubles
        the axis before drops start, charged to the budget + cooldown.
      * SHRINK: occupancy below `shrink_frac` of the cap for
        `shrink_patience` consecutive ticks halves the axis, floored at
        the config the engine was armed with (the autosizer only gives
        back what it grew -- or what the caller over-provisioned above
        its own starting point, never below it). A shrink the engine
        refuses (`ShapeRestoreError`: live state would not fit) resets
        the patience and is counted, not raised.

    `ensure_page(t)` is the admission guarantee: before a caller drives
    a [T, K] batch it grows `matches` so one advance can never overflow
    the pend ring (T * matches_per_step <= matches) -- correctness
    bypasses the cooldown but still lands in the budget accounting.
    """

    def __init__(
        self,
        engine: Any,
        *,
        registry: Optional[Any] = None,
        compile_budget: int = 6,
        cooldown: int = 16,
        grow_frac: float = 0.75,
        shrink_frac: float = 0.15,
        shrink_patience: int = 64,
        max_lanes: int = 4096,
        max_nodes: int = 1 << 20,
        max_matches: int = 1 << 20,
        cadence: Optional[DrainController] = None,
        **cadence_opts: Any,
    ) -> None:
        self.engine = engine
        self.query = getattr(engine, "query_name", None) or "q"
        self.metrics = registry if registry is not None else engine.metrics
        self.cadence = (
            cadence
            if cadence is not None
            else DrainController(
                engine, registry=self.metrics, **cadence_opts
            )
        )
        self.compile_budget = int(compile_budget)
        self.cooldown = max(1, int(cooldown))
        self.grow_frac = float(grow_frac)
        self.shrink_frac = float(shrink_frac)
        self.shrink_patience = max(1, int(shrink_patience))
        self.max_lanes = int(max_lanes)
        self.max_nodes = int(max_nodes)
        self.max_matches = int(max_matches)
        cfg = engine.config
        #: Shrink floor: the shape the engine was armed with.
        self.floor = {
            "lanes": int(cfg.lanes),
            "nodes": int(cfg.nodes),
            "matches": int(cfg.matches),
        }
        self._ceil = {
            "lanes": self.max_lanes,
            "nodes": self.max_nodes,
            "matches": self.max_matches,
        }
        self.resizes = 0
        self.refused = 0
        self._ticks = 0
        self._last_resize_tick = -self.cooldown
        self._low_ticks = {"lanes": 0, "nodes": 0, "matches": 0}
        self._drop_seen: Dict[str, float] = {}
        lab = dict(query=self.query)
        self._m_lanes = self.metrics.gauge(
            "cep_autosize_lanes",
            "Lane cap chosen by the capacity autosizer",
            labels=("query",),
        ).labels(**lab)
        self._m_nodes = self.metrics.gauge(
            "cep_autosize_nodes",
            "Node-region cap chosen by the capacity autosizer",
            labels=("query",),
        ).labels(**lab)
        self._m_matches = self.metrics.gauge(
            "cep_autosize_matches",
            "Pend-ring cap chosen by the capacity autosizer",
            labels=("query",),
        ).labels(**lab)
        self._m_t = self.metrics.gauge(
            "cep_autosize_t",
            "Pow2-quantized packed-batch extent suggested by the "
            "autosizer (DrainController.suggest_t folded into the "
            "capacity law)",
            labels=("query",),
        ).labels(**lab)
        self._m_resize = self.metrics.counter(
            "cep_autosize_resizes_total",
            "Capacity re-shapes by the autosizer (axis x direction; "
            "'refused' counts shrinks the engine declined because live "
            "state would not fit)",
            labels=("query", "axis", "direction"),
        )
        self._set_gauges()

    def _set_gauges(self) -> None:
        cfg = self.engine.config
        self._m_lanes.set(float(cfg.lanes))
        self._m_nodes.set(float(cfg.nodes))
        self._m_matches.set(float(cfg.matches))

    # -------------------------------------------------------------- signals
    def _drop_deltas(self) -> Dict[str, float]:
        """Per-axis NEW drops since the last tick, from the registry's
        `cep_overflow_dropped_total{counter}` family (latched by the
        engine at drain boundaries -- host-side reads only)."""
        fam = self.metrics.get("cep_overflow_dropped_total")
        out: Dict[str, float] = {}
        if fam is None:
            return out
        for lvals, child in fam._sorted_children():
            counter = dict(zip(fam.label_names, lvals)).get("counter")
            axis = _DROP_AXIS.get(counter or "")
            if axis is None:
                continue
            seen = self._drop_seen.get(counter, 0.0)
            if child.value > seen:
                out[axis] = out.get(axis, 0.0) + (child.value - seen)
            self._drop_seen[counter] = child.value
        return out

    # -------------------------------------------------------------- control
    def observe(self, events: int = 0, t: Optional[int] = None) -> Dict[str, Any]:
        """One control tick: cadence knobs first (DrainController), then
        the capacity law. Pass `t` when the caller owns its batch extent
        so the admission guarantee (`ensure_page`) rides the tick."""
        self._ticks += 1
        self.cadence.observe(events)
        if t is not None:
            self.ensure_page(int(t))
        cfg = self.engine.config
        drops = self._drop_deltas()
        occ, fill, _pos = self.engine._occupancy_bound()
        lane_obs = getattr(self.engine, "lane_obs", None)
        levels = {
            "lanes": None if lane_obs is None else lane_obs / max(1, cfg.lanes),
            "nodes": fill / max(1, cfg.nodes),
            "matches": occ / max(1, cfg.matches),
        }
        want = {
            "lanes": int(cfg.lanes),
            "nodes": int(cfg.nodes),
            "matches": int(cfg.matches),
        }
        step_want = int(cfg.matches_per_step)
        grew = False
        for axis in ("lanes", "nodes", "matches"):
            if drops.get(axis):
                # Loss already happened: double now, budget notwithstanding.
                want[axis] = min(self._ceil[axis], _pow2_up(want[axis]))
                grew = grew or want[axis] != getattr(cfg, axis)
        if drops.get("matches"):
            # Per-step-cap drops cannot be cured by ring growth alone
            # (class docstring): double the emission cap too, bounded by
            # the (already doubled) ring so one step can never overfill.
            step_want = min(want["matches"], _pow2_up(step_want))
            if t is not None:
                # Keep the admission guarantee (t * matches_per_step <=
                # matches) true for the NEW per-step cap in the same
                # retrace, instead of waiting for ring drops to re-teach
                # it one doubling per tick.
                want["matches"] = min(
                    self._ceil["matches"],
                    max(
                        want["matches"],
                        _pow2_at_least(max(1, int(t)) * step_want),
                    ),
                )
                step_want = min(want["matches"], step_want)
        budget_open = self.resizes < self.compile_budget
        cooled = self._ticks - self._last_resize_tick >= self.cooldown
        if budget_open and cooled:
            for axis in ("lanes", "nodes", "matches"):
                lvl = levels[axis]
                if lvl is not None and lvl > self.grow_frac:
                    want[axis] = min(self._ceil[axis], _pow2_up(want[axis]))
        # Shrink only when nothing wants to grow this tick (hysteresis:
        # mixed signals freeze the shape).
        wants_grow = any(
            want[a] > getattr(cfg, a) for a in ("lanes", "nodes", "matches")
        )
        if not wants_grow and budget_open and cooled:
            for axis in ("lanes", "nodes", "matches"):
                lvl = levels[axis]
                if lvl is not None and lvl < self.shrink_frac:
                    self._low_ticks[axis] += 1
                else:
                    self._low_ticks[axis] = 0
                if (
                    self._low_ticks[axis] >= self.shrink_patience
                    and want[axis] > self.floor[axis]
                ):
                    want[axis] = max(self.floor[axis], _pow2_down(want[axis]))
        self._apply(want, step=step_want)
        t_sug = self.suggest_t()
        self._m_t.set(float(t_sug))
        return self.state()

    def ensure_page(self, t: int) -> None:
        """Grow `matches` so one [t, K] advance can never overflow the
        pend ring (the loss-free admission requirement: t *
        matches_per_step <= matches). Correctness bypasses the cooldown;
        the resize still counts toward the budget accounting."""
        cfg = self.engine.config
        step_cap = max(1, int(t)) * max(1, int(cfg.matches_per_step))
        if step_cap <= cfg.matches:
            return
        want = {
            "lanes": int(cfg.lanes),
            "nodes": int(cfg.nodes),
            "matches": min(
                self._ceil["matches"],
                max(_pow2_at_least(step_cap), int(cfg.matches)),
            ),
        }
        self._apply(want)

    def _apply(
        self, want: Dict[str, int], step: Optional[int] = None
    ) -> None:
        from dataclasses import replace

        cfg = self.engine.config
        new_step = int(cfg.matches_per_step) if step is None else int(step)
        moves = [
            (axis, getattr(cfg, axis), want[axis])
            for axis in ("lanes", "nodes", "matches")
            if want[axis] != getattr(cfg, axis)
        ]
        if new_step != cfg.matches_per_step:
            moves.append(
                ("matches_per_step", int(cfg.matches_per_step), new_step)
            )
        if not moves:
            return
        new_cfg = replace(
            cfg, lanes=want["lanes"], nodes=want["nodes"],
            matches=want["matches"], matches_per_step=new_step,
        )
        try:
            resized = self.engine.resize(new_cfg)
        except Exception as exc:
            # A refused shrink (live state would not fit) is "not now",
            # not an error; re-observe from scratch next window.
            from ..state.serde import ShapeRestoreError

            if not isinstance(exc, ShapeRestoreError):
                raise
            self.refused += 1
            for axis, _old, _new in moves:
                self._low_ticks[axis] = 0
                self._m_resize.labels(
                    query=self.query, axis=axis, direction="refused"
                ).inc()
            return
        if not resized:
            return
        self.resizes += 1
        self._last_resize_tick = self._ticks
        for axis, old, new in moves:
            self._low_ticks[axis] = 0
            self._m_resize.labels(
                query=self.query, axis=axis,
                direction="grow" if new > old else "shrink",
            ).inc()
        self._set_gauges()

    def suggest_t(self) -> int:
        """The cadence controller's advisory batch extent, pow2-quantized
        so callers that adopt it visit a logarithmic set of [T, K]
        compile signatures."""
        return min(
            self.cadence.t_max,
            max(self.cadence.t_min, _pow2_at_least(self.cadence.suggest_t())),
        )

    def state(self) -> Dict[str, Any]:
        """JSON-ready snapshot for artifacts: the chosen capacity plus
        the nested cadence state. The `resizes` key doubles as the
        schema discriminator (check_bench_schema dispatches autosizer
        vs plain drain-controller blocks on it)."""
        cfg = self.engine.config
        cw = getattr(self.engine, "compile_watch", None)
        return {
            "lanes": int(cfg.lanes),
            "nodes": int(cfg.nodes),
            "matches": int(cfg.matches),
            "matches_per_step": int(cfg.matches_per_step),
            "suggest_t": self.suggest_t(),
            "resizes": self.resizes,
            "refused": self.refused,
            "ticks": self._ticks,
            "compile_budget": self.compile_budget,
            "floor": dict(self.floor),
            "cadence": self.cadence.state(),
            "compiles_seen": None if cw is None else cw.seen_count,
        }


class AdmissionPacer:
    """Adaptive ingest pacing for poll loops.

    A fixed (or unbounded) poll budget lets one backlogged topic starve
    the gated queries' event-time ticks, so p99 match latency becomes
    ingest-rate-bound. The pacer sizes each poll's record budget around
    the measured admission rate -- one poll should cost about
    `target_poll_ms` of processing, keeping `tick_event_time`/`flush`
    cadence bounded no matter the backlog. Pow2-quantized and clamped,
    host-side arithmetic only.
    """

    def __init__(
        self,
        *,
        target_poll_ms: float = 100.0,
        min_batch: int = 32,
        max_batch: int = 8192,
        registry: Optional[Any] = None,
        group: str = "default",
    ) -> None:
        if target_poll_ms <= 0:
            raise ValueError(
                f"target_poll_ms must be > 0, got {target_poll_ms}"
            )
        if not 0 < int(min_batch) <= int(max_batch):
            raise ValueError(
                f"need 0 < min_batch <= max_batch, got "
                f"({min_batch}, {max_batch})"
            )
        self.target_poll_ms = float(target_poll_ms)
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self._rate_ev_s = 0.0
        self._t = _time.perf_counter()
        self._m_batch = None
        if registry is not None:
            self._m_batch = registry.gauge(
                "cep_driver_poll_batch",
                "Per-poll record budget chosen by the admission pacer",
                labels=("group",),
            ).labels(group=group)

    def observe(self, admitted: int) -> None:
        """Fold one completed poll's admitted-record count into the rate
        EWMA (same 0.8/0.2 blend as the drain controller)."""
        now = _time.perf_counter()
        dt = now - self._t
        self._t = now
        if admitted > 0 and dt > 0:
            inst = admitted / dt
            self._rate_ev_s = (
                inst if self._rate_ev_s == 0.0
                else 0.8 * self._rate_ev_s + 0.2 * inst
            )

    def suggest_batch(self) -> int:
        """The next poll's record budget: about `target_poll_ms` worth of
        records at the observed admission rate, pow2-quantized into
        [min_batch, max_batch]."""
        if self._rate_ev_s <= 0:
            n = self.min_batch
        else:
            n = _pow2_at_least(
                int(self._rate_ev_s * self.target_poll_ms / 1e3)
            )
        n = max(self.min_batch, min(self.max_batch, n))
        if self._m_batch is not None:
            self._m_batch.set(float(n))
        return n

    def state(self) -> Dict[str, Any]:
        return {
            "rate_ev_s": self._rate_ev_s,
            "batch": self.suggest_batch(),
            "target_poll_ms": self.target_poll_ms,
        }
