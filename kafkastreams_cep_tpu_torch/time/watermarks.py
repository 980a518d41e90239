"""Pluggable watermark generators (Dataflow low-watermark model).

A watermark is the gate's claim that no record with event time <= the
watermark will be useful anymore: the reorder stage releases buffered
records at or below it, records older than it are late, and the engine's
window expiry sweeps off it (ops/engine.py build_step expiry clock).

Generators are deterministic host-side state machines: `observe()` feeds
every arriving record's (timestamp, source), `current_ms()` reads the
watermark, `advance_wall()` lets wall-clock-driven generators (idle
timeouts) progress between records. State round-trips through
`state()` / `restore()` as a plain dict so state/serde.py can checkpoint a
gate without knowing generator internals.

A copy of the JAX package's `time/watermarks.py`, except that
`MinMergeWatermark` keeps its merged minimum incrementally: the JAX
merge rescans every source on every read, O(sources) per record, which
at thousands of per-key sources costs more than the engine. Marks,
states and restores are the JAX merge's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

#: "No watermark yet": below any real i64 ms timestamp a stream can carry.
#: (Matches the engine's WM_NONE i32 fill after rebase clamping.)
WM_MIN_MS = -(2**62)


class WatermarkGenerator:
    """Base generator: never advances (everything buffers until flush)."""

    kind = "none"

    def observe(self, ts_ms: int, source: Any = None) -> None:
        pass

    def current_ms(self) -> int:
        return WM_MIN_MS

    def advance_wall(self, now_ms: int) -> None:
        """Wall-clock tick (driver poll cadence); default no-op."""

    # -- checkpointing ------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        return {}

    def restore(self, state: Dict[str, Any]) -> None:
        pass


class ArrivalOrderWatermark(WatermarkGenerator):
    """Watermark == max observed timestamp: arrival-order parity.

    With an in-order source this makes the gate a pure passthrough whose
    per-record clocks equal the record timestamps -- the engine output is
    bitwise-identical to running without the gate (pinned by
    the JAX package's tests/test_watermarks.py). Out-of-order records are
    immediately late.
    """

    kind = "arrival"

    def __init__(self) -> None:
        self._max_ts = WM_MIN_MS

    def observe(self, ts_ms: int, source: Any = None) -> None:
        if ts_ms > self._max_ts:
            self._max_ts = int(ts_ms)

    def current_ms(self) -> int:
        return self._max_ts

    def state(self) -> Dict[str, Any]:
        return {"max_ts": self._max_ts}

    def restore(self, state: Dict[str, Any]) -> None:
        self._max_ts = int(state["max_ts"])


class BoundedOutOfOrderness(WatermarkGenerator):
    """Watermark trails the max observed timestamp by a fixed bound:
    records up to `bound_ms` behind the stream head reorder cleanly,
    older ones are late (the FlinkCEP/Dataflow default strategy)."""

    kind = "bounded"

    def __init__(self, bound_ms: int) -> None:
        if bound_ms < 0:
            raise ValueError(f"bound_ms must be >= 0, got {bound_ms}")
        self.bound_ms = int(bound_ms)
        self._max_ts = WM_MIN_MS

    def observe(self, ts_ms: int, source: Any = None) -> None:
        if ts_ms > self._max_ts:
            self._max_ts = int(ts_ms)

    def current_ms(self) -> int:
        if self._max_ts == WM_MIN_MS:
            return WM_MIN_MS
        return self._max_ts - self.bound_ms

    def state(self) -> Dict[str, Any]:
        return {"max_ts": self._max_ts, "bound_ms": self.bound_ms}

    def restore(self, state: Dict[str, Any]) -> None:
        self._max_ts = int(state["max_ts"])
        self.bound_ms = int(state["bound_ms"])


class MinMergeWatermark(WatermarkGenerator):
    """Per-source min-merge: the fan-in watermark is the minimum of every
    live source's own watermark (Dataflow's multi-input merge), so a slow
    exchange holds the merged clock back until its records arrive -- and a
    source marked idle (see IdleTimeout) stops holding it back.

    `per_source` maps source id -> generator; sources seen in `observe()`
    without a registered generator get `default_factory()` (a
    BoundedOutOfOrderness(0) unless overridden).

    PRE-REGISTER every expected source when the fan-in set is known: an
    unregistered source contributes nothing to the min until its first
    record, so the merged mark can run ahead of it and that first record
    (or its in-bound stragglers) may be judged late on arrival. With all
    sources registered up front the merge stays at the floor until every
    source has reported -- the Dataflow source-registration behavior."""

    kind = "min_merge"

    def __init__(
        self,
        per_source: Optional[Mapping[Any, WatermarkGenerator]] = None,
        default_factory: Any = None,
    ) -> None:
        self.per_source: Dict[Any, WatermarkGenerator] = dict(per_source or {})
        self._default_factory = default_factory or (
            lambda: BoundedOutOfOrderness(0)
        )
        self.idle: Dict[Any, bool] = {}
        #: The merged mark while at least one source is live, and how many
        #: live sources sit at it; None when it must be recomputed (after
        #: a wall tick, an idle flip or a restore, or once the last source
        #: at the minimum moved up).
        self._min: Optional[int] = None
        self._at_min = 0

    def observe(self, ts_ms: int, source: Any = None) -> None:
        gen = self.per_source.get(source)
        if gen is None:
            gen = self.per_source[source] = self._default_factory()
            old = None
        else:
            old = gen.current_ms()
        was_idle = self.idle.get(source, False)
        gen.observe(ts_ms, source)
        self.idle[source] = False
        if self._min is None:
            return
        if was_idle:
            self._min = None
            return
        new = gen.current_ms()
        if new == old:
            return
        if old == self._min:
            self._at_min -= 1
        if new < self._min:
            self._min, self._at_min = new, 1
        elif new == self._min:
            self._at_min += 1
        if self._at_min == 0:
            self._min = None

    def mark_idle(self, source: Any, idle: bool = True) -> None:
        self.idle[source] = idle
        self._min = None

    def advance_wall(self, now_ms: int) -> None:
        for gen in self.per_source.values():
            gen.advance_wall(now_ms)
        self._min = None

    def current_ms(self) -> int:
        if self._min is not None:
            return self._min
        live = [
            g.current_ms()
            for s, g in self.per_source.items()
            if not self.idle.get(s, False)
        ]
        if not live:
            # Every source idle: the watermark rides the MAX of the idle
            # sources' own marks (nothing is coming; a min here would
            # wedge the faster idle sources' buffered records forever --
            # the exact outcome this branch exists to avoid).
            all_marks = [g.current_ms() for g in self.per_source.values()]
            return max(all_marks) if all_marks else WM_MIN_MS
        self._min = min(live)
        self._at_min = live.count(self._min)
        return self._min

    def state(self) -> Dict[str, Any]:
        return {
            "sources": {s: g.state() for s, g in self.per_source.items()},
            "kinds": {s: g.kind for s, g in self.per_source.items()},
            "idle": dict(self.idle),
        }

    def restore(self, state: Dict[str, Any]) -> None:
        kinds = state.get("kinds", {})
        for s, sub in state["sources"].items():
            gen = self.per_source.get(s)
            if gen is None:
                gen = self.per_source[s] = self._default_factory()
            want = kinds.get(s, gen.kind)
            if gen.kind != want:
                # A default-factory generator cannot absorb another
                # kind's state dict -- require the caller to pre-register
                # the matching per-source generators (mirrors the gate's
                # top-level kind check).
                raise ValueError(
                    f"checkpoint source {s!r} used a {want!r} watermark "
                    f"generator but the restored merge builds {gen.kind!r}; "
                    "pre-register per_source generators matching the "
                    "snapshot before restoring"
                )
            gen.restore(sub)
        self.idle = dict(state.get("idle", {}))
        self._min = None


class IdleTimeout(WatermarkGenerator):
    """Idle-source timeout wrapper: when no record has been observed for
    `timeout_ms` of wall time, the inner generator's watermark stops being
    authoritative and the watermark jumps to the max event time observed
    (the source is provably stalled; buffered records must not wait for
    it). Wrapping a MinMergeWatermark's per-source generators gives the
    classic "idle partition" semantics; wrapping the whole merge drains
    the gate on a globally quiet stream.

    Wall time comes exclusively from `advance_wall()` so tests and replay
    stay deterministic -- the driver ticks it at poll cadence."""

    kind = "idle_timeout"

    def __init__(self, inner: WatermarkGenerator, timeout_ms: int) -> None:
        if timeout_ms <= 0:
            raise ValueError(f"timeout_ms must be > 0, got {timeout_ms}")
        self.inner = inner
        self.timeout_ms = int(timeout_ms)
        self._last_observe_wall: Optional[int] = None
        self._idle = False
        self._max_ts = WM_MIN_MS
        #: Records observed since the last wall tick: the NEXT tick
        #: re-anchors the idle clock to its own wall instead of testing
        #: against a stale (possibly pre-restore) anchor -- observe()
        #: itself never reads the wall, keeping the two clock domains
        #: apart.
        self._observed_since_tick = False

    def observe(self, ts_ms: int, source: Any = None) -> None:
        self.inner.observe(ts_ms, source)
        self._idle = False
        if ts_ms > self._max_ts:
            self._max_ts = int(ts_ms)
        self._observed_since_tick = True

    def advance_wall(self, now_ms: int) -> None:
        self.inner.advance_wall(now_ms)
        if self._observed_since_tick:
            # A record arrived since the last tick (covers records
            # observed before the FIRST tick and the first record after
            # a checkpoint restore alike): the idle clock starts at THIS
            # tick -- never at a stale anchor that would declare a
            # just-active source idle.
            self._last_observe_wall = int(now_ms)
            self._observed_since_tick = False
        elif (
            self._last_observe_wall is not None
            and now_ms - self._last_observe_wall >= self.timeout_ms
        ):
            self._idle = True

    def current_ms(self) -> int:
        if self._idle:
            return max(self.inner.current_ms(), self._max_ts)
        return self.inner.current_ms()

    @property
    def is_idle(self) -> bool:
        return self._idle

    def state(self) -> Dict[str, Any]:
        return {
            "inner": self.inner.state(),
            "inner_kind": self.inner.kind,
            "timeout_ms": self.timeout_ms,
            "last_observe_wall": self._last_observe_wall,
            "idle": self._idle,
            "max_ts": self._max_ts,
            "observed_since_tick": self._observed_since_tick,
        }

    def restore(self, state: Dict[str, Any]) -> None:
        self.inner.restore(state["inner"])
        self.timeout_ms = int(state["timeout_ms"])
        # The restored anchor belongs to the PREVIOUS process's wall
        # epoch: comparing across restarts would declare a just-active
        # source idle after a long outage. Drop it and re-arm as if a
        # record just arrived -- the first post-restore tick re-anchors
        # and a genuinely dark source still goes idle one full timeout
        # later (a fresh grace period, never a wedge, never a false
        # positive).
        self._last_observe_wall = None
        self._idle = bool(state["idle"])
        self._max_ts = int(state["max_ts"])
        self._observed_since_tick = True
