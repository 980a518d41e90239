"""Fleet controller: SLO burn rates close the rebalance loop.

A copy of the JAX package's `ops/controller.py` (host-side only).
`streams/rebalance.py` holds the mechanism (fence -> checkpoint -> resume
via `RebalanceController.migrate`, salvage recovery via
`recover_broker`); `FleetController` is the daemon that decides when,
from OBSERVATIONS only:

1. **Scrape.** Each tick pulls every configured source's registry
   snapshot -- an `IntrospectionServer` URL (``GET /snapshot``), a live
   `MetricsRegistry`, or any callable returning a snapshot dict. A
   source that fails to scrape is counted
   (`cep_controller_scrape_errors_total`) and skipped; the loop never
   wedges on one dead broker.
2. **Merge.** Snapshots merge through `obs.merge.merge_snapshots` --
   counters sum, gauges gain the `device` label, histograms add
   bucket-wise -- so SLO evaluation sees the fleet as one system.
3. **Evaluate burn.** Three SLOs, the same families the soak
   gates: match-latency p99 (merged `cep_match_latency_seconds`
   buckets), emission integrity (the soak's DROP_SERIES counters --
   any fleet-wide drop is burn), and pend-occupancy drift (least-squares
   slope of the merged `cep_pend_occupancy` over the controller's own
   sample history). Burn = observed / budget; >= the policy threshold
   is a breach (`cep_slo_burn_rate{slo}` /
   `cep_slo_burn_breaches_total{slo}`).
4. **Act.** Per-shard load (delta of each device's
   `cep_driver_records_total` per tick) feeds `rebalance.plan()`;
   returned actions -- skew migrations, dead-broker recovery -- are
   handed to the configured `execute` callback (the harness wires it to
   `RebalanceController.migrate` / `recover_broker`), rate-limited by a
   cooldown so one hot window cannot thrash shards back and forth.
   Every decision (burn, loads, actions, execution results) lands in a
   bounded ring served by `state()` -- the block the soak artifact
   records.

Pure host-side: scraping, merging and planning never touch a device or
the data path; acting is whatever the callback does.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple
from urllib.request import urlopen

from ..obs.merge import merge_snapshots
from ..obs.registry import MetricsRegistry, default_registry

__all__ = ["ControllerPolicy", "FleetController", "histogram_quantile"]

#: Counter families whose fleet-wide increase burns the emission SLO --
#: mirrors faults.soak.DROP_SERIES (imported lazily there to avoid a
#: faults -> ops cycle; the soak asserts the two stay equal).
DROP_SERIES: Tuple[str, ...] = (
    "cep_overflow_dropped_total",
    "cep_reorder_overflow_dropped_total",
    "cep_late_dropped_total",
    "cep_driver_dead_letters_total",
)


class ControllerPolicy:
    """Thresholds the controller steers by. Budgets are per-SLO
    denominators (burn = observed / budget); `burn_threshold` is where a
    burn becomes a breach; skew/dead knobs pass through to
    `rebalance.plan`; `cooldown_s` bounds how often actions execute."""

    __slots__ = (
        "latency_p99_budget_s",
        "drops_budget_per_s",
        "pend_slope_budget_per_s",
        "burn_threshold",
        "skew_ratio",
        "min_load",
        "dead_after_s",
        "cooldown_s",
    )

    def __init__(
        self,
        latency_p99_budget_s: float = 0.5,
        drops_budget_per_s: float = 0.0,
        pend_slope_budget_per_s: float = 50.0,
        burn_threshold: float = 1.0,
        skew_ratio: float = 4.0,
        min_load: float = 1.0,
        dead_after_s: float = 10.0,
        cooldown_s: float = 2.0,
    ) -> None:
        self.latency_p99_budget_s = float(latency_p99_budget_s)
        self.drops_budget_per_s = float(drops_budget_per_s)
        self.pend_slope_budget_per_s = float(pend_slope_budget_per_s)
        self.burn_threshold = float(burn_threshold)
        self.skew_ratio = float(skew_ratio)
        self.min_load = float(min_load)
        self.dead_after_s = float(dead_after_s)
        self.cooldown_s = float(cooldown_s)

    def as_dict(self) -> Dict[str, float]:
        return {name: getattr(self, name) for name in self.__slots__}


def histogram_quantile(fam: Mapping[str, Any], q: float) -> Optional[float]:
    """Quantile estimate from a snapshot histogram family: sum the
    cumulative buckets across every label set (layouts agree within a
    family -- the registry and merge both enforce it), then return the
    smallest finite upper bound covering q of the count. None on an
    empty family; the top bucket answers with its lower neighbor's bound
    (the honest "at least this much" -- there is no upper edge)."""
    cum: Dict[float, float] = {}
    total = 0.0
    for entry in fam.get("values", ()):
        total += float(entry.get("count", 0))
        for le_s, c in entry.get("buckets", {}).items():
            le = float("inf") if le_s in ("+Inf", "inf") else float(le_s)
            cum[le] = cum.get(le, 0.0) + float(c)
    if total <= 0:
        return None
    want = q * total
    bounds = sorted(cum)
    prev_finite = 0.0
    for le in bounds:
        if cum[le] >= want:
            return prev_finite if le == float("inf") else le
        if le != float("inf"):
            prev_finite = le
    return prev_finite


def _fold_counter(fam: Optional[Mapping[str, Any]]) -> float:
    if fam is None:
        return 0.0
    return sum(float(e.get("value", 0.0)) for e in fam.get("values", ()))


def _fold_gauge_sum(fam: Optional[Mapping[str, Any]]) -> float:
    if fam is None:
        return 0.0
    return sum(float(e.get("value", 0.0)) for e in fam.get("values", ()))


class FleetController:
    """The burn-rate-driven rebalance daemon (module docstring).

    `sources` maps a device/shard id to where its metrics live: an
    IntrospectionServer base URL (``http://...``), a live
    `MetricsRegistry`, or a zero-arg callable returning a snapshot dict.
    `execute` receives each `rebalance.plan` action dict and does the
    actual migration/recovery; its return value (or exception string)
    is recorded in the decision. `broker_ages_fn` supplies
    {device: last_ok_age_s} for dead-broker planning (all-zero default:
    scrape failure is the liveness signal instead)."""

    def __init__(
        self,
        sources: Mapping[str, Any],
        registry: Optional[MetricsRegistry] = None,
        policy: Optional[ControllerPolicy] = None,
        execute: Optional[Callable[[Dict[str, Any]], Any]] = None,
        broker_ages_fn: Optional[Callable[[], Mapping[str, float]]] = None,
        every_s: float = 1.0,
        timeout_s: float = 2.0,
        decisions: int = 128,
    ) -> None:
        if not sources:
            raise ValueError("FleetController needs at least one source")
        self.sources = dict(sources)
        self.metrics = registry if registry is not None else default_registry()
        self.policy = policy if policy is not None else ControllerPolicy()
        self.execute = execute
        self.broker_ages_fn = broker_ages_fn
        self.every_s = max(0.01, float(every_s))
        self.timeout_s = float(timeout_s)
        from collections import deque

        self._decisions: Any = deque(maxlen=max(1, int(decisions)))
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: Per-device previous (wall, records_total) for load deltas.
        self._prev_records: Dict[str, Tuple[float, float]] = {}
        #: Previous (wall, fleet drop total) for the emission burn rate.
        self._prev_drops: Optional[Tuple[float, float]] = None
        #: (wall, merged pend occupancy) history for the drift slope.
        self._pend_hist: Any = deque(maxlen=256)
        self._last_action_t: Optional[float] = None
        self.ticks = 0
        m = self.metrics
        self._m_burn = m.gauge(
            "cep_slo_burn_rate",
            "Fleet SLO burn (observed/budget; >= policy threshold is a "
            "breach) from merged scrapes, per SLO",
            labels=("slo",),
        )
        self._m_breaches = m.counter(
            "cep_slo_burn_breaches_total",
            "Controller ticks on which an SLO's burn crossed the policy "
            "threshold",
            labels=("slo",),
        )
        self._m_ticks = m.counter(
            "cep_controller_ticks_total",
            "Fleet-controller evaluation ticks",
        )
        self._m_scrape_errors = m.counter(
            "cep_controller_scrape_errors_total",
            "Source scrapes that failed (skipped, never wedging the loop)",
            labels=("device",),
        )
        self._m_actions = m.counter(
            "cep_controller_actions_total",
            "Rebalance actions the controller invoked, by plan kind",
            labels=("kind",),
        )
        self._m_load = m.gauge(
            "cep_controller_shard_load",
            "Per-shard load (records/s delta of cep_driver_records_total) "
            "the controller last fed to rebalance.plan",
            labels=("shard",),
        )

    # ------------------------------------------------------------- scraping
    def _snapshot_of(self, source: Any) -> Dict[str, Any]:
        if isinstance(source, str):
            with urlopen(
                source.rstrip("/") + "/snapshot", timeout=self.timeout_s
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        if callable(source):
            return source()
        return source.snapshot()

    def _scrape(self) -> Dict[str, Dict[str, Any]]:
        snaps: Dict[str, Dict[str, Any]] = {}
        for device, source in self.sources.items():
            try:
                snaps[device] = self._snapshot_of(source)
            except Exception:
                self._m_scrape_errors.labels(device=str(device)).inc()
        return snaps

    # ------------------------------------------------------------ one tick
    def tick(self) -> Dict[str, Any]:
        """One scrape -> merge -> evaluate -> (maybe) act pass. Returns
        the decision record (also kept in the bounded ring)."""
        from ..streams.rebalance import plan

        now = time.time()
        snaps = self._scrape()
        merged = merge_snapshots(snaps) if snaps else {}

        # Per-shard load: records/s since each device's previous tick.
        # tick() is reachable from both the daemon loop and direct
        # callers (tests, one-shot harnesses), so delta state lives
        # under the lock; scraping and acting stay outside it.
        shard_loads: Dict[str, float] = {}
        with self._lock:
            for device, snap in snaps.items():
                total = _fold_counter(snap.get("cep_driver_records_total"))
                prev = self._prev_records.get(device)
                self._prev_records[device] = (now, total)
                if prev is None or now <= prev[0]:
                    continue
                shard_loads[device] = (
                    max(0.0, total - prev[1]) / (now - prev[0])
                )
        for shard, load in shard_loads.items():
            self._m_load.labels(shard=str(shard)).set(load)

        # SLO burn rates off the merged fleet view.
        pol = self.policy
        p99 = histogram_quantile(
            merged.get("cep_match_latency_seconds", {}), 0.99
        )
        burn: Dict[str, float] = {}
        burn["match_latency_p99"] = (
            0.0 if p99 is None else p99 / max(pol.latency_p99_budget_s, 1e-9)
        )
        drops = sum(_fold_counter(merged.get(s)) for s in DROP_SERIES)
        with self._lock:
            prev_drops = self._prev_drops
            self._prev_drops = (now, drops)
        if prev_drops is None or now <= prev_drops[0]:
            drop_rate = 0.0
        else:
            drop_rate = max(0.0, drops - prev_drops[1]) / (now - prev_drops[0])
        if pol.drops_budget_per_s > 0:
            burn["emission_integrity"] = drop_rate / pol.drops_budget_per_s
        else:
            # Zero budget: any fleet-wide drop is a full breach.
            burn["emission_integrity"] = (
                0.0 if drop_rate <= 0 else max(1.0, drop_rate)
            )
        pend = _fold_gauge_sum(merged.get("cep_pend_occupancy"))
        self._pend_hist.append((now, pend))
        burn["pend_drift"] = (
            max(0.0, self._pend_slope())
            / max(pol.pend_slope_budget_per_s, 1e-9)
        )
        breached = []
        for slo, b in burn.items():
            self._m_burn.labels(slo=slo).set(b)
            if b >= pol.burn_threshold:
                self._m_breaches.labels(slo=slo).inc()
                breached.append(slo)

        # Plan + act. plan() detects skew and dead brokers on its own;
        # the controller supplies what it observed and rate-limits the
        # execution.
        ages = (
            dict(self.broker_ages_fn())
            if self.broker_ages_fn is not None
            else {d: 0.0 for d in self.sources}
        )
        actions = plan(
            shard_loads,
            ages,
            skew_ratio=pol.skew_ratio,
            dead_after_s=pol.dead_after_s,
            min_load=pol.min_load,
        )
        executed: List[Dict[str, Any]] = []
        with self._lock:
            cooled = (
                self._last_action_t is not None
                and now - self._last_action_t < pol.cooldown_s
            )
            acting = bool(actions) and self.execute is not None and not cooled
            if acting:
                self._last_action_t = now
        if acting:
            for action in actions:
                self._m_actions.labels(kind=str(action.get("kind"))).inc()
                outcome: Dict[str, Any] = dict(action)
                try:
                    result = self.execute(action)
                    outcome["ok"] = True
                    if result is not None:
                        outcome["result"] = str(result)
                except Exception as exc:
                    outcome["ok"] = False
                    outcome["error"] = f"{type(exc).__name__}: {exc}"
                executed.append(outcome)
        with self._lock:
            self.ticks += 1
        self._m_ticks.inc()
        decision = {
            "t_unix": now,
            "scraped": sorted(snaps),
            "shard_loads": shard_loads,
            "burn": burn,
            "breached": breached,
            "planned": actions,
            "cooldown": bool(actions) and cooled,
            "executed": executed,
        }
        with self._lock:
            self._decisions.append(decision)
        return decision

    def _pend_slope(self) -> float:
        """Least-squares slope (units/s) of the merged pend occupancy
        history -- the same drift statistic the soak's leak SLO uses."""
        pts = list(self._pend_hist)
        if len(pts) < 3:
            return 0.0
        n = float(len(pts))
        t0 = pts[0][0]
        xs = [t - t0 for t, _v in pts]
        ys = [v for _t, v in pts]
        sx = sum(xs)
        sy = sum(ys)
        sxx = sum(x * x for x in xs)
        sxy = sum(x * y for x, y in zip(xs, ys))
        denom = n * sxx - sx * sx
        if denom <= 0:
            return 0.0
        return (n * sxy - sx * sy) / denom

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="kct-fleet-controller", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self.tick()
            except Exception:
                import logging

                logging.getLogger("kafkastreams_cep_tpu_torch.obs").warning(
                    "fleet controller tick failed", exc_info=True
                )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -------------------------------------------------------------- surface
    def decisions(self, limit: int = 64) -> List[Dict[str, Any]]:
        """Recent decision records, newest first."""
        with self._lock:
            snap = list(self._decisions)
        return snap[::-1][: max(0, limit)]

    def state(self) -> Dict[str, Any]:
        """The controller block a soak artifact records: tick/action
        totals, last burn, policy, and the bounded decision ring
        (oldest first, JSON-ready)."""
        with self._lock:
            decs = list(self._decisions)
        last_burn = decs[-1]["burn"] if decs else {}
        actions = sum(len(d["executed"]) for d in decs)
        return {
            "enabled": True,
            "ticks": self.ticks,
            "actions": actions,
            "burn": last_burn,
            "policy": self.policy.as_dict(),
            "decisions": decs,
        }
