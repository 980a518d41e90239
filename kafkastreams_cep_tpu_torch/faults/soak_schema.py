"""The soak verdict's schema: a copy of the soak half of the repo's
`scripts/check_bench_schema.py` (`SOAK_SLOS`, `validate_soak`,
`looks_like_soak`), so that the port's soak validates its artifact
without importing a script or the JAX package. The `metrics` round trip
runs through the port's own `obs/registry.py`.

A SOAK_r*.json verdict (faults/soak.py) is held both ways: every
documented key present, no undocumented extra. The SLO set is pinned to
`SOAK_SLOS` exactly, every SLO entry carries the verdict shape, every
scraped series summary carries min/max/last/slope, and the
`metrics`/`faults` sections hold the registry contract (snapshot round
trip through Prometheus text, FAULT_SERIES key pinning).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from ..obs.registry import FAULT_SERIES, parse_prom_text, registry_from_snapshot

NUMBER = (int, float)
OPT_NUMBER = (int, float, type(None))

#: The `faults` block: label-summed totals of every fault/robustness
#: counter family (obs/registry.py FAULT_SERIES). All keys always present;
#: all-zero in a healthy run.
FAULT_KEYS: Tuple[str, ...] = FAULT_SERIES

#: DrainController.state() (parallel/drain_sched.py): the knob/signal
#: snapshot embedded by the soak's auto-cadence scenario; pinned both
#: ways here.
SINK_CONTROLLER_KEYS: Dict[str, tuple] = {
    "target_emit_ms": NUMBER,
    "gc_group": NUMBER,
    "suggest_t": NUMBER,
    "p99_ms": OPT_NUMBER,
    "rate_ev_s": NUMBER,
    "ticks": NUMBER,
    "adjustments": NUMBER,
    "gc_changes": NUMBER,
    "compile_budget": NUMBER,
    "compiles_seen": OPT_NUMBER,
}

#: CapacityAutosizer.state() (parallel/drain_sched.py): the
#: capacity law's snapshot -- chosen caps, resize/refusal counts, the
#: shrink floor, and the NESTED cadence state (SINK_CONTROLLER_KEYS).
#: Controller blocks dispatch on the `resizes` key: present means
#: autosizer, absent means a plain drain controller.
AUTOSIZER_STATE_KEYS: Dict[str, tuple] = {
    "lanes": NUMBER,
    "nodes": NUMBER,
    "matches": NUMBER,
    "matches_per_step": NUMBER,
    "suggest_t": NUMBER,
    "resizes": NUMBER,
    "refused": NUMBER,
    "ticks": NUMBER,
    "compile_budget": NUMBER,
    "floor": (dict,),
    "cadence": (dict,),
    "compiles_seen": OPT_NUMBER,
}


def _check_controller_block(
    block: Optional[dict], where: str, errors: List[str]
) -> None:
    """A `controller` entry is either a CapacityAutosizer state
    (discriminated by its `resizes` key) or a plain DrainController
    state -- validate whichever shape it claims, both ways."""
    if block is None:
        return
    if "resizes" in block:
        _check_flat_block(block, AUTOSIZER_STATE_KEYS, where, errors)
        if isinstance(block.get("cadence"), dict):
            _check_flat_block(
                block["cadence"], SINK_CONTROLLER_KEYS,
                f"{where}.cadence", errors,
            )
    else:
        _check_flat_block(block, SINK_CONTROLLER_KEYS, where, errors)


#: The `eps_regression` SLO's detail: deltas vs a --compare prior
#: artifact (scripts/perf_ledger.py compare_artifacts); None without
#: --compare. Per-config entries hold per-metric
#: {prev, cur, delta_pct, regressed} dicts.
REGRESSION_KEYS: Dict[str, tuple] = {
    "prior": (str,),
    "tolerance": NUMBER,
    "configs": (dict,),
    "missing_configs": (list,),
    "regressed": (bool,),
    "excused": (bool,),
    "tunnel_degraded_prev": (bool,),
    "tunnel_degraded_cur": (bool,),
    # Platform-change excusal: a round recorded on a
    # different backend (cpu vs another device) is an environment delta, not a code
    # regression -- both sides' platforms ride the block so the excusal
    # is auditable. None when the prior predates self-described
    # platforms (truncated wrappers).
    "platform_prev": (str, type(None)),
    "platform_cur": (str, type(None)),
    # Bench-mode excusal: full vs --quick/--smoke rounds run
    # deliberately different workload sizes, so cross-mode deltas are
    # excused -- both sides' modes ride the block for auditability. None
    # when a truncated wrapper carries no mode marker.
    "mode_prev": (str, type(None)),
    "mode_cur": (str, type(None)),
    # Autosize excusal: a hand-tuned round vs a zero-knob
    # round measures deliberately different shapes; the flag flip is an
    # excuse, not a regression. None when a side predates the flag.
    "autosized_prev": (bool, type(None)),
    "autosized_cur": (bool, type(None)),
    # Controller-migration excusal: a round during which the
    # fleet controller executed rebalance actions spent wall clock on
    # fence->checkpoint->resume by design; the marker rides both sides
    # for auditability. None when a side predates the controller.
    "controller_migrations_prev": (bool, type(None)),
    "controller_migrations_cur": (bool, type(None)),
    # Which excusal actually fired (tunnel_degraded | platform_change |
    # mode_change | autosize_change | controller_migration |
    # salvaged_artifact); None when nothing regressed or nothing
    # excused it.
    "excuse": (str, type(None)),
}

METRIC_KINDS = ("counter", "gauge", "histogram")

# ---------------------------------------------------------------- SOAK schema
#: Top-level contract of a SOAK_r*.json verdict (faults/soak.py). Same
#: both-ways rule as every artifact of the repo.
SOAK_TOP_LEVEL: Dict[str, Tuple[bool, tuple]] = {
    "soak": (True, (dict,)),
    "scenarios": (True, (dict,)),
    # Fleet tracing & SLO control plane: the burn-rate
    # controller's state + stitched-trace evidence. Optional so older
    # verdicts still validate; when present it is held to FLEET_KEYS.
    "fleet": (False, (dict,)),
    "slos": (True, (dict,)),
    "series": (True, (dict,)),
    "metrics": (True, (dict,)),
    "faults": (True, (dict,)),
    "passed": (True, (bool,)),
    "schema_ok": (False, (bool,)),
}

#: The `fleet` block (ops/controller.py FleetController.state
#: trimmed by the soak): burn/decision evidence when the controller was
#: armed. `enabled: false` blocks carry only the trace evidence.
FLEET_KEYS: Dict[str, tuple] = {
    "enabled": (bool,),
    "ticks": NUMBER,
    "actions": NUMBER,
    "burn": (dict,),
    "policy": (dict,),
    "decisions": (list,),
    "trace": (dict,),
}
#: Burn SLO names -- pinned exactly (a controller that silently stops
#: evaluating an SLO must fail the artifact's own schema).
FLEET_BURN_KEYS: Dict[str, tuple] = {
    "match_latency_p99": NUMBER,
    "emission_integrity": NUMBER,
    "pend_drift": NUMBER,
}
#: ControllerPolicy.as_dict() -- the thresholds the decisions were made
#: under ride the artifact so a judge can re-derive every breach.
FLEET_POLICY_KEYS: Dict[str, tuple] = {
    "latency_p99_budget_s": NUMBER,
    "drops_budget_per_s": NUMBER,
    "pend_slope_budget_per_s": NUMBER,
    "burn_threshold": NUMBER,
    "skew_ratio": NUMBER,
    "min_load": NUMBER,
    "dead_after_s": NUMBER,
    "cooldown_s": NUMBER,
}
#: One controller decision record (FleetController.tick()).
FLEET_DECISION_KEYS: Dict[str, tuple] = {
    "t_unix": NUMBER,
    "scraped": (list,),
    "shard_loads": (dict,),
    "burn": (dict,),
    "breached": (list,),
    "planned": (list,),
    "cooldown": (bool,),
    "executed": (list,),
}
#: The fleet block's stitched-trace evidence: span totals and the
#: Perfetto-loadable trace file the run wrote (None when tracing was
#: disabled or the workdir was unwritable).
FLEET_TRACE_KEYS: Dict[str, tuple] = {
    "spans": NUMBER,
    "stitched": NUMBER,
    "trace_file": (str, type(None)),
}


def _check_fleet_block(
    block: dict, where: str, errors: List[str]
) -> None:
    """Both-ways check of the soak's `fleet` block. A disabled block
    carries only {enabled, trace}; an enabled one carries the full
    controller state, with the burn names, policy knobs and decision
    shape each pinned exactly."""
    keys = (
        FLEET_KEYS
        if block.get("enabled")
        else {k: FLEET_KEYS[k] for k in ("enabled", "trace")}
    )
    _check_flat_block(block, keys, where, errors)
    if isinstance(block.get("trace"), dict):
        _check_flat_block(
            block["trace"], FLEET_TRACE_KEYS, f"{where}.trace", errors
        )
    if not block.get("enabled"):
        return
    if isinstance(block.get("burn"), dict):
        _check_flat_block(
            block["burn"], FLEET_BURN_KEYS, f"{where}.burn", errors
        )
    if isinstance(block.get("policy"), dict):
        _check_flat_block(
            block["policy"], FLEET_POLICY_KEYS, f"{where}.policy", errors
        )
    for i, dec in enumerate(block.get("decisions", ())):
        if not isinstance(dec, dict):
            errors.append(f"{where}.decisions[{i}]: expected object")
            continue
        _check_flat_block(
            dec, FLEET_DECISION_KEYS, f"{where}.decisions[{i}]", errors
        )
        if isinstance(dec.get("burn"), dict):
            _check_flat_block(
                dec["burn"], FLEET_BURN_KEYS,
                f"{where}.decisions[{i}].burn", errors,
            )

#: The `soak` run-description block.
SOAK_RUN_KEYS: Dict[str, tuple] = {
    "version": NUMBER,
    "seed": NUMBER,
    "quick": (bool,),
    "platform": (str,),
    "runtime": (str,),
    "transport": (str,),
    "violation": (str,),
    "duration_s": NUMBER,
    "wall_s": NUMBER,
    "events_produced": NUMBER,
    "events_processed": NUMBER,
    "matches": NUMBER,
    "eps": NUMBER,
    "crashes": NUMBER,
    "chaos_points": NUMBER,
    "churn_epochs": NUMBER,
    "scrapes": NUMBER,
    "scrape_errors": NUMBER,
    # Partitioned-fleet evidence: --brokers size, seeded
    # broker kills that landed, and the salvage-rebalance volume (all
    # zero-ish in single-broker runs).
    "brokers": NUMBER,
    "broker_kills": NUMBER,
    "rebalance_partitions_moved": NUMBER,
    "rebalance_records_moved": NUMBER,
    # Zero-knob capacity: True when the device scenarios ran
    # under the capacity autosizer + admission pacer (--auto-cadence).
    "autosized": (bool,),
}

#: The SLO name set -- pinned EXACTLY (a soak that silently stops gating
#: an SLO must fail its own schema).
SOAK_SLOS: Tuple[str, ...] = (
    "evidence",
    "drops",
    "p99_match_latency_ms",
    "watermark_lag_s",
    "leak_drift",
    "eps_regression",
    # Exactly-once across crashes, broker kills and shard rebalances
    # every sink digest unique.
    "emission_integrity",
)

#: One SLO verdict entry: the machine-gateable shape.
SOAK_SLO_KEYS: Dict[str, tuple] = {
    "ok": (bool,),
    "value": OPT_NUMBER,
    "bound": OPT_NUMBER,
    "excused": (bool,),
    "detail": (dict, type(None)),
}

#: One scraped time-series summary (obs/scrape.py TimeSeries.summary):
#: min/max/last/slope let a judge tell a leak from a spike offline.
SOAK_SERIES_KEYS: Dict[str, tuple] = {
    "n": NUMBER,
    "min": NUMBER,
    "max": NUMBER,
    "last": NUMBER,
    "slope_per_s": NUMBER,
}

#: One scenario detail entry. `controller` carries the adaptive drain
#: controller's chosen knobs (DrainController.state()) for the
#: auto-cadence scenario; None for scenarios running without
#: the controller.
SOAK_SCENARIO_KEYS: Dict[str, tuple] = {
    "generator": (str,),
    "runtime": (str,),
    "topics": (list,),
    "events": NUMBER,
    "matches": NUMBER,
    "eps": NUMBER,
    "gated": (bool,),
    "controller": (dict, type(None)),
}


def looks_like_soak(doc: Any) -> bool:
    """Shape dispatch for main(): soak verdicts carry `soak` + `slos`."""
    return isinstance(doc, dict) and "soak" in doc and "slos" in doc


def validate_soak(out: Any) -> List[str]:
    """Schema violations for a SOAK_r*.json verdict (empty = valid)."""
    errors: List[str] = []
    if not isinstance(out, dict):
        return [f"soak artifact must be a JSON object, got {type(out).__name__}"]
    for key, (required, types) in SOAK_TOP_LEVEL.items():
        if key not in out:
            if required:
                errors.append(f"missing documented key {key!r}")
            continue
        if not isinstance(out[key], types):
            errors.append(
                f"{key}: expected {tuple(t.__name__ for t in types)}, "
                f"got {type(out[key]).__name__}"
            )
    for key in out:
        if key not in SOAK_TOP_LEVEL:
            errors.append(
                f"undocumented key {key!r} (document it in "
                "faults/soak_schema.py SOAK_TOP_LEVEL)"
            )
    if isinstance(out.get("soak"), dict):
        _check_flat_block(out["soak"], SOAK_RUN_KEYS, "soak", errors)
    if isinstance(out.get("fleet"), dict):
        _check_fleet_block(out["fleet"], "fleet", errors)
    slos = out.get("slos")
    if isinstance(slos, dict):
        for name in SOAK_SLOS:
            if name not in slos:
                errors.append(f"slos: missing SLO {name!r}")
        for name, entry in slos.items():
            if name not in SOAK_SLOS:
                errors.append(f"slos: undocumented SLO {name!r}")
            if not isinstance(entry, dict):
                errors.append(f"slos.{name}: expected object")
                continue
            _check_flat_block(entry, SOAK_SLO_KEYS, f"slos.{name}", errors)
            # The regression SLO's detail is a perf_ledger
            # compare_artifacts block: hold it to that contract.
            if name == "eps_regression" and isinstance(
                entry.get("detail"), dict
            ):
                _check_flat_block(
                    entry["detail"], REGRESSION_KEYS,
                    "slos.eps_regression.detail", errors,
                )
    if isinstance(out.get("series"), dict):
        for name, summary in out["series"].items():
            if not isinstance(summary, dict):
                errors.append(f"series.{name}: expected object")
            else:
                _check_flat_block(
                    summary, SOAK_SERIES_KEYS, f"series.{name}", errors
                )
    if isinstance(out.get("scenarios"), dict):
        for name, sc in out["scenarios"].items():
            if not isinstance(sc, dict):
                errors.append(f"scenarios.{name}: expected object")
            else:
                _check_flat_block(
                    sc, SOAK_SCENARIO_KEYS, f"scenarios.{name}", errors
                )
                if isinstance(sc.get("controller"), dict):
                    _check_controller_block(
                        sc["controller"],
                        f"scenarios.{name}.controller", errors,
                    )
    if isinstance(out.get("metrics"), dict):
        _check_metrics_section(out["metrics"], errors)
    faults = out.get("faults")
    if isinstance(faults, dict):
        for k in FAULT_KEYS:
            if k not in faults:
                errors.append(f"faults: missing series {k!r}")
            elif not isinstance(faults[k], NUMBER):
                errors.append(f"faults.{k}: expected number")
        for k in faults:
            if k not in FAULT_KEYS:
                errors.append(
                    f"faults: undocumented series {k!r} (add it to "
                    "obs.registry.FAULT_SERIES and this schema)"
                )
    return errors

def _check_flat_block(
    block: Optional[dict],
    keys: Dict[str, tuple],
    where: str,
    errors: List[str],
) -> None:
    """Documented-key check for a flat dict block (observation, latency)."""
    if block is None:
        return
    for k, types in keys.items():
        if k not in block:
            errors.append(f"{where}: missing documented key {k!r}")
        elif not isinstance(block[k], types):
            errors.append(
                f"{where}.{k}: expected {types}, got {type(block[k]).__name__}"
            )
    for k in block:
        if k not in keys:
            errors.append(f"{where}: undocumented key {k!r}")


def _check_metrics_section(
    snap: dict, errors: List[str], section: str = "metrics"
) -> None:
    """Structural check of a registry snapshot + prom-text round-trip.

    `section` names the artifact key being checked -- the same contract
    applies to the primary `metrics` snapshot and the merged
    cross-registry `metrics_merged` one (obs/merge.py output)."""
    # Section-local structural errors gate the round-trip below (a
    # malformed snapshot cannot be rebuilt); unrelated errors from other
    # sections must not suppress this check.
    local: List[str] = []
    for name, fam in snap.items():
        where = f"{section}.{name}"
        if not isinstance(fam, dict):
            local.append(f"{where}: expected object")
            continue
        kind = fam.get("type")
        if kind not in METRIC_KINDS:
            local.append(f"{where}: bad type {kind!r}")
            continue
        for req in ("help", "label_names", "values"):
            if req not in fam:
                local.append(f"{where}: missing {req!r}")
        for entry in fam.get("values", ()):
            if kind == "histogram":
                missing = {"labels", "count", "sum", "buckets"} - set(entry)
            else:
                missing = {"labels", "value"} - set(entry)
            if missing:
                local.append(f"{where}: value entry missing {sorted(missing)}")
    errors.extend(local)
    if local:
        return
    # Round-trip: snapshot -> registry -> prom text -> parsed samples must
    # carry the same values the snapshot holds.
    reg = registry_from_snapshot(snap)
    parsed = parse_prom_text(reg.to_prom_text())

    def close(a: float, b: float) -> bool:
        if math.isinf(a) or math.isinf(b):
            return a == b
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)

    for name, fam in snap.items():
        label_names = fam.get("label_names", [])
        for entry in fam["values"]:
            base = tuple(
                (ln, str(entry["labels"][ln])) for ln in label_names
            )
            if fam["type"] == "histogram":
                pairs = [
                    (f"{name}_sum", base, float(entry["sum"])),
                    (f"{name}_count", base, float(entry["count"])),
                ] + [
                    (
                        f"{name}_bucket",
                        base + (("le", le),),
                        float(cum),
                    )
                    for le, cum in entry["buckets"].items()
                ]
            else:
                pairs = [(name, base, float(entry["value"]))]
            for sample, labels, want in pairs:
                got = parsed.get(sample, {}).get(labels)
                if got is None:
                    errors.append(
                        f"{section} round-trip: {sample}{dict(labels)} "
                        "missing from prom text"
                    )
                elif not close(got, want):
                    errors.append(
                        f"{section} round-trip: {sample}{dict(labels)} "
                        f"prom={got} snapshot={want}"
                    )
