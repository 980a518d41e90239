"""The multi-device dryrun: one sharded multi-key engine step on a key mesh.

The port's counterpart of the JAX package's `dryrun_multichip`: a
`BatchedDeviceNFA` over a key mesh of n shards (parallel/key_shard.py)
advances 2n keys through the stock demo's first events, then

  * `global_stats` summed over the shards must count every event;
  * every key sees the same stream, so every key has the same matches;
  * `device_registries()` -- one registry a shard -- merged by
    obs/merge.py must give counters equal to the global totals and keep
    every shard's `cep_device_runs` gauge under its own `device` label.

It prints one `merged_registry: {...}` line and returns the summary.
A mesh on one device repeated is a virtual mesh: on the CPU it needs no
card, which is how the tests run it; on the card `--device cuda` puts
the `--devices` shards on the visible cards in turn (a card holds more
than one when there are fewer cards than shards).

    python -m kafkastreams_cep_tpu_torch.parallel.dryrun --devices 8 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional, Sequence as Seq, Tuple

import numpy as np

from ..core.event import Event
from ..models.cases import STOCK_FIELDS
from ..models.stocks import GOLDEN_EVENTS, stocks_pattern
from ..obs.merge import merge_registries
from ..ops.engine import EngineConfig
from ..ops.schema import EventSchema
from ..ops.tables import CompiledQuery, compile_query
from ..pattern.compiler import compile_pattern
from .batched import BatchedDeviceNFA
from .key_shard import global_stats, key_mesh


def stock_events(n: int = 8):
    """The first n events of the stock demo on one key (the JAX dryrun's)."""
    return [Event("K", v, 1_000_000 + i, "stocks", 0, i) for i, v in enumerate(GOLDEN_EVENTS[:n])]


def dryrun_query() -> Tuple[CompiledQuery, EngineConfig]:
    """The dryrun's query (the stock demo's) and its tiny engine shape."""
    query = compile_query(compile_pattern(stocks_pattern()), EventSchema(STOCK_FIELDS))
    return query, EngineConfig(lanes=8, nodes=64, matches=16)


def dryrun_multichip(n_devices: int, devices: Optional[Seq[Any]] = None) -> Dict[str, Any]:
    """One sharded step on `key_mesh(n_devices, devices)` (tiny shapes);
    raises AssertionError when a check fails. Returns the merged
    registry's summary."""
    mesh = key_mesh(n_devices, devices=devices)
    query, config = dryrun_query()
    keys = [f"k{i}" for i in range(2 * mesh.size)]
    events = stock_events()
    bat = BatchedDeviceNFA(query, keys=keys, config=config, mesh=mesh)
    out = bat.advance({k: events for k in keys})
    expect = len(events) * len(keys)
    per_shard = [global_stats(st) for st in bat._state]
    totals = {name: sum(int(g[name]) for g in per_shard) for name in per_shard[0]}
    if totals["n_events"] != expect:
        raise AssertionError(f"sharded step ran {totals['n_events']} events, want {expect}")
    counts = {k: len(out.get(k, [])) for k in keys}
    if len(set(counts.values())) != 1 or not counts[keys[0]]:
        raise AssertionError(f"per-key match divergence or no match: {counts}")
    merged = merge_registries(bat.device_registries())
    snap = merged.snapshot()
    merged_totals = {v["labels"]["counter"]: v["value"]
                     for v in snap["cep_device_state_total"]["values"]}
    for name, value in merged_totals.items():
        if value != totals[name]:
            raise AssertionError(f"merged-registry {name} {value} != global {totals[name]}")
    runs = {v["labels"]["device"]: v["value"] for v in snap["cep_device_runs"]["values"]}
    if sorted(runs, key=int) != [str(s) for s in range(mesh.size)]:
        raise AssertionError(f"merged gauges cover devices {sorted(runs)}, want {mesh.size}")
    shard_runs = bat.shard_stats()["runs"]
    if [runs[str(s)] for s in range(mesh.size)] != shard_runs.tolist() \
            or int(np.sum(shard_runs)) != totals["runs"]:
        raise AssertionError(f"per-device runs {runs} != shard_stats {shard_runs.tolist()}")
    if not merged.to_prom_text():
        raise AssertionError("the merged exposition rendered nothing")
    summary = {
        "mesh": mesh.describe(),
        "families": len(snap),
        "n_events": merged_totals["n_events"],
        "matches_per_key": counts[keys[0]],
        "runs_per_device": {d: runs[d] for d in sorted(runs, key=int)},
    }
    print("merged_registry: " + json.dumps(summary), flush=True)
    return summary


def main(argv: Optional[Seq[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="shards of the key mesh")
    ap.add_argument("--device", default="cuda",
                    help="cpu (a virtual mesh on the CPU) or cuda (every visible card)")
    args = ap.parse_args(argv)
    devices = None if args.device == "cuda" else [args.device]
    dryrun_multichip(args.devices, devices=devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
