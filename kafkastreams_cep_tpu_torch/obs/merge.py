"""Cross-device registry merge: one exposition for a sharded fleet.

A copy of the JAX package's `obs/merge.py` (stdlib only). Each
device/shard owns a host-side MetricsRegistry, and a scraper wants ONE exposition for the
fleet. The merge rules mirror what the series semantics demand:

- **Counters sum.** Monotonic totals with identical label sets add across
  devices (the fleet's total is the sum of the parts; per-device
  attribution, when wanted, belongs in an explicit label the source
  registry already carries).
- **Gauges carry a `device` label.** A point-in-time value from two
  devices is two series, never a sum -- each child gains
  `device="<id>"` so the series can never interleave. Gauges whose
  family already declares a `device` label are passed through verbatim,
  and a collision (two source registries claiming the same device value)
  is an error, not a silent overwrite.
- **Histograms merge bucket-wise.** Families must agree on bucket
  layout (a mismatch is two subsystems fighting over one name -- the
  same rule MetricsRegistry enforces at registration); cumulative bucket
  counts, `sum` and `count` add per label set.

The merge operates on snapshots (`MetricsRegistry.snapshot()` dicts), so
it works identically for live registries, soak artifacts and anything a
remote shard shipped over the wire; `merge_registries` is the live-object
convenience. Bounded cardinality survives the merge: the rebuilt registry
enforces `max_label_sets` like any other, so a fleet-wide label explosion
(K devices x L series) fails loudly instead of flooding the exposition.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from .registry import MetricsRegistry, registry_from_snapshot

__all__ = ["merge_registries", "merge_snapshots"]


def _label_key(labels: Mapping[str, Any], names: List[str]) -> Tuple[str, ...]:
    return tuple(str(labels[n]) for n in names)


def merge_snapshots(
    snaps: Mapping[str, Mapping[str, Any]],
) -> Dict[str, Any]:
    """Merge per-device registry snapshots into one snapshot dict.

    `snaps` maps a device id (mesh shard index, hostname, ...) to that
    device's `MetricsRegistry.snapshot()`. Returns a snapshot in the same
    format, mergeable further or rebuildable via `registry_from_snapshot`.
    """
    merged: Dict[str, Any] = {}
    for device, snap in snaps.items():
        for name, fam in snap.items():
            kind = fam["type"]
            label_names = list(fam.get("label_names", ()))
            out = merged.get(name)
            if out is None:
                out_label_names = list(label_names)
                if kind == "gauge" and "device" not in out_label_names:
                    out_label_names.append("device")
                out = merged[name] = {
                    "type": kind,
                    "help": fam.get("help", ""),
                    "label_names": out_label_names,
                    "_src_label_names": label_names,
                    "_bucket_layout": None,
                    "values": [],
                    "_index": {},
                }
            else:
                if out["type"] != kind or out["_src_label_names"] != label_names:
                    raise ValueError(
                        f"metric {name!r}: device {device!r} disagrees on "
                        f"type/labels ({kind} {label_names} vs "
                        f"{out['type']} {out['_src_label_names']})"
                    )
            for entry in fam["values"]:
                labels = dict(entry["labels"])
                if kind == "histogram":
                    # FAMILY-level layout check (prom registries hold one
                    # bucket layout per family): comparing only on a label
                    # collision would let disjoint label sets smuggle two
                    # layouts into one family, which the rebuilt registry
                    # then renders corruptly.
                    layout = frozenset(entry["buckets"])
                    if out["_bucket_layout"] is None:
                        out["_bucket_layout"] = layout
                    elif out["_bucket_layout"] != layout:
                        raise ValueError(
                            f"histogram {name!r}: device {device!r} bucket "
                            f"layout {sorted(entry['buckets'])} differs "
                            f"from the family's "
                            f"{sorted(out['_bucket_layout'])}"
                        )
                if kind == "gauge":
                    if "device" not in label_names:
                        labels["device"] = str(device)
                    key = _label_key(labels, out["label_names"])
                    if key in out["_index"]:
                        raise ValueError(
                            f"gauge {name!r}: device series {labels} "
                            "already present (two devices claim one "
                            "device label value)"
                        )
                    out["_index"][key] = len(out["values"])
                    out["values"].append({"labels": labels, "value": entry["value"]})
                    continue
                key = _label_key(labels, out["label_names"])
                at = out["_index"].get(key)
                if at is None:
                    out["_index"][key] = len(out["values"])
                    if kind == "histogram":
                        out["values"].append(
                            {
                                "labels": labels,
                                "count": int(entry["count"]),
                                "sum": float(entry["sum"]),
                                "buckets": {
                                    k: int(v) for k, v in entry["buckets"].items()
                                },
                            }
                        )
                    else:
                        out["values"].append(
                            {"labels": labels, "value": float(entry["value"])}
                        )
                    continue
                acc = out["values"][at]
                if kind == "histogram":
                    # Layout agreement was enforced family-level above.
                    # Cumulative-per-bucket counts add bucket-wise: the
                    # merged cumulative distribution is the sum of the
                    # parts' (both are cumulative over the same bounds).
                    for k, v in entry["buckets"].items():
                        acc["buckets"][k] += int(v)
                    acc["sum"] += float(entry["sum"])
                    acc["count"] += int(entry["count"])
                else:
                    acc["value"] += float(entry["value"])
    for fam in merged.values():
        fam.pop("_index")
        fam.pop("_src_label_names")
        fam.pop("_bucket_layout")
    return merged


def merge_registries(
    registries: Mapping[str, MetricsRegistry],
    max_label_sets: Optional[int] = None,
) -> MetricsRegistry:
    """Merge live per-device registries into one rebuilt MetricsRegistry.

    `registries` maps device id -> registry; the result holds the merged
    values (counters summed, gauges device-labeled, histograms merged
    bucket-wise) and exposes them through the normal `to_prom_text` /
    `snapshot` paths. Histogram sample reservoirs are not merged -- the
    rebuilt copy is exposition-only, like `registry_from_snapshot`.
    `max_label_sets` bounds the merged cardinality (fleet-wide series
    explosions fail loudly at the merge, not at the scraper)."""
    snap = merge_snapshots(
        {dev: reg.snapshot() for dev, reg in registries.items()}
    )
    return registry_from_snapshot(snap, max_label_sets=max_label_sets)
