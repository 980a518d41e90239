"""Timeline export: SpanTracer rings + match exemplars as Chrome-trace JSON.

A copy of the JAX package's `obs/trace_export.py`.

The SpanTracer's recent-span ring (restore / poll-commit / device_trace
walls) and the engines' sampled match-provenance exemplars could only be
read as JSON lists -- no timeline view. This module renders
both into the Chrome Trace Event format (the JSON Perfetto and
chrome://tracing load natively), so "what did this process just spend
time on" becomes a zoomable timeline instead of a scrollback of dicts:

- **Host spans** become complete (``"ph": "X"``) events on the wall-clock
  timebase: ``ts`` is the span's start in microseconds since the Unix
  epoch, ``dur`` its wall duration. One timeline row per span name (the
  ``tid`` is a stable small index per name) so poll/commit/restore
  cadence reads at a glance.
- **Match exemplars** become complete events on the EVENT-TIME timebase
  (the window's first..last event timestamp): a match's provenance
  carries no host wall stamp, so mixing it into the span rows would lie
  about simultaneity. They land under their own process row
  (``pid`` MATCH_PID, one row per query) with the full provenance dict
  in ``args`` -- clicking a match in Perfetto shows its lineage.

`chrome_trace` returns the JSON-object flavor (``{"traceEvents": [...]}``
plus metadata); the event array alone is also a valid trace. Serving
lives in obs/http.py (``/tracez?format=chrome``).

The **stitched fleet view**: spans recorded with a
`TraceContext` (trace_id / span_id / parent_id ring fields) render
twice -- as their usual per-process ``X`` events, and as async
nestable events (``"ph": "b"/"e"`` keyed by ``id`` = trace id) under
one dedicated TRACE_PID row group, so a record's end-to-end story
(producer ingest, broker A append, migration fence -> resume, match
emission on broker B) reads as ONE timeline track even though the
spans were recorded by different tracers in different processes.
Flow arrows (``"ph": "s"/"f"``) bind each child span to its parent.
`stitched_chrome_trace(*tracers)` merges several rings into one doc.

Everything here is a pure host-side read of already-recorded rings --
rendering a timeline can never sync the device or touch the data path.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional

from .trace import SpanTracer

__all__ = [
    "MATCH_PID",
    "SPAN_PID",
    "TRACE_PID",
    "chrome_trace",
    "match_events",
    "span_events",
    "stitched_chrome_trace",
    "stitched_span_events",
    "write_chrome_trace",
]

#: Chrome-trace process ids: host wall spans vs event-time match rows.
#: Two timebases must never share a row (see module docstring).
SPAN_PID = 1
MATCH_PID = 2
#: Stitched wire-propagated traces (one async track per trace id).
TRACE_PID = 3


def span_events(
    spans: Iterable[Mapping[str, Any]],
    pid: int = SPAN_PID,
) -> List[Dict[str, Any]]:
    """Render SpanTracer ring entries (``recent()`` dicts: span /
    end_unix / duration_s) as Chrome complete events, one ``tid`` row per
    span name. Input order is free; output carries whatever was given
    (trace viewers sort by ``ts`` themselves)."""
    rows: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for s in spans:
        name = str(s.get("span", "span"))
        tid = rows.setdefault(name, len(rows) + 1)
        dur_s = float(s.get("duration_s", 0.0))
        end_unix = float(s.get("end_unix", 0.0))
        args: Dict[str, Any] = {"end_unix": end_unix}
        for k in ("trace_id", "span_id", "parent_id"):
            if s.get(k) is not None:
                args[k] = s[k]
        out.append(
            {
                "name": name,
                "cat": "host_span",
                "ph": "X",
                # Microseconds since the epoch: Perfetto renders absolute
                # wall clocks fine, and two exports from two processes
                # line up without a shared t0 handshake.
                "ts": (end_unix - dur_s) * 1e6,
                "dur": dur_s * 1e6,
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    return out


def stitched_span_events(
    spans: Iterable[Mapping[str, Any]],
    pid: int = TRACE_PID,
) -> List[Dict[str, Any]]:
    """Render trace-bearing span entries (the ring entries that carry
    `trace_id`/`span_id`/`parent_id`) as ONE stitched track per trace:
    async nestable begin/end pairs keyed by ``id`` = trace id (Perfetto
    groups them on one row regardless of which process recorded each
    span), plus flow arrows from each parent span's end to its child's
    start. Entries without a trace id are skipped -- they belong on the
    per-process SPAN_PID rows."""
    out: List[Dict[str, Any]] = []
    #: span_id -> (start_us, end_us), for flow-arrow anchoring.
    walls: Dict[str, Any] = {}
    traced = [s for s in spans if s.get("trace_id")]
    for s in traced:
        dur_s = float(s.get("duration_s", 0.0))
        end_unix = float(s.get("end_unix", 0.0))
        t0 = (end_unix - dur_s) * 1e6
        t1 = end_unix * 1e6
        sid = s.get("span_id")
        if sid is not None:
            walls[str(sid)] = (t0, t1)
        base = {
            "name": str(s.get("span", "span")),
            "cat": "stitched_trace",
            "id": str(s["trace_id"]),
            "pid": pid,
            "tid": 1,
            "args": {
                "trace_id": s["trace_id"],
                "span_id": sid,
                "parent_id": s.get("parent_id"),
            },
        }
        out.append(dict(base, ph="b", ts=t0))
        out.append(dict(base, ph="e", ts=t1))
    # Parent -> child flow arrows: only when both ends are in this export
    # (a parent recorded by a process that was not merged in simply has
    # no arrow; the async track above still stitches the story).
    flow_ids = 0
    for s in traced:
        parent = s.get("parent_id")
        if parent is None or str(parent) not in walls:
            continue
        dur_s = float(s.get("duration_s", 0.0))
        end_unix = float(s.get("end_unix", 0.0))
        child_start = (end_unix - dur_s) * 1e6
        parent_start = walls[str(parent)][0]
        flow_ids += 1
        fid = f"{s['trace_id']}:{flow_ids}"
        common = {
            "name": "propagate",
            "cat": "stitched_trace",
            "pid": pid,
            "tid": 1,
        }
        out.append(dict(common, ph="s", id=fid, ts=parent_start))
        out.append(dict(common, ph="f", id=fid, bp="e", ts=child_start))
    return out


def match_events(
    matches: Iterable[Mapping[str, Any]],
    pid: int = MATCH_PID,
) -> List[Dict[str, Any]]:
    """Render match-provenance exemplars (provenance_exemplars() dicts)
    as Chrome complete events on the event-time axis: ts..ts+dur is the
    match window's first..last event timestamp (ms -> us), with the full
    provenance in ``args``. Zero-width windows (single-event matches)
    still render: viewers draw a minimal sliver for dur=0."""
    rows: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for m in matches:
        query = str(m.get("query", "q"))
        tid = rows.setdefault(query, len(rows) + 1)
        t0_ms = float(m.get("first_timestamp", -1))
        t1_ms = float(m.get("last_timestamp", t0_ms))
        out.append(
            {
                "name": query,
                "cat": "match_event_time",
                "ph": "X",
                "ts": t0_ms * 1e3,
                "dur": max(t1_ms - t0_ms, 0.0) * 1e3,
                "pid": pid,
                "tid": tid,
                "args": dict(m),
            }
        )
    return out


def _process_metadata(pid: int, name: str) -> Dict[str, Any]:
    return {
        "name": "process_name",
        "ph": "M",
        "pid": pid,
        "tid": 0,
        "args": {"name": name},
    }


def chrome_trace(
    tracer: Optional[SpanTracer] = None,
    spans: Optional[Iterable[Mapping[str, Any]]] = None,
    match_exemplars: Optional[Iterable[Mapping[str, Any]]] = None,
    limit: int = 1024,
) -> Dict[str, Any]:
    """The full Chrome-trace document: host spans (from `tracer.recent`
    or an explicit `spans` iterable) + optional match exemplars, with
    process-name metadata rows naming the two timebases."""
    if spans is None:
        spans = tracer.recent(limit) if tracer is not None else []
    events: List[Dict[str, Any]] = [
        _process_metadata(SPAN_PID, "host spans (wall clock)"),
    ]
    events.extend(span_events(spans))
    if match_exemplars is not None:
        events.append(_process_metadata(MATCH_PID, "matches (event time)"))
        events.extend(match_events(match_exemplars))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "kafkastreams_cep_tpu_torch.obs.trace_export"},
    }


def stitched_chrome_trace(
    *tracers: SpanTracer,
    limit: int = 1024,
    names: Optional[Iterable[str]] = None,
) -> Dict[str, Any]:
    """Merge several tracers' rings (producer, per-broker, controller)
    into ONE Chrome-trace document: each tracer keeps its own per-process
    row group (``pid`` SPAN_PID + index, named via `names` or
    "tracer <n>"), and every trace-bearing span across ALL rings also
    lands on the shared TRACE_PID stitched track -- the fleet view where
    one record's producer->broker->migration->match story reads as a
    single async row with parent flow arrows. Cross-process arrows work
    precisely because stitching runs over the UNION of rings: a child on
    broker B finds its parent recorded by broker A's tracer."""
    labels = list(names) if names is not None else []
    events: List[Dict[str, Any]] = []
    union: List[Mapping[str, Any]] = []
    for i, tracer in enumerate(tracers):
        pid = SPAN_PID + i
        label = labels[i] if i < len(labels) else f"tracer {i}"
        spans = tracer.recent(limit)
        events.append(_process_metadata(pid, f"{label} (wall clock)"))
        events.extend(span_events(spans, pid=pid))
        union.extend(spans)
    # The stitched pid must not collide with a per-tracer row group when
    # more than TRACE_PID - SPAN_PID tracers are merged.
    stitched_pid = max(TRACE_PID, SPAN_PID + len(tracers))
    events.append(_process_metadata(stitched_pid, "stitched traces (fleet)"))
    events.extend(stitched_span_events(union, pid=stitched_pid))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "kafkastreams_cep_tpu_torch.obs.trace_export"},
    }


def write_chrome_trace(path: str, doc: Mapping[str, Any]) -> None:
    """Write a chrome_trace() document to disk (load it in Perfetto via
    "Open trace file" or chrome://tracing)."""
    with open(path, "w") as f:
        json.dump(doc, f)
