"""Egress serialization and key/value schema specs (copies from the JAX
package's `streams/serde.py`).

`sequence_to_json` reproduces the reference's output JSON shape byte for
byte (reference: core/.../cep/JsonSequenceSerde.java:26-85) for the stock
demo golden outputs. `SinkMatch` is what the sink-to-bytes decode
(`sink_format="json"` or `"arrow"`, native/decoder.cc
`decode_matches_json` / `decode_matches_arrow`) emits in place of a
`Sequence`; `sink_match_from_sequence` is the host-Python reference for
those bytes. `Queried` carries a query's event schema.

The Arrow payload is one IPC stream of one record batch, a row per
matched event (`ARROW_SINK_COLUMNS`). `pyarrow` is imported only when an
Arrow payload is built or its schema asked for, so nothing else of the
package needs it.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional

from ..core.sequence import Sequence


def _event_value_repr(value: Any) -> Any:
    """A value with a `name` (the stock demo's events) serializes as that
    name; a plain value as itself."""
    if isinstance(value, dict) and "name" in value:
        return value["name"]
    name = getattr(value, "name", None)
    if name is not None:
        return name
    return value


def sequence_to_dict(sequence: Sequence) -> dict:
    return {
        "events": [
            {
                "name": staged.stage,
                "events": [_event_value_repr(e.value) for e in staged.events],
            }
            for staged in sequence.matched
        ]
    }


def sequence_to_json(sequence: Sequence) -> str:
    return json.dumps(sequence_to_dict(sequence), separators=(",", ":"))


#: Arrow sink column names: one row per matched event, in
#: Sequence.matched order. `value` holds the compact JSON fragment of
#: `_event_value_repr(e.value)`, so any value type stays exact.
ARROW_SINK_COLUMNS = ("stage", "value")


def json_fragment(value: Any) -> str:
    """Compact JSON of one value -- the encoding `sequence_to_json` uses
    per event, and what the native decoder calls back into for any value
    beyond None/bool/int/float/str, so composition stays byte-identical."""
    return json.dumps(value, separators=(",", ":"))


def sequence_to_json_bytes(sequence: Sequence) -> bytes:
    """Reference JSON sink payload: what decode_matches_json emits."""
    return sequence_to_json(sequence).encode("utf-8")


def _arrow():
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ImportError("sink_format='arrow' requires pyarrow (not installed)") from e
    return pa


def arrow_sink_schema():
    """The per-match Arrow sink schema (stage: utf8, value: utf8)."""
    pa = _arrow()
    return pa.schema([(c, pa.utf8()) for c in ARROW_SINK_COLUMNS])


def _arrow_ipc(stage_arr, value_arr) -> bytes:
    pa = _arrow()
    batch = pa.record_batch([stage_arr, value_arr], schema=arrow_sink_schema())
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue().to_pybytes()


def sequence_to_arrow_ipc(sequence: Sequence) -> bytes:
    """Reference Arrow sink payload: one IPC stream holding one record
    batch, one row per matched event (what the wrapped
    decode_matches_arrow buffers serialize to)."""
    pa = _arrow()
    stages = [st.stage for st in sequence.matched for _ in st.events]
    values = [json_fragment(_event_value_repr(e.value))
              for st in sequence.matched for e in st.events]
    return _arrow_ipc(pa.array(stages, pa.utf8()), pa.array(values, pa.utf8()))


def arrow_ipc_from_columns(
    stage_off: bytes,
    stage_data: bytes,
    value_off: bytes,
    value_data: bytes,
    rows: int,
) -> bytes:
    """Wrap the native decoder's raw column buffers (int32 offsets + utf8
    data per string column) without a copy into the IPC stream
    `sequence_to_arrow_ipc` produces."""
    pa = _arrow()
    stage = pa.Array.from_buffers(
        pa.utf8(), rows, [None, pa.py_buffer(stage_off), pa.py_buffer(stage_data)])
    value = pa.Array.from_buffers(
        pa.utf8(), rows, [None, pa.py_buffer(value_off), pa.py_buffer(value_data)])
    return _arrow_ipc(stage, value)


class SinkMatch:
    """One decoded match already serialized to sink bytes.

    `payload` is the sink record value (JSON text or an Arrow IPC
    stream), `ident` the per-stage
    identity frames the EmissionGate digests (`admit_ident` -- digest
    parity with `admit(key, seq)` on the same match), `last_event` the
    completing event carrying the Record timestamp/topic/partition/offset.
    `sequence` is set by `sink_match_from_sequence` and, for
    provenance-sampled matches, by the engine's decode, which also sets
    `lineage` (`match_lineage` of that sequence: the topology's explain
    entry, with no re-decode downstream)."""

    __slots__ = ("format", "payload", "ident", "last_event", "sequence", "lineage")

    def __init__(
        self,
        format: str,
        payload: bytes,
        ident: bytes,
        last_event: Any,
        sequence: Optional[Sequence] = None,
        lineage: Optional[dict] = None,
    ) -> None:
        self.format = format
        self.payload = payload
        self.ident = ident
        self.last_event = last_event
        self.sequence = sequence
        self.lineage = lineage

    def __repr__(self) -> str:
        return (
            f"SinkMatch(format={self.format!r}, "
            f"payload={len(self.payload)}B, last={self.last_event!r})"
        )


#: Bound on contributing-event identities carried per lineage record: an
#: explain read is diagnostic, so a long chain must not balloon the ring.
LINEAGE_MAX_EVENTS = 16


def match_lineage(
    sequence: Sequence,
    provenance: Optional[Any] = None,
    max_events: int = LINEAGE_MAX_EVENTS,
) -> dict:
    """The bounded lineage record of one match (the JAX package's
    `match_lineage`): contributing event identities in chain order (stage,
    topic, partition, offset, timestamp), the run's version path (stage
    walk + branch depth, from `MatchProvenance` when sampled, re-derived
    from the matched stages otherwise) and the chain depth. Identities
    past `max_events` are dropped and counted in ``truncated_events``."""
    events = []
    total = 0
    for staged in sequence.matched:
        for e in staged.events:
            total += 1
            if len(events) < max_events:
                events.append({
                    "stage": staged.stage,
                    "topic": getattr(e, "topic", ""),
                    "partition": getattr(e, "partition", 0),
                    "offset": getattr(e, "offset", 0),
                    "timestamp": getattr(e, "timestamp", 0),
                })
    prov = provenance if provenance is not None else getattr(sequence, "provenance", None)
    if prov is not None:
        stage_path = list(prov.stage_path)
        branch_depth = prov.branch_depth
        chain_depth = prov.chain_depth
    else:
        stage_path = [st.stage for st in sequence.matched]
        branch_depth = len(stage_path)
        chain_depth = total
    return {
        "events": events,
        "truncated_events": total - len(events),
        "stage_path": stage_path,
        "branch_depth": branch_depth,
        "chain_depth": chain_depth,
    }


def sink_match_from_sequence(sequence: Sequence, format: str) -> SinkMatch:
    """Host-Python reference for the native sink-to-bytes decode:
    serialize an already-materialized Sequence into the same SinkMatch the
    native path emits."""
    from .emission import sequence_ident_frames

    if format == "json":
        payload = sequence_to_json_bytes(sequence)
    elif format == "arrow":
        payload = sequence_to_arrow_ipc(sequence)
    else:
        raise ValueError(f"unknown sink format {format!r}")
    last = sequence.matched[-1].events[-1] if sequence.matched else None
    return SinkMatch(format, payload, sequence_ident_frames(sequence), last, sequence)


class Queried:
    """Key/value schema holder for a deployed query
    (reference: Queried.java:26-88): the event schema used to pack values
    into device columns (ops/schema.py) and optional host codecs."""

    def __init__(
        self,
        key_serde: Optional[Callable[[Any], bytes]] = None,
        value_serde: Optional[Callable[[Any], bytes]] = None,
        schema: Optional[Any] = None,
    ) -> None:
        self.key_serde = key_serde
        self.value_serde = value_serde
        self.schema = schema

    @staticmethod
    def with_(key_serde=None, value_serde=None, schema=None) -> "Queried":
        return Queried(key_serde, value_serde, schema)

    @staticmethod
    def with_schema(schema) -> "Queried":
        return Queried(schema=schema)
