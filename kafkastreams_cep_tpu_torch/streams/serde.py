"""Egress serialization and key/value schema specs (copies from the JAX
package's `streams/serde.py`).

`sequence_to_json` reproduces the reference's output JSON shape byte for
byte (reference: core/.../cep/JsonSequenceSerde.java:26-85) for the stock
demo golden outputs. `SinkMatch` is what the sink-to-bytes decode
(`sink_format="json"`, native/decoder.cc `decode_matches_json`) emits in
place of a `Sequence`; `sink_match_from_sequence` is the host-Python
reference for those bytes. `Queried` carries a query's event schema.
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


def json_fragment(value: Any) -> str:
    """Compact JSON of one value -- the encoding `sequence_to_json` uses
    per event, and what the native decoder calls back into for any value
    beyond None/bool/int/float/str, so composition stays byte-identical."""
    return json.dumps(value, separators=(",", ":"))


def sequence_to_json_bytes(sequence: Sequence) -> bytes:
    """Reference JSON sink payload: what decode_matches_json emits."""
    return sequence_to_json(sequence).encode("utf-8")


class SinkMatch:
    """One decoded match already serialized to sink bytes.

    `payload` is the sink record value (JSON text), `ident` the per-stage
    identity frames the EmissionGate digests (`admit_ident` -- digest
    parity with `admit(key, seq)` on the same match), `last_event` the
    completing event carrying the Record timestamp/topic/partition/offset.
    `sequence` is set only by `sink_match_from_sequence`."""

    __slots__ = ("format", "payload", "ident", "last_event", "sequence")

    def __init__(
        self,
        format: str,
        payload: bytes,
        ident: bytes,
        last_event: Any,
        sequence: Optional[Sequence] = None,
    ) -> None:
        self.format = format
        self.payload = payload
        self.ident = ident
        self.last_event = last_event
        self.sequence = sequence

    def __repr__(self) -> str:
        return (
            f"SinkMatch(format={self.format!r}, "
            f"payload={len(self.payload)}B, last={self.last_event!r})"
        )


def sink_match_from_sequence(sequence: Sequence, format: str) -> SinkMatch:
    """Host-Python reference for the native sink-to-bytes decode:
    serialize an already-materialized Sequence into the same SinkMatch the
    native path emits."""
    from .emission import sequence_ident_frames

    if format != "json":
        raise ValueError(f"unknown sink format {format!r}")
    last = sequence.matched[-1].events[-1] if sequence.matched else None
    return SinkMatch(
        format, sequence_to_json_bytes(sequence), sequence_ident_frames(sequence),
        last, sequence,
    )


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
