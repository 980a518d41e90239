"""Match serialization: the reference's output JSON shape, byte for byte
(the JAX package's `streams/serde.py` `sequence_to_json`, copied)."""
from __future__ import annotations

import json
from typing import Any

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
