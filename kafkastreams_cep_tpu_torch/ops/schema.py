"""Event schema: packing host events into device columns.

The reference moves every event through Kryo serdes into a byte KV store
(reference: core/.../cep/state/internal/serde/*.java); the TPU-native design
instead declares a typed schema once and packs micro-batches of events into
structure-of-arrays jnp columns: one f32/i32 column per declared field, plus
timestamp (i32 ms, rebased), tokenized topic id, and a per-lane monotone
event index. String values are tokenized into i32 codes via a vocabulary
owned by the schema.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class EventSchema:
    """Declares the device representation of event values.

    fields: mapping field-name -> numpy dtype (np.float32 / np.int32).
    A scalar stream (values are raw strings/numbers, e.g. the Letters demo)
    uses the reserved field name "" (what ``value()`` references).
    String-typed fields use dtype np.int32 with tokenization.
    """

    def __init__(self, fields: Optional[Dict[str, Any]] = None) -> None:
        self.fields: Dict[str, Any] = dict(fields or {"": np.int32})
        self._vocab: Dict[Any, int] = {}
        self._rev_vocab: List[Any] = []
        self._topic_vocab: Dict[str, int] = {}

    # -- tokenization --------------------------------------------------------
    def token(self, value: Any) -> int:
        code = self._vocab.get(value)
        if code is None:
            code = len(self._rev_vocab)
            self._vocab[value] = code
            self._rev_vocab.append(value)
        return code

    def topic_id(self, topic: str) -> int:
        code = self._topic_vocab.get(topic)
        if code is None:
            code = len(self._topic_vocab)
            self._topic_vocab[topic] = code
        return code

    def encode_const(self, value: Any) -> Any:
        """Encode a predicate constant for device comparison."""
        if isinstance(value, str):
            return self.token(value)
        return value

    def _field_value(self, value: Any, name: str) -> Any:
        raw = value if name == "" else (
            value[name] if isinstance(value, dict) else getattr(value, name)
        )
        if isinstance(raw, str):
            return self.token(raw)
        return raw

    # -- packing -------------------------------------------------------------
    def pack(
        self,
        values: Sequence[Any],
        timestamps: Sequence[int],
        topics: Optional[Sequence[str]] = None,
        ts_base: int = 0,
    ) -> Dict[str, np.ndarray]:
        """Pack a list of event values into column arrays of shape [T]."""
        n = len(values)
        cols: Dict[str, np.ndarray] = {}
        for name, dtype in self.fields.items():
            col = np.empty(n, dtype=dtype)
            for i, v in enumerate(values):
                col[i] = self._field_value(v, name)
            cols[f"f:{name}"] = col
        cols["ts"] = np.asarray(
            [int(t) - ts_base for t in timestamps], dtype=np.int32
        )
        if topics is None:
            cols["topic"] = np.zeros(n, dtype=np.int32)
        else:
            cols["topic"] = np.asarray([self.topic_id(t) for t in topics], dtype=np.int32)
        return cols
