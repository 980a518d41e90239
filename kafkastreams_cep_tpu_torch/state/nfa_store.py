"""The emission gate's watermark store (a copy of `EmitWatermark` and
`EmissionStore` from the JAX package's `state/nfa_store.py`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class EmitWatermark:
    """Persisted emitted-match high-watermark for one query.

    `sink_pos` records each sink topic's end offset at the last commit:
    after a crash, the tail past these positions tells which matches the
    sink already saw (exactly-once recovery -- streams/emission.py).
    Externalized like every other piece of execution state: through the
    changelogged store stack, at commit time."""

    sink_pos: Dict[str, int] = field(default_factory=dict)


class EmissionStore:
    """Single-value store holding a query's `EmitWatermark`."""

    _KEY = "watermark"

    def __init__(self, backing: Optional[Any] = None) -> None:
        if backing is None:
            from .store import InMemoryKeyValueStore

            backing = InMemoryKeyValueStore("emitted")
        self._kv = backing

    def get(self) -> Optional[EmitWatermark]:
        return self._kv.get(self._KEY)

    def put(self, watermark: EmitWatermark) -> None:
        self._kv.put(self._KEY, watermark)

    def flush(self) -> None:
        self._kv.flush()
