"""Stacked multi-query driver: Q concurrent queries, one device program.

The port's counterpart of the JAX package's `parallel/stacked.py`. The
reference attaches one processor node per query to the same topic
(reference: core/.../kstream/internals/CEPStreamImpl.java:80-93), so N
concurrent queries cost N per-record NFA walks over the same events.
Here every query compiles into ONE table set (ops/tables.py
`compile_multi_query`): the event columns pack once, one begin lane per
query seeds the shared lane pool, and a single batched advance -- one
launch of the step kernel on the card -- serves all queries. The
per-event cost grows with the union stage table and the extra live
lanes, not with a full engine per query. Past 64 stages or 64
predicates the kernel takes multi-word stage and predicate masks
(ops/codegen.py `wide_masks`).

Matches route back to their owning query by the chain's stage-name id
(`qid_of_name_id`); per-query outputs equal running each query on its
own engine (tests/test_torch_stacked.py pins the equivalence).

`drain_mode` passes through as in the JAX class: "flat" (the default) or
"pool", whose `decode_matches` carries the same attribution
(`qid_of_name_id`). Differences from the JAX class, both the port's
`BatchedDeviceNFA`'s: `device=` and `engine=` ("cuda" | "torch") and the
engine's other options pass through; `mesh=` is refused (multi-card
sharding is not ported). A stacked query has no host stages, so exact
replay is off and a fold divergence warns (the JAX behaviour); the bytes
sinks are refused (their bytes carry no query).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence as Seq, Tuple

from ..core.event import Event
from ..core.sequence import Sequence
from ..ops.engine import EngineConfig
from ..ops.schema import EventSchema
from ..ops.tables import compile_multi_query
from .batched import BatchedDeviceNFA


class StackedQueryEngine:
    """Q queries x K keys advanced as one [T, K] device program.

    API mirrors BatchedDeviceNFA; outputs are nested per key, then per
    query name: `{key: {query_name: [Sequence, ...]}}`.
    """

    def __init__(
        self,
        named_queries: List[Tuple[str, Any]],
        keys: Seq[Any],
        schema: Optional[EventSchema] = None,
        config: Optional[EngineConfig] = None,
        mesh: Optional[Any] = None,
        engine: Optional[str] = None,
        auto_drain: bool = True,
        drain_mode: str = "flat",
        device: Any = None,
        **opts: Any,
    ) -> None:
        if mesh is not None:
            raise ValueError("mesh= is not ported (ROADMAP.md queue A, multi-GPU key sharding)")
        self.query = compile_multi_query(named_queries, schema)
        self.query_names: List[str] = list(self.query.query_names or [])
        self.engine = BatchedDeviceNFA(
            self.query,
            keys=keys,
            config=config,
            device=device,
            engine=engine,
            auto_drain=auto_drain,
            drain_mode=drain_mode,
            **opts,
        )

    # ------------------------------------------------------------------ API
    def pack(self, events_by_key: Mapping[Any, Seq[Event]]):
        return self.engine.pack(events_by_key)

    def advance(
        self, events_by_key: Mapping[Any, Seq[Event]]
    ) -> Dict[Any, Dict[str, List[Sequence]]]:
        return self._split(self.engine.advance(events_by_key))

    def advance_packed(self, xs, decode: bool = True):
        return self._split(self.engine.advance_packed(xs, decode=decode))

    def drain(self) -> Dict[Any, Dict[str, List[Sequence]]]:
        return self._split(self.engine.drain())

    def resize(self, config: EngineConfig) -> bool:
        """Re-shape the shared capacity (`BatchedDeviceNFA.resize`)."""
        return self.engine.resize(config)

    @property
    def config(self) -> EngineConfig:
        return self.engine.config

    @property
    def stats(self) -> Dict[str, int]:
        """Cross-key, cross-query counter totals, the drop counters
        among them (what `CapacityAutosizer` reads)."""
        return self.engine.stats

    @property
    def timings(self):
        return self.engine.timings

    def snapshot(self) -> bytes:
        return self.engine.snapshot()

    def close(self) -> None:
        self.engine.close()

    # ----------------------------------------------------------- internals
    def _split(
        self, out: Dict[Any, List[Tuple[int, Sequence]]]
    ) -> Dict[Any, Dict[str, List[Sequence]]]:
        split: Dict[Any, Dict[str, List[Sequence]]] = {}
        for key, pairs in out.items():
            per_q = split.setdefault(key, {})
            for qid, seq in pairs:
                name = (
                    self.query_names[qid]
                    if 0 <= qid < len(self.query_names)
                    else str(qid)
                )
                per_q.setdefault(name, []).append(seq)
        return split
