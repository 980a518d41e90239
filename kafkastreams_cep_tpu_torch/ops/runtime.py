"""Host helpers of the device runtime: watermark rebase, match
materialization and match provenance (the JAX package's `ops/runtime.py`
helpers, which the port keeps its own copy of)."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..core.event import Event
from ..core.sequence import MatchProvenance, Sequence, Staged
from .engine import WM_NONE


def rebase_watermarks(watermark_ms: Any, n: int, ts_base: int) -> np.ndarray:
    """Absolute-ms watermark(s) -> rebased i32 "wm" column of shape [n].

    A scalar broadcasts to every step; None entries fall back to WM_NONE,
    which the step's max(ts, wm) clock reduces to the event timestamp.
    Values clamp into i32."""
    lo, hi = int(WM_NONE), 2**31 - 1
    if np.isscalar(watermark_ms) or watermark_ms is None:
        seq = [watermark_ms] * n
    else:
        seq = list(watermark_ms)
        if len(seq) != n:
            raise ValueError(
                f"watermark sequence length {len(seq)} != batch length {n}"
            )
    # None maps to ts_base + lo, which the clip takes to lo == WM_NONE.
    vals = np.asarray([ts_base + lo if w is None else w for w in seq], np.int64)
    return np.clip(vals - ts_base, lo, hi).astype(np.int32)


def materialize_sequence(
    chain: List[Tuple[int, int]],
    name_of_id: List[str],
    events: Dict[int, Event],
) -> Sequence:
    """Build a `Sequence` from an oldest-first (name-id, gidx) chain,
    grouping nodes by stage NAME (a begin-position one_or_more compiles to
    two stage ids sharing one name, whose events land in one group)."""
    groups: Dict[str, List[Event]] = {}
    order: List[str] = []
    for name_id, gidx in chain:
        name = name_of_id[name_id]
        lst = groups.get(name)
        if lst is None:
            lst = groups[name] = []
            order.append(name)
        lst.append(events[gidx])
    matched: List[Staged] = []
    for name in order:
        evs = groups[name]
        # Skip Staged's sorted(set(...)) normalization when the group is
        # provably normalized already: one (topic, partition), offsets
        # strictly increasing.
        first = evs[0]
        prev = None
        normalized = True
        for e in evs:
            if (
                e.topic != first.topic
                or e.partition != first.partition
                or (prev is not None and e.offset <= prev)
            ):
                normalized = False
                break
            prev = e.offset
        if normalized:
            st = Staged.__new__(Staged)
            st.stage = name
            st._events = evs
            matched.append(st)
        else:
            matched.append(Staged(name, evs))
    return Sequence(matched)


def sequence_provenance(
    seq: Sequence, query: str = "q", trigger: str = "drain"
) -> MatchProvenance:
    """One match's lineage from its materialized Sequence (the JAX
    package's `ops/runtime.sequence_provenance`): stage path and
    version-path depth from the group walk, chain depth from the hop
    count, the offset span in the Event contract's order and the
    timestamp span over raw event time (behind a reorder gate an
    out-of-order source's log order no longer tracks event time). A pure
    host read: no device pull, no sync."""
    events = [e for staged in seq.matched for e in staged.events]
    first = min(events) if events else None
    last = max(events) if events else None
    ts = [e.timestamp for e in events]
    return MatchProvenance(
        query=query,
        trigger=trigger,
        stage_path=tuple(s.stage for s in seq.matched),
        chain_depth=len(events),
        branch_depth=len(seq.matched),
        first_offset=first.offset if first is not None else -1,
        last_offset=last.offset if last is not None else -1,
        first_timestamp=min(ts) if ts else -1,
        last_timestamp=max(ts) if ts else -1,
    )
