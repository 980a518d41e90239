"""Host helpers of the device runtime: watermark rebase, the host pool
walk (`decode_chains`), match materialization and match provenance (the
JAX package's `ops/runtime.py` helpers, which the port keeps its own copy
of). The JAX module's single-key `DeviceNFA` lives in ops/device_nfa.py
and is re-exported here."""
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


def decode_chains(
    start_nodes: np.ndarray,
    node_name: np.ndarray,
    node_event: np.ndarray,
    node_pred: np.ndarray,
) -> List[List[Tuple[int, int]]]:
    """Vectorized predecessor walk: all match chains at once, one numpy
    gather per chain depth level (the host analog of the reference's peek
    loop, SharedVersionedBufferStoreImpl.java:176-201). Returns, per start
    node, the chain as (stage-name-id, event-gidx) pairs oldest-first."""
    n = len(start_nodes)
    cur = start_nodes.astype(np.int64)
    midx = np.arange(n)
    levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    while True:
        live = cur >= 0
        if not live.any():
            break
        li = cur[live]
        levels.append((midx[live], node_name[li], node_event[li]))
        nxt = np.full_like(cur, -1)
        nxt[live] = node_pred[li]
        cur = nxt

    chains: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for m_ids, names_l, gidxs in reversed(levels):
        for m, nm, g in zip(m_ids.tolist(), names_l.tolist(), gidxs.tolist()):
            if g < 0:
                # A dropped put (node-pool overflow): the hop is skipped;
                # node_drops already counts it.
                continue
            chains[m].append((nm, g))
    return chains


def __getattr__(name: str) -> Any:
    # DeviceNFA imports the batched engine, which imports this module.
    if name == "DeviceNFA":
        from .device_nfa import DeviceNFA

        return DeviceNFA
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
