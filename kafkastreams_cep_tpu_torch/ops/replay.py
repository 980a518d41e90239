"""Exact-replay bridge: device engine state <-> host oracle state.

The device engine stores fold registers per run LANE with copy-on-emit;
the reference keys aggregate state per RUN and writes through sequentially
per queue item (reference: core/.../cep/state/internal/
AggregatesStoreImpl.java:55-75, nfa/NFA.java:319-321,362-369). When a
consuming lane shares its run id with another live lane, the per-lane
copies diverge from the shared cell -- the engine detects every such event
(`seq_collisions`, ops/engine.py) and this module makes the divergence
RECOVERABLE instead of merely counted:

  * `device_to_oracle` rebuilds a host `NFA` from a per-key device state
    snapshot. Sound exactly when no collision has fired since the snapshot:
    then every group of same-run-id lanes carries registers equal to the
    oracle's per-run cell (one-sided fold writes are what break this, and
    each one bumps the counter), so the per-lane -> per-run collapse loses
    nothing. The node pool maps 1:1 onto the host exact-lineage buffer
    (state/buffer.py mirrors ops/engine.py's pool by design).
  * `oracle_to_device` lowers the post-replay oracle back into the per-key
    lane/pool arrays, so the device continues from a reference-exact state
    and the next collision replays only its own interval.

The batched driver (parallel/batched.py) snapshots the engine at drain
boundaries -- a snapshot is a reference to the state and pool tensors,
which no pass writes in place, copied to the host only when a replay
fires -- and on a per-key counter increment replays that key's interval
events through the oracle, substituting its matches and resyncing the
device.

The port's copy of the JAX package's `ops/replay.py`: numpy on both sides,
the oracle (nfa/, state/aggregates.py, state/buffer.py) copied unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.dewey import DeweyVersion
from ..core.event import Event
from ..nfa.nfa import NFA, ComputationStage
from ..pattern.stages import Stage
from ..state.aggregates import AggregatesStore
from ..state.buffer import BufferNode, SharedVersionedBuffer
from .engine import EngineConfig
from .tables import CompiledQuery


def supports_replay(query: CompiledQuery) -> bool:
    """Replay applies only when divergence is possible (the query folds)
    and the host stage graph was retained by compile_query."""
    return bool(query.agg_slots) and query.host_stages is not None


def _new_epsilon(query: CompiledQuery, config: EngineConfig, src: int, tgt: int) -> Stage:
    """The oracle's synthesized forwarding stage for a consumed run at
    (src, eps) -- mirrors NFA._new_epsilon including the strict-windows
    window inheritance."""
    cur = query.stage_list[src]
    target = query.stage_list[tgt]
    eps = Stage.new_epsilon(cur, target)
    if config.strict_windows:
        eps.window_ms = target.window_ms if target.window_ms != -1 else cur.window_ms
    return eps


def device_to_oracle(
    query: CompiledQuery,
    config: EngineConfig,
    state: Dict[str, np.ndarray],
    pool: Dict[str, np.ndarray],
    registry: Dict[int, Event],
    ts_base: int,
    key: Any,
) -> Tuple[NFA, Dict[Event, int]]:
    """Rebuild a host oracle from one key's device state (numpy slices).

    Returns (oracle, event->gidx map for the buffer's events). Raises
    KeyError if a chain event was pruned from the registry (the drivers
    pin snapshot-referenced events precisely to prevent that).
    """
    assert query.host_stages is not None, "compile_query retains host stages"
    buffer: SharedVersionedBuffer = SharedVersionedBuffer()
    n_nodes = int(pool["node_count"])
    node_event = pool["node_event"]
    node_name = pool["node_name"]
    node_pred = pool["node_pred"]
    ev_gidx: Dict[Event, int] = {}
    for i in range(n_nodes):
        g = int(node_event[i])
        ev = registry[g]
        parent = int(node_pred[i])
        buffer._nodes[i] = BufferNode(
            query.name_of_id[int(node_name[i])], ev, parent if parent >= 0 else None
        )
        ev_gidx[ev] = g
    buffer._next_id = n_nodes

    store = AggregatesStore()
    runs: List[ComputationStage] = []
    R = state["active"].shape[0]
    seen_seq: set = set()
    for i in range(R):
        if not bool(state["active"][i]):
            continue
        src = int(state["src"][i])
        eps = int(state["eps"][i])
        stage = (
            _new_epsilon(query, config, src, eps)
            if eps >= 0
            else query.stage_list[src]
        )
        vlen = int(state["vlen"][i])
        version = DeweyVersion(tuple(int(d) for d in state["ver"][i][:vlen]))
        seq = int(state["seq"][i])
        node = int(state["node"][i])
        ts = int(state["ts"][i])
        runs.append(
            ComputationStage(
                stage=stage,
                version=version,
                sequence=seq,
                last_event=(
                    buffer._nodes[node].event if node >= 0 else None
                ),
                timestamp=ts + ts_base if ts >= 0 else -1,
                is_branching=bool(state["branching"][i]),
                is_ignored=bool(state["ignored"][i]),
                last_node=node if node >= 0 else None,
            )
        )
        # Per-run aggregate cells from the lane registers: same-run lanes
        # hold equal copies while no collision has fired (the snapshot
        # contract), so the first lane of each run id is authoritative.
        if seq not in seen_seq:
            seen_seq.add(seq)
            for name, slot in query.agg_slots.items():
                if bool(state["regs_set"][i][slot]):
                    store.put(key, name, seq, float(state["regs"][i][slot]))

    return (
        NFA(
            store,
            buffer,
            query.host_stages.defined_states(),
            runs,
            runs=int(state["runs"]),
            strict_windows=config.strict_windows,
        ),
        ev_gidx,
    )


def oracle_to_device(
    query: CompiledQuery,
    config: EngineConfig,
    oracle: NFA,
    key: Any,
    ev_gidx: Dict[Event, int],
    ts_base: int,
    old_state: Dict[str, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Lower a (post-replay) host oracle into per-key device state arrays.

    `ev_gidx` must cover every event in the oracle's buffer (the caller
    extends the conversion-time map with the replayed interval's events).
    `old_state` supplies the observability counters, carried through.
    Raises ValueError when the oracle outgrew the engine's lane/node
    capacities (the caller degrades to detection-only for the key).
    """
    index_of: Dict[Tuple[int, Any], int] = {
        (s.id, s.type): i for i, s in enumerate(query.stage_list)
    }
    ident_of: Dict[int, int] = {id(s): i for i, s in enumerate(query.stage_list)}

    R = config.lanes
    B = config.nodes
    D = config.dewey_width(query)
    A = query.n_aggs

    live = list(oracle.computation_stages)
    if len(live) > R:
        raise ValueError(f"oracle queue {len(live)} exceeds lanes {R}")

    # -- node pool: renumber the buffer densely, parents first -------------
    ids = sorted(oracle.buffer._nodes)
    if len(ids) > B:
        raise ValueError(f"oracle buffer {len(ids)} exceeds nodes {B}")
    remap = {old: new for new, old in enumerate(ids)}
    node_event = np.full(B, -1, np.int32)
    node_name = np.full(B, -1, np.int32)
    node_pred = np.full(B, -1, np.int32)
    name_id_of = {  # (name, StateType) -> buffer name id, as compile_query
        nm: i for i, nm in enumerate(query.name_of_id)
    }
    for old in ids:
        node = oracle.buffer._nodes[old]
        new = remap[old]
        g = ev_gidx.get(node.event)
        if g is None:
            raise ValueError("buffer event missing from gidx map")
        node_event[new] = g
        nid = name_id_of.get(node.stage_name)
        if nid is None:
            raise ValueError(f"unknown stage name {node.stage_name!r}")
        node_name[new] = nid
        node_pred[new] = remap[node.parent] if node.parent is not None else -1

    # Fresh empty ring: the replay interval's matches were just returned by
    # the oracle, and the drivers only resync at drain boundaries (ring
    # drained). Pins start empty -- nothing is pending.
    from .engine import _PEND_MIN_NONE

    pool = {
        "node_event": node_event,
        "node_name": node_name,
        "node_pred": node_pred,
        "node_count": np.asarray(len(ids), np.int32),
        "pend": np.full(config.matches, -1, np.int32),
        "pend_count": np.asarray(0, np.int32),
        "pend_pos": np.asarray(0, np.int32),
        "pinned": np.zeros(B, bool),
        "pend_min": np.asarray(_PEND_MIN_NONE, np.int32),
    }

    # -- lane table --------------------------------------------------------
    state = {
        "active": np.zeros(R, bool),
        "src": np.zeros(R, np.int32),
        "eps": np.full(R, -1, np.int32),
        "ver": np.zeros((R, D), np.int32),
        "vlen": np.zeros(R, np.int32),
        "seq": np.zeros(R, np.int32),
        "node": np.full(R, -1, np.int32),
        "ts": np.full(R, -1, np.int32),
        "branching": np.zeros(R, bool),
        "ignored": np.zeros(R, bool),
        "regs": np.zeros((R, A), np.float32),
        "regs_set": np.zeros((R, A), bool),
        "runs": np.asarray(int(oracle.runs), np.int32),
    }
    for i, comp in enumerate(live):
        stage = comp.stage
        if stage.is_epsilon() and id(stage) not in ident_of:
            tgt = stage.edges[0].target
            src_i = index_of.get((stage.id, stage.type))
            tgt_i = ident_of.get(id(tgt))
            if src_i is None or tgt_i is None:
                raise ValueError(f"cannot map epsilon stage {stage!r}")
            state["src"][i] = src_i
            state["eps"][i] = tgt_i
        else:
            src_i = ident_of.get(id(stage))
            if src_i is None:
                src_i = index_of.get((stage.id, stage.type))
            if src_i is None:
                raise ValueError(f"cannot map stage {stage!r}")
            state["src"][i] = src_i
            state["eps"][i] = -1
        digits = comp.version.digits
        if len(digits) > D:
            raise ValueError(f"dewey width {len(digits)} exceeds {D}")
        state["active"][i] = True
        state["ver"][i, : len(digits)] = digits
        state["vlen"][i] = len(digits)
        state["seq"][i] = comp.sequence
        state["node"][i] = (
            remap[comp.last_node] if comp.last_node is not None else -1
        )
        state["ts"][i] = (
            comp.timestamp - ts_base if comp.timestamp >= 0 else -1
        )
        state["branching"][i] = comp.is_branching
        state["ignored"][i] = comp.is_ignored
        for name, slot in query.agg_slots.items():
            val = oracle.aggregates_store.find(key, name, comp.sequence)
            if val is not None:
                state["regs"][i, slot] = np.float32(val)
                state["regs_set"][i, slot] = True

    # Per-lane chain roots: follow the freshly built predecessor pointers
    # (the dense renumbering is creation-ordered, preserving the interval-
    # pinning invariant that a chain's root is its smallest id).
    from ..state.serde import _chain_roots

    state["root"] = _chain_roots(state["node"], node_pred)

    # Observability counters carry through from the device state.
    for ctr in (
        "n_events", "n_branches", "n_expired",
        "lane_drops", "node_drops", "match_drops", "seq_collisions",
    ):
        state[ctr] = np.asarray(old_state[ctr], np.int32)
    # Resyncs happen at drain boundaries, after the group flush: the
    # group-phase scalar is 0 there (the renumbered pool has no window).
    state["gc_phase"] = np.asarray(0, np.int32)
    return state, pool
