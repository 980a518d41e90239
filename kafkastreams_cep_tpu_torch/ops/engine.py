"""Engine state, capacity config and the post/drain passes, in PyTorch.

The port's counterpart of the JAX package's `ops/engine.py`. The state
layout is the JAX engine's, leaf for leaf: the same names, dtypes and
shapes, with the key axis LAST once batched ([R, K] lane planes,
[R, D, K] Dewey digits, [B, K] node pool, [M, K] pending-match ring,
[K] counters). The tests compare the two engines leaf by leaf, and
`carry.py` moves a JAX engine's state into the port unchanged.

What lives here:

  * `EngineConfig`, field for field the JAX dataclass (capacity knobs and
    semantics switches), and the state constants;
  * `init_state` / `init_pool` (one key) -- parallel/key_shard.py stacks
    them along the trailing key axis;
  * `eval_stateless_preds`, the [T, K, P] stateless predicate masks;
  * the per-advance pend append, the group-flush GC (precise frontier
    walk and `pin_interval`; the mark itself is ops/gc_kernel.py), the
    ring remap and the drain passes: the flat drain's (`drain_probe`,
    `build_chain_flatten`), the pool drain's (`drain_compact`) and
    `drain_pend`.

The per-event transition itself is ops/step.py (plain version) and
ops/step_kernel.py (the CUDA kernel). Everything here is written for the
batched K-last layout directly: where the JAX package vmaps a per-key
function over the key axis, the port indexes [*, K] planes with
`gather`/`scatter` along dim 0.

JAX arrays are immutable; these functions keep that style and return new
dicts (the post passes allocate fresh planes instead of updating in
place), so a caller may hold an older state without it changing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .gc_kernel import gc_mark
from .gc_sweep import WINDOW_PLANES, _PEND_MIN_NONE, gc_sweep, remap_ids
from .tables import CompiledQuery, TorchEnv
from .numerics import as_mask

Tensor = torch.Tensor
State = Dict[str, Tensor]

_I32_MAX = np.int64(2**31 - 1)
#: Watermark-column fill when no watermark is threaded: the expiry clock
#: is max(event ts, watermark), so this floor makes it the event timestamp.
WM_NONE = np.int32(-(2**31))

#: The observable per-key state counters (the stats surfaces iterate this
#: one tuple). "runs" is state too but reported per key.
STATE_COUNTER_KEYS = (
    "n_events", "n_branches", "n_expired",
    "lane_drops", "node_drops", "match_drops", "seq_collisions",
)

#: The silent-loss counters: zero at the end of a run means no match,
#: run or node was lost to a fixed capacity.
DROP_COUNTER_KEYS = ("lane_drops", "node_drops", "match_drops")

@dataclass(frozen=True)
class EngineConfig:
    """Capacity knobs and semantics switches, field for field the JAX
    package's `EngineConfig` (same names, defaults and checks).

    The port's driver honours every field: the capacity fields,
    `strict_windows`, `pin_interval`, `gc_group`, the overflow policy
    (`on_overflow`, `block_retries`, `block_backoff_s`) and the event-time
    gate's (`reorder_capacity > 0` arms it in the processor, with
    `lateness_ms` and `late_policy`).
    """

    lanes: int = 64          # max simultaneous runs per key (run-lane pool)
    nodes: int = 8192        # compacted node-pool region per key (post-GC)
    matches: int = 1024      # pending-match id buffer per key (between drains)
    #: per-(key, event-step) cap on emitted matches; overflow is counted in
    #: match_drops.
    matches_per_step: int = 16
    #: per-(key, event-step) cap on buffer-node appends. 0 = uncapped
    #: (lanes * max_depth slots per step). Overflow -> node_drops.
    nodes_per_step: int = 0
    digits: int = 0          # Dewey digit width; 0 = auto (n_stages + 2)
    #: False: synthesized epsilon stages carry no window (reference
    #: parity); True: every run with a consumed event expires (bounded
    #: memory).
    strict_windows: bool = False
    #: Pin pending matches' chains by id interval [pend_min, end) instead
    #: of per-chain frontier walks.
    pin_interval: bool = False
    #: GC group size G: the full mark/sweep folds the accumulated window
    #: back into the region on every G-th advance.
    gc_group: int = 1
    #: Capacity-overflow policy: "drop" | "raise" | "block".
    on_overflow: str = "drop"
    #: Bounded admission retries for on_overflow="block".
    block_retries: int = 4
    #: Linear backoff step between blocked-admission retries (seconds).
    block_backoff_s: float = 0.0
    #: Per-key reorder-buffer capacity of the event-time gate (0 = off).
    reorder_capacity: int = 0
    #: Bounded-out-of-orderness lateness (ms) of the default watermark.
    lateness_ms: int = 0
    #: What happens to records older than the watermark.
    late_policy: str = "drop"

    def __post_init__(self) -> None:
        if self.on_overflow not in ("drop", "raise", "block"):
            raise ValueError(
                f"on_overflow must be drop|raise|block, got {self.on_overflow!r}"
            )
        if self.late_policy not in ("drop", "sideoutput", "recompute-none"):
            raise ValueError(
                "late_policy must be drop|sideoutput|recompute-none, got "
                f"{self.late_policy!r}"
            )
        if self.reorder_capacity < 0:
            raise ValueError(
                f"reorder_capacity must be >= 0, got {self.reorder_capacity}"
            )

    def dewey_width(self, query: CompiledQuery) -> int:
        return self.digits if self.digits > 0 else query.n_stages + 2


def node_window_cap(query: CompiledQuery, config: EngineConfig) -> int:
    """P_CAP: buffer-node slots one event step may append per key."""
    if config.nodes_per_step > 0:
        return config.nodes_per_step
    return config.lanes * query.max_depth


def window_ms_i32(query: CompiledQuery) -> np.ndarray:
    """Per-stage windows as i32 (-1 none; huge windows clamp below i32 max,
    which compares identically to "no expiry" on rebased timestamps)."""
    return np.where(
        query.window_ms < 0, -1, np.minimum(query.window_ms, _I32_MAX - 1)
    ).astype(np.int32)


def init_state(
    query: CompiledQuery, config: EngineConfig, device="cpu"
) -> State:
    """Initial per-key state: one begin run, version `1`, run id 1."""
    R = config.lanes
    D = config.dewey_width(query)
    A = query.n_aggs
    begins = query.begin_stages if query.begin_stages else [query.begin_stage]
    if len(begins) > R:
        raise ValueError(
            f"{len(begins)} stacked queries exceed the {R}-lane pool"
        )
    ver = np.zeros((R, D), np.int32)
    for qi in range(len(begins)):
        ver[qi, 0] = 1
    state = {
        "active": np.zeros(R, bool),
        "src": np.zeros(R, np.int32),
        "eps": np.full(R, -1, np.int32),
        "ver": ver,
        "vlen": np.zeros(R, np.int32),
        "seq": np.zeros(R, np.int32),
        "node": np.full(R, -1, np.int32),
        "root": np.full(R, -1, np.int32),
        "ts": np.full(R, -1, np.int32),
        "branching": np.zeros(R, bool),
        "ignored": np.zeros(R, bool),
        "regs": np.zeros((R, A), np.float32),
        "regs_set": np.zeros((R, A), bool),
        "runs": np.asarray(len(begins), np.int32),
        "gc_phase": np.asarray(0, np.int32),
        "n_events": np.asarray(0, np.int32),
        "n_branches": np.asarray(0, np.int32),
        "n_expired": np.asarray(0, np.int32),
        "lane_drops": np.asarray(0, np.int32),
        "node_drops": np.asarray(0, np.int32),
        "match_drops": np.asarray(0, np.int32),
        "seq_collisions": np.asarray(0, np.int32),
    }
    for qi, b in enumerate(begins):
        state["active"][qi] = True
        state["src"][qi] = b
        state["vlen"][qi] = 1
        state["seq"][qi] = qi + 1
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in state.items()}


def init_pool(
    query: CompiledQuery, config: EngineConfig, device="cpu"
) -> State:
    """The GC-owned node-pool region + pending-match ring (per key)."""
    B = config.nodes
    M = config.matches
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "node_event": torch.full((B,), -1, **i32),
        "node_name": torch.full((B,), -1, **i32),
        "node_pred": torch.full((B,), -1, **i32),
        "node_count": torch.tensor(0, **i32),
        "pend": torch.full((M,), -1, **i32),
        "pend_count": torch.tensor(0, **i32),
        "pend_pos": torch.tensor(0, **i32),
        "pinned": torch.zeros(B, dtype=torch.bool, device=device),
        "pend_min": torch.tensor(int(_PEND_MIN_NONE), **i32),
    }


def eval_stateless_preds(query: CompiledQuery, cols: Dict[str, Tensor]) -> Tensor:
    """All stateless predicates over the whole batch: [T, K, P] bool
    (stateful columns stay False; the step evaluates them per lane)."""
    ts = cols["ts"]
    env = TorchEnv(
        cols,
        torch.zeros((1, query.n_aggs), dtype=torch.float32, device=ts.device),
        torch.zeros((1, query.n_aggs), dtype=torch.bool, device=ts.device),
        query.agg_slots,
        query.agg_defaults,
    )
    out = []
    for p in range(max(query.n_preds, 1)):
        if p < query.n_preds and not query.pred_stateful[p]:
            out.append(as_mask(query.predicates[p](env), ts.shape, ts.device))
        else:
            out.append(torch.zeros(ts.shape, dtype=torch.bool, device=ts.device))
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------- helpers
def compact_valid_front(ids: Tensor) -> Tuple[Tensor, Tensor]:
    """Stably move each key column's valid (>= 0) entries to the front;
    returns (compacted [M, K], per-key counts [K])."""
    m = ids >= 0
    M = ids.shape[0]
    c = torch.cumsum(m.to(torch.int32), dim=0)
    counts = c[-1].to(torch.int32)
    rank = torch.where(m, c - 1, torch.full_like(c, M)).long()  # holes -> trash
    out = torch.full((M + 1,) + tuple(ids.shape[1:]), -1, dtype=ids.dtype,
                     device=ids.device)
    out.scatter_(0, rank, torch.where(m, ids, torch.full_like(ids, -1)))
    return out[:M], counts


# ------------------------------------------------------------- pend append
def build_pend_append(config: EngineConfig):
    """The per-advance append of each key's step match ids into its ring.

    `append(state, pool, w_match, w_mroot)` takes the step's match planes
    as [T, M_STEP, K] and returns (state', pool', page_roots [TM, K]):
    the page with every id that did not land in the ring blanked to -1.
    Pages that fit the ring ride the dense scatter at each key's cursor;
    a page larger than the ring takes the compact path (valid ids sorted
    to the front first). Both count what did not fit in match_drops.
    """
    M = config.matches

    def _min_root(pool: State, roots: Tensor, placed_m: Tensor) -> Tensor:
        cand = torch.where(
            placed_m & (roots >= 0), roots,
            torch.full_like(roots, int(_PEND_MIN_NONE)),
        )
        return torch.minimum(pool["pend_min"], cand.min(dim=0).values)

    def append_compact(state, pool, ids, roots):
        TM = ids.shape[0]
        m_valid = ids >= 0
        pos = pool["pend_pos"]
        m_sorted, n_m = compact_valid_front(ids)
        rank = torch.cumsum(m_valid.to(torch.int32), dim=0) - 1
        idx = torch.arange(M, dtype=torch.int32, device=ids.device)[:, None]
        rel = idx - pos[None, :]
        take = (rel >= 0) & (rel < TM) & (rel < n_m[None, :])
        gathered = torch.gather(m_sorted, 0, rel.clamp(0, TM - 1).long())
        new_pend = torch.where(take, gathered, pool["pend"])
        placed = torch.minimum(torch.clamp(M - pos, min=0), n_m)
        placed_m = m_valid & (pos[None, :] + rank < M)
        new_pool = {
            **pool,
            "pend": new_pend,
            "pend_count": pool["pend_count"] + placed,
            "pend_pos": (pos + placed).to(torch.int32),
            "pend_min": _min_root(pool, roots, placed_m),
        }
        new_state = {**state, "match_drops": state["match_drops"] + (n_m - placed)}
        return new_state, new_pool, torch.where(placed_m, ids, torch.full_like(ids, -1))

    def append(state, pool, w_match, w_mroot):
        T, m_step, K = w_match.shape
        TM = T * m_step
        ids = w_match.reshape(TM, K)
        roots = w_mroot.reshape(TM, K)
        if TM > M:
            return append_compact(state, pool, ids, roots)
        pos = pool["pend_pos"]
        m_valid = ids >= 0
        csum = torch.cumsum(m_valid.to(torch.int32), dim=0)
        n_valid = csum[-1].to(torch.int32)
        target = pos[None, :] + csum - m_valid.to(torch.int32)
        placed_m = m_valid & (target < M)
        rows = torch.where(placed_m, target, torch.full_like(target, M)).long()
        ring = torch.cat([pool["pend"], pool["pend"].new_full((1, K), -1)])
        ring.scatter_(0, rows, torch.where(placed_m, ids, torch.full_like(ids, -1)))
        placed = torch.minimum(torch.clamp(M - pos, min=0), n_valid)
        new_pool = {
            **pool,
            "pend": ring[:M],
            "pend_count": pool["pend_count"] + placed,
            "pend_pos": (pos + placed).to(torch.int32),
            "pend_min": _min_root(pool, roots, placed_m),
        }
        new_state = {
            **state, "match_drops": state["match_drops"] + (n_valid - placed),
        }
        return new_state, new_pool, torch.where(placed_m, ids, torch.full_like(ids, -1))

    return append


# ---------------------------------------------------------------------- GC
def build_gc(query: CompiledQuery, config: EngineConfig):
    """The post-advance GC for K-last batched state: pin-seeded mark +
    stable sweep compaction of (region ++ accumulated window) into B
    slots, remapping lane pointers, node preds, the ring and `pinned`.

    `gc(state, pool, ys, page_roots)`: `ys` holds the group's node planes
    as the step writes them, [T, K, cap] (window node id B + t * cap + c
    is [t, k, c]), and `page_roots` the appended match pages [TM, K].
    Marking runs in two phases as in the JAX engine: the pend-reachable
    closure (old pins + this group's pages, or the id interval [pend_min,
    end) under `pin_interval`) becomes the new `pinned`; live-lane chains
    are kept but not pinned. Both walks are `gc_mark` (ops/gc_kernel.py)
    and the compaction with every remap, the ring's included, is
    `gc_sweep` (ops/gc_sweep.py): CUDA kernels on the card, which run
    without a host read.
    """
    B = config.nodes

    def t_major(plane: Tensor, out: Tensor) -> None:
        """Copy a [T, K, cap] plane into `out`, its [T * cap, K] rows."""
        T, K, cap = plane.shape
        out.view(T, cap, K).copy_(plane.permute(0, 2, 1))

    def gc(state: State, pool: State, ys: State, page_roots: Tensor):
        T, K, cap = ys["w_event"].shape
        W = T * cap
        BW = B + W
        dev = ys["w_event"].device
        combined_pred = torch.empty((BW, K), dtype=torch.int32, device=dev)
        combined_pred[:B] = pool["node_pred"]
        t_major(ys["w_pred"], combined_pred[B:])
        lane_roots = torch.where(
            state["active"], state["node"], torch.full_like(state["node"], -1)
        )
        if config.pin_interval:
            node_valid = torch.zeros((BW + 1, K), dtype=torch.bool, device=dev)
            node_valid[:B] = pool["node_event"] >= 0
            t_major(ys["w_event"] >= 0, node_valid[B:BW])
            ids = torch.arange(BW + 1, dtype=torch.int32, device=dev)[:, None]
            marked_pin = (ids >= pool["pend_min"][None, :]) & node_valid
        else:
            marked0 = torch.cat([
                pool["pinned"],
                torch.zeros((W + 1, K), dtype=torch.bool, device=dev),
            ])
            marked_pin = gc_mark(marked0, page_roots, combined_pred)
        marked = gc_mark(marked_pin, lane_roots, combined_pred)
        swept = gc_sweep(marked, marked_pin, state, pool, ys)
        new_pool = {
            "node_event": swept["node_event"],
            "node_name": swept["node_name"],
            "node_pred": swept["node_pred"],
            "node_count": swept["node_count"],
            "pend": swept["pend"],
            "pend_count": pool["pend_count"],
            "pend_pos": pool["pend_pos"],
            "pinned": swept["pinned"],
            "pend_min": swept["pend_min"],
        }
        new_state = {
            **state,
            "node": swept["node"],
            "root": swept["root"],
            "node_drops": swept["node_drops"],
        }
        return new_state, new_pool

    return gc


def concat_group_window(
    group_ys: List[State], group_roots: List[Tensor]
) -> Tuple[State, Tensor]:
    """Concatenate a GC group's per-advance window planes ([T, K, cap])
    and page roots ([TM, K]) along the step axis."""
    if len(group_ys) == 1:
        return group_ys[0], group_roots[0]
    ys_cat = {k: torch.cat([ys[k] for ys in group_ys], dim=0) for k in WINDOW_PLANES}
    return ys_cat, torch.cat(group_roots, dim=0)


def build_append_post(config: EngineConfig):
    """Per-advance light post: pend append + group-phase bump. Takes the
    step's ys in the [T, K, cap] layout."""
    append = build_pend_append(config)

    def post_append(state: State, pool: State, ys: State):
        state, pool, page_roots = append(
            state, pool,
            ys["w_match"].permute(0, 2, 1), ys["w_mroot"].permute(0, 2, 1),
        )
        state = {**state, "gc_phase": state["gc_phase"] + ys["w_event"].shape[0]}
        return state, pool, page_roots

    return post_append


def build_flush_post(query: CompiledQuery, config: EngineConfig):
    """Group flush: mark/sweep over the accumulated window (the sweep
    remaps the ring too), then reset `gc_phase`. Takes the group's ys
    planes as [T, K, cap]."""
    gc = build_gc(query, config)

    def flush(state: State, pool: State, ys: State, page_roots: Tensor):
        state, pool = gc(state, pool, ys, page_roots)
        state = {**state, "gc_phase": torch.zeros_like(state["gc_phase"])}
        return state, pool

    return flush


# ------------------------------------------------------------------- drain
def drain_probe(pool: State) -> Tensor:
    """[3, K] = (pend_count, pend_pos, chain-depth bound). The bound comes
    from pointer doubling over the pred graph (ceil(log2 B) rounds) and is
    only computed when something is pending."""
    pred = pool["node_pred"]
    B = pred.shape[0]
    if int(pool["pend_count"].sum()) > 0:
        valid = pool["node_event"] >= 0
        d = valid.to(torch.int32)
        j = torch.where(valid, pred, torch.full_like(pred, -1))
        for _ in range(max(int(math.ceil(math.log2(max(B, 2)))), 1)):
            live = j >= 0
            cj = j.clamp(0, B - 1).long()
            d = d + torch.where(live, torch.gather(d, 0, cj), torch.zeros_like(d))
            j = torch.where(live, torch.gather(j, 0, cj), torch.full_like(j, -1))
        depth = torch.clamp(d.max(dim=0).values, max=B)
    else:
        depth = torch.zeros(pred.shape[1:], dtype=torch.int32, device=pred.device)
    return torch.stack([pool["pend_count"], pool["pend_pos"], depth]).to(torch.int32)


def build_chain_flatten(max_matches: int, max_chain: int):
    """The drain-time chain flattener: every pending match's predecessor
    chain walked on the device into one dense newest-first table
    [3, Mb, Cb, K] (event gidx, stage name id, hop validity)."""
    Mb, Cb = max_matches, max_chain

    def flatten(pool: State) -> Tensor:
        compacted, _ = compact_valid_front(pool["pend"])
        cur = compacted[:Mb]
        ev, nm, pr = pool["node_event"], pool["node_name"], pool["node_pred"]
        B = pr.shape[0]
        hops = []
        for _ in range(Cb):
            live = cur >= 0
            cidx = cur.clamp(0, B - 1).long()
            neg = torch.full_like(cur, -1)
            g = torch.where(live, torch.gather(ev, 0, cidx), neg)
            n = torch.where(live, torch.gather(nm, 0, cidx), neg)
            cur = torch.where(live, torch.gather(pr, 0, cidx), neg)
            hops.append(torch.stack([g, n, live.to(torch.int32)]))
        return torch.stack(hops, dim=2)  # [3, Mb, Cb, K]

    return flatten


def drain_compact(pool: State, maxpos: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The pool drain's device half (the JAX package's `_drain_compact`,
    parallel/batched.py:1858-1951): the precise pend-reachable closure,
    and every pending chain projected into the closure's rank space, so a
    pull carries only what the decode reads.

    The mark is `gc_mark(zeros [B + 1, K], pend[:min(maxpos, M)],
    node_pred)` -- the kernel of csrc/gc_mark.cu on the card, the plain
    walk on CPU tensors -- with `maxpos` the largest ring cursor, which
    the drain's [2, K] probe has already read, so the walk adds no host
    read. The JAX package walks the ring's occupied prefix in chunks of
    256 rows; a walker stops at a marked node in both, so the closure is
    the same set. Ring holes (-1: chains a GC nulled under region
    overflow) mark nothing. Then the rank compaction: `pcount` [K] kept
    nodes a key, `nodes3` [3, B, K] = node_event, node_name and the
    remapped node_pred at their ranks (-1 past `pcount`), and `pend_r` the
    ring remapped into rank ids (`remap_ids`, the group flush's ring remap,
    as the JAX package's `remap_pend_blocks`)."""
    pred, pend = pool["node_pred"], pool["pend"]
    B, K = pred.shape
    M = pend.shape[0]
    seed = torch.zeros((B + 1, K), dtype=torch.bool, device=pred.device)
    pinned = gc_mark(seed, pend[: min(int(maxpos), M)], pred)[:B]
    csum = torch.cumsum(pinned.to(torch.int32), dim=0, dtype=torch.int32)
    pcount = csum[-1]
    neg = torch.full_like(csum, -1)
    remap_full = torch.cat([torch.where(pinned, csum - 1, neg), neg[:1]])
    prank = torch.where(pinned, csum - 1, torch.full_like(csum, B)).long()  # holes -> trash

    def compact_by(vals: Tensor) -> Tensor:
        out = torch.full((B + 1, K), -1, dtype=vals.dtype, device=vals.device)
        out.scatter_(0, prank, torch.where(pinned, vals, torch.full_like(vals, -1)))
        return out[:B]

    nodes3 = torch.stack([
        compact_by(pool["node_event"]),
        compact_by(pool["node_name"]),
        compact_by(remap_ids(remap_full, pred)),
    ])
    return remap_ids(remap_full, pend), nodes3, pcount


def drain_pend(pool: State) -> State:
    """Clear the pending-match ring and the pins that kept its chains."""
    return {
        **pool,
        "pend": torch.full_like(pool["pend"], -1),
        "pend_count": torch.zeros_like(pool["pend_count"]),
        "pend_pos": torch.zeros_like(pool["pend_pos"]),
        "pinned": torch.zeros_like(pool["pinned"]),
        "pend_min": torch.full_like(pool["pend_min"], int(_PEND_MIN_NONE)),
    }
