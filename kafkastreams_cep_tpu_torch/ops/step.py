"""The batched NFA step, plain PyTorch version.

One advance takes every key's [K, R] lane table through the T events of a
micro-batch: the same transition relation as the JAX package's XLA step
(`ops/engine.py::build_step`, vmapped over keys by
`parallel/key_shard.py::build_batched_advance`) and its fused Pallas kernel
(`ops/pallas_step.py::build_pallas_batched_advance`) -- window expiry,
the unrolled epsilon descent, stateful predicates and fold registers, the
fold-divergence detector, buffer-node puts ranked into P_CAP, branch
clones and begin re-adds, the 3L-slot table in the oracle's DFS order,
fresh run ids, match extraction and lane compaction, and 8 counters.

It is written key-batched rather than vmapped: every per-lane quantity is
a [K, R] plane and a Python loop walks the T events. Where the Pallas
kernel selects slots with one-hot matmuls, this version ranks with an
exclusive cumsum in (lane, slot) order and scatters straight to the rank
(a trash column takes what does not fit). It is the reference the CUDA
kernel (ops/step_kernel.py, csrc/nfa_step.cu) is held to on the card,
and what the wrapper runs for tensors on the CPU.

State in and out is the K-last engine layout (ops/engine.py); ys come out
as [T, K, cap] like the Pallas kernel's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .engine import EngineConfig, node_window_cap, window_ms_i32
from .numerics import as_f32, as_mask
from .tables import (
    OP_NONE,
    OP_TAKE,
    PR_NONE,
    PR_PROCEED,
    PR_SKIP,
    CompiledQuery,
    TorchEnv,
)

Tensor = torch.Tensor

#: per-lane i32/bool leaves of the state, in the order the kernel reads them.
LANE_FIELDS = (
    "active", "src", "eps", "vlen", "seq", "node", "ts", "branching",
    "ignored", "root",
)
#: per-key scalar counters, in the order the kernel reads them.
COUNTER_FIELDS = (
    "runs", "n_events", "n_branches", "n_expired",
    "lane_drops", "node_drops", "match_drops", "seq_collisions",
)
YS_FIELDS = ("w_event", "w_name", "w_pred", "w_match", "w_mroot")
_BOOL_LANES = ("active", "branching", "ignored")


def flat_folds(query: CompiledQuery) -> List[Tuple[int, int, Callable]]:
    """Folds as [(stage, slot, fn)] in per-stage order."""
    return [
        (stage_i, slot, fn)
        for stage_i, stage_folds in enumerate(query.folds)
        for slot, fn in stage_folds
    ]


def build_plain_step(query: CompiledQuery, config: EngineConfig):
    """advance(state, xs) -> (state, ys) for K-last batched state.

    xs leaves are time-major [T, K]: "f:<field>", "ts", "topic", "gidx",
    "valid", "spred" ([T, K, P]) and optionally "wm".
    """
    R = config.lanes
    D = config.dewey_width(query)
    A = query.n_aggs
    B = config.nodes
    M_STEP = config.matches_per_step
    L = query.max_depth
    P = query.n_preds
    S = 3 * L
    P_CAP = node_window_cap(query, config)
    folds = flat_folds(query)
    stateful = [bool(f) for f in query.pred_stateful]
    N_ST = len(query.consume_op)

    tables_np = {
        "consume_op": query.consume_op, "consume_pred": query.consume_pred,
        "consume_target": query.consume_target, "ignore_pred": query.ignore_pred,
        "proceed_kind": query.proceed_kind, "proceed_pred": query.proceed_pred,
        "proceed_target": query.proceed_target, "window": window_ms_i32(query),
        "name_id": query.name_id, "pure_name": query.pure_name_id,
        "is_begin": query.is_begin, "is_final": query.is_final,
        "is_fwd": query.is_fwd, "fwd_final": query.fwd_final,
    }
    pure_of_ptgt = query.pure_name_id[query.proceed_target.clip(0)]
    isfin_of_ctgt = query.is_final[query.consume_target.clip(0)] & (
        query.consume_target >= 0
    )
    tables_np["pure_of_ptgt"] = pure_of_ptgt
    tables_np["isfin_of_ctgt"] = isfin_of_ctgt

    def advance(state: Dict[str, Tensor], xs: Dict[str, Tensor]):
        dev = xs["valid"].device
        T, K = xs["valid"].shape
        tab = {
            k: torch.as_tensor(v.astype("int32"), device=dev)
            for k, v in tables_np.items()
        }

        def lut(name: str, ids: Tensor) -> Tensor:
            ok = (ids >= 0) & (ids < N_ST)
            got = tab[name][ids.clamp(0, N_ST - 1).long()]
            return torch.where(ok, got, torch.zeros_like(got))

        def lutb(name: str, ids: Tensor) -> Tensor:
            return lut(name, ids) != 0

        i32 = dict(dtype=torch.int32, device=dev)
        ar_r = torch.arange(R, **i32)
        zero = torch.zeros((K, R), **i32)
        neg = torch.full((K, R), -1, **i32)
        false = torch.zeros((K, R), dtype=torch.bool, device=dev)

        # [K, R] working planes (transposed once per advance).
        st = {n: state[n].t().contiguous() for n in LANE_FIELDS}
        for n in _BOOL_LANES:
            st[n] = st[n].to(torch.bool)
        ver0 = state["ver"].permute(2, 0, 1).contiguous()          # [K, R, D]
        regs0 = state["regs"].permute(2, 0, 1).contiguous()        # [K, R, A]
        rset0 = state["regs_set"].permute(2, 0, 1).contiguous()
        ctr = {n: state[n].clone() for n in COUNTER_FIELDS}
        phase = state["gc_phase"]
        ys: Dict[str, List[Tensor]] = {k: [] for k in YS_FIELDS}

        for t in range(T):
            valid = xs["valid"][t]                                   # [K]
            ev_ts = xs["ts"][t][:, None]
            ev_clk = torch.maximum(ev_ts, xs["wm"][t][:, None]) if "wm" in xs else ev_ts
            gidx = xs["gidx"][t][:, None]
            event = {"ts": ev_ts, "topic": xs["topic"][t][:, None]}
            for name in query.schema.fields:
                event[f"f:{name}"] = xs[f"f:{name}"][t][:, None]

            active, src, eps = st["active"], st["src"], st["eps"]
            lane_node, lane_root, lane_ts = st["node"], st["root"], st["ts"]
            lane_seq = st["seq"]

            # -- predicate planes [K, R, P] --------------------------------
            env = TorchEnv(event, regs0, rset0, query.agg_slots, query.agg_defaults)
            cols = []
            for p in range(max(P, 1)):
                if p < P and stateful[p]:
                    cols.append(as_mask(query.predicates[p](env), (K, R), dev))
                elif p < P:
                    cols.append(xs["spred"][t][:, p][:, None].expand(K, R))
                else:
                    cols.append(false)
            pred_vals = torch.stack(cols, dim=2)

            def lut_pred(ids: Tensor, name: str) -> Tensor:
                """Per-lane value of the predicate a stage table names."""
                pid = tab[name][ids.clamp(0, N_ST - 1).long()]
                has = (ids >= 0) & (ids < N_ST) & (pid >= 0)
                got = torch.gather(pred_vals, 2, pid.clamp(0).long()[..., None])[..., 0]
                return has & got

            # -- window expiry --------------------------------------------
            root_begin = lutb("is_begin", src)
            w_src = lut("window", src)
            if config.strict_windows:
                w_eps = lut("window", eps)
                w_eps = torch.where(w_eps >= 0, w_eps, w_src)
                eff_window = torch.where(eps >= 0, w_eps, w_src)
                expired = (
                    active & (lane_ts >= 0) & (eff_window >= 0)
                    & ((ev_clk - lane_ts) > eff_window)
                )
            else:
                eff_window = torch.where(eps >= 0, neg, w_src)
                expired = (
                    active & ~root_begin & (eff_window >= 0)
                    & ((ev_clk - lane_ts) > eff_window)
                )
            active = active & ~expired
            root_fwd = (eps >= 0) | lutb("is_fwd", src)
            start_ts = torch.where(root_begin, ev_ts.expand(K, R), lane_ts)
            state_match = ((eps >= 0) & lutb("is_final", eps)) | (
                (eps < 0) & lutb("fwd_final", src)
            )

            # -- downward pass: unrolled epsilon descent -------------------
            alive, cs, is_eps, ceps = active, src, eps >= 0, eps
            vlen, br, ig = st["vlen"], st["branching"], st["ignored"]
            ps = neg
            levels = []
            for lvl in range(L):
                c_op = torch.where(is_eps, zero + OP_NONE, lut("consume_op", cs))
                c_m = alive & ~is_eps & (c_op != OP_NONE) & lut_pred(cs, "consume_pred")
                take_m = c_m & (c_op == OP_TAKE)
                ig_m = alive & ~is_eps & lut_pred(cs, "ignore_pred")
                pk = torch.where(is_eps, zero + PR_PROCEED, lut("proceed_kind", cs))
                ptgt = torch.where(is_eps, ceps, lut("proceed_target", cs))
                p_m = alive & (pk != PR_NONE) & (is_eps | lut_pred(cs, "proceed_pred"))
                p_strict = p_m & (pk == PR_PROCEED)
                branch_m = (p_strict & take_m) | (ig_m & (c_m | p_strict))
                ptgt_c = torch.clamp(ptgt, min=0)
                pure_tgt = lut("pure_of_ptgt", cs)
                if lvl == 0:
                    pure_tgt = torch.where(is_eps, lut("pure_name", ceps), pure_tgt)
                fwd_next = p_m & (pure_tgt != lut("pure_name", cs)) & ~br & ~ig
                levels.append(dict(
                    alive=alive, cs=cs, vlen=vlen, ps=ps, c_m=c_m,
                    take_m=take_m, ig_m=ig_m, branch_m=branch_m,
                ))
                vlen = torch.where(fwd_next, vlen + 1, vlen)
                br = br & ~fwd_next
                ig = ig & ~fwd_next
                ps = torch.where(pk == PR_SKIP, ps, cs)
                alive = p_m
                cs = ptgt_c
                is_eps = false
                ceps = neg

            # -- fold-register chain (deepest level first) -----------------
            cur_regs, cur_set = regs0, rset0
            clone_regs: List[Tuple[Tensor, Tensor]] = [None] * L  # type: ignore
            for lvl in reversed(range(L)):
                clone_regs[lvl] = (cur_regs, cur_set)
                if folds:
                    v = levels[lvl]
                    regs_l = list(cur_regs.unbind(2))
                    set_l = list(cur_set.unbind(2))
                    for stage_i, slot, fn in folds:
                        mask = v["c_m"] & (v["cs"] == stage_i)
                        fenv = TorchEnv(
                            event, torch.stack(regs_l, 2), torch.stack(set_l, 2),
                            query.agg_slots, query.agg_defaults,
                        )
                        val = as_f32(fn(fenv), (K, R), dev)
                        regs_l[slot] = torch.where(mask, val, regs_l[slot])
                        set_l[slot] = set_l[slot] | mask
                    cur_regs = torch.stack(regs_l, 2)
                    cur_set = torch.stack(set_l, 2)
            final_regs, final_set = cur_regs, cur_set

            # -- fold-divergence detector ----------------------------------
            if folds:
                consuming = false
                for v in levels:
                    consuming = consuming | v["c_m"]
                pair = (
                    (lane_seq[:, :, None] == lane_seq[:, None, :])
                    & consuming[:, :, None] & active[:, None, :]
                    & (ar_r[:, None] != ar_r[None, :])[None]
                )
                collide = pair.flatten(1).any(dim=1)
            else:
                collide = torch.zeros(K, dtype=torch.bool, device=dev)

            # -- buffer puts, ranked in (lane, level) order ----------------
            put = torch.stack([v["c_m"] for v in levels], dim=2)       # [K, R, L]
            put_rank = _excl_cumsum(put.reshape(K, R * L)).reshape(K, R, L)
            n_put = put.sum(dim=(1, 2), dtype=torch.int32)
            base = B + (phase + t)[:, None] * P_CAP                  # [K, 1]
            put_ok = put & (put_rank < P_CAP)
            put_idx = torch.where(put_ok, base[:, :, None] + put_rank, -1)
            names = torch.stack([lut("name_id", v["cs"]) for v in levels], dim=2)
            dest = torch.where(put_ok, put_rank, P_CAP).reshape(K, R * L).long()
            w_name = _scatter_row(dest, names.reshape(K, R * L), P_CAP, -1)
            w_pred = _scatter_row(
                dest, lane_node[:, :, None].expand(K, R, L).reshape(K, R * L), P_CAP, -1
            )
            jj = torch.arange(P_CAP, **i32)[None, :]
            w_event = torch.where(
                jj < torch.clamp(n_put, max=P_CAP)[:, None], gidx, -1
            )

            # -- upward pass: clones / begin re-adds -----------------------
            desc_any = false
            up: List[Dict[str, Tensor]] = [None] * L  # type: ignore
            for lvl in reversed(range(L)):
                v = levels[lvl]
                ignore_emit = v["ig_m"] & ~v["branch_m"]
                clone_m = v["branch_m"] & v["c_m"]
                rootcopy_m = v["branch_m"] & ~v["c_m"] & ~desc_any
                readd_cond = root_begin & ~root_fwd & v["alive"]
                readd_fresh = readd_cond & v["c_m"]
                readd_root = readd_cond & ~v["c_m"]
                ns_before = v["c_m"] | ignore_emit | desc_any | clone_m | rootcopy_m
                up[lvl] = dict(
                    ignore_emit=ignore_emit, clone_m=clone_m, rootcopy_m=rootcopy_m,
                    readd_fresh=readd_fresh, readd_root=readd_root,
                    readd_add=readd_fresh & ns_before,
                )
                desc_any = ns_before | readd_fresh | readd_root

            # -- output slot table in oracle DFS order ---------------------
            ar_d = torch.arange(D, **i32)

            def bump(ver: Tensor, idx: Tensor, mask: Tensor) -> Tensor:
                return ver + ((ar_d[None, None, :] == idx[:, :, None]) & mask[:, :, None]).to(torch.int32)

            slots: List[Dict[str, Tensor]] = []
            for lvl in range(L):
                v = levels[lvl]
                c_m = v["c_m"]
                c_eps = torch.where(v["take_m"], v["cs"], lut("consume_target", v["cs"]))
                match_consume = (v["take_m"] & lutb("is_final", v["cs"])) | (
                    ~v["take_m"] & lutb("isfin_of_ctgt", v["cs"])
                )
                slots.append(dict(
                    occ=c_m | up[lvl]["ignore_emit"],
                    src=torch.where(c_m, v["cs"], src),
                    eps=torch.where(c_m, c_eps, eps),
                    ver=ver0, vlen=v["vlen"], seq=lane_seq,
                    node=torch.where(c_m, put_idx[:, :, lvl], lane_node),
                    ts=torch.where(c_m, start_ts, lane_ts),
                    br=false, ig=~c_m, newseq=false,
                    regs=final_regs, regs_set=final_set,
                    match=(c_m & match_consume) | (~c_m & state_match),
                ))
            for lvl in reversed(range(L)):
                v, u = levels[lvl], up[lvl]
                has_ps = v["ps"] >= 0
                ps_begin = ~has_ps | lutb("is_begin", v["ps"])
                off = torch.where(ps_begin & (v["vlen"] >= 2), 2, 1).to(torch.int32)
                m_clone = u["clone_m"]
                cr, cr_set = clone_regs[lvl]
                slots.append(dict(
                    occ=m_clone | u["rootcopy_m"],
                    src=torch.where(m_clone, torch.where(has_ps, v["ps"], v["cs"]), src),
                    eps=torch.where(m_clone, v["cs"], eps),
                    ver=bump(ver0, v["vlen"] - off, m_clone),
                    vlen=torch.where(m_clone, v["vlen"], st["vlen"]),
                    seq=torch.where(m_clone, zero, lane_seq),
                    node=torch.where(
                        m_clone,
                        torch.where(v["ig_m"], lane_node, put_idx[:, :, lvl]),
                        lane_node,
                    ),
                    ts=torch.where(m_clone, start_ts, lane_ts),
                    br=m_clone | st["branching"],
                    ig=~m_clone & st["ignored"],
                    newseq=m_clone,
                    regs=torch.where(m_clone[:, :, None], cr, final_regs),
                    regs_set=torch.where(m_clone[:, :, None], cr_set, final_set),
                    match=(m_clone & lutb("is_final", v["cs"])) | (~m_clone & state_match),
                ))
                m_fresh = u["readd_fresh"]
                slots.append(dict(
                    occ=m_fresh | u["readd_root"],
                    src=src, eps=eps,
                    ver=bump(ver0, v["vlen"] - 1, u["readd_add"] & m_fresh),
                    vlen=torch.where(m_fresh, v["vlen"], st["vlen"]),
                    seq=torch.where(m_fresh, zero, lane_seq),
                    node=torch.where(m_fresh, neg, lane_node),
                    ts=torch.where(m_fresh, neg, lane_ts),
                    br=~m_fresh & st["branching"],
                    ig=~m_fresh & st["ignored"],
                    newseq=m_fresh,
                    regs=torch.where(m_fresh[:, :, None], torch.zeros_like(final_regs), final_regs),
                    regs_set=~m_fresh[:, :, None] & final_set,
                    match=state_match,
                ))

            def stack(name: str) -> Tensor:
                return torch.stack([s[name] for s in slots], dim=2)   # [K, R, S, ...]

            occ = stack("occ")
            o_node = stack("node")
            o_root = torch.where(lane_root[:, :, None] >= 0, lane_root[:, :, None], o_node)
            o_seq = stack("seq")

            # -- fresh run ids in (lane, slot) DFS order -------------------
            ns = occ & stack("newseq")
            ns_rank = _excl_cumsum(ns.reshape(K, R * S)).reshape(K, R, S)
            o_seq = torch.where(ns, ctr["runs"][:, None, None] + 1 + ns_rank, o_seq)
            n_new = ns.sum(dim=(1, 2), dtype=torch.int32)

            # -- match extraction + lane compaction ------------------------
            is_match = occ & stack("match")
            keep = occ & ~is_match
            n_match = is_match.sum(dim=(1, 2), dtype=torch.int32)
            n_keep = keep.sum(dim=(1, 2), dtype=torch.int32)
            m_rank = _excl_cumsum(is_match.reshape(K, R * S))
            m_dest = torch.where(is_match.reshape(K, R * S) & (m_rank < M_STEP), m_rank, M_STEP).long()
            w_match = _scatter_row(m_dest, o_node.reshape(K, R * S), M_STEP, -1)
            w_mroot = _scatter_row(m_dest, o_root.reshape(K, R * S), M_STEP, -1)

            k_rank = _excl_cumsum(keep.reshape(K, R * S))
            k_dest = torch.where(keep.reshape(K, R * S) & (k_rank < R), k_rank, R).long()

            def compact(vals: Tensor, fill) -> Tensor:
                return _scatter_row(k_dest, vals.reshape((K, R * S) + vals.shape[3:]), R, fill)

            lane_ok = ar_r[None, :] < torch.clamp(n_keep, max=R)[:, None]
            new_st = {
                "active": lane_ok,
                "src": compact(stack("src"), 0),
                "eps": compact(stack("eps"), -1),
                "vlen": compact(stack("vlen"), 0),
                "seq": compact(o_seq, 0),
                "node": compact(o_node, -1),
                "ts": compact(stack("ts"), -1),
                "branching": compact(stack("br"), False),
                "ignored": compact(stack("ig"), False),
                "root": compact(o_root, -1),
            }
            new_ver = compact(stack("ver"), 0)
            new_regs = compact(stack("regs"), 0.0)
            new_rset = compact(stack("regs_set"), False)

            # -- counters + masked write-back ------------------------------
            n_branch = sum(u["clone_m"].sum(dim=1, dtype=torch.int32) for u in up)
            deltas = {
                "runs": n_new,
                "n_events": torch.ones(K, **i32),
                "n_branches": n_branch,
                "n_expired": expired.sum(dim=1, dtype=torch.int32),
                "lane_drops": torch.clamp(n_keep - R, min=0),
                "node_drops": torch.clamp(n_put - P_CAP, min=0),
                "match_drops": torch.clamp(n_match - M_STEP, min=0),
                "seq_collisions": collide.to(torch.int32),
            }
            for n in COUNTER_FIELDS:
                ctr[n] = ctr[n] + torch.where(valid, deltas[n], 0)
            vm = valid[:, None]
            st = {n: torch.where(vm, new_st[n], st[n]) for n in LANE_FIELDS}
            ver0 = torch.where(vm[:, :, None], new_ver, ver0)
            regs0 = torch.where(vm[:, :, None], new_regs, regs0)
            rset0 = torch.where(vm[:, :, None], new_rset, rset0)
            for name, val in (
                ("w_event", w_event), ("w_name", w_name), ("w_pred", w_pred),
                ("w_match", w_match), ("w_mroot", w_mroot),
            ):
                ys[name].append(torch.where(vm, val, -1).to(torch.int32))

        new_state = dict(state)
        for n in LANE_FIELDS:
            new_state[n] = st[n].t().contiguous()
        new_state["ver"] = ver0.permute(1, 2, 0).contiguous()
        new_state["regs"] = regs0.permute(1, 2, 0).contiguous()
        new_state["regs_set"] = rset0.permute(1, 2, 0).contiguous()
        for n in COUNTER_FIELDS:
            new_state[n] = ctr[n].to(torch.int32)
        return new_state, {k: torch.stack(v) for k, v in ys.items()}

    return advance


def _excl_cumsum(mask: Tensor) -> Tensor:
    m = mask.to(torch.int32)
    return (torch.cumsum(m, dim=1) - m).to(torch.int32)


def _scatter_row(dest: Tensor, vals: Tensor, width: int, fill) -> Tensor:
    """out[k, dest[k, i]] = vals[k, i] into a [K, width] row (+ a trash
    column at `width` for entries that do not land)."""
    K = vals.shape[0]
    out = torch.full((K, width + 1) + tuple(vals.shape[2:]), fill,
                     dtype=vals.dtype, device=vals.device)
    idx = dest.reshape(dest.shape + (1,) * (vals.dim() - 2)).expand(vals.shape)
    out.scatter_(1, idx, vals)
    return out[:, :width]
