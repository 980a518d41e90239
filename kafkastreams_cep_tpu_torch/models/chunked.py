"""Cases that reach the step kernel's multi-chunk path.

The CUDA step kernel (csrc/nfa_step.cu) walks a key's live lanes 32 at a
time, carrying rank bases from chunk to chunk. The three conformance
cases of models/cases.py never hold more than 32 lanes, so these cases
(K keys x 64 events x 3 batches each) push past it: the flagship
skip_any8 deployment with its lanes cut to 96 (some key holds more than
32 live lanes) and to 24 (lanes overflow: `lane_drops` > 0), and the
stock fold pattern at 64 lanes on a stream whose prices hover near 100
(more than 32 live lanes with fold registers, so the fold-divergence
detector compares across chunks). `scatter_live_lanes` builds an entry
state whose live lanes are not a prefix. The tests run them through the
kernel's source on the CPU and chip_smoke.py through the kernel on the
card, both against the plain step.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List

import torch

from . import skip_any
from .cases import STOCK_FIELDS, TS0, _pkg, stock_pattern


def stock_near_100_stream(rng: random.Random, n: int, dsl: Any = None) -> List[Any]:
    """Prices near 100 and volumes above 900: stage 2's price > avg holds
    about half the time, so runs pile up past 32 lanes per key."""
    ev = _pkg(dsl).Event
    return [
        ev("K", {"name": "s", "price": rng.randint(90, 110),
                 "volume": rng.randint(900, 1200)}, TS0 + i, "t", 0, i)
        for i in range(n)
    ]


#: name -> (pattern, schema fields, stream, stream seed, EngineConfig keywords).
CHUNKED: Dict[str, tuple] = {
    "skip_any8_lanes96": (skip_any.skip_any8_pattern, None, skip_any.skip_any8_stream, 7,
                          {**skip_any.FLAGSHIP_CONFIG, "lanes": 96}),
    "skip_any8_lanes24": (skip_any.skip_any8_pattern, None, skip_any.skip_any8_stream, 7,
                          {**skip_any.FLAGSHIP_CONFIG, "lanes": 24}),
    "stock_lanes64": (stock_pattern, STOCK_FIELDS, stock_near_100_stream, 5,
                      dict(lanes=64, nodes=4096, matches=2048, matches_per_step=32,
                           nodes_per_step=128)),
}
#: Events per batch of every chunked case.
CHUNKED_T = skip_any.FLAGSHIP_T


def scatter_live_lanes(state: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
    """A copy of a K-last state with each key's active lanes moved, in
    order, to random lane positions (so they are not a prefix) and every
    inactive lane filled with arbitrary values."""
    rng = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)
    R, K = state["active"].shape
    out = {n: v.clone() for n, v in state.items()}
    lane_leaves = [n for n in state if state[n].dim() >= 2]
    for k in range(K):
        live = torch.nonzero(state["active"][:, k]).flatten().tolist()
        pos = sorted(rng.sample(range(R), len(live)))
        for n in lane_leaves:
            v = out[n]
            junk = torch.randint(-3, 40, v[..., k].shape, generator=gen).to(v.device)
            v[..., k] = junk > 18 if v.dtype == torch.bool else junk.to(v.dtype)
            v[pos, ..., k] = state[n][live, ..., k]
        out["active"][:, k] = False
        out["active"][pos, k] = True
    return out
