"""Key-axis batching: every per-key NFA of one instance advanced together.

The port's counterpart of the JAX package's `parallel/key_shard.py`,
without the device mesh. Per-key state is stacked along a trailing key
axis ([..., K], the JAX engine's layout) and the step advances all keys
in one call (one CUDA block per key on the card). The post passes
(ops/engine.py `build_append_post` / `build_flush_post`) work on the
K-last planes directly, so they need no batched wrapper here.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.engine import STATE_COUNTER_KEYS, EngineConfig, init_pool, init_state
from ..ops.tables import CompiledQuery

#: The step engines: "cuda" runs the hand-written kernel through its
#: wrapper (ops/step_kernel.py), "torch" the plain PyTorch step.
ENGINES = ("cuda", "torch")


def _broadcast_tree(tree: Dict[str, torch.Tensor], n_keys: int) -> Dict[str, torch.Tensor]:
    return {
        k: leaf[..., None].expand(leaf.shape + (n_keys,)).contiguous()
        for k, leaf in tree.items()
    }


def init_batched_state(
    query: CompiledQuery, config: EngineConfig, n_keys: int, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Per-key engine state stacked along a trailing [..., K] axis."""
    return _broadcast_tree(init_state(query, config, device), n_keys)


def init_batched_pool(
    query: CompiledQuery, config: EngineConfig, n_keys: int, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Per-key node pool / pending-match ring stacked along [..., K]."""
    return _broadcast_tree(init_pool(query, config, device), n_keys)


def build_batched_advance(query: CompiledQuery, config: EngineConfig, engine: str = "cuda"):
    """advance(state, xs) -> (state, ys): all keys through one [T, K]
    micro-batch. ys leaves are [T, K, cap]."""
    if engine == "cuda":
        from ..ops.step_kernel import NfaStep

        return NfaStep(query, config)
    if engine == "torch":
        from ..ops.step import build_plain_step

        return build_plain_step(query, config)
    raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")


def global_stats(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Cross-key counter totals."""
    return {k: state[k].sum() for k in STATE_COUNTER_KEYS + ("runs",)}
