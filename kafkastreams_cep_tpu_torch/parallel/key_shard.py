"""Key-axis batching and the key mesh: every per-key NFA of one instance
advanced together, the key axis optionally split over several devices.

The port's counterpart of the JAX package's `parallel/key_shard.py`.
Per-key state is stacked along a trailing key axis ([..., K], the JAX
engine's layout) and the step advances all keys in one call (one warp a
key on the card). The post passes (ops/engine.py `build_append_post` /
`build_flush_post`) work on the K-last planes directly, so they need no
batched wrapper here.

The mesh (`KeyMesh`, `key_mesh`) is the JAX package's 1-D `Mesh` over
the key axis: one process drives every device, as in JAX, and no
collective runs on the hot path. The key axis is cut into contiguous
blocks of equal width, one a shard, the blocks every consumer of the
trailing axis shares (`shard_stats`, `slice_shard_tree`, the engine's
layout); a shard's tensors live on its device and every device pass of
the engine runs once a shard on them (parallel/batched.py). A mesh may
name one device more than once: a *virtual* mesh, the counterpart of the
JAX tests' forced host device count, which runs n shards on one card
(or on the CPU, for the tests), each with its own tensors and launches.
`shard_state` / `shard_xs` split a whole tree into per-shard trees on
their devices and `gather_state` joins them back.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from ..ops.engine import STATE_COUNTER_KEYS, EngineConfig, init_pool, init_state
from ..ops.tables import CompiledQuery

#: The step engines: "cuda" runs the hand-written kernel through its
#: wrapper (ops/step_kernel.py), "torch" the plain PyTorch step.
ENGINES = ("cuda", "torch")

#: Mesh axis name for the key shard (the data-parallel axis).
KEY_AXIS = "keys"

#: The counters `global_stats` and `shard_stats` reduce.
STAT_KEYS = STATE_COUNTER_KEYS + ("runs",)


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
    """Cross-key counter totals of one (whole or shard) tree."""
    return {k: state[k].sum() for k in STAT_KEYS}


# ----------------------------------------------------------------- the mesh
def _normalize(device: Any) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a key mesh")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class KeyMesh:
    """A 1-D mesh over the key axis: one device a shard, shard s holding
    the key block `_shard_block(K, size, s)`. A device may appear more than
    once (a virtual mesh); all shards are of one device type."""

    def __init__(self, devices: Seq[Any]) -> None:
        devs = tuple(_normalize(d) for d in devices)
        if not devs:
            raise ValueError("a key mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a key mesh spans one device type, got {devs}")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def distinct(self) -> int:
        """How many distinct devices the shards run on."""
        return len(set(self.devices))

    @property
    def virtual(self) -> bool:
        """True when some device holds more than one shard."""
        return self.distinct < self.size

    def describe(self) -> Dict[str, Any]:
        return {"shards": self.size, "devices": [str(d) for d in self.devices],
                "distinct": self.distinct, "virtual": self.virtual}

    def __repr__(self) -> str:
        return f"KeyMesh({[str(d) for d in self.devices]})"


def key_mesh(n_devices: Optional[int] = None, devices: Optional[Seq[Any]] = None) -> KeyMesh:
    """A 1-D key mesh of `n_devices` shards over `devices`, shard s on
    devices[s % len(devices)]. `devices` defaults to every visible CUDA
    device and `n_devices` to one shard a device; more shards than
    devices make a virtual mesh (e.g. `key_mesh(8, devices=["cpu"])` for
    the tests, `key_mesh(2)` on a one-card machine). Raises when no
    device is given and no CUDA device is visible."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "key_mesh() found no CUDA device; pass devices= (e.g. "
                "devices=['cpu'] for a virtual mesh on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("key_mesh needs at least one device")
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a key mesh needs at least one shard, got {n}")
    return KeyMesh([devices[s % len(devices)] for s in range(n)])


def padded_extent(k: int, n_shards: int) -> int:
    """The key extent padded to a multiple of the shard count, so every
    shard's block has the same width (padding keys never receive a valid
    event)."""
    return -(-k // n_shards) * n_shards


def _shard_block(k: int, n_shards: int, shard: int) -> Tuple[int, int]:
    """[lo, hi) key-column range of one shard under the contiguous block
    partitioning every consumer of the trailing key axis shares."""
    if k % n_shards:
        raise ValueError(f"key extent {k} not divisible by {n_shards} shards")
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range ({n_shards} shards)")
    span = k // n_shards
    return shard * span, (shard + 1) * span


def shard_state(tree: Mapping[str, torch.Tensor], mesh: KeyMesh) -> List[Dict[str, torch.Tensor]]:
    """A whole K-last tree (tensors or numpy arrays) as one tree a shard:
    each leaf's trailing key axis cut to the shard's block, contiguous, on
    the shard's device."""
    out = []
    for s, dev in enumerate(mesh.devices):
        part = {}
        for name, leaf in tree.items():
            lo, hi = _shard_block(leaf.shape[-1], mesh.size, s)
            part[name] = torch.as_tensor(leaf[..., lo:hi]).contiguous().to(dev)
        out.append(part)
    return out


def shard_xs(xs: Mapping[str, torch.Tensor], mesh: KeyMesh) -> List[Dict[str, torch.Tensor]]:
    """Time-major [T, K, ...] columns as one dict a shard: axis 1 (keys)
    cut to the shard's block, on the shard's device."""
    out = []
    for s, dev in enumerate(mesh.devices):
        part = {}
        for name, col in xs.items():
            lo, hi = _shard_block(col.shape[1], mesh.size, s)
            part[name] = torch.as_tensor(col[:, lo:hi]).contiguous().to(dev)
        out.append(part)
    return out


def gather_state(trees: Seq[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-shard trees joined along the trailing key axis on the first
    shard's device: the inverse of `shard_state`. One tree is returned as
    it is."""
    if len(trees) == 1:
        return trees[0]
    first = trees[0]
    dev = next(iter(first.values())).device
    return {name: torch.cat([t[name].to(dev) for t in trees], dim=-1) for name in first}


def shard_stats(state: Mapping[str, Any], n_shards: int = 1) -> Dict[str, Any]:
    """Per-shard counter totals of a whole tree: each [K] counter summed
    within each of the `n_shards` contiguous key blocks, [n_shards] totals
    per counter (the JAX package's `shard_stats`)."""

    def per_shard(leaf):
        k = leaf.shape[-1]
        if k % n_shards:
            raise ValueError(f"key extent {k} not divisible by {n_shards} shards")
        return leaf.reshape(n_shards, k // n_shards).sum(-1)

    return {k: per_shard(state[k]) for k in STAT_KEYS}


def slice_shard_tree(tree: Mapping[str, Any], n_shards: int, shard: int) -> Dict[str, Any]:
    """One shard's columns: every leaf's trailing key axis cut to the
    shard's contiguous block (the blocks of `shard_stats`), keeping the
    [..., K/n_shards] layout. Leaves may be tensors or numpy arrays."""
    out = {}
    for name, leaf in tree.items():
        lo, hi = _shard_block(leaf.shape[-1], n_shards, shard)
        out[name] = leaf[..., lo:hi]
    return out


def merge_shard_tree(
    base: Mapping[str, Any], shard_tree: Mapping[str, Any], n_shards: int, shard: int,
) -> Dict[str, Any]:
    """Graft a shard's columns into a whole tree: the inverse of
    `slice_shard_tree`, writing the shard's block over `base`'s columns
    (bitwise). Returns new leaves of `base`'s kind."""
    out = {}
    for name, leaf in base.items():
        cols = shard_tree[name]
        lo, hi = _shard_block(leaf.shape[-1], n_shards, shard)
        if tuple(cols.shape) != tuple(leaf[..., lo:hi].shape):
            raise ValueError(
                f"shard column shape {tuple(cols.shape)} does not fit block "
                f"[{lo}:{hi}] of leaf shape {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out[name] = torch.cat([leaf[..., :lo], torch.as_tensor(cols, device=leaf.device)
                                   .to(leaf.dtype), leaf[..., hi:]], dim=-1)
        else:
            out[name] = np.concatenate(
                [leaf[..., :lo], np.asarray(cols, leaf.dtype), leaf[..., hi:]], axis=-1)
    return out
