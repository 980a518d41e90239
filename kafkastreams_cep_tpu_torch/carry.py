"""Carry a running engine across frameworks: JAX engine state <-> port.

The port keeps the JAX engine's state layout leaf for leaf (names,
dtypes, K-last shapes), so moving a live engine is a copy, not a
conversion: `state_from_numpy` takes a JAX `BatchedDeviceNFA`'s `state`
and `pool` as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
eng.state.items()}`) and returns the port's tensors on `device`;
`state_to_numpy` goes back. This is the engine's counterpart of loading a
model's weights into a ported model.

A JAX engine on a key mesh holds its state sharded; `np.asarray` gathers
it. `state_from_numpy(..., mesh=)` splits such a gathered tree into one
tree a shard of the port's mesh (parallel/key_shard.py), each on its
shard's device, as `BatchedDeviceNFA.state` takes them, and
`state_to_numpy` gathers per-shard lists back into whole arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_DTYPES = {
    np.dtype(bool): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def _to_torch(tree: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, leaf in tree.items():
        arr = np.asarray(leaf)
        if arr.dtype not in _DTYPES:
            raise TypeError(f"leaf {name!r}: unsupported dtype {arr.dtype}")
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


Tree = Dict[str, torch.Tensor]


def state_from_numpy(
    state: Mapping[str, Any], pool: Mapping[str, Any], device="cpu", mesh: Optional[Any] = None,
) -> Tuple[Union[Tree, List[Tree]], Union[Tree, List[Tree]]]:
    """(state, pool) numpy leaves -> the port's tensors on `device`, or,
    with a `KeyMesh`, one tree a shard on the shard's device (the key
    extent must divide by the mesh's shard count)."""
    if mesh is None:
        return _to_torch(state, device), _to_torch(pool, device)
    from .parallel.key_shard import shard_state

    return (shard_state(_to_torch(state, "cpu"), mesh),
            shard_state(_to_torch(pool, "cpu"), mesh))


def _to_numpy(tree: Union[Mapping[str, torch.Tensor], List[Mapping[str, torch.Tensor]]]):
    if isinstance(tree, (list, tuple)):
        return {k: np.concatenate([t[k].detach().cpu().numpy() for t in tree], axis=-1)
                for k in tree[0]}
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def state_to_numpy(state, pool) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The port's (state, pool) tensors -> numpy leaves; per-shard lists
    of trees are joined along the key axis."""
    return _to_numpy(state), _to_numpy(pool)
