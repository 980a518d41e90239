"""Carry a running engine across frameworks: JAX engine state <-> port.

The port keeps the JAX engine's state layout leaf for leaf (names,
dtypes, K-last shapes), so moving a live engine is a copy, not a
conversion: `state_from_numpy` takes a JAX `BatchedDeviceNFA`'s `state`
and `pool` as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
eng.state.items()}`) and returns the port's tensors on `device`;
`state_to_numpy` goes back. This is the engine's counterpart of loading a
model's weights into a ported model.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def state_from_numpy(
    state: Mapping[str, Any], pool: Mapping[str, Any], device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(state, pool) numpy leaves -> the port's tensors on `device`."""
    return _to_torch(state, device), _to_torch(pool, device)


def state_to_numpy(
    state: Mapping[str, torch.Tensor], pool: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The port's (state, pool) tensors -> numpy leaves."""
    return (
        {k: v.detach().cpu().numpy() for k, v in state.items()},
        {k: v.detach().cpu().numpy() for k, v in pool.items()},
    )
