"""The GC sweep: the wrapper of csrc/gc_sweep.cu and its plain version.

`gc_sweep(marked, marked_pin, state, pool, ys)` is the second half of the
group flush (ops/engine.py `build_gc`), after the mark: the marked nodes
of (region ++ group window) compacted stably into the B-slot region, node
preds, lane `node`/`root`, the ring rows below `pend_pos` and `pend_min`
remapped, `node_count` and `node_drops` updated. `marked` and
`marked_pin` are the mark's [BW + 1, K] bool planes (row BW unused), `ys`
the group's window as the step writes it ([T, K, cap] planes). Returns
the new planes by name: the pool's `node_event`, `node_name`,
`node_pred`, `node_count`, `pinned`, `pend_min` and `pend`, and the
state's `node`, `root` and `node_drops`.

For tensors on the card it launches the kernel of csrc/gc_sweep.cu (the
marks packed into bit words and the region's fill and the ring's copy
written by whole-row grids, then a block of a few keys: their bitmaps and
per-word prefix counts in shared memory, a rank one popcount, slot r
taking the r-th kept node, read where it lies); a failed build or a
refused launch raises, nothing falls back.
For tensors on the CPU it runs `_sweep`, the plain version, which the
kernel is held to bitwise (on the card by chip_smoke.py, on the CPU
through the kernel's g++ emulation build).

The kernel replaces the compaction and remaps of the JAX package's
`ops/engine.py` `build_gc` (lines 1178-1232) and its ring remap
`remap_pend_blocks` (lines 1237-1282); it is built once per target, not
per query, by ops/kernel_build.py.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .kernel_build import CSRC, compile_source, on_device

Tensor = torch.Tensor
State = Dict[str, Tensor]
KERNEL_SOURCE = CSRC / "gc_sweep.cu"

#: `pend_min` sentinel: no pending match (any real node id is smaller).
_PEND_MIN_NONE = np.int32(2**31 - 1)
#: The ys node planes a GC group's accumulated window carries between the
#: per-advance append and the group flush.
WINDOW_PLANES = ("w_event", "w_name", "w_pred")
#: The planes the sweep gives back (pool's, then state's).
POOL_OUT = ("node_event", "node_name", "node_pred", "node_count", "pinned", "pend_min", "pend")
STATE_OUT = ("node", "root", "node_drops")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _excl_cumsum(mask: Tensor, dim: int = 0) -> Tensor:
    m = mask.to(torch.int32)
    return (torch.cumsum(m, dim=dim) - m).to(torch.int32)


def remap_ids(remap_full: Tensor, ids: Tensor) -> Tensor:
    """Per-key value remap of node ids ([N, K] or [K]; -1 stays -1).

    On the ring [M, K] it is the plain version of the JAX package's
    `remap_pend_blocks` (ops/engine.py:1237-1282), which remaps only the
    occupied prefix, in blocks up to the largest cursor: the rows past a
    key's `pend_pos` hold -1 here, which the remap keeps, so the whole ring
    remaps to the same. The sweep below and the pool drain's compaction
    (ops/engine.py `drain_compact`) remap the ring with it."""
    squeeze = ids.dim() == 1
    idx = ids.unsqueeze(0) if squeeze else ids
    got = torch.gather(remap_full, 0, idx.clamp(min=0).long())
    out = torch.where(idx >= 0, got, torch.full_like(got, -1))
    return out.squeeze(0) if squeeze else out


def window_planes(ys: State) -> State:
    """[T, K, cap] ys node planes -> the [T * cap, K] t-major window."""
    out = {}
    for k in WINDOW_PLANES:
        T, K, cap = ys[k].shape
        out[k] = ys[k].permute(0, 2, 1).reshape(T * cap, K)
    return out


def _sweep(marked: Tensor, marked_pin: Tensor, state: State, pool: State, ys: State) -> State:
    """The plain sweep: rank = exclusive cumsum of the marks, a kept node
    (rank < B) scattered to its rank, every node id remapped through a
    [BW + 1, K] table (the ring in full: its rows past `pend_pos` hold
    -1, which the remap keeps)."""
    window = window_planes(ys)
    w_event, w_name, w_pred = (window[k] for k in WINDOW_PLANES)
    B = pool["node_event"].shape[0]
    W, K = w_event.shape
    BW = B + W
    dev = w_event.device
    combined_pred = torch.cat([pool["node_pred"], w_pred])
    marked_pin = marked_pin[:BW]
    marked = marked[:BW]

    n_keep = marked.sum(dim=0, dtype=torch.int32)
    rank = _excl_cumsum(marked)
    keep = marked & (rank < B)
    remap = torch.where(keep, rank, torch.full_like(rank, -1))
    remap_full = torch.cat([remap, remap.new_full((1, K), -1)])
    # The stable sweep: kept nodes land at their rank, in id order.
    dest = torch.where(keep, rank, torch.full_like(rank, B)).long()

    def sweep(vals: Tensor, fill) -> Tensor:
        out = torch.full((B + 1, K), fill, dtype=vals.dtype, device=dev)
        out.scatter_(0, dest, torch.where(keep, vals, torch.full_like(vals, fill)))
        return out[:B]

    pm = pool["pend_min"]
    pm_remap = torch.gather(
        remap_full, 0, pm.clamp(0, BW)[None, :].long()
    )[0]
    new_pend_min = torch.where(
        pm == int(_PEND_MIN_NONE), pm, torch.clamp(pm_remap, min=0)
    )
    return {
        "node_event": sweep(torch.cat([pool["node_event"], w_event]), -1),
        "node_name": sweep(torch.cat([pool["node_name"], w_name]), -1),
        "node_pred": sweep(remap_ids(remap_full, combined_pred), -1),
        "node_count": torch.clamp(n_keep, max=B),
        "pinned": sweep(marked_pin, False),
        "pend_min": new_pend_min,
        "pend": remap_ids(remap_full, pool["pend"]),
        "node": remap_ids(remap_full, state["node"]),
        "root": remap_ids(remap_full, state["root"]),
        "node_drops": state["node_drops"] + torch.clamp(n_keep - B, min=0),
    }


def build_library(target: str = "sm_90a", build_dir: Optional[Path] = None) -> Path:
    """Compile csrc/gc_sweep.cu (cached by a hash of source and flags)."""
    return compile_source(KERNEL_SOURCE.read_text(), "gc_sweep", target, build_dir)


def load_library(path: Path) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(str(path))
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.gc_sweep_launch.argtypes = [ctypes.c_void_p] * 5
            lib.gc_sweep_launch.restype = ctypes.c_int
            for fn, res in (("gc_sweep_scratch_words", ctypes.c_longlong),
                            ("gc_sweep_smem_bytes", ctypes.c_longlong),
                            ("gc_sweep_words", ctypes.c_longlong),
                            ("gc_sweep_block_words", ctypes.c_longlong),
                            ("gc_sweep_keys_per_block", ctypes.c_int)):
                getattr(lib, fn).argtypes = [ctypes.c_int, ctypes.c_int]
                getattr(lib, fn).restype = res
            _libs[str(path)] = lib
    return lib


def _operands(marked: Tensor, marked_pin: Tensor, state: State, pool: State, ys: State):
    """The kernel's inputs in its order, each with its expected shape."""
    B, K = pool["node_event"].shape
    T, _, cap = ys["w_event"].shape
    R, M = state["node"].shape[0], pool["pend"].shape[0]
    BW = B + T * cap
    return (
        ("marked", marked, (BW + 1, K), torch.bool),
        ("marked_pin", marked_pin, (BW + 1, K), torch.bool),
        *((n, pool[n], (B, K), torch.int32) for n in ("node_event", "node_name", "node_pred")),
        *((n, ys[n], (T, K, cap), torch.int32) for n in WINDOW_PLANES),
        ("node", state["node"], (R, K), torch.int32),
        ("root", state["root"], (R, K), torch.int32),
        ("pend", pool["pend"], (M, K), torch.int32),
        *((n, pool[n], (K,), torch.int32) for n in ("pend_pos", "pend_min")),
        ("node_drops", state["node_drops"], (K,), torch.int32),
    )


def check_inputs(marked: Tensor, marked_pin: Tensor, state: State, pool: State,
                 ys: State) -> None:
    """Raise ValueError for inputs outside the kernel's contract."""
    dev = pool["node_event"].device
    for name, t, shape, dtype in _operands(marked, marked_pin, state, pool, ys):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def launch(lib: ctypes.CDLL, marked: Tensor, marked_pin: Tensor, state: State, pool: State,
           ys: State, keys_per_block: int = 0, global_bitmaps: bool = False) -> State:
    """Run the compiled sweep on tensors on the library's device (the card
    for sm_90a builds, the CPU for the emulation build): new planes, as
    `_sweep` returns them, launched with their device current. Does not
    synchronize. `keys_per_block` 0 lets
    the kernel choose from BW and K; `global_bitmaps` puts bitmaps and
    prefix counts in a global scratch even where shared memory would hold
    them (the tests use both to run every geometry at small shapes)."""
    check_inputs(marked, marked_pin, state, pool, ys)
    B, K = pool["node_event"].shape
    T, _, cap = ys["w_event"].shape
    R, M = state["node"].shape[0], pool["pend"].shape[0]
    BW = B + T * cap
    dev = pool["node_event"].device
    out = {
        "node_event": torch.empty((B, K), dtype=torch.int32, device=dev),
        "node_name": torch.empty((B, K), dtype=torch.int32, device=dev),
        "node_pred": torch.empty((B, K), dtype=torch.int32, device=dev),
        "pinned": torch.empty((B, K), dtype=torch.bool, device=dev),
        "node_count": torch.empty((K,), dtype=torch.int32, device=dev),
        "pend_min": torch.empty((K,), dtype=torch.int32, device=dev),
        "node": torch.empty((R, K), dtype=torch.int32, device=dev),
        "root": torch.empty((R, K), dtype=torch.int32, device=dev),
        "node_drops": torch.empty((K,), dtype=torch.int32, device=dev),
        "pend": torch.empty((M, K), dtype=torch.int32, device=dev),
    }
    ins = [t for _n, t, _s, _d in _operands(marked, marked_pin, state, pool, ys)]
    ptrs = (ctypes.c_void_p * 24)(*(t.data_ptr() for t in ins + list(out.values())))
    dims = (ctypes.c_int * 7)(B, cap, BW, K, R, M, keys_per_block)
    kpb = keys_per_block or lib.gc_sweep_keys_per_block(BW, K)
    words = torch.empty(lib.gc_sweep_words(BW, K), dtype=torch.int32, device=dev)
    scratch = None
    if global_bitmaps or lib.gc_sweep_scratch_words(BW, K) > 0:
        scratch = torch.empty(-(-K // kpb) * lib.gc_sweep_block_words(BW, kpb),
                              dtype=torch.int32, device=dev)
    with on_device(dev, lib):
        stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else 0
        err = lib.gc_sweep_launch(
            ptrs, dims, words.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"gc_sweep kernel launch failed: cudaError {err}")
    return out


class GcSweep:
    """The sweep backed by the CUDA kernel (the plain sweep for CPU
    tensors). Builds the kernel at its first launch on the card."""

    #: Kernel launches, counted where the kernel is launched and nowhere
    #: else (chip_smoke.py zeroes and reads it around the main path).
    launches = 0

    def __init__(self) -> None:
        self._lib: Optional[ctypes.CDLL] = None

    def library(self) -> ctypes.CDLL:
        """Build (or reuse) and load the kernel."""
        if self._lib is None:
            self._lib = load_library(build_library())
        return self._lib

    def __call__(self, marked: Tensor, marked_pin: Tensor, state: State, pool: State,
                 ys: State) -> State:
        dev = pool["node_event"].device
        if dev.type == "cpu":
            return _sweep(marked, marked_pin, state, pool, ys)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        ys = {k: ys[k].contiguous() for k in WINDOW_PLANES}
        state = {k: state[k].contiguous() for k in STATE_OUT}
        out = launch(self.library(), marked, marked_pin, state, pool, ys)
        GcSweep.launches += 1
        return out


#: The sweep the group flush calls.
gc_sweep = GcSweep()
