"""The GC mark: the wrapper of csrc/gc_mark.cu and its plain version.

`gc_mark(marked, frontier, pred)` marks, per key, every node reachable
from `frontier` ([F, K] node ids, -1 = hole) along `pred` ([BW, K]),
stopping at nodes already marked; `marked` is the [BW + 1, K] bool seed
with a trash row at BW, returned as given. Both walks of the group-flush
GC (ops/engine.py `build_gc`) run through it: the page-root walk (without
`pin_interval`) and the lane-root walk. So does the pool drain's closure
walk (ops/engine.py `drain_compact`): an all-false seed, the ring's first
max(pend_pos) rows as the frontier (-1 holes included) and the region's
preds alone (BW = B).

For tensors on the card it launches the kernel of csrc/gc_mark.cu (the
seed packed into bit words by a coalesced grid, each key's words walked
in shared memory to the fixed point, unpacked by a second coalesced
grid), so the flush issues no host read;
a failed build or a refused launch raises, nothing falls back. For
tensors on the CPU it runs `_walk`, the plain version, which the kernel
is held to bitwise (on the card by chip_smoke.py, on the CPU through the
kernel's g++ emulation build). `_walk` asks the host every 8 hops whether
a cursor is still live: on CPU tensors that read is free.

The kernel replaces the `walk` while_loop of the JAX package's
`ops/engine.py` `build_gc` (lines 1118-1134), which XLA keeps on the
device; it is built once per target, not per query, by
ops/kernel_build.py.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from .kernel_build import CSRC, compile_source

Tensor = torch.Tensor
KERNEL_SOURCE = CSRC / "gc_mark.cu"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _walk(marked: Tensor, frontier: Tensor, pred: Tensor) -> Tensor:
    """The plain mark: walk every frontier cursor along `pred`, marking
    nodes; a cursor stops at a node that was marked already. Dead cursors
    mark the trash row BW, which is then given back as it came. The live
    check reads the host every 8 hops (the extra hops of a finished walk
    are no-ops)."""
    BW = pred.shape[0]
    seed_trash = marked[BW:]
    fr = frontier
    while True:
        for _ in range(8):
            live = fr >= 0
            cidx = torch.where(live, fr, torch.full_like(fr, BW)).long()
            already = torch.gather(marked, 0, cidx) & live
            marked = marked.scatter(0, cidx, torch.ones_like(already))
            nxt = torch.gather(pred, 0, cidx.clamp(max=BW - 1))
            fr = torch.where(live & ~already, nxt, torch.full_like(nxt, -1))
        if not bool((fr >= 0).any()):
            return torch.cat([marked[:BW], seed_trash])


def build_library(target: str = "sm_90a", build_dir: Optional[Path] = None) -> Path:
    """Compile csrc/gc_mark.cu (cached by a hash of source and flags)."""
    return compile_source(KERNEL_SOURCE.read_text(), "gc_mark", target, build_dir)


def load_library(path: Path) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(str(path))
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.gc_mark_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.gc_mark_launch.restype = ctypes.c_int
            for fn, res in (("gc_mark_words", ctypes.c_longlong),
                            ("gc_mark_smem_bytes", ctypes.c_longlong),
                            ("gc_mark_keys_per_block", ctypes.c_int)):
                getattr(lib, fn).argtypes = [ctypes.c_int, ctypes.c_int]
                getattr(lib, fn).restype = res
            _libs[str(path)] = lib
    return lib


def check_inputs(marked: Tensor, frontier: Tensor, pred: Tensor) -> None:
    """Raise ValueError for inputs outside the kernel's contract."""
    BW, K = pred.shape
    dev = pred.device
    for name, t, shape, dtype in (
        ("marked", marked, (BW + 1, K), torch.bool),
        ("frontier", frontier, (frontier.shape[0], K), torch.int32),
        ("pred", pred, (BW, K), torch.int32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if frontier.dim() != 2:
        raise ValueError("frontier must be [F, K]")


def launch(lib: ctypes.CDLL, marked: Tensor, frontier: Tensor, pred: Tensor,
           keys_per_block: int = 0, global_bitmaps: bool = False) -> Tensor:
    """Run the compiled mark on tensors on the library's device (the card
    for sm_90a builds, the CPU for the emulation build): a new [BW + 1, K]
    bool tensor. Does not synchronize. `keys_per_block` 0 lets the kernel
    choose the walk's keys a block from BW and K; `global_bitmaps` walks in
    place in the packed words even where shared memory would hold them
    (the tests use both to run every geometry at small shapes)."""
    check_inputs(marked, frontier, pred)
    BW, K = pred.shape
    F = frontier.shape[0]
    out = torch.empty_like(marked)
    words = torch.empty(lib.gc_mark_words(BW, K), dtype=torch.int32, device=pred.device)
    stream = (torch.cuda.current_stream(pred.device).cuda_stream
              if pred.device.type == "cuda" else 0)
    err = lib.gc_mark_launch(
        marked.data_ptr(), frontier.data_ptr(), pred.data_ptr(), out.data_ptr(), F, BW, K,
        keys_per_block, words.data_ptr(), int(global_bitmaps), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"gc_mark kernel launch failed: cudaError {err}")
    return out


class GcMark:
    """The mark backed by the CUDA kernel (the plain walk for CPU
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

    def __call__(self, marked: Tensor, frontier: Tensor, pred: Tensor) -> Tensor:
        if pred.device.type == "cpu":
            return _walk(marked, frontier, pred)
        if pred.device.type != "cuda":
            raise ValueError(f"unsupported device {pred.device}")
        out = launch(self.library(), marked, frontier.contiguous(), pred)
        GcMark.launches += 1
        return out


#: The mark both GC walks call.
gc_mark = GcMark()
