"""The wrapper of the CUDA step kernel: build, bind, launch, count.

`NfaStep(query, config)` is the batched advance `(state, xs) -> (state,
ys)` with the kernel of csrc/nfa_step.cu behind it. It replaces
`pallas_step.py::build_pallas_batched_advance` of the JAX package. For
tensors on the card it launches the kernel or raises -- a failed build, a
query outside the kernel's envelope or a launch error never falls back.
For tensors on the CPU it runs the plain version (ops/step.py), which is
what the kernel is held to. Each launch allocates the kernel's scratch
lane tables (`nfa_step_scratch_words()` int32 words per key) with
`torch.empty`; the kernel allocates nothing.

Build: the query's header (ops/codegen.py) is spliced into the kernel
source, which is compiled at first use by ops/kernel_build.py (nvcc for
sm_90a into csrc/_build/, keyed by a hash of the generated source and the
flags, loaded with ctypes). `build_library(..., target="cpu")` compiles
the same source with g++ under csrc/cpu_emu.h: the tests use it to run
the kernel's own code on the CPU against the plain version. The wrapper
never uses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .codegen import XI_FIXED, field_layout, query_header, wide_masks
from .engine import WM_NONE, EngineConfig, node_window_cap
from .kernel_build import CSRC, compile_source
from .step import COUNTER_FIELDS, build_plain_step
from .tables import CompiledQuery

KERNEL_SOURCE = CSRC / "nfa_step.cu"

#: The kernel's envelope: its slot masks (3 slots per descent level) are
#: 64-bit; its stage and predicate masks are one 64-bit word up to 64
#: stages and 64 predicates and `Mask<W>` words past that (the kernel's
#: NFA_WIDE_MASKS blocks), up to 256 of each: 4 words per live set in
#: registers, and the stage table's `__constant__`/shared copy is
#: N_TAB x 256 int32 = 5 KB (of 64 KB constant, 48 KB static shared).
MAX_SLOTS = 64
MAX_PREDS = 256
MAX_STAGES = 256
#: The kernel's conditional blocks that `kernel_source` resolves.
_WIDE_IF, _WIDE_ELSE, _WIDE_END = "#if NFA_WIDE_MASKS", "#else", "#endif  // NFA_WIDE_MASKS"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def resolve_wide_blocks(src: str, wide: bool) -> str:
    """Keep one branch of each `#if NFA_WIDE_MASKS` / `#else` / `#endif
    // NFA_WIDE_MASKS` block of the kernel source (no directive lines),
    so a query with single-word masks compiles the source it always did."""
    out, branch = [], None
    for line in src.splitlines(keepends=True):
        text = line.strip()
        if branch is None and text == _WIDE_IF:
            branch = "wide"
        elif branch == "wide" and text == _WIDE_ELSE:
            branch = "narrow"
        elif branch is not None and text == _WIDE_END:
            branch = None
        elif branch is None or (branch == "wide") == wide:
            out.append(line)
    if branch is not None:
        raise ValueError("unterminated NFA_WIDE_MASKS block in the kernel source")
    return "".join(out)


def kernel_source(query: CompiledQuery, config: EngineConfig,
                  source: Path = KERNEL_SOURCE) -> str:
    """The complete kernel source for one (query, config)."""
    src = resolve_wide_blocks(Path(source).read_text(), wide_masks(query))
    return src.replace('#include "nfa_query.cuh"\n', query_header(query, config))


def kernel_signature(query: CompiledQuery, config: EngineConfig) -> str:
    """A digest of the generated source: two (query, config) pairs share a
    kernel build exactly when their signatures are equal."""
    return hashlib.sha256(kernel_source(query, config).encode()).hexdigest()[:20]


def build_library(
    query: CompiledQuery, config: EngineConfig, target: str = "sm_90a",
    build_dir: Optional[Path] = None, source: Path = KERNEL_SOURCE,
) -> Path:
    """Compile the kernel for one (query, config) and return the .so path
    (cached by a hash of the generated source and the flags). `source`
    names another kernel file (scripts/time_nfa_step.py times variants)."""
    return compile_source(kernel_source(query, config, source), "nfa_step", target, build_dir)


def load_library(path: Path) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(str(path))
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.nfa_step_launch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.nfa_step_launch.restype = ctypes.c_int
            lib.nfa_step_scratch_words.argtypes = []
            lib.nfa_step_scratch_words.restype = ctypes.c_longlong
            _libs[str(path)] = lib
    return lib


def pack_inputs(query: CompiledQuery, xs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """xi [T, K, CI] int32 (ts, topic, gidx, valid, wm, int fields,
    stateless predicate columns) and xf [T, K, NF] float32 (None when the
    schema has no float field)."""
    ints, floats = field_layout(query)
    valid = xs["valid"]
    wm = xs["wm"] if "wm" in xs else torch.full_like(xs["ts"], int(WM_NONE))
    cols = [xs["ts"], xs["topic"], xs["gidx"], valid.to(torch.int32), wm]
    assert len(cols) == len(XI_FIXED)
    cols += [xs[f"f:{n}"] for n in ints]
    xi = torch.cat(
        [torch.stack([c.to(torch.int32) for c in cols], dim=2),
         xs["spred"][..., : query.n_preds].to(torch.int32)],
        dim=2,
    ).contiguous()
    xf = None
    if floats:
        xf = torch.stack([xs[f"f:{n}"] for n in floats], dim=2).to(torch.float32).contiguous()
    return xi, xf


_STATE_IN = (
    "active", "src", "eps", "vlen", "seq", "node", "ts", "branching",
    "ignored", "root", "ver", "regs", "regs_set", "gc_phase",
)
_STATE_OUT = _STATE_IN[:-1]


def prepare(query: CompiledQuery, config: EngineConfig, state, xs, scratch_words: int):
    """Check (state, xs) against the kernel's contract, pack xi/xf and
    allocate every output and `scratch_words` int32 words of scratch per
    key. Returns (pointer array, T, K, state', ys, keep); the outputs are
    filled by `call`, and `keep` holds what must outlive the launch."""
    T, K = xs["valid"].shape
    R = config.lanes
    D = config.dewey_width(query)
    A = query.n_aggs
    P_CAP = node_window_cap(query, config)
    M_STEP = config.matches_per_step
    expect = {
        "active": ((R, K), torch.bool), "src": ((R, K), torch.int32),
        "eps": ((R, K), torch.int32), "vlen": ((R, K), torch.int32),
        "seq": ((R, K), torch.int32), "node": ((R, K), torch.int32),
        "ts": ((R, K), torch.int32), "branching": ((R, K), torch.bool),
        "ignored": ((R, K), torch.bool), "root": ((R, K), torch.int32),
        "ver": ((R, D, K), torch.int32), "regs": ((R, A, K), torch.float32),
        "regs_set": ((R, A, K), torch.bool), "gc_phase": ((K,), torch.int32),
    }
    for c in COUNTER_FIELDS:
        expect[c] = ((K,), torch.int32)
    dev = xs["valid"].device
    for name, (shape, dtype) in expect.items():
        leaf = state[name]
        if tuple(leaf.shape) != shape or leaf.dtype != dtype or leaf.device != dev:
            raise ValueError(
                f"state[{name!r}]: expected {dtype} {shape} on {dev}, got "
                f"{leaf.dtype} {tuple(leaf.shape)} on {leaf.device}"
            )
        if not leaf.is_contiguous():
            raise ValueError(f"state[{name!r}] is not contiguous")
    xi, xf = pack_inputs(query, xs)
    out = {n: torch.empty_like(state[n]) for n in _STATE_OUT}
    ctr_out = {c: torch.empty_like(state[c]) for c in COUNTER_FIELDS}
    i32 = dict(dtype=torch.int32, device=dev)
    ys = {
        "w_event": torch.empty((T, K, P_CAP), **i32),
        "w_name": torch.empty((T, K, P_CAP), **i32),
        "w_pred": torch.empty((T, K, P_CAP), **i32),
        "w_match": torch.empty((T, K, M_STEP), **i32),
        "w_mroot": torch.empty((T, K, M_STEP), **i32),
    }
    ptrs = [xi.data_ptr(), xf.data_ptr() if xf is not None else 0]
    ptrs += [state[n].data_ptr() for n in _STATE_IN]
    ptrs += [state[c].data_ptr() for c in COUNTER_FIELDS]
    ptrs += [out[n].data_ptr() for n in _STATE_OUT]
    ptrs += [ctr_out[c].data_ptr() for c in COUNTER_FIELDS]
    ptrs += [ys[k].data_ptr() for k in ("w_event", "w_name", "w_pred", "w_match", "w_mroot")]
    scratch = torch.empty(K * scratch_words, **i32)
    ptrs.append(scratch.data_ptr())
    new_state = dict(state)
    new_state.update(out)
    new_state.update(ctr_out)
    # xi/xf and the scratch ride along so they outlive the (asynchronous)
    # launch.
    keep = (xi, xf, scratch)
    return (ctypes.c_void_p * len(ptrs))(*ptrs), int(T), int(K), new_state, ys, keep


def call(lib: ctypes.CDLL, ptrs, T: int, K: int, device: torch.device) -> None:
    """One launch of the compiled kernel on the device's current stream;
    raises if the launch was refused."""
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    err = lib.nfa_step_launch(ptrs, T, K, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"nfa_step kernel launch failed: cudaError {err}")


def launch(lib: ctypes.CDLL, query: CompiledQuery, config: EngineConfig, state, xs):
    """Run the compiled step on (state, xs) with tensors on the library's
    device (the card for sm_90a builds, the CPU for the emulation build).
    Returns (state', ys); does not synchronize."""
    ptrs, T, K, new_state, ys, _keep = prepare(
        query, config, state, xs, int(lib.nfa_step_scratch_words()))
    call(lib, ptrs, T, K, xs["valid"].device)
    return new_state, ys


def check_envelope(query: CompiledQuery) -> None:
    """Raise ValueError for a query the kernel cannot take. Lanes, keys
    and Dewey digits have no limit of their own: a key's lanes live in
    the scratch, walked 32 at a time."""
    if 3 * query.max_depth > MAX_SLOTS:
        raise ValueError(
            f"descent depth {query.max_depth} needs {3 * query.max_depth} slots per "
            f"lane; the kernel's slot masks hold {MAX_SLOTS}"
        )
    if query.n_preds > MAX_PREDS:
        raise ValueError(
            f"{query.n_preds} predicates exceed the kernel's {MAX_PREDS}-bit predicate masks")
    if query.n_stages > MAX_STAGES:
        raise ValueError(
            f"{query.n_stages} stages exceed the kernel's {MAX_STAGES}-bit stage masks"
        )


class NfaStep:
    """The batched advance backed by the CUDA kernel (plain version for
    CPU tensors). Builds the kernel at its first launch on the card."""

    #: Kernel launches, counted where the kernel is launched and nowhere
    #: else (chip_smoke.py zeroes and reads it around the main path).
    launches = 0

    def __init__(self, query: CompiledQuery, config: EngineConfig) -> None:
        check_envelope(query)
        self.query = query
        self.config = config
        self._plain = build_plain_step(query, config)
        self._lib: Optional[ctypes.CDLL] = None

    def library(self) -> ctypes.CDLL:
        """Build (or reuse) and load the kernel."""
        if self._lib is None:
            self._lib = load_library(build_library(self.query, self.config))
        return self._lib

    def __call__(self, state, xs):
        if xs["valid"].device.type == "cpu":
            return self._plain(state, xs)
        if xs["valid"].device.type != "cuda":
            raise ValueError(f"unsupported device {xs['valid'].device}")
        lib = self.library()
        result = launch(lib, self.query, self.config, state, xs)
        NfaStep.launches += 1
        return result
