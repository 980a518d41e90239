"""Bytes-level checkpoint frames for the device engine and its processor.

A copy of the engine-checkpoint parts of the JAX package's
`state/serde.py`, byte-compatible with it: CRC-32C sealed frames
(`seal_frame` / `open_frame`), the length-prefixed field writer and reader,
typed array trees (name, dtype, shape, C-order bytes: the engine's state
and pool), the event registry, and the cross-shape graft that `restore`
and `resize` use. A frame sealed by either package opens in the other.

What differs from the JAX module:
  * the checksum is the native CRC-32C (native/crc32c.cc), built at first
    use; a failed build raises `NativeBuildError`. `crc32c_python`, the
    JAX module's pure-Python slicing-by-8, is kept as the reference the
    tests hold the native one to -- nothing here seals or verifies with it;
  * pickled payloads (engine keys, event keys and values, the processor's
    high-water marks) load through `loads`, whose unpickler maps the JAX
    package's module paths to the port's copies, so a JAX snapshot
    restores without importing the JAX package; any other path of that
    package is refused;
  * the host runtime's stage tables and the event-time frames are not
    copied (the port has neither yet); `carries_event_time` only
    recognises an event-time wrapper so that a processor can refuse it.
"""
from __future__ import annotations

import importlib
import io
import pickle
import struct
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.event import Event

MAGIC = b"KCT5"  # format tag + version (5: interval pinning -- pool carries
                 # pend_min, state carries per-lane chain roots; 4: paged
                 # pend ring; 3: batched leaves key-axis-last)
#: still-readable prior versions: missing leaves are synthesized on load
#: (`upgrade_pool_tree` / `upgrade_checkpoint_trees`).
COMPAT_MAGIC = (b"KCT3", b"KCT4")
#: Wrapper tag of a processor snapshot that carries event-time gate state.
ET_MAGIC = b"KCW1"


class CheckpointError(ValueError):
    """A checkpoint payload failed validation: truncated frame, trailing
    garbage, bad magic, or CRC mismatch."""


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) integrity frames
# ---------------------------------------------------------------------------
#: Seal marker for CRC-framed checkpoint payloads. Payloads themselves
#: always begin with a KCT* magic, so the marker never collides with an
#: unsealed checkpoint.
CRC_MARKER = b"KCRC"
_CRC_HEADER = struct.Struct("<IQ")  # crc32c, payload length

_crc_mod = None


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`: the
    checksum RocksDB and Kafka use for their block and record frames;
    crc32c(b"123456789") == 0xE3069283. Native (native/crc32c.cc)."""
    global _crc_mod
    if _crc_mod is None:
        from ..native import load_crc32c

        _crc_mod = load_crc32c()
    return _crc_mod.extend(crc, data)


def _crc32c_tables() -> List[List[int]]:
    """Slicing-by-8 tables for the Castagnoli polynomial (reflected
    0x82F63B78)."""
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8) for i in range(256)])
    return tables


_CRC_TABLES: Optional[List[List[int]]] = None


def crc32c_python(data: bytes, crc: int = 0) -> int:
    """The pure-Python CRC-32C (the JAX module's slicing-by-8): the
    reference the native checksum is tested against. Slow (a few MB/s);
    nothing in the port seals or verifies a frame with it."""
    global _CRC_TABLES
    if _CRC_TABLES is None:
        _CRC_TABLES = _crc32c_tables()
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC_TABLES
    crc ^= 0xFFFFFFFF
    n = len(data)
    mv = memoryview(data)
    i = 0
    end8 = n - (n % 8)
    while i < end8:
        lo = crc ^ int.from_bytes(mv[i : i + 4], "little")
        hi = int.from_bytes(mv[i + 4 : i + 8], "little")
        crc = (
            t7[lo & 0xFF]
            ^ t6[(lo >> 8) & 0xFF]
            ^ t5[(lo >> 16) & 0xFF]
            ^ t4[(lo >> 24) & 0xFF]
            ^ t3[hi & 0xFF]
            ^ t2[(hi >> 8) & 0xFF]
            ^ t1[(hi >> 16) & 0xFF]
            ^ t0[(hi >> 24) & 0xFF]
        )
        i += 8
    while i < n:
        crc = (crc >> 8) ^ t0[(crc ^ data[i]) & 0xFF]
        i += 1
    return crc ^ 0xFFFFFFFF


def seal_frame(payload: bytes) -> bytes:
    """Wrap a checkpoint payload in a CRC32C frame:
    [KCRC][u32 crc][u64 len][payload]."""
    return CRC_MARKER + _CRC_HEADER.pack(crc32c(payload), len(payload)) + payload


def open_frame(data: bytes) -> bytes:
    """Unwrap (and verify) a sealed frame; unsealed payloads pass through
    untouched (they begin with a KCT* magic, never KCRC). Raises
    `CheckpointError` on truncation, length mismatch, or CRC mismatch.
    The payload is a zero-copy view when `data` is a memoryview."""
    if bytes(data[:4]) != CRC_MARKER:
        return data
    if len(data) < 4 + _CRC_HEADER.size:
        raise CheckpointError("truncated checkpoint CRC header")
    crc, length = _CRC_HEADER.unpack_from(data, 4)
    payload = data[4 + _CRC_HEADER.size :]
    if len(payload) != length:
        raise CheckpointError(
            f"checkpoint frame length mismatch (header {length}, "
            f"payload {len(payload)})"
        )
    if crc32c(payload) != crc:
        raise CheckpointError("checkpoint CRC32C mismatch (corrupt payload)")
    return payload


def read_magic(r: "_Reader") -> int:
    """Consume and validate the 4-byte format tag; returns its version."""
    tag = bytes(r._read(4))
    if tag == MAGIC:
        return int(MAGIC[3:].decode())
    if tag in COMPAT_MAGIC:
        return int(tag[3:].decode())
    raise CheckpointError("bad checkpoint magic")


def carries_event_time(data: bytes) -> bool:
    """True when a processor snapshot is wrapped with event-time gate
    state (the JAX package's `wrap_event_time`)."""
    return bytes(open_frame(data)[:4]) == ET_MAGIC


def upgrade_pool_tree(pool: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Upgrade a KCT3 engine pool in place: synthesize the paged-ring
    cursor (`pend_pos` = one past the last occupied slot -- KCT3 rings are
    compact prefixes) and the `pinned` bitmap (the pend-reachable closure,
    re-walked host-side so pending chains survive the next GC)."""
    if "pend_pos" in pool:
        return pool
    pend = np.asarray(pool["pend"])
    pred = np.asarray(pool["node_pred"])
    B = pred.shape[0]
    valid = pend >= 0

    def closure(pend_k: np.ndarray, pred_k: np.ndarray) -> np.ndarray:
        pinned = np.zeros(B, bool)
        cur = pend_k[(pend_k >= 0) & (pend_k < B)]
        while cur.size:
            cur = np.unique(cur)
            new = cur[~pinned[cur]]
            if new.size == 0:
                break
            pinned[new] = True
            nxt = pred_k[new]
            cur = nxt[(nxt >= 0) & (nxt < B)]
        return pinned

    if pend.ndim == 1:
        pos = int(valid.nonzero()[0].max()) + 1 if valid.any() else 0
        pool["pend_pos"] = np.asarray(pos, np.int32)
        pool["pinned"] = closure(pend, pred)
    else:  # batched: key axis last ([M, K] ring, [B, K] pool)
        M, K = pend.shape
        pos = np.where(valid.any(0), M - np.argmax(valid[::-1], 0), 0)
        pool["pend_pos"] = pos.astype(np.int32)
        pinned = np.zeros((B, K), bool)
        for k in range(K):
            pinned[:, k] = closure(pend[:, k], pred[:, k])
        pool["pinned"] = pinned
    return pool


#: `pend_min` sentinel (engine._PEND_MIN_NONE): no pending match.
_PEND_MIN_NONE = np.int32(2**31 - 1)


def _chain_roots(node: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Follow predecessor pointers host-side: the chain root of each
    lane's last node (vectorized pointer-jumping; -1 stays -1)."""
    root = node.astype(np.int32).copy()
    while True:
        live = root >= 0
        if not live.any():
            break
        nxt = np.where(live, pred[np.clip(root, 0, None)], -1)
        step = live & (nxt >= 0)
        if not step.any():
            break
        root = np.where(step, nxt, root)
    return root


def upgrade_checkpoint_trees(
    state: Dict[str, np.ndarray], pool: Dict[str, np.ndarray]
) -> None:
    """Upgrade KCT3/KCT4 trees in place to the KCT5 schema: synthesize the
    pool's `pend_min` (min pinned node id -- pinned IS the pend-reachable
    set, whose minimum bounds every pending chain) and the state's
    per-lane chain roots (a host-side predecessor walk)."""
    upgrade_pool_tree(pool)
    if "pend_min" not in pool:
        pinned = np.asarray(pool["pinned"])
        any_pin = pinned.any(axis=0)
        first = np.argmax(pinned, axis=0).astype(np.int32)
        pool["pend_min"] = np.where(any_pin, first, _PEND_MIN_NONE).astype(
            np.int32
        )
    if "root" not in state:
        node = np.asarray(state["node"])
        pred = np.asarray(pool["node_pred"])
        if node.ndim == 1:
            state["root"] = _chain_roots(node, pred)
        else:  # [R, K] lanes over [B, K] pools
            R, K = node.shape
            root = np.empty((R, K), np.int32)
            for k in range(K):
                root[:, k] = _chain_roots(node[:, k], pred[:, k])
            state["root"] = root
    if "gc_phase" not in state:
        # Pre-group checkpoints carry no group-phase scalar; snapshots
        # always flush the group window first, so 0 is exact.
        state["gc_phase"] = np.zeros_like(np.asarray(state["runs"], np.int32))


# ---------------------------------------------------------------------------
# Pickled payloads
# ---------------------------------------------------------------------------
_JAX_PACKAGE = "kafkastreams_cep_tpu"
_PORT_PACKAGE = __name__.split(".", 1)[0]


class _PortUnpickler(pickle.Unpickler):
    """Loads a pickle written by either package. A class of the JAX
    package (an engine key that is a processor's `_Lane`, an event value
    of `models/`) resolves to the port's copy at the same module path;
    a path the port has no copy of is refused, so loading never imports
    the JAX package."""

    def find_class(self, module: str, name: str) -> Any:
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            ported = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
            try:
                mod = importlib.import_module(ported)
                return getattr(mod, name)
            except (ImportError, AttributeError):
                raise pickle.UnpicklingError(
                    f"{module}.{name} has no counterpart in {_PORT_PACKAGE}"
                ) from None
        return super().find_class(module, name)


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes) -> Any:
    """`pickle.loads` with the JAX package's module paths mapped to the
    port's (see `_PortUnpickler`)."""
    return _PortUnpickler(io.BytesIO(data)).load()


class _Writer:
    def __init__(self) -> None:
        self._buf = io.BytesIO()

    def u8(self, v: int) -> None:
        self._buf.write(struct.pack("<B", v))

    def i32(self, v: int) -> None:
        self._buf.write(struct.pack("<i", v))

    def i64(self, v: int) -> None:
        self._buf.write(struct.pack("<q", v))

    def blob(self, data: bytes) -> None:
        self._buf.write(struct.pack("<I", len(data)))
        self._buf.write(data)

    def text(self, s: str) -> None:
        self.blob(s.encode("utf-8"))

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


class _Reader:
    """Reads a payload in place: `blob()` returns zero-copy memoryview
    slices, so a large array blob is not copied before it is decoded."""

    def __init__(self, data: bytes) -> None:
        self._data = memoryview(data)
        self._pos = 0

    def _read(self, n: int) -> bytes:
        end = self._pos + n
        if end > len(self._data):
            raise CheckpointError("truncated checkpoint frame")
        out = self._data[self._pos:end]
        self._pos = end
        return out

    def expect_end(self) -> None:
        """Every decode entry point must consume its payload exactly:
        trailing garbage means a framing bug or a corrupt/foreign blob."""
        if self._pos != len(self._data):
            raise CheckpointError(
                f"checkpoint frame carries {len(self._data) - self._pos} "
                "trailing byte(s) past the decoded payload"
            )

    def u8(self) -> int:
        return struct.unpack("<B", self._read(1))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._read(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._read(8))[0]

    def blob(self) -> memoryview:
        (n,) = struct.unpack("<I", self._read(4))
        return self._read(n)

    def text(self) -> str:
        return bytes(self.blob()).decode("utf-8")


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------
def put_event(w: _Writer, event: Optional[Event]) -> None:
    """One event's frame (the JAX `CheckpointCodec._put_event`)."""
    if event is None:
        w.u8(0)
        return
    w.u8(1)
    w.blob(dumps(event.key))
    w.blob(dumps(event.value))
    w.i64(event.timestamp)
    w.text(event.topic)
    w.i32(event.partition)
    w.i64(event.offset)


def get_event(r: _Reader) -> Optional[Event]:
    if r.u8() == 0:
        return None
    key = loads(r.blob())
    value = loads(r.blob())
    ts = r.i64()
    topic = r.text()
    partition = r.i32()
    offset = r.i64()
    return Event(key, value, ts, topic, partition, offset)


def encode_event_registry(events: Dict[int, Event]) -> bytes:
    w = _Writer()
    w._buf.write(MAGIC)
    w.i32(len(events))
    for gidx, event in events.items():
        w.i64(gidx)
        put_event(w, event)
    return seal_frame(w.getvalue())


def decode_event_registry(data: bytes) -> Dict[int, Event]:
    r = _Reader(open_frame(data))
    if r._read(4) != MAGIC:
        raise CheckpointError("bad checkpoint magic")
    out: Dict[int, Event] = {}
    for _ in range(r.i32()):
        gidx = r.i64()
        out[gidx] = get_event(r)
    r.expect_end()
    return out


# ---------------------------------------------------------------------------
# Device state frames
# ---------------------------------------------------------------------------
def encode_array_tree(tree: Dict[str, Any]) -> bytes:
    """Raw typed frames for a flat dict of arrays (the device state dict)."""
    w = _Writer()
    w._buf.write(MAGIC)
    w.i32(len(tree))
    for name in sorted(tree):
        arr = np.ascontiguousarray(tree[name])
        w.text(name)
        w.text(str(arr.dtype))
        w.i32(arr.ndim)
        for dim in arr.shape:
            w.i64(dim)
        w.blob(memoryview(arr).cast("B") if arr.size else b"")
    return seal_frame(w.getvalue())


def decode_array_tree(data: bytes) -> Dict[str, np.ndarray]:
    r = _Reader(open_frame(data))
    if r._read(4) != MAGIC:
        raise CheckpointError("bad checkpoint magic")
    out: Dict[str, np.ndarray] = {}
    for _ in range(r.i32()):
        name = r.text()
        dtype = np.dtype(r.text())
        shape = tuple(r.i64() for _ in range(r.i32()))
        raw = r.blob()
        try:
            out[name] = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        except ValueError as exc:
            raise CheckpointError(f"array leaf {name!r}: {exc}") from None
    r.expect_end()
    return out


class ShapeRestoreError(CheckpointError):
    """Cross-shape restore refused: the snapshot's LIVE occupancy does
    not fit the target shape. Raised instead of silently truncating."""


def check_restore_capacity(
    state: Dict[str, Any],
    pool: Dict[str, Any],
    *,
    lanes: int,
    nodes: int,
    matches: int,
    where: str = "restore",
) -> None:
    """Refuse loudly when a snapshot's live occupancy exceeds the target
    capacity (`ShapeRestoreError`). The checks lean on the engine's
    compaction invariants: GC folds live nodes to the region prefix
    `[0, node_count)` and the pend ring is a dense prefix
    `[0, pend_pos)`, so prefix extents bound every live id."""
    problems = []
    active = np.asarray(state["active"])
    if active.ndim >= 1 and active.shape[0] > lanes:
        # Lanes are NOT compacted to a prefix: any live run in a lane
        # beyond the target extent blocks the shrink.
        lane_live = active.reshape(active.shape[0], -1).any(axis=1)
        if bool(lane_live[lanes:].any()):
            top = int(np.nonzero(lane_live)[0].max())
            problems.append(f"live run in lane {top} >= target lanes {lanes}")
    node_count = np.asarray(pool["node_count"])
    if int(node_count.max(initial=0)) > nodes:
        problems.append(
            f"node_count {int(node_count.max(initial=0))} > target nodes {nodes}"
        )
    pend_pos = np.asarray(pool["pend_pos"])
    if int(pend_pos.max(initial=0)) > matches:
        problems.append(
            f"pend_pos {int(pend_pos.max(initial=0))} > target matches {matches}"
        )
    # Defensive id bound: every stored node id (match chains, run
    # cursors, predecessor links) must address the target region.
    max_id = -1
    for tree, name in ((state, "node"), (state, "root"),
                       (pool, "node_pred"), (pool, "pend")):
        arr = np.asarray(tree[name])
        if arr.size:
            max_id = max(max_id, int(arr.max()))
    if max_id >= nodes:
        problems.append(f"stored node id {max_id} >= target nodes {nodes}")
    if problems:
        raise ShapeRestoreError(
            f"{where}: snapshot does not fit target shape "
            f"(lanes={lanes}, nodes={nodes}, matches={matches}): "
            + "; ".join(problems)
        )


def graft_array_tree(
    src: Dict[str, Any], target: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Paste `src` leaves into freshly initialized `target` leaves,
    slicing every axis to the common extent (in place; returns target).

    Correct for the device trees because capacity pads carry init values
    (node planes -1, pend ring -1, pinned False) and the live content is
    compacted to axis prefixes -- callers gate on
    `check_restore_capacity` first so nothing live is ever cut."""
    for name, dst in target.items():
        if name not in src:
            continue
        arr = np.asarray(src[name])
        if arr.ndim != dst.ndim:
            raise ShapeRestoreError(
                f"graft: leaf {name!r} rank mismatch "
                f"({arr.ndim} vs {dst.ndim})"
            )
        sl = tuple(
            slice(0, min(a, b)) for a, b in zip(arr.shape, dst.shape)
        )
        dst[sl] = arr[sl].astype(dst.dtype, copy=False)
    return target
