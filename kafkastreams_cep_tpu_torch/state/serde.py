"""Bytes-level checkpoint frames for the host stores, the device engine and
its processor.

A copy of the JAX package's `state/serde.py`, byte-compatible with it:
CRC-32C sealed frames (`seal_frame` / `open_frame`), the length-prefixed
field writer and reader, the host runtime's `CheckpointCodec` (per-key
NFA states with stages referenced by id against the recompiled query,
lineage buffers, fold registers, and a query's three stores as one blob),
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
  * events are framed by `put_event` / `get_event` (the JAX codec's
    `_put_event` / `_get_event` and its `_EventOnly` subclass, as
    functions), which `CheckpointCodec` calls with its own serializers
    and the event registry with the defaults. The event-time
    gate frames (`encode_event_time_state`, `wrap_event_time`) are the
    JAX package's, byte for byte.
"""
from __future__ import annotations

import importlib
import io
import pickle
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.dewey import DeweyVersion
from ..core.event import Event
from ..pattern.stages import Stage, Stages
from .aggregates import AggregatesStore
from .buffer import BufferNode, BufferStore, SharedVersionedBuffer
from .nfa_store import NFAStates, NFAStore

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
def put_event(w: _Writer, event: Optional[Event],
              serialize: Callable[[Any], bytes] = dumps) -> None:
    """One event's frame (the JAX `CheckpointCodec._put_event`); key and
    value through `serialize`."""
    if event is None:
        w.u8(0)
        return
    w.u8(1)
    w.blob(serialize(event.key))
    w.blob(serialize(event.value))
    w.i64(event.timestamp)
    w.text(event.topic)
    w.i32(event.partition)
    w.i64(event.offset)


def get_event(r: _Reader, deserialize: Callable[[bytes], Any] = loads) -> Optional[Event]:
    if r.u8() == 0:
        return None
    key = deserialize(r.blob())
    value = deserialize(r.blob())
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
# Host stores (the host runtime's changelogs and snapshots)
# ---------------------------------------------------------------------------
class CheckpointCodec:
    """Codec bound to one compiled query (stages re-linked by index).

    The stage table must be the same compile output shape on encode and
    decode -- the reference makes the same assumption when it rebuilds
    stages from ids against the recompiled pattern
    (ComputationStageSerde.java:90-101). User keys and values go through
    `serialize` / `deserialize` (pickle by default; `loads` maps the JAX
    package's module paths to the port's).
    """

    def __init__(
        self,
        stages: Stages,
        serialize: Callable[[Any], bytes] = dumps,
        deserialize: Callable[[bytes], Any] = loads,
        strict_windows: bool = False,
    ) -> None:
        self.stages = stages
        self._stage_list: List[Stage] = list(stages)
        self._index_of: Dict[int, int] = {id(s): i for i, s in enumerate(self._stage_list)}
        self._ser = serialize
        self._de = deserialize
        self.strict_windows = strict_windows

    # ---------------------------------------------------------------- stages
    def _stage_ref(self, stage: Stage) -> Tuple[int, int]:
        """(compiled index, epsilon-target index | -1) for a runtime stage."""
        idx = self._index_of.get(id(stage))
        if idx is not None:
            return idx, -1
        # Synthesized epsilon: identity is a compiled stage (same id/name),
        # target is its single PROCEED edge.
        target = stage.edges[0].target
        tgt_idx = self._index_of.get(id(target))
        src_idx = next(
            (i for i, s in enumerate(self._stage_list)
             if s.id == stage.id and s.name == stage.name and s.type == stage.type),
            None,
        )
        if src_idx is None or tgt_idx is None:
            raise ValueError(f"stage {stage!r} does not belong to this query")
        return src_idx, tgt_idx

    def _resolve_stage(self, idx: int, eps_target: int) -> Stage:
        stage = self._stage_list[idx]
        if eps_target < 0:
            return stage
        target = self._stage_list[eps_target]
        eps = Stage.new_epsilon(stage, target)
        if self.strict_windows:
            eps.window_ms = target.window_ms if target.window_ms != -1 else stage.window_ms
        return eps

    # ------------------------------------------------------------- NFAStates
    def encode_nfa_states(self, snap: NFAStates) -> bytes:
        """Frame: run queue (stage ids + versions + embedded last events),
        runs counter, offset high-water marks
        (NFAStateValueSerde.java:79-116)."""
        w = _Writer()
        w._buf.write(MAGIC)
        w.i32(len(snap.computation_stages))
        for cs in snap.computation_stages:
            src, eps = self._stage_ref(cs.stage)
            w.i32(src)
            w.i32(eps)
            w.i32(len(cs.version.digits))
            for d in cs.version.digits:
                w.i32(d)
            w.i64(cs.sequence)
            w.i64(cs.timestamp)
            w.u8(1 if cs.is_branching else 0)
            w.u8(1 if cs.is_ignored else 0)
            w.i64(cs.last_node if cs.last_node is not None else -1)
            put_event(w, cs.last_event, self._ser)
        w.i64(snap.runs)
        w.i32(len(snap.latest_offsets))
        for topic, offset in snap.latest_offsets.items():
            w.text(topic)
            w.i64(offset)
        return seal_frame(w.getvalue())

    def decode_nfa_states(self, data: bytes) -> NFAStates:
        from ..nfa.nfa import ComputationStage

        r = _Reader(open_frame(data))
        read_magic(r)
        queue = []
        for _ in range(r.i32()):
            src = r.i32()
            eps = r.i32()
            digits = tuple(r.i32() for _ in range(r.i32()))
            sequence = r.i64()
            timestamp = r.i64()
            is_branching = bool(r.u8())
            is_ignored = bool(r.u8())
            last_node = r.i64()
            last_event = get_event(r, self._de)
            queue.append(ComputationStage(
                stage=self._resolve_stage(src, eps),
                version=DeweyVersion(digits),
                sequence=sequence,
                last_event=last_event,
                timestamp=timestamp,
                is_branching=is_branching,
                is_ignored=is_ignored,
                last_node=None if last_node < 0 else last_node,
            ))
        runs = r.i64()
        offsets = {}
        for _ in range(r.i32()):
            topic = r.text()
            offsets[topic] = r.i64()
        r.expect_end()
        return NFAStates(queue, runs, offsets)

    # ---------------------------------------------------------------- buffer
    def encode_buffer(self, buffer: SharedVersionedBuffer) -> bytes:
        """Node frame: id, stage name, embedded event, parent id
        (MatchedEventSerde.java:86-118 analog, minus refcounts --
        reclamation is mark-sweep here)."""
        w = _Writer()
        w._buf.write(MAGIC)
        w.i64(buffer._next_id)
        w.i32(len(buffer._nodes))
        for node_id, node in buffer._nodes.items():
            w.i64(node_id)
            w.text(node.stage_name)
            put_event(w, node.event, self._ser)
            w.i64(node.parent if node.parent is not None else -1)
        return seal_frame(w.getvalue())

    def decode_buffer(self, data: bytes) -> SharedVersionedBuffer:
        r = _Reader(open_frame(data))
        read_magic(r)
        buffer: SharedVersionedBuffer = SharedVersionedBuffer()
        buffer._next_id = r.i64()
        for _ in range(r.i32()):
            node_id = r.i64()
            stage_name = r.text()
            event = get_event(r, self._de)
            parent = r.i64()
            buffer._nodes[node_id] = BufferNode(stage_name, event, None if parent < 0 else parent)
        r.expect_end()
        return buffer

    # ------------------------------------------------------------ aggregates
    def encode_aggregates(self, store: AggregatesStore) -> bytes:
        """(record key, name, run id) -> value frames
        (AggregateKeySerde.java:107-121 analog)."""
        w = _Writer()
        w._buf.write(MAGIC)
        entries = list(store.items())
        w.i32(len(entries))
        for (key, name, sequence), value in entries:
            w.blob(self._ser(key))
            w.text(name)
            w.i64(sequence)
            w.blob(self._ser(value))
        return seal_frame(w.getvalue())

    def decode_aggregates(self, data: bytes) -> AggregatesStore:
        r = _Reader(open_frame(data))
        read_magic(r)
        store = AggregatesStore()
        for _ in range(r.i32()):
            key = self._de(r.blob())
            name = r.text()
            sequence = r.i64()
            value = self._de(r.blob())
            store.put(key, name, sequence, value)
        r.expect_end()
        return store

    # ---------------------------------------------------- query-level stores
    def encode_query_stores(
        self, nfa_store: NFAStore, buffers: BufferStore, aggregates: AggregatesStore,
    ) -> bytes:
        """One checkpoint blob for a query's three stores -- the changelog
        record equivalent (README.md:350-355 store naming scheme)."""
        w = _Writer()
        w._buf.write(MAGIC)
        nfa_entries = list(nfa_store.items())
        w.i32(len(nfa_entries))
        for key, snap in nfa_entries:
            w.blob(self._ser(key))
            w.blob(self.encode_nfa_states(snap))
        buf_entries = list(buffers.items())
        w.i32(len(buf_entries))
        for key, buffer in buf_entries:
            w.blob(self._ser(key))
            w.blob(self.encode_buffer(buffer))
        w.blob(self.encode_aggregates(aggregates))
        return seal_frame(w.getvalue())

    def decode_query_stores(self, data: bytes) -> Tuple[NFAStore, BufferStore, AggregatesStore]:
        r = _Reader(open_frame(data))
        read_magic(r)
        nfa_store = NFAStore()
        for _ in range(r.i32()):
            key = self._de(r.blob())
            nfa_store.put(key, self.decode_nfa_states(r.blob()))
        buffers = BufferStore()
        for _ in range(r.i32()):
            key = self._de(r.blob())
            buffers.set_for_key(key, self.decode_buffer(r.blob()))
        aggregates = self.decode_aggregates(r.blob())
        r.expect_end()
        return nfa_store, buffers, aggregates


# ---------------------------------------------------------------------------
# Event-time gate frames
# ---------------------------------------------------------------------------
def encode_event_time_state(state: Dict[str, Any]) -> bytes:
    """Seal an `EventTimeGate.snapshot_state()` dict, byte for byte the
    JAX package's frame: watermark-generator kind + state, per-key release
    clocks, forced/observed marks, the arrival sequence, every key's
    buffered (seq, Event) entries in (ts, seq) order, the late side output
    and the arrival high-water marks (`{}` from the device processor,
    whose marks ride its own frame)."""
    w = _Writer()
    w._buf.write(MAGIC)
    w.text(state["gen_kind"])
    w.blob(dumps(state["gen_state"]))
    clocks = state["clocks"]
    w.i32(len(clocks))
    for key in clocks:
        w.blob(dumps(key))
        w.i64(clocks[key])
    w.i64(state["forced_wm"])
    w.i64(state["max_seen"])
    w.i64(state["seq"])
    buffers = state["buffers"]
    w.i32(len(buffers))
    for key in buffers:
        w.blob(dumps(key))
        entries = buffers[key]
        w.i32(len(entries))
        for _ts, seq, ev in entries:
            w.i64(seq)
            put_event(w, ev)
    late = state["late"]
    w.i32(len(late))
    for ev in late:
        put_event(w, ev)
    w.blob(dumps(state.get("hwm", {})))
    return seal_frame(w.getvalue())


def decode_event_time_state(data: bytes) -> Dict[str, Any]:
    r = _Reader(open_frame(data))
    read_magic(r)
    out: Dict[str, Any] = {"gen_kind": r.text(), "gen_state": loads(r.blob())}
    clocks: Dict[Any, int] = {}
    for _ in range(r.i32()):
        ck = loads(r.blob())
        clocks[ck] = r.i64()
    out["clocks"] = clocks
    out["forced_wm"] = r.i64()
    out["max_seen"] = r.i64()
    out["seq"] = r.i64()
    buffers: Dict[Any, list] = {}
    for _ in range(r.i32()):
        key = loads(r.blob())
        entries = []
        for _ in range(r.i32()):
            seq = r.i64()
            ev = get_event(r)
            entries.append((ev.timestamp, seq, ev))
        buffers[key] = entries
    out["buffers"] = buffers
    out["late"] = [get_event(r) for _ in range(r.i32())]
    out["hwm"] = loads(r.blob())  # cep: serde-ok(arrival HWMs are consumed by CEPProcessor.restore_event_time, not the gate; the device runtime encodes {})
    r.expect_end()
    return out


def wrap_event_time(inner: bytes, gate_bytes: bytes) -> bytes:
    """Wrap a processor snapshot with its event-time gate frame."""
    w = _Writer()
    w._buf.write(ET_MAGIC)
    w.blob(inner)
    w.blob(gate_bytes)
    return seal_frame(w.getvalue())


def split_event_time(data: bytes) -> Tuple[bytes, Optional[bytes]]:
    """(inner snapshot, gate frame | None): the inverse of
    `wrap_event_time`. A snapshot without the wrapper passes through with
    gate None."""
    payload = open_frame(data)
    if bytes(payload[:4]) != ET_MAGIC:
        return data, None
    r = _Reader(payload)
    r._read(4)
    inner = bytes(r.blob())
    gate = bytes(r.blob())
    r.expect_end()
    return inner, gate


# ---------------------------------------------------------------------------
# Device state frames
# ---------------------------------------------------------------------------
def encode_array_tree(tree: Dict[str, Any]) -> bytes:
    """Raw typed frames for a flat dict of arrays (the device state dict)."""
    w = _Writer()
    w._buf.write(MAGIC)
    w.i32(len(tree))
    for name in sorted(tree):
        # The shape of the array as given (a scalar leaf stays 0-d: the
        # contiguous copy below would make it (1,)).
        arr = np.asarray(tree[name])
        w.text(name)
        w.text(str(arr.dtype))
        w.i32(arr.ndim)
        for dim in arr.shape:
            w.i64(dim)
        w.blob(memoryview(np.ascontiguousarray(arr)).cast("B") if arr.size else b"")
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


# ---------------------------------------------------------------------------
# Shard checkpoints (live migration)
# ---------------------------------------------------------------------------
#: Format tag for a self-contained movable shard: everything a successor
#: driver on another broker needs to resume a fenced shard mid-stream --
#: consumer positions, per-broker transport sessions (the idempotent-
#: producer identity, so server-side dedup spans the move), and per-query
#: store/emission/event-time state. Distinct from KCT*/KCW1 so a shard
#: frame can never be mistaken for an engine or gate snapshot.
SHARD_MAGIC = b"KSH1"
#: Tag of the port's optional shard-frame trailer: per query, the digests
#: its emission gate recovered after a crash that replay had not yet
#: regenerated when the frame was cut (streams/emission.py). It is written
#: only when there are some, so every other frame is byte for byte the JAX
#: package's, which has no such state (and refuses the trailer).
SHARD_RECOVERED_TAG = b"KSHR"


def encode_shard_checkpoint(shard: Dict[str, Any]) -> bytes:
    """Seal one shard's movable state. Schema (all keys required):

    - ``shard_id``: str -- the shard's stable name (also the app-id salt
      for its changelog topics).
    - ``group``: str -- the shard driver's consumer group.
    - ``positions``: {(topic, partition): pos} -- committed consumer
      positions at the fence point (`LogDriver.positions()`).
    - ``sessions``: {broker_label: (session_bytes, seq)} -- per-broker
      `SocketRecordLog.session_state()`; the successor client adopts
      both so the broker's seq->offset dedup table keeps covering
      appends issued before the move.
    - ``queries``: {qname: {"runtime": str, "stores": bytes | None,
      "sink_pos": {topic: pos}, "event_time": bytes | None}} -- the
      store snapshot (host: `CheckpointCodec.encode_query_stores`;
      device: `processor.snapshot()`), the EmissionGate watermark, and
      the sealed event-time gate frame; optionally also "recovered":
      [16-byte digest], the gate's outstanding recovered digests, which
      go into the trailer.
    """
    w = _Writer()
    w._buf.write(SHARD_MAGIC)
    w.text(shard["shard_id"])
    w.text(shard["group"])
    positions = shard["positions"]
    w.i32(len(positions))
    for (topic, partition) in sorted(positions):
        w.text(topic)
        w.i32(int(partition))
        w.i64(int(positions[(topic, partition)]))
    sessions = shard["sessions"]
    w.i32(len(sessions))
    for label in sorted(sessions):
        session, seq = sessions[label]
        w.text(str(label))
        w.blob(bytes(session))
        w.i64(int(seq))
    queries = shard["queries"]
    w.i32(len(queries))
    for qname in sorted(queries):
        q = queries[qname]
        w.text(qname)
        w.text(q["runtime"])
        stores = q.get("stores")
        w.u8(0 if stores is None else 1)
        if stores is not None:
            w.blob(stores)
        sink_pos = q.get("sink_pos") or {}
        w.i32(len(sink_pos))
        for topic in sorted(sink_pos):
            w.text(topic)
            w.i64(int(sink_pos[topic]))
        gate = q.get("event_time")
        w.u8(0 if gate is None else 1)
        if gate is not None:
            w.blob(gate)
    recovered = {
        qname: sorted(bytes(d) for d in queries[qname]["recovered"])
        for qname in sorted(queries) if queries[qname].get("recovered")
    }
    if recovered:
        w._buf.write(SHARD_RECOVERED_TAG)
        w.i32(len(recovered))
        for qname, digests in recovered.items():
            w.text(qname)
            w.i32(len(digests))
            for digest in digests:
                w.blob(digest)
    return seal_frame(w.getvalue())


def decode_shard_checkpoint(data: bytes) -> Dict[str, Any]:
    """Inverse of `encode_shard_checkpoint`; raises `CheckpointError` on
    a corrupt frame or a non-shard payload."""
    r = _Reader(open_frame(data))
    if r._read(4) != SHARD_MAGIC:
        raise CheckpointError("bad shard checkpoint magic")
    out: Dict[str, Any] = {
        "shard_id": r.text(),
        "group": r.text(),
    }
    positions: Dict[Tuple[str, int], int] = {}
    for _ in range(r.i32()):
        topic = r.text()
        partition = r.i32()
        positions[(topic, partition)] = r.i64()
    out["positions"] = positions
    sessions: Dict[str, Tuple[bytes, int]] = {}
    for _ in range(r.i32()):
        label = r.text()
        session = r.blob()
        sessions[label] = (session, r.i64())
    out["sessions"] = sessions
    queries: Dict[str, Dict[str, Any]] = {}
    for _ in range(r.i32()):
        qname = r.text()
        q: Dict[str, Any] = {"runtime": r.text()}
        q["stores"] = r.blob() if r.u8() else None
        sink_pos: Dict[str, int] = {}
        for _ in range(r.i32()):
            topic = r.text()
            sink_pos[topic] = r.i64()
        q["sink_pos"] = sink_pos
        q["event_time"] = r.blob() if r.u8() else None
        queries[qname] = q
    out["queries"] = queries
    if r._pos < len(r._data):
        if r._read(4) != SHARD_RECOVERED_TAG:
            raise CheckpointError("bad shard checkpoint trailer")
        for _ in range(r.i32()):
            q = queries.get(r.text())
            if q is None:
                raise CheckpointError("shard checkpoint trailer names no query")
            q["recovered"] = [bytes(r.blob()) for _ in range(r.i32())]
    r.expect_end()
    return out
