"""Wire transport: the RecordLog contract over length-framed sockets.

A copy of the JAX package's `streams/transport.py`; the wire format is
that package's byte for byte, so a client of either package talks to a
server of either.

`streams/log.py` documents `RecordLog` as "the seam where one would plug
in" a real Kafka client; until this module, every byte the engine ever
moved went through that file-backed shim in-process. This is the seam
filled in: a stdlib-`socket` server (`RecordLogServer`) fronting any
`RecordLog`, and a client (`SocketRecordLog`) that implements the exact
same contract -- `append`/`read`/`end_offset` per (topic, partition) with
None-tombstone framing preserved -- so `LogDriver`, `EmissionGate`, and
the changelog stores run over real connections unchanged.

Wire framing (one frame per request and per response)::

    +----------------+----------------+----------------------------------+
    | u32 len        | u32 crc32c     | payload (len bytes)              |
    +----------------+----------------+----------------------------------+
    payload := [u8 op][u64 seq][op-specific body]

Every frame is CRC-sealed (the same crc32c as the checkpoint codec,
state/serde.py). A torn frame -- mid-frame EOF, oversized length, or CRC
mismatch -- is never partially applied: the receiver discards it, counts
`cep_transport_torn_frames_total{role}`, and drops the connection, so
resync always happens on a clean frame boundary (the wire analog of
`RecordLog._load`'s truncate-at-torn-tail recovery).

Robustness model:

- **Reconnect/backoff.** Connection loss is transient: the client closes
  the socket, then retries with seeded-jitter exponential backoff under a
  retry budget (`cep_transport_retries_total{site}`; the raw connect also
  runs under `faults.with_retry`). Budget exhaustion raises
  `TransportError` -- fail-stop, like `RecordLog.flush`.
- **Exactly-once appends.** The client holds every unacknowledged request
  in a FIFO and replays it verbatim after reconnect. Appends carry a
  (16-byte session id, monotone u64 seq) identity; the server keeps a
  bounded per-session seq->offset map and suppresses replayed appends
  (`cep_transport_dedup_total`) -- the Kafka idempotent-producer model.
  Reads/end_offset/flush are idempotent and simply re-execute. Combined
  with the `EmissionGate` digests + committed sink watermark,
  sink emission stays exactly-once across mid-emit disconnects.
- **Propagated backpressure.** `window` > 1 pipelines appends but bounds
  them: when the in-flight window is full, `append()` BLOCKS draining
  acks (`cep_transport_backpressure_total`), never buffering unboundedly.
  Server-side, requests are applied inline on the peer's reader thread,
  so a stalled apply stops socket reads and the kernel's TCP buffers
  backpressure the producer -- `on_overflow=block` end to end. Windowed
  offsets are client-predicted and ack-verified; exact prediction assumes
  the idempotent-producer deployment (one producer per partition).
- **Heartbeat/stall detection.** With `heartbeat_s` set, an idle client
  pings; a peer that stops answering within `io_timeout_s` is a stall
  (`cep_transport_stalls_total`) and triggers the reconnect path. Client
  `health()` (freshness, window occupancy, reconnect counts) is surfaced
  through `LogDriver.health()` into `/healthz`.
- **Broker death.** An `InjectedCrash` inside the backing log (the
  `log.torn_append` site) kills the "broker": the server drops every
  connection and reopens its file-backed log -- the reload truncates the
  torn tail -- while producer sessions survive (the idempotent-producer
  state a real broker keeps replicated in the log), so client replays
  still dedup. Clients just see a disconnect and recover.

Fault sites (faults/injection.py): `net.partial_write` lands half a frame
on the socket then severs, `net.disconnect` severs between frames,
`net.stall` freezes the server's apply loop past the client's IO deadline.

All threads are named daemons (`kct-transport-accept`,
`kct-transport-peer-N`, `kct-transport-heartbeat`) and all shared maps are
lock-guarded, per the ceplint `threads` checker.
"""
from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..faults import injection as _flt
from ..faults.injection import InjectedCrash, TransientFault, with_retry
from ..state.serde import crc32c
from .log import LogRecord, RecordLog

__all__ = [
    "MAX_FRAME",
    "RecordLogServer",
    "SocketRecordLog",
    "TransportError",
    "WIRE_VERSION",
]

WIRE_VERSION = 1
#: Frame header: payload length, crc32c(payload).
_FRAME = struct.Struct("<II")
#: Hard cap on one frame's payload: a torn/garbage length field must fail
#: fast as a torn frame, not allocate gigabytes.
MAX_FRAME = 64 * 1024 * 1024

_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_I32 = struct.Struct("<i")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")

# Request ops.
OP_HELLO = b"h"
OP_APPEND = b"a"
OP_READ = b"r"
OP_END = b"e"
OP_TOPICS = b"t"
OP_PARTS = b"p"
OP_FLUSH = b"f"
OP_PING = b"g"
# Response ops.
OP_OK = b"k"
OP_ERR = b"!"

_SESSION_LEN = 16


class TransportError(RuntimeError):
    """Fail-stop transport failure: retry budget exhausted, protocol
    violation, or a server-side application error."""


class _Lost(Exception):
    """Internal: the connection is damaged; reconnect + replay owns it."""

    def __init__(self, cause: str) -> None:
        super().__init__(cause)
        self.cause = cause


class _WireEOF(Exception):
    """Internal: the peer closed the stream. `partial` marks a mid-read
    EOF (torn frame) vs a clean close on a frame boundary."""

    def __init__(self, partial: bool) -> None:
        super().__init__("eof")
        self.partial = partial


# ------------------------------------------------------------------ framing
def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise _WireEOF(partial=bool(buf))
        buf += chunk
    return bytes(buf)


def _seal(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), crc32c(payload)) + payload


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _U16.pack(len(b)) + b


def _pack_blob(b: Optional[bytes]) -> bytes:
    if b is None:
        return _I32.pack(-1)
    return _I32.pack(len(b)) + b


class _Reader:
    """Cursor over a payload; short reads raise (the CRC already vouched
    for integrity, so a short body is a protocol bug, not line noise)."""

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated payload")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def op(self) -> bytes:
        return self.take(1)

    def u16(self) -> int:
        return _U16.unpack(self.take(_U16.size))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(_U32.size))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(_U64.size))[0]

    def i32(self) -> int:
        return _I32.unpack(self.take(_I32.size))[0]

    def i64(self) -> int:
        return _I64.unpack(self.take(_I64.size))[0]

    def str(self) -> str:
        return self.take(self.u16()).decode("utf-8")

    def blob(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return self.take(n)


# ---------------------------------------------------------- response parses
def _parse_i64(rd: _Reader) -> int:
    return rd.i64()


def _parse_records(rd: _Reader) -> List[LogRecord]:
    n = rd.u32()
    records = [
        LogRecord(rd.i64(), rd.i64(), rd.blob(), rd.blob()) for _ in range(n)
    ]
    # Trace propagation: servers that carry trace context append a
    # trailing per-record blob section AFTER the classic record section, so
    # an older client parses the same frame unchanged (it never looks past
    # record n-1) and an older server's frame leaves traces at None here.
    if n and rd.pos < len(rd.data):
        records = [
            r._replace(trace=rd.blob()) for r in records
        ]
    return records


def _parse_strs(rd: _Reader) -> List[str]:
    return [rd.str() for _ in range(rd.u32())]


def _parse_i32s(rd: _Reader) -> List[int]:
    return [rd.i32() for _ in range(rd.u32())]


# ------------------------------------------------------------------- server
class RecordLogServer:
    """Serve a `RecordLog` over a loopback/LAN socket.

    One named daemon accept thread plus one reader thread per peer;
    requests are applied inline on the peer thread (that inline apply IS
    the backpressure: a slow backing log stops socket reads and TCP
    flow-controls the producer). Producer sessions and the peer map are
    lock-guarded shared state."""

    def __init__(
        self,
        backing: Optional[RecordLog] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[Any] = None,
        io_timeout_s: float = 30.0,
        stall_inject_s: float = 0.75,
        dedup_cache: int = 4096,
        tracer: Optional[Any] = None,
    ) -> None:
        from ..obs.registry import default_registry

        self.backing = backing if backing is not None else RecordLog()
        self.host = host
        self.port = port
        #: Optional obs.trace.SpanTracer: when set, every trace-bearing
        #: append also lands a "broker.append" child span in THIS broker's
        #: ring, so the fleet export stitches the hop into the record's
        #: end-to-end trace.
        self.tracer = tracer
        self.io_timeout_s = io_timeout_s
        #: How long an injected `net.stall` freezes the apply loop. Pick
        #: it ABOVE the clients' `io_timeout_s` to force stall-detection
        #: reconnects; below it, stalls are absorbed as latency.
        self.stall_inject_s = stall_inject_s
        self.dedup_cache = dedup_cache
        self.metrics = registry if registry is not None else default_registry()
        self._lock = threading.Lock()
        self._sessions: Dict[bytes, "OrderedDict[int, int]"] = {}
        #: Per-session high-water mark of seqs EVICTED from the bounded
        #: dedup map: a replayed append at or below it can no longer be
        #: verified against its original offset, so it must fail the
        #: session rather than silently re-append (exactly-once would
        #: break on the quiet duplicate).
        self._evicted: Dict[bytes, int] = {}
        #: Sessions failed after an evicted-range replay: every further
        #: append on them errors until the producer starts a new session.
        self._fenced: set = set()
        self._peers: Dict[int, socket.socket] = {}
        self._peer_ids = itertools.count(1)
        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._addr: Tuple[str, int] = (host, port)
        self._stopping = False
        self._n_restarts = 0
        self._n_torn = 0
        m = self.metrics
        self._m_frames = m.counter(
            "cep_transport_frames_total",
            "Wire frames by endpoint role and direction",
            labels=("role", "dir"),
        )
        self._m_bytes = m.counter(
            "cep_transport_bytes_total",
            "Wire bytes (frame headers included) by role and direction",
            labels=("role", "dir"),
        )
        self._m_conns = m.gauge(
            "cep_transport_connections",
            "Open transport connections (server: live peers; client: 0/1)",
            labels=("role",),
        )
        self._m_torn = m.counter(
            "cep_transport_torn_frames_total",
            "Torn wire frames discarded (CRC/length/mid-frame EOF)",
            labels=("role",),
        )
        self._m_dedup = m.counter(
            "cep_transport_dedup_total",
            "Replayed appends suppressed by (session, seq) identity",
        )
        self._m_sessions = m.gauge(
            "cep_transport_sessions",
            "Producer sessions tracked for idempotent-append dedup",
        )
        self._m_restarts = m.counter(
            "cep_transport_server_restarts_total",
            "Simulated broker crash-restarts (injected backing-log deaths)",
        )

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RecordLogServer":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(64)
        # Short accept timeout so stop() is noticed promptly.
        sock.settimeout(0.2)
        with self._lock:
            self._listener = sock
            self._addr = sock.getsockname()
        t = threading.Thread(
            target=self._accept_loop, name="kct-transport-accept", daemon=True
        )
        with self._lock:
            self._threads.append(t)
        t.start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        with self._lock:
            return self._addr

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            listener, self._listener = self._listener, None
            peers = list(self._peers.values())
            self._peers.clear()
            threads = list(self._threads)
            self._m_conns.labels(role="server").set(0.0)
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        for conn in peers:
            try:
                conn.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=2.0)
        self.backing.flush()

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "mode": "socket-server",
                "address": f"{self._addr[0]}:{self._addr[1]}",
                "peers": len(self._peers),
                "sessions": len(self._sessions),
                "restarts": self._n_restarts,
                "torn_frames": self._n_torn,
            }

    # ---------------------------------------------------------- peer loops
    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                listener = self._listener
            if listener is None:
                return
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            pid = next(self._peer_ids)
            conn.settimeout(self.io_timeout_s)
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            t = threading.Thread(
                target=self._serve_peer,
                args=(conn, pid),
                name=f"kct-transport-peer-{pid}",
                daemon=True,
            )
            with self._lock:
                self._peers[pid] = conn
                self._threads.append(t)
                self._m_conns.labels(role="server").set(float(len(self._peers)))
            t.start()

    def _torn_frame(self) -> None:
        self._m_torn.labels(role="server").inc()
        with self._lock:
            self._n_torn += 1

    def _serve_peer(self, conn: socket.socket, pid: int) -> None:
        peer: Dict[str, Any] = {"session": None}
        frames_in = self._m_frames.labels(role="server", dir="in")
        frames_out = self._m_frames.labels(role="server", dir="out")
        bytes_in = self._m_bytes.labels(role="server", dir="in")
        bytes_out = self._m_bytes.labels(role="server", dir="out")
        try:
            while not self._stopping:
                try:
                    hdr = _recv_exact(conn, _FRAME.size)
                except _WireEOF as eof:
                    if eof.partial:
                        self._torn_frame()
                    return
                except socket.timeout:
                    continue
                except OSError:
                    return
                length, crc = _FRAME.unpack(hdr)
                if length > MAX_FRAME:
                    self._torn_frame()
                    return
                try:
                    payload = _recv_exact(conn, length)
                except (socket.timeout, OSError, _WireEOF):
                    # Mid-frame loss: never apply a torn frame; resync is
                    # the peer's reconnect, on a clean boundary.
                    self._torn_frame()
                    return
                if crc32c(payload) != crc:
                    self._torn_frame()
                    return
                frames_in.inc()
                bytes_in.inc(len(payload) + _FRAME.size)
                if _flt.ACTIVE is not None:
                    try:
                        _flt.ACTIVE.fire("net.stall")
                    except TransientFault:
                        # Injected consumer stall: stop reading/answering.
                        # Kernel socket buffers fill, producers block (or
                        # hit their IO deadline and reconnect).
                        time.sleep(self.stall_inject_s)
                try:
                    resp = self._apply(payload, peer)
                except InjectedCrash:
                    # The backing log "process" died (log.torn_append):
                    # simulate the broker restart and drop this peer.
                    self._restart_backing()
                    return
                except Exception as exc:
                    seq = 0
                    if len(payload) >= 1 + _U64.size:
                        seq = _U64.unpack_from(payload, 1)[0]
                    resp = (
                        OP_ERR
                        + _U64.pack(seq)
                        + _pack_str(f"{type(exc).__name__}: {exc}")
                    )
                out = _seal(resp)
                try:
                    conn.sendall(out)
                except OSError:
                    return
                frames_out.inc()
                bytes_out.inc(len(out))
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._peers.pop(pid, None)
                self._m_conns.labels(role="server").set(float(len(self._peers)))

    # -------------------------------------------------------------- apply
    def _apply(self, payload: bytes, peer: Dict[str, Any]) -> bytes:
        rd = _Reader(payload)
        op = rd.op()
        seq = rd.u64()

        def ok(body: bytes = b"") -> bytes:
            return OP_OK + _U64.pack(seq) + body

        if op == OP_HELLO:
            sid = rd.take(_SESSION_LEN)
            ver = rd.u32()
            if ver != WIRE_VERSION:
                raise ValueError(f"wire version {ver} != {WIRE_VERSION}")
            with self._lock:
                sess = self._sessions.setdefault(sid, OrderedDict())
                peer["session"] = sid
                self._m_sessions.set(float(len(self._sessions)))
                last = next(reversed(sess)) if sess else 0
            return ok(_U64.pack(last))
        if op == OP_APPEND:
            t0 = time.perf_counter()
            topic = rd.str()
            part = rd.i32()
            ts = rd.i64()
            key = rd.blob()
            value = rd.blob()
            # Optional trailing trace-context blob: absent from
            # older clients' frames, so only read it when bytes remain.
            trace = rd.blob() if rd.pos < len(rd.data) else None
            sid = peer["session"]
            with self._lock:
                sess = self._sessions.get(sid) if sid is not None else None
                if sid is not None and sid in self._fenced:
                    raise ValueError(
                        "session fenced after an evicted-range replay; "
                        "start a new session"
                    )
                if sess is not None and seq in sess:
                    # Replayed append (the ack was lost in a disconnect):
                    # same (session, seq) -> same offset, applied once.
                    self._m_dedup.inc()
                    return ok(_I64.pack(sess[seq]))
                if sess is not None and seq <= self._evicted.get(sid, 0):
                    # Replay from BELOW the dedup window: its original
                    # offset was evicted, so applied-once can no longer be
                    # proven. Re-appending here would be a silent duplicate
                    # -- fail the session explicitly instead (the client
                    # surfaces a TransportError, never a quiet re-append).
                    self._fenced.add(sid)
                    raise ValueError(
                        f"replayed append seq {seq} predates the dedup "
                        f"window (evicted through seq "
                        f"{self._evicted.get(sid, 0)}): exactly-once "
                        "cannot be verified; session fenced"
                    )
                off = self.backing.append(
                    topic, key, value, timestamp=ts, partition=part,
                    trace=trace,
                )
                if sess is not None:
                    sess[seq] = off
                    while len(sess) > self.dedup_cache:
                        gone, _off = sess.popitem(last=False)
                        if gone > self._evicted.get(sid, 0):
                            self._evicted[sid] = gone
            if self.tracer is not None and trace is not None:
                # Stitch the broker hop into the record's trace: a child
                # span of the producer's append span. The STORED blob stays
                # the producer's context byte-for-byte -- re-encoding per
                # hop would make the same record read back differently from
                # different brokers.
                from ..obs.trace import TraceContext

                ctx = TraceContext.decode(trace)
                if ctx is not None:
                    self.tracer.record(
                        "broker.append",
                        time.perf_counter() - t0,
                        trace=ctx,
                    )
            return ok(_I64.pack(off))
        if op == OP_READ:
            topic = rd.str()
            part = rd.i32()
            start = rd.i64()
            maxr = rd.i64()
            records = self.backing.read(
                topic,
                partition=part,
                start=start,
                max_records=None if maxr < 0 else maxr,
            )
            body = bytearray(_U32.pack(len(records)))
            for r in records:
                body += _I64.pack(r.offset)
                body += _I64.pack(r.timestamp)
                body += _pack_blob(r.key)
                body += _pack_blob(r.value)
            # Trailing trace section: one blob per record, after
            # the classic section so pre-trace clients parse unchanged.
            # Only emitted when at least one record carries context --
            # trace-free traffic pays zero bytes.
            if any(getattr(r, "trace", None) is not None for r in records):
                for r in records:
                    body += _pack_blob(r.trace)
            return ok(bytes(body))
        if op == OP_END:
            topic = rd.str()
            part = rd.i32()
            return ok(_I64.pack(self.backing.end_offset(topic, partition=part)))
        if op == OP_TOPICS:
            names = self.backing.topics()
            return ok(
                _U32.pack(len(names)) + b"".join(_pack_str(n) for n in names)
            )
        if op == OP_PARTS:
            parts = self.backing.partitions(rd.str())
            return ok(
                _U32.pack(len(parts)) + b"".join(_I32.pack(p) for p in parts)
            )
        if op == OP_FLUSH:
            self.backing.flush()
            return ok()
        if op == OP_PING:
            return ok()
        raise ValueError(f"unknown wire op {op!r}")

    def _restart_backing(self) -> None:
        """Simulated broker death: drop every connection and reopen the
        file-backed log (the reload truncates the torn tail, exactly as
        `RecordLog._load` promises). Sessions survive -- the idempotent-
        producer state a real broker keeps replicated in the log -- so
        post-restart replays still dedup."""
        with self._lock:
            self._m_restarts.inc()
            self._n_restarts += 1
            for conn in self._peers.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._peers.clear()
            self._m_conns.labels(role="server").set(0.0)
            if self.backing.path is not None:
                self.backing.close()
                self.backing = RecordLog(self.backing.path)


# ------------------------------------------------------------------- client
class SocketRecordLog:
    """`RecordLog` contract over a socket, with reconnect/backoff, bounded
    in-flight appends, idempotent replay, and heartbeat stall detection.

    Thread-safe: every public method serializes on one RLock (the
    heartbeat daemon uses the same lock), matching `RecordLog`'s locking
    discipline. `window=1` (default) keeps appends synchronous -- exact
    server offsets returned. `window>1` pipelines appends and returns
    client-predicted offsets (exact under one-producer-per-partition,
    ack-verified and resynced otherwise); a full window BLOCKS, which is
    `on_overflow=block` propagated to the wire."""

    def __init__(
        self,
        address: Tuple[str, int],
        registry: Optional[Any] = None,
        window: int = 1,
        io_timeout_s: float = 5.0,
        retry_budget: int = 8,
        backoff_base_s: float = 0.01,
        backoff_cap_s: float = 0.5,
        backoff_seed: int = 0,
        heartbeat_s: Optional[float] = None,
        connect: bool = True,
        session: Optional[bytes] = None,
        start_seq: int = 0,
    ) -> None:
        import os as _os
        import random as _random

        from ..obs.registry import default_registry

        self.address = (str(address[0]), int(address[1]))
        self.path = None  # RecordLog-contract parity: not file-backed here
        self.window = max(1, int(window))
        self.io_timeout_s = io_timeout_s
        self.retry_budget = max(0, int(retry_budget))
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.heartbeat_s = heartbeat_s
        self.metrics = registry if registry is not None else default_registry()
        self._rng = _random.Random(backoff_seed)
        # A migrated shard's successor adopts the source's producer
        # session AND its seq cursor (streams/rebalance.py handoff): the
        # server's (session, seq) dedup then spans the move. Resuming a
        # session with a REWOUND seq would collide with the server's
        # table, so the two travel together in the shard checkpoint.
        if session is not None and len(session) != _SESSION_LEN:
            raise ValueError(
                f"session id must be {_SESSION_LEN} bytes, got {len(session)}"
            )
        self._session = (
            bytes(session) if session is not None else _os.urandom(_SESSION_LEN)
        )
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._seq = max(0, int(start_seq))
        self._inflight: Deque[Dict[str, Any]] = deque()
        self._next_off: Dict[Tuple[str, int], int] = {}
        self._closed = False
        self._connects = 0
        self._server_last_seq = 0
        self._last_ok = 0.0
        self._n_reconnects = 0
        self._n_disconnects = 0
        self._n_stalls = 0
        self._n_retries = 0
        self._n_backpressure = 0
        m = self.metrics
        self._m_frames = m.counter(
            "cep_transport_frames_total",
            "Wire frames by endpoint role and direction",
            labels=("role", "dir"),
        )
        self._m_bytes = m.counter(
            "cep_transport_bytes_total",
            "Wire bytes (frame headers included) by role and direction",
            labels=("role", "dir"),
        )
        self._m_conns = m.gauge(
            "cep_transport_connections",
            "Open transport connections (server: live peers; client: 0/1)",
            labels=("role",),
        )
        self._m_torn = m.counter(
            "cep_transport_torn_frames_total",
            "Torn wire frames discarded (CRC/length/mid-frame EOF)",
            labels=("role",),
        )
        self._m_retries = m.counter(
            "cep_transport_retries_total",
            "Reconnect/backoff attempts by call site",
            labels=("site",),
        )
        self._m_reconnects = m.counter(
            "cep_transport_reconnects_total",
            "Successful reconnections after a connection loss",
        )
        self._m_disconnects = m.counter(
            "cep_transport_disconnects_total",
            "Connection losses observed by the client, by cause",
            labels=("cause",),
        )
        self._m_stalls = m.counter(
            "cep_transport_stalls_total",
            "Idle/stall timeouts (no response within the IO deadline)",
        )
        self._m_backpressure = m.counter(
            "cep_transport_backpressure_total",
            "Windowed appends that blocked on the bounded in-flight window",
        )
        self._m_inflight = m.gauge(
            "cep_transport_inflight_appends",
            "Client unacknowledged appends currently in the window",
        )
        self._m_last_ok = m.gauge(
            "cep_transport_last_ok_age_seconds",
            "Seconds since the client last heard the server",
        )
        self._hb_thread: Optional[threading.Thread] = None
        if connect:
            with self._lock:
                self._reconnect(site="connect")
        if heartbeat_s is not None:
            t = threading.Thread(
                target=self._heartbeat_loop,
                name="kct-transport-heartbeat",
                daemon=True,
            )
            self._hb_thread = t
            t.start()

    # -------------------------------------------------------- connection
    # Every helper below re-enters self._lock (an RLock; all callers --
    # public methods and the heartbeat daemon -- already hold it), so the
    # shared-state writes are syntactically lock-guarded, not just
    # guarded-by-convention.
    def _close_socket(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            self._m_conns.labels(role="client").set(0.0)

    def _connect_and_hello(self) -> None:
        # Immediate double-tap on the raw connect via the shared transient
        # retry helper (counts cep_retries_total{site="net.connect"});
        # the seeded exponential backoff lives one level up in _reconnect.
        sock = with_retry(
            lambda: socket.create_connection(
                self.address, timeout=self.io_timeout_s
            ),
            site="net.connect",
            attempts=2,
            backoff_s=0.0,
            registry=self.metrics,
        )
        sock.settimeout(self.io_timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        # The handshake bypasses the fault hooks: the net.* sites target
        # steady-state traffic, and a fault here would only re-enter the
        # same reconnect loop that is already running.
        hello = OP_HELLO + _U64.pack(0) + self._session + _U32.pack(WIRE_VERSION)
        sock.sendall(_seal(hello))
        hdr = _recv_exact(sock, _FRAME.size)
        length, crc = _FRAME.unpack(hdr)
        if length > MAX_FRAME:
            raise _Lost("torn")
        payload = _recv_exact(sock, length)
        if crc32c(payload) != crc:
            raise _Lost("torn")
        rd = _Reader(payload)
        if rd.op() != OP_OK or rd.u64() != 0:
            raise TransportError("bad HELLO response (not a RecordLogServer?)")
        with self._lock:
            self._sock = sock
            self._server_last_seq = rd.u64()
            self._last_ok = time.monotonic()
            self._connects += 1
            self._m_conns.labels(role="client").set(1.0)
            if self._connects > 1:
                self._m_reconnects.inc()
                self._n_reconnects += 1

    def _reconnect(self, site: str) -> None:
        """(Re)connect with seeded-jitter exponential backoff under the
        retry budget, then replay every in-flight frame in FIFO order.
        Attempt 0 is immediate; budget exhaustion is fail-stop."""
        for attempt in range(self.retry_budget + 1):
            if attempt > 0:
                with self._lock:
                    self._m_retries.labels(site=site).inc()
                    self._n_retries += 1
                span = min(
                    self.backoff_cap_s,
                    self.backoff_base_s * (2 ** (attempt - 1)),
                )
                time.sleep(span * (0.5 + 0.5 * self._rng.random()))
            try:
                self._connect_and_hello()
                for entry in self._inflight:
                    self._send_frame(entry["frame"])
                return
            except (_Lost, _WireEOF, OSError, socket.timeout):
                self._close_socket()
        raise TransportError(
            f"transport to {self.address[0]}:{self.address[1]} unrecoverable "
            f"after {self.retry_budget} backoff retries (site={site})"
        )

    def _recover(self, lost: _Lost, site: str) -> None:
        self._close_socket()
        with self._lock:
            self._m_disconnects.labels(cause=lost.cause).inc()
            self._n_disconnects += 1
            if lost.cause == "stall":
                self._m_stalls.inc()
                self._n_stalls += 1
        self._reconnect(site)

    # ------------------------------------------------------------ wire IO
    def _send_frame(self, frame: bytes) -> None:
        sock = self._sock
        if sock is None:
            raise _Lost("closed")
        try:
            if _flt.ACTIVE is not None:
                _flt.ACTIVE.fire("net.partial_write", sock=sock, payload=frame)
                _flt.ACTIVE.fire("net.disconnect")
            sock.sendall(frame)
        except TransientFault as fault:
            cause = (
                "partial_write"
                if fault.site == "net.partial_write"
                else "injected"
            )
            raise _Lost(cause) from fault
        except socket.timeout:
            raise _Lost("stall") from None
        except OSError as exc:
            raise _Lost("send") from exc
        self._m_frames.labels(role="client", dir="out").inc()
        self._m_bytes.labels(role="client", dir="out").inc(len(frame))

    def _recv_frame(self) -> bytes:
        sock = self._sock
        if sock is None:
            raise _Lost("closed")
        if _flt.ACTIVE is not None:
            try:
                _flt.ACTIVE.fire("net.disconnect")
            except TransientFault as fault:
                raise _Lost("injected") from fault
        try:
            hdr = _recv_exact(sock, _FRAME.size)
            length, crc = _FRAME.unpack(hdr)
            if length > MAX_FRAME:
                self._m_torn.labels(role="client").inc()
                raise _Lost("torn")
            payload = _recv_exact(sock, length)
        except socket.timeout:
            raise _Lost("stall") from None
        except _WireEOF as eof:
            if eof.partial:
                self._m_torn.labels(role="client").inc()
                raise _Lost("torn") from eof
            raise _Lost("eof") from eof
        except OSError as exc:
            raise _Lost("recv") from exc
        if crc32c(payload) != crc:
            self._m_torn.labels(role="client").inc()
            raise _Lost("torn")
        with self._lock:
            self._m_frames.labels(role="client", dir="in").inc()
            self._m_bytes.labels(role="client", dir="in").inc(
                len(payload) + _FRAME.size
            )
            self._last_ok = time.monotonic()
        return payload

    # ------------------------------------------------------- request FIFO
    def _appends_inflight(self) -> int:
        return sum(1 for e in self._inflight if e["kind"] == "append")

    def _submit(
        self,
        op: bytes,
        body: bytes,
        parse: Optional[Callable[[_Reader], Any]],
        kind: str,
        tp: Optional[Tuple[str, int]] = None,
        predicted: Optional[int] = None,
    ) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            payload = op + _U64.pack(self._seq) + body
            entry: Dict[str, Any] = {
                "seq": self._seq,
                "frame": _seal(payload),
                "parse": parse,
                "kind": kind,
                "tp": tp,
                "predicted": predicted,
                "done": False,
                "result": None,
                "site": "append" if kind == "append" else kind,
            }
            if self._sock is None:
                self._reconnect(site=entry["site"])
            self._inflight.append(entry)
        try:
            self._send_frame(entry["frame"])
        except _Lost as lost:
            # The entry is already in the FIFO: reconnect replays it.
            self._recover(lost, site=entry["site"])
        self._m_inflight.set(float(self._appends_inflight()))
        return entry

    def _pump_one(self) -> None:
        """Receive and apply exactly one response (FIFO order)."""
        payload = self._recv_frame()
        rd = _Reader(payload)
        op = rd.op()
        seq = rd.u64()
        if not self._inflight:
            raise _Lost("torn")  # unsolicited frame: desync; resync clean
        entry = self._inflight[0]
        if seq != entry["seq"]:
            raise TransportError(
                f"response seq {seq} != expected {entry['seq']}: "
                "request/response FIFO violated"
            )
        self._inflight.popleft()
        self._m_inflight.set(float(self._appends_inflight()))
        if op == OP_ERR:
            raise TransportError(
                f"server error for {entry['kind']}: {rd.str()}"
            )
        if op != OP_OK:
            raise TransportError(f"unknown response op {op!r}")
        entry["result"] = rd if entry["parse"] is None else entry["parse"](rd)
        entry["done"] = True
        if entry["kind"] == "append":
            self._on_append_ack(entry)

    def _on_append_ack(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            tp = entry["tp"]
            off = entry["result"]
            predicted = entry["predicted"]
            if predicted is not None and off != predicted:
                # Another producer interleaved on this partition: resync
                # the predictor past our still-unacked appends to it.
                waiting = sum(1 for e in self._inflight if e["tp"] == tp)
                self._next_off[tp] = off + 1 + waiting
            else:
                self._next_off[tp] = max(self._next_off.get(tp, 0), off + 1)

    def _await(self, entry: Dict[str, Any]) -> Any:
        while not entry["done"]:
            try:
                self._pump_one()
            except _Lost as lost:
                self._recover(lost, site=entry["site"])
        return entry["result"]

    def _request(
        self,
        op: bytes,
        body: bytes,
        parse: Optional[Callable[[_Reader], Any]],
        kind: str,
    ) -> Any:
        entry = self._submit(op, body, parse, kind=kind)
        return self._await(entry)

    def _check_open(self) -> None:
        if self._closed:
            raise TransportError("transport is closed")

    # ------------------------------------------------- RecordLog contract
    def append(
        self,
        topic: str,
        key: Optional[bytes],
        value: Optional[bytes],
        timestamp: int = 0,
        partition: int = 0,
        trace: Optional[bytes] = None,
    ) -> int:
        with self._lock:
            self._check_open()
            tp = (topic, partition)
            predicted: Optional[int] = None
            if self.window > 1:
                if tp not in self._next_off:
                    self._next_off[tp] = self._request(
                        OP_END,
                        _pack_str(topic) + _I32.pack(partition),
                        _parse_i64,
                        kind="end_offset",
                    )
                predicted = self._next_off[tp]
                self._next_off[tp] = predicted + 1
            body = (
                _pack_str(topic)
                + _I32.pack(partition)
                + _I64.pack(timestamp)
                + _pack_blob(key)
                + _pack_blob(value)
            )
            if trace is not None:
                # Trailing optional blob: a pre-trace server never reads
                # past `value`, so the frame stays WIRE_VERSION 1 and the
                # context rides replays untouched (the _inflight entry
                # keeps the sealed body, so reconnect replay re-sends it).
                body += _pack_blob(trace)
            entry = self._submit(
                OP_APPEND, body, _parse_i64, kind="append",
                tp=tp, predicted=predicted,
            )
            if self.window <= 1:
                return self._await(entry)
            if self._appends_inflight() >= self.window:
                # Bounded in-flight window: BLOCK draining acks -- this is
                # on_overflow=block propagated to the wire, never an
                # unbounded client-side buffer.
                self._m_backpressure.inc()
                self._n_backpressure += 1
                while self._appends_inflight() >= self.window:
                    try:
                        self._pump_one()
                    except _Lost as lost:
                        self._recover(lost, site="append")
            return predicted

    def read(
        self,
        topic: str,
        partition: int = 0,
        start: int = 0,
        max_records: Optional[int] = None,
    ) -> List[LogRecord]:
        with self._lock:
            self._check_open()
            body = (
                _pack_str(topic)
                + _I32.pack(partition)
                + _I64.pack(start)
                + _I64.pack(-1 if max_records is None else max_records)
            )
            return self._request(OP_READ, body, _parse_records, "read")

    def end_offset(self, topic: str, partition: int = 0) -> int:
        with self._lock:
            self._check_open()
            body = _pack_str(topic) + _I32.pack(partition)
            return self._request(OP_END, body, _parse_i64, "end_offset")

    def topics(self) -> List[str]:
        with self._lock:
            self._check_open()
            return self._request(OP_TOPICS, b"", _parse_strs, "topics")

    def partitions(self, topic: str) -> List[int]:
        with self._lock:
            self._check_open()
            return self._request(
                OP_PARTS, _pack_str(topic), _parse_i32s, "partitions"
            )

    def flush(self) -> None:
        """Drain the in-flight window, then fsync the server's backing
        log. The FIFO guarantees every prior append was applied before
        the server sees the FLUSH, so commit-before-offsets ordering
        (streams/driver.py) holds over the wire too."""
        with self._lock:
            self._check_open()
            self._request(OP_FLUSH, b"", None, "flush")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            try:
                while self._inflight and self._sock is not None:
                    self._pump_one()  # best-effort drain; no reconnects
            except (_Lost, TransportError):
                pass
            self._closed = True
            self._close_socket()
        t = self._hb_thread
        if t is not None:
            t.join(timeout=2.0)

    def session_state(self) -> Tuple[bytes, int]:
        """(session id, last issued seq): the idempotent-producer identity
        a shard checkpoint carries so a migrated shard's successor client
        resumes the SAME dedup horizon on the broker (pass both back as
        `session=`/`start_seq=`)."""
        with self._lock:
            return self._session, self._seq

    # ----------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        with self._lock:
            idle = (
                round(time.monotonic() - self._last_ok, 3)
                if self._last_ok
                else None
            )
            return {
                "mode": "socket",
                "server": f"{self.address[0]}:{self.address[1]}",
                "connected": self._sock is not None,
                "session": self._session.hex(),
                "last_ok_age_s": idle,
                "pending_appends": self._appends_inflight(),
                "window": self.window,
                "reconnects": self._n_reconnects,
                "disconnects": self._n_disconnects,
                "stalls": self._n_stalls,
                "backoff_retries": self._n_retries,
                "backpressure_hits": self._n_backpressure,
            }

    def _heartbeat_loop(self) -> None:
        period = max(0.01, (self.heartbeat_s or 1.0) / 4.0)
        while True:
            time.sleep(period)
            if self._closed:
                return
            if not self._lock.acquire(timeout=period):
                continue  # a long windowed drain owns the wire; skip
            try:
                if self._closed:
                    return
                idle = time.monotonic() - self._last_ok
                self._m_last_ok.set(idle)
                if self._sock is None or idle < self.heartbeat_s:
                    continue
                try:
                    self._request(OP_PING, b"", None, "heartbeat")
                except TransportError:
                    # Budget exhausted: leave the socket down; the next
                    # API call retries with a fresh budget.
                    pass
            finally:
                self._lock.release()
