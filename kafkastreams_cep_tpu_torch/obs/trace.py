"""Span tracer: host-side wall spans + the device trace, one API.

A copy of the JAX package's `obs/trace.py`; `device()` reaches the port's
`ops.profiling.device_trace` (torch.profiler, CUDA activity on the card).

`SpanTracer.span("restore")` times a host block and records it into the
registry (`cep_span_seconds{span=...}` histogram + `cep_span_total`
counter), so the streams layer's poll/commit/restore sections land in the
same spine as the engine's section walls. `SpanTracer.device(log_dir)`
wraps ops.profiling.device_trace (a torch.profiler capture) and records
the capture wall as a span of the same name -- one call site for "time
this, and profile the device while at it".

The tracer also keeps a bounded ring of recent completed
spans (`recent()`), which the introspection plane serves as `/tracez` --
a curl-able "what did this process just spend time on" without a
profiler attach.

**Wire trace propagation**: `TraceContext` is the compact
per-record context (trace id, root span id, ingest wall clock) that a
producer mints at ingest and the transport carries as an opaque blob on
append/read frames. Spans recorded with
`trace=ctx` (or via `record()`) gain `trace_id`/`span_id`/`parent_id`
ring fields, so spans landed by DIFFERENT processes -- the producing
client, broker A's server tracer, a migration controller, broker B's
successor pipeline -- stitch into one end-to-end trace keyed by
trace id (obs/trace_export.py renders the stitched Perfetto view).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from .registry import MetricsRegistry, default_registry

__all__ = ["SpanTracer", "TraceContext"]

#: Wire-blob version tag; decode() returns None for unknown versions so
#: a newer producer never breaks an older consumer (forward-compatible
#: observability: the record still applies, only the trace is dropped).
TRACE_CTX_VERSION = 1

#: [u8 version][8B trace id][8B span id][f64 ingest unix] = 25 bytes --
#: compact enough to ride every record's frame.
_CTX = struct.Struct("<B8s8sd")


def _new_id() -> str:
    """16-hex-char random id (8 random bytes) for trace/span identity."""
    return os.urandom(8).hex()


class TraceContext:
    """One record's propagated trace identity.

    `trace_id` names the end-to-end story (minted once at ingest);
    `span_id` is the id of the span this context is a child OF (the
    producer's root span, or a forwarding hop's span); `ingest_unix` is
    the producing wall clock, carried so any process in the fleet can
    place its child spans on the ingest timeline without clock
    agreement beyond wall time."""

    __slots__ = ("trace_id", "span_id", "ingest_unix")

    def __init__(
        self, trace_id: str, span_id: str, ingest_unix: float
    ) -> None:
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.ingest_unix = float(ingest_unix)

    @classmethod
    def new(cls, ingest_unix: Optional[float] = None) -> "TraceContext":
        """Mint a fresh root context (producer ingest path)."""
        return cls(
            _new_id(),
            _new_id(),
            time.time() if ingest_unix is None else ingest_unix,
        )

    def child(self, span_id: str) -> "TraceContext":
        """The context a hop forwards after recording its own span: same
        trace, the hop's span as the new parent."""
        return TraceContext(self.trace_id, span_id, self.ingest_unix)

    # ------------------------------------------------------------- codec
    def encode(self) -> bytes:
        return _CTX.pack(
            TRACE_CTX_VERSION,
            bytes.fromhex(self.trace_id),
            bytes.fromhex(self.span_id),
            self.ingest_unix,
        )

    @classmethod
    def decode(cls, blob: Optional[bytes]) -> Optional["TraceContext"]:
        """None for absent/undersized/unknown-version blobs: trace
        context is observability, never a reason to reject a record."""
        if blob is None or len(blob) != _CTX.size:
            return None
        ver, tid, sid, unix = _CTX.unpack(blob)
        if ver != TRACE_CTX_VERSION:
            return None
        return cls(tid.hex(), sid.hex(), unix)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "ingest_unix": self.ingest_unix,
        }

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
            and self.ingest_unix == other.ingest_unix
        )

    def __repr__(self) -> str:
        return (
            f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
            f"{self.ingest_unix!r})"
        )


class SpanTracer:
    """Named wall-clock spans recorded into a MetricsRegistry.

    `ring` bounds the recent-span buffer behind `recent()` (the /tracez
    surface); completed spans beyond it age out oldest-first.
    """

    def __init__(
        self, registry: Optional[MetricsRegistry] = None, ring: int = 256
    ) -> None:
        self.registry = registry if registry is not None else default_registry()
        self._hist = self.registry.histogram(
            "cep_span_seconds", "Host wall per named span", labels=("span",)
        )
        self._count = self.registry.counter(
            "cep_span_total", "Completed spans", labels=("span",)
        )
        # deque appends are atomic, but recent()'s snapshot iteration must
        # not race a rotating append from another thread.
        self._ring: deque = deque(maxlen=max(1, ring))
        self._ring_lock = threading.Lock()

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        trace: Optional[TraceContext] = None,
        parent_id: Optional[str] = None,
    ) -> Iterator[Optional[TraceContext]]:
        """Time a host block. With `trace=` the completed span joins that
        trace as a child of `parent_id` (default: the context's span id)
        and the block receives the FORWARDING context -- same trace, this
        span as the parent -- to hand to anything it emits downstream.
        Without `trace` the entry is the classic anonymous /tracez span
        and the block receives None."""
        t0 = time.perf_counter()
        child: Optional[TraceContext] = None
        sid: Optional[str] = None
        if trace is not None:
            sid = _new_id()
            child = trace.child(sid)
        try:
            yield child
        finally:
            dt = time.perf_counter() - t0
            self._hist.labels(span=name).observe(dt)
            self._count.labels(span=name).inc()
            entry: Dict[str, Any] = {
                "span": name,
                "end_unix": time.time(),
                "duration_s": dt,
            }
            if trace is not None:
                entry["trace_id"] = trace.trace_id
                entry["span_id"] = sid
                entry["parent_id"] = (
                    parent_id if parent_id is not None else trace.span_id
                )
            with self._ring_lock:
                self._ring.append(entry)

    def record(
        self,
        name: str,
        duration_s: float,
        end_unix: Optional[float] = None,
        trace: Optional[TraceContext] = None,
        parent_id: Optional[str] = None,
        span_id: Optional[str] = None,
    ) -> Optional[str]:
        """Record an already-measured span (latency observed elsewhere,
        e.g. the ingest-stamp -> sink-emission match wall). Returns the
        span's id when `trace` was given, so callers can parent further
        children on it. `span_id` pins the recorded id (a producer
        recording its ROOT span as the context's own span id); an empty
        `parent_id` marks a root -- stored as None, no parent arrow."""
        self._hist.labels(span=name).observe(float(duration_s))
        self._count.labels(span=name).inc()
        entry: Dict[str, Any] = {
            "span": name,
            "end_unix": time.time() if end_unix is None else float(end_unix),
            "duration_s": float(duration_s),
        }
        sid: Optional[str] = None
        if trace is not None:
            sid = span_id if span_id is not None else _new_id()
            entry["trace_id"] = trace.trace_id
            entry["span_id"] = sid
            pid = parent_id if parent_id is not None else trace.span_id
            entry["parent_id"] = pid or None
        with self._ring_lock:
            self._ring.append(entry)
        return sid

    def recent(
        self, limit: int = 64, name: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Most-recent completed spans, newest first (the /tracez view)."""
        with self._ring_lock:
            spans = list(self._ring)
        it = reversed(spans)
        if name is not None:
            it = (s for s in it if s["span"] == name)
        return list(itertools.islice(it, max(0, limit)))

    @contextlib.contextmanager
    def device(self, log_dir: str, name: str = "device_trace") -> Iterator[Any]:
        """Capture a device profile of the block AND record its wall
        as a span (the existing ops.profiling.device_trace, wrapped).
        An unavailable profiler degrades to the bare span, with the
        condition persisted on this tracer's registry
        (`cep_profiler_unavailable{reason}`)."""
        from ..ops.profiling import device_trace

        with self.span(name):
            with device_trace(log_dir, registry=self.registry):
                yield
