"""Live introspection plane: stdlib HTTP exposition on a daemon thread.

A copy of the JAX package's `obs/http.py`; `/profilez` captures through
the port's torch.profiler `device_trace`.

A production engine must be curl-able mid-stream: the
`IntrospectionServer` binds `http.server.ThreadingHTTPServer` on a daemon
thread and serves, with zero third-party dependencies:

- ``/metrics``   Prometheus 0.0.4 text of the attached registry
- ``/snapshot``  the registry's JSON snapshot
- ``/healthz``   liveness JSON: server uptime plus whatever the attached
                 `health_fn` reports (LogDriver: poll/commit ages,
                 restore state, fault-arm state)
- ``/tracez``    recent SpanTracer spans as JSON (newest first);
                 ``?kind=match`` serves sampled match-provenance
                 exemplars instead; ``?limit=N`` bounds either;
                 ``?format=chrome`` renders spans AND exemplars as one
                 Chrome-trace/Perfetto document (obs/trace_export.py)
- ``/explainz``  recent emitted-match lineage: contributing
                 event identities, run version path, trace-id exemplar,
                 source broker, observed latency -- the read-only "why
                 did this match fire" surface (`explain_fn`, e.g.
                 LogDriver.explain); ``?limit=N`` / ``?query=name``
                 bound and filter
- ``/profilez``  ``?secs=N`` arms an on-demand device trace capture
                 (ops.profiling.device_trace) for N seconds on a
                 background thread against the running pipeline; the
                 reply returns immediately with the capture's log_dir.
                 One capture at a time; a degraded profiler (no card /
                 profiler busy) no-ops with a persistent warning gauge

The server also owns the plane's **clock thread**: callables registered
via `tick_fns` run every `tick_every_s` seconds regardless of stream
traffic. `LogDriver.serve_http` registers its periodic reporter here,
fixing the poll-gated cadence (an idle topic previously never reported --
no poll, no report).

Reads only: every handler renders from host-side registries/rings, so a
scrape can never sync the device or touch the data path.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterable, List, Optional
from urllib.parse import parse_qs, urlsplit

from .registry import MetricsRegistry, default_registry
from .trace import SpanTracer

__all__ = ["IntrospectionServer"]


class _Handler(BaseHTTPRequestHandler):
    # Scrapes must never block each other on a slow client.
    protocol_version = "HTTP/1.1"

    def log_message(self, *args: Any) -> None:  # silence per-request noise
        pass

    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        plane: "IntrospectionServer" = self.server.plane  # type: ignore[attr-defined]
        parts = urlsplit(self.path)
        query = parse_qs(parts.query)
        try:
            route = plane._routes.get(parts.path)
            if route is None:
                self._reply(404, "text/plain; charset=utf-8",
                            f"unknown route {parts.path!r}\n".encode())
                return
            content_type, body = route(query)
        except Exception as exc:  # a broken health_fn must not kill serving
            self._reply(500, "text/plain; charset=utf-8",
                        f"introspection handler failed: {exc}\n".encode())
            return
        self._reply(200, content_type, body)

    def _reply(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _limit(query: Dict[str, List[str]], default: int = 64) -> int:
    try:
        return max(0, int(query.get("limit", [default])[0]))
    except (TypeError, ValueError):
        return default


class IntrospectionServer:
    """The live plane: HTTP exposition + the time-driven tick clock.

    `registry`: the exposition source (process default when omitted).
    `tracer`: span source for /tracez (one is created over `registry`
    when omitted, so attaching a server always yields a working /tracez).
    `health_fn`: extra /healthz fields (dict); exceptions surface as 500.
    `match_exemplars`: callable(limit) -> list of provenance dicts for
    /tracez?kind=match (e.g. BatchedDeviceNFA.provenance_exemplars).
    `tick_fns`: called from the clock thread every `tick_every_s` --
    idle-stream periodic reporting lives here, not on the poll path.
    `profile_dir`: where /profilez drops trace captures (a fresh temp
    dir per capture under the system tmp dir when omitted).
    """

    #: /profilez duration clamp: a runaway ?secs= must not pin the
    #: profiler (and its buffer memory) for hours.
    PROFILE_MAX_SECS = 60.0

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        match_exemplars: Optional[Callable[[int], List[Dict[str, Any]]]] = None,
        explain_fn: Optional[Callable[[int], List[Dict[str, Any]]]] = None,
        tick_fns: Iterable[Callable[[], Any]] = (),
        tick_every_s: float = 0.25,
        host: str = "127.0.0.1",
        port: int = 0,
        profile_dir: Optional[str] = None,
    ) -> None:
        self.registry = registry if registry is not None else default_registry()
        self.tracer = tracer if tracer is not None else SpanTracer(self.registry)
        self.health_fn = health_fn
        self.match_exemplars = match_exemplars
        self.explain_fn = explain_fn
        self.tick_fns = list(tick_fns)
        self.tick_every_s = max(0.01, float(tick_every_s))
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._clock_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._t_start = time.time()
        self.requests = 0
        self.profile_dir = profile_dir
        self._profile_thread: Optional[threading.Thread] = None
        self._profile_lock = threading.Lock()
        # Request counter lock: routes run on per-request handler threads
        # (ThreadingHTTPServer), so the += below would lose updates.
        self._req_lock = threading.Lock()
        self.profile_captures = 0
        self._routes: Dict[str, Callable] = {
            "/metrics": self._route_metrics,
            "/snapshot": self._route_snapshot,
            "/healthz": self._route_healthz,
            "/tracez": self._route_tracez,
            "/explainz": self._route_explainz,
            "/profilez": self._route_profilez,
        }

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "IntrospectionServer":
        if self._httpd is not None:
            return self
        # A restarted server must tick again: stop() leaves the event set,
        # and a set event would kill the fresh clock thread on its first
        # wait() -- silently, since HTTP keeps answering.
        self._stop.clear()
        self._t_start = time.time()
        self._httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.plane = self  # type: ignore[attr-defined]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="kct-introspect-http",
            daemon=True,
        )
        self._serve_thread.start()
        if self.tick_fns:
            self._clock_thread = threading.Thread(
                target=self._clock, name="kct-introspect-clock", daemon=True
            )
            self._clock_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
            self._serve_thread = None
        if self._clock_thread is not None:
            self._clock_thread.join(timeout=5)
            self._clock_thread = None
        # Read under the profile lock: an in-flight /profilez handler
        # (handler threads are not joined by httpd.shutdown) may be
        # arming a capture concurrently -- the lock orders us after its
        # spawn, and the handler's own stopped-check (below) orders any
        # LATER arm after our _stop.set(). Either way no capture thread
        # survives stop().
        with self._profile_lock:
            profile_thread, self._profile_thread = self._profile_thread, None
        if profile_thread is not None:
            # _stop is set above, so an armed capture's wait() returns
            # immediately and the profiler context closes before teardown.
            profile_thread.join(timeout=5)

    def __enter__(self) -> "IntrospectionServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    # ----------------------------------------------------------- clock thread
    def _clock(self) -> None:
        """The plane's cadence: tick_fns run on wall time, never on the
        poll path -- an idle stream still reports."""
        while not self._stop.wait(self.tick_every_s):
            for fn in self.tick_fns:
                try:
                    fn()
                except Exception:
                    import logging

                    logging.getLogger("kafkastreams_cep_tpu_torch.obs").warning(
                        "introspection tick failed", exc_info=True
                    )

    def _count_request(self) -> None:
        with self._req_lock:
            self.requests += 1

    # ---------------------------------------------------------------- routes
    def _route_metrics(self, query: Dict[str, List[str]]):
        self._count_request()
        return (
            "text/plain; version=0.0.4; charset=utf-8",
            self.registry.to_prom_text().encode("utf-8"),
        )

    def _route_snapshot(self, query: Dict[str, List[str]]):
        self._count_request()
        return (
            "application/json",
            json.dumps(self.registry.snapshot()).encode("utf-8"),
        )

    def _route_healthz(self, query: Dict[str, List[str]]):
        self._count_request()
        from ..faults import injection as _flt

        body: Dict[str, Any] = {
            "status": "ok",
            "uptime_s": time.time() - self._t_start,
            "requests": self.requests,
            "faults_armed": _flt.ACTIVE is not None,
        }
        if self.health_fn is not None:
            body.update(self.health_fn())
        return "application/json", json.dumps(body).encode("utf-8")

    def _route_tracez(self, query: Dict[str, List[str]]):
        self._count_request()
        limit = _limit(query)
        if query.get("format", [None])[0] == "chrome":
            from .trace_export import chrome_trace

            matches: List[Dict[str, Any]] = []
            if self.match_exemplars is not None:
                matches = self.match_exemplars(limit)
            doc = chrome_trace(
                tracer=self.tracer, match_exemplars=matches, limit=limit
            )
            return "application/json", json.dumps(doc).encode("utf-8")
        kind = query.get("kind", ["span"])[0]
        if kind == "match":
            matches: List[Dict[str, Any]] = []
            if self.match_exemplars is not None:
                matches = self.match_exemplars(limit)
            body: Dict[str, Any] = {"kind": "match", "matches": matches}
        else:
            name = query.get("span", [None])[0]
            body = {
                "kind": "span",
                "spans": self.tracer.recent(limit, name=name),
            }
        return "application/json", json.dumps(body).encode("utf-8")

    def _route_explainz(self, query: Dict[str, List[str]]):
        """Read-only match-lineage surface: the attached
        `explain_fn`'s recent entries, newest first. ``?query=name``
        filters to one query's matches; ``?trace_id=`` to one trace.
        Pure ring reads -- never touches the data path."""
        self._count_request()
        limit = _limit(query)
        entries: List[Dict[str, Any]] = []
        if self.explain_fn is not None:
            entries = self.explain_fn(limit)
            qname = query.get("query", [None])[0]
            if qname is not None:
                entries = [e for e in entries if e.get("query") == qname]
            tid = query.get("trace_id", [None])[0]
            if tid is not None:
                entries = [e for e in entries if e.get("trace_id") == tid]
        body = {"kind": "explain", "matches": entries}
        return "application/json", json.dumps(body).encode("utf-8")

    def _route_profilez(self, query: Dict[str, List[str]]):
        """Arm an on-demand device trace capture for ?secs=N (clamped)
        on a daemon thread, so the running pipeline profiles itself
        without a profiler attach. The capture wall also lands as a
        `device_trace` span (SpanTracer.device), so /tracez shows when a
        profile was taken. One capture at a time: a second request while
        armed replies busy instead of stacking profiler sessions."""
        self._count_request()
        try:
            secs = float(query.get("secs", ["1"])[0])
        except (TypeError, ValueError):
            secs = 1.0
        secs = max(0.0, min(secs, self.PROFILE_MAX_SECS))
        with self._profile_lock:
            if self._stop.is_set():
                # stop() already began: never arm a capture that would
                # outlive the plane (stop() joins under this same lock).
                body = {"armed": False, "stopping": True}
                return "application/json", json.dumps(body).encode("utf-8")
            if self._profile_thread is not None and self._profile_thread.is_alive():
                body = {"armed": False, "busy": True}
                return "application/json", json.dumps(body).encode("utf-8")
            log_dir = self.profile_dir
            if log_dir is None:
                import tempfile

                log_dir = tempfile.mkdtemp(prefix="cep-profilez-")

            def _capture() -> None:
                with self.tracer.device(log_dir):
                    self._stop.wait(secs)

            self._profile_thread = threading.Thread(
                target=_capture, name="kct-introspect-profile", daemon=True
            )
            self.profile_captures += 1
            self._profile_thread.start()
        body = {"armed": True, "secs": secs, "log_dir": log_dir}
        return "application/json", json.dumps(body).encode("utf-8")
