"""Deterministic fault injection: seeded schedules over named crash sites.

A copy of the JAX package's `faults/injection.py`; the port's engine,
processor, driver, gate and log fire the same named sites.

The reference delegates its entire failure story to Kafka Streams
(changelog restore, task reassignment, offset commits --
CEPProcessor.java:111-160); the layers this framework adds on top of that
L0 contract -- the device engine, the async flat-drain decode thread, the
checkpoint codec -- need their failure modes *provoked*, not awaited. This
module is the provoker: a `FaultSchedule` (seeded RNG -> ordered fault
points) armed process-globally, with injection hooks compiled into the
production code at named crash sites. Every hook is a no-op unless armed:
the production path pays exactly one module-attribute check
(`ACTIVE is not None`), so a disarmed advance stays zero-sync.

Named sites (the full set is `ALL_SITES`):

  driver.pre_commit       LogDriver.poll, after processing, before commit()
  driver.post_commit      LogDriver.poll, after commit() returned
  driver.restore          LogDriver startup changelog restore (transient)
  engine.mid_drain        batched drain: ring pulled + cleared, decode
                          worker not yet joined (matches in flight)
  engine.device_step      the device advance dispatch (transient -- the
                          retry wrapper recovers it)
  store.checkpoint_write  CheckpointFile.save mid-write (torn bytes land
                          on the final path; CRC + last-good recover)
  log.torn_append         RecordLog.append: half a frame reaches the
                          segment file before the crash (reload truncates)
  time.reorder_overflow   EventTimeGate.offer admission (transient -- the
                          gate catches it and treats the reorder buffer
                          as full NOW, so chaos schedules exercise the
                          overflow policy path without filling a buffer)
  net.partial_write       SocketRecordLog frame send: half the frame lands
                          on the socket, then the connection is damaged
                          (transient -- the peer discards the torn frame
                          and the client's reconnect path re-delivers)
  net.disconnect          SocketRecordLog send/recv between frames
                          (transient -- reconnect + idempotent replay)
  net.stall               RecordLogServer apply loop: the server freezes
                          past the client's IO deadline (transient -- the
                          client's heartbeat/stall detection reconnects)

Crashes raise `InjectedCrash`, a BaseException subclass so no quarantine /
best-effort `except Exception` in the pipeline can accidentally swallow a
simulated process death. Transient sites raise `TransientFault` (an
Exception), which `with_retry` recovers.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "ALL_SITES",
    "CRASH_SITES",
    "TRANSIENT_SITES",
    "CEPOverflowError",
    "FaultInjector",
    "FaultPoint",
    "FaultSchedule",
    "InjectedCrash",
    "PoisonRecords",
    "TransientFault",
    "armed",
    "arm",
    "disarm",
    "with_retry",
]

#: Crash sites: the process "dies" here (InjectedCrash propagates).
CRASH_SITES: Tuple[str, ...] = (
    "driver.pre_commit",
    "driver.post_commit",
    "engine.mid_drain",
    "store.checkpoint_write",
    "log.torn_append",
)
#: Transient sites: the fault is recoverable in-process (TransientFault,
#: caught at the site -- by the retry wrapper, or by the event-time
#: gate's overflow hook, which reinterprets it as forced buffer pressure).
TRANSIENT_SITES: Tuple[str, ...] = (
    "engine.device_step",
    "driver.restore",
    "time.reorder_overflow",
    # Wire-transport sites (streams/transport.py): connection damage is
    # recoverable by design -- reconnect/backoff + idempotent replay.
    "net.partial_write",
    "net.disconnect",
    "net.stall",
)
ALL_SITES: Tuple[str, ...] = CRASH_SITES + TRANSIENT_SITES


class InjectedCrash(BaseException):
    """A simulated process death at a named crash site.

    BaseException on purpose: poison quarantine and best-effort reporters
    catch `Exception`, and a simulated crash must never be quarantined."""

    def __init__(self, site: str) -> None:
        super().__init__(site)
        self.site = site


class TransientFault(Exception):
    """A recoverable injected fault (device-step blip, log IO hiccup)."""

    def __init__(self, site: str) -> None:
        super().__init__(site)
        self.site = site


class CEPOverflowError(RuntimeError):
    """Engine capacity overflow escalated by `EngineConfig.on_overflow`.

    Raised (policy "raise", and "block" when backpressure could not keep
    the run loss-free) instead of the default loud-drop accounting. When
    raised from a drain boundary, `.matches` carries the successfully
    drained matches (the ring was already pulled), so callers can still
    deliver them. Lives here so host-only layers (streams/driver.py) can
    catch it without importing the engine."""

    #: Matches drained before the escalation (set at drain boundaries).
    matches = None


class PoisonRecords(Exception):
    """One or more records failed inside the engine's pack/predicate path.

    Carries [(key, Event, original exception)] so the driver can quarantine
    exactly the poison records while the batch's healthy remainder has
    already been processed."""

    def __init__(self, poisoned: List[Tuple[Any, Any, Exception]]) -> None:
        super().__init__(f"{len(poisoned)} poison record(s)")
        self.poisoned = poisoned


@dataclass
class FaultPoint:
    """One scheduled fault: fires on the `hit`-th call to its site."""

    site: str
    hit: int  # 1-based cumulative fire() count at this site
    fired: bool = field(default=False, compare=False)

    def __post_init__(self) -> None:
        if self.site not in ALL_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (known: {ALL_SITES})"
            )
        if self.hit < 1:
            raise ValueError("hit counts are 1-based")


class FaultSchedule:
    """An ordered set of fault points, optionally generated from a seed.

    `seeded(seed)` draws `n_points` (site, hit) pairs with a deterministic
    RNG so a failing chaos run reproduces from its seed alone. Hit counts
    are cumulative per site across the whole run -- they keep counting
    through simulated crashes, so one schedule can kill a pipeline several
    times at different depths."""

    def __init__(self, points: Iterable[FaultPoint]) -> None:
        self.points: List[FaultPoint] = list(points)

    @classmethod
    def seeded(
        cls,
        seed: int,
        sites: Sequence[str] = CRASH_SITES,
        n_points: int = 2,
        max_hit: int = 6,
    ) -> "FaultSchedule":
        rng = random.Random(seed)
        points = [
            FaultPoint(rng.choice(list(sites)), rng.randint(1, max_hit))
            for _ in range(n_points)
        ]
        # Two points on the same (site, hit) collapse to one fault.
        uniq = {(p.site, p.hit): p for p in points}
        return cls(sorted(uniq.values(), key=lambda p: (p.site, p.hit)))

    def pending(self) -> List[FaultPoint]:
        return [p for p in self.points if not p.fired]

    def __repr__(self) -> str:
        return f"FaultSchedule({self.points!r})"


class FaultInjector:
    """Arms a schedule: counts `fire()` calls per site, raises on matches.

    The injector outlives simulated crashes (it is test-side state, not
    pipeline state), so hit counts keep accumulating across restarts --
    exactly how a flaky environment behaves. `cep_faults_injected_total`
    lands in `registry` (the process default when none is passed)."""

    def __init__(
        self, schedule: FaultSchedule, registry: Optional[Any] = None
    ) -> None:
        from ..obs.registry import default_registry

        self.schedule = schedule
        self.hits: dict = {}
        self.fired: List[FaultPoint] = []
        self.metrics = registry if registry is not None else default_registry()
        self._m_injected = self.metrics.counter(
            "cep_faults_injected_total",
            "Faults fired by the injection harness",
            labels=("site",),
        )

    def fire(self, site: str, **ctx: Any) -> None:
        """Count one pass through `site`; raise if a point is due.

        `ctx` carries site-specific handles (the torn-append site gets the
        open segment file + frame bytes so it can land half a frame before
        the crash)."""
        n = self.hits.get(site, 0) + 1
        self.hits[site] = n
        for p in self.schedule.points:
            if p.fired or p.site != site or p.hit != n:
                continue
            p.fired = True
            self.fired.append(p)
            self._m_injected.labels(site=site).inc()
            if site == "log.torn_append":
                self._tear(ctx)
            if site == "store.checkpoint_write":
                self._corrupt_checkpoint(ctx)
            if site == "net.partial_write":
                self._partial_send(ctx)
            if site in TRANSIENT_SITES:
                raise TransientFault(site)
            raise InjectedCrash(site)

    @staticmethod
    def _tear(ctx: dict) -> None:
        """Land the first half of the frame durably, then die: the reload
        path must truncate exactly the torn tail (streams/log.py)."""
        f, payload = ctx.get("file"), ctx.get("payload", b"")
        if f is not None and payload:
            import os

            f.write(payload[: max(1, len(payload) // 2)])
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def _partial_send(ctx: dict) -> None:
        """Land the first half of the wire frame on the socket, then
        sever: the peer reads a torn frame (mid-frame EOF or CRC reject),
        discards it without applying, and drops the connection -- the
        client's reconnect path owns re-delivery on a clean frame
        boundary (streams/transport.py)."""
        sock, payload = ctx.get("sock"), ctx.get("payload", b"")
        if sock is not None and payload:
            try:
                sock.sendall(payload[: max(1, len(payload) // 2)])
            except OSError:
                pass  # an already-dead socket IS the disconnect

    @staticmethod
    def _corrupt_checkpoint(ctx: dict) -> None:
        """Land half the checkpoint bytes on the FINAL path (simulating a
        non-atomic writer / disk corruption), then die: load must reject
        the CRC and fall back to last-good (state/store.py)."""
        path, data = ctx.get("path"), ctx.get("data", b"")
        if path is not None and data:
            with open(path, "wb") as f:
                f.write(data[: max(1, len(data) // 2)])
                f.flush()
                import os

                os.fsync(f.fileno())


#: The process-global armed injector. Hooks check `ACTIVE is not None`
#: (one module-attribute read) and call `ACTIVE.fire(site)` only when a
#: harness armed one -- the production path is a no-op.
ACTIVE: Optional[FaultInjector] = None


def arm(injector: FaultInjector) -> FaultInjector:
    global ACTIVE
    ACTIVE = injector
    return injector


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


class armed:
    """Context manager: arm an injector (or a schedule) for the block."""

    def __init__(self, injector_or_schedule, registry: Optional[Any] = None):
        if isinstance(injector_or_schedule, FaultSchedule):
            injector_or_schedule = FaultInjector(
                injector_or_schedule, registry=registry
            )
        self.injector: FaultInjector = injector_or_schedule

    def __enter__(self) -> FaultInjector:
        return arm(self.injector)

    def __exit__(self, *exc) -> None:
        disarm()


def with_retry(
    fn: Callable[[], Any],
    site: str,
    attempts: int = 3,
    backoff_s: float = 0.001,
    retry_on: Tuple[type, ...] = (TransientFault, OSError),
    registry: Optional[Any] = None,
) -> Any:
    """Run `fn`, retrying transient failures with linear backoff.

    Retries only `retry_on` exceptions (never InjectedCrash -- a simulated
    process death must not be survivable in-process), caps at `attempts`
    total tries, and counts every retry in `cep_retries_total{site}`. The
    final failure re-raises."""
    from ..obs.registry import default_registry

    metrics = registry if registry is not None else default_registry()
    counter = metrics.counter(
        "cep_retries_total",
        "Transient-fault retries by site",
        labels=("site",),
    )
    last: Optional[BaseException] = None
    for attempt in range(max(1, attempts)):
        if attempt > 0:
            counter.labels(site=site).inc()
            if backoff_s > 0:
                time.sleep(backoff_s * attempt)
        try:
            return fn()
        except retry_on as exc:
            last = exc
    assert last is not None
    raise last
