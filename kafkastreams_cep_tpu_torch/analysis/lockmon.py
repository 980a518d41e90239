"""Instrumented-lock runtime monitor: lock-order cycle detection.

A copy of the JAX package's `analysis/lockmon.py` (pure `threading`),
made to nest: the static thread checker (analysis/threads.py) proves
shared writes are *locked*; it cannot prove two locks are always taken in
the same order. This monitor can: while armed, ``threading.Lock``/
``threading.RLock`` return instrumented wrappers that record, per thread,
which lock sites were held when each lock site was acquired. Every (held
-> acquired) pair is an edge in the lock-order graph; a cycle in that
graph is a potential deadlock (two threads can interleave the cyclic
orders), even if the run never actually deadlocked.

Lock identity is the *creation site* (file:line), not the instance:
per-request or per-engine lock instances from one source line are one
ordering class, so the graph is stable across runs and its nodes are
attributable (which is also why anonymous thread roots are a lint
finding -- CEP-T03 -- the edge samples record thread names).

Nesting: `install` saves whatever ``threading.Lock``/``RLock`` are
current (the stdlib's, or another monitor's -- the shared test conftest
arms the JAX package's for chaos/soak/transport tests) and `uninstall`
puts exactly those back, so monitors nest last-in first-out. The locks a
wrapper owns are always the interpreter's own (``_thread``), so a lock
made under this monitor is recorded here and not through an outer one.
Overhead while armed is one dict update per acquire; disarmed, nothing
is patched.

Usage::

    with lock_monitor() as mon:
        ... multithreaded work ...
    assert mon.cycles() == []
"""
from __future__ import annotations

import sys
import threading
import _thread
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Set, Tuple

__all__ = ["LockMonitor", "lock_monitor", "active_monitor"]

#: the un-instrumented allocators (graph bookkeeping must not recurse
#: into the instrumented constructors, and a wrapper never owns another
#: monitor's wrapper).
_raw_lock = _thread.allocate_lock
_raw_rlock = _thread.RLock

_active: Optional["LockMonitor"] = None


def active_monitor() -> Optional["LockMonitor"]:
    return _active


def _creation_site(depth: int = 2) -> str:
    """file:line of the instrumented constructor's caller, with stdlib
    frames skipped (a Condition() allocating its RLock should attribute
    to the caller of Condition, not to threading.py)."""
    frame = sys._getframe(depth)
    while frame is not None:
        fname = frame.f_code.co_filename
        if "threading" not in fname.rsplit("/", 1)[-1]:
            break
        frame = frame.f_back
    if frame is None:  # pragma: no cover - stdlib-only stack
        return "<unknown>"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


class _InstrumentedLock:
    """Wraps a real lock; delegates everything, records ordering edges."""

    def __init__(self, monitor: "LockMonitor", inner, site: str) -> None:
        self._mon = monitor
        self._inner = inner
        self._site = site

    # ------------------------------------------------------------- protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._mon._record_acquire(self._site)
        return got

    def release(self) -> None:
        self._inner.release()
        self._mon._record_release(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str):
        # Condition and friends poke at private lock internals
        # (_is_owned, _release_save, _at_fork_reinit, ...).
        return getattr(self._inner, name)


class LockMonitor:
    """The lock-order graph and the Lock/RLock patch points."""

    def __init__(self, max_edges: int = 4096) -> None:
        self.max_edges = max_edges
        self._graph_lock = _raw_lock()
        #: (held site, acquired site) -> sample {thread name}
        self.edges: Dict[Tuple[str, str], Set[str]] = {}
        #: creation sites of the locks made while armed (the graph's
        #: possible nodes; a diagnostic the JAX monitor does not keep)
        self.sites: Set[str] = set()
        self.acquires = 0
        self._held = threading.local()
        self._installed = False
        self._orig_lock = None
        self._orig_rlock = None
        self._make_lock = None
        self._make_rlock = None

    # ------------------------------------------------------------ recording
    def _stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def _record_acquire(self, site: str) -> None:
        if not self._installed:
            return  # wrapper outlived the monitor: plain lock behavior
        # The counter is deliberately unlocked: a lost increment is fine
        # for a diagnostic count, and taking the graph lock on EVERY
        # acquire would serialize all monitored threads through one
        # point (the monitor must not create the contention it audits).
        self.acquires += 1
        stack = self._stack()
        if stack:
            tname = threading.current_thread().name
            with self._graph_lock:
                for held in stack:
                    if held == site:
                        continue  # re-entrant same-site acquire
                    edge = (held, site)
                    samples = self.edges.get(edge)
                    if samples is None:
                        if len(self.edges) >= self.max_edges:
                            continue
                        samples = self.edges[edge] = set()
                    if len(samples) < 8:
                        samples.add(tname)
        stack.append(site)

    def _record_release(self, site: str) -> None:
        stack = self._stack()
        # Release order need not be LIFO; drop the innermost match.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                break

    # --------------------------------------------------------------- verdict
    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the lock-order graph (site lists); empty
        means no potential lock-order deadlock was observed."""
        with self._graph_lock:
            adj: Dict[str, Set[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        # Iterative DFS per start node; path-based cycle extraction. The
        # graph is tiny (lock *sites*, not instances), so simple wins.
        for start in sorted(adj):
            stack: List[Tuple[str, Iterator[str]]] = [
                (start, iter(sorted(adj.get(start, ()))))
            ]
            on_path = [start]
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if nxt == start:
                        cyc = on_path[:]
                        key = tuple(sorted(cyc))
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            out.append(cyc + [start])
                    elif nxt not in on_path and nxt in adj:
                        stack.append(
                            (nxt, iter(sorted(adj.get(nxt, ()))))
                        )
                        on_path.append(nxt)
                        advanced = True
                        break
                if not advanced:
                    stack.pop()
                    on_path.pop()
        return out

    def report(self) -> str:
        lines = [
            f"lockmon: {self.acquires} acquires, "
            f"{len(self.edges)} ordering edge(s)"
        ]
        for (a, b), threads in sorted(self.edges.items()):
            lines.append(f"  {a} -> {b}  [{', '.join(sorted(threads))}]")
        for cyc in self.cycles():
            lines.append("  CYCLE: " + " -> ".join(cyc))
        return "\n".join(lines)

    # ------------------------------------------------------------- patching
    def install(self) -> "LockMonitor":
        global _active
        if self._installed:
            return self
        if _active is not None:
            raise RuntimeError("another LockMonitor is already installed")
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        mon = self

        def make_lock():  # noqa: ANN202 - threading.Lock signature
            site = _creation_site()
            mon.sites.add(site)
            return _InstrumentedLock(mon, _raw_lock(), site)

        def make_rlock():
            site = _creation_site()
            mon.sites.add(site)
            return _InstrumentedLock(mon, _raw_rlock(), site)

        threading.Lock = make_lock  # type: ignore[assignment]
        threading.RLock = make_rlock  # type: ignore[assignment]
        self._make_lock, self._make_rlock = make_lock, make_rlock
        self._installed = True
        _active = self
        return self

    def uninstall(self) -> None:
        global _active
        if not self._installed:
            return
        # Put back what install() found -- unless a monitor armed after
        # this one still holds the patch points (out-of-order uninstall):
        # then it restores them to ours, whose wrappers act as plain
        # locks once uninstalled.
        if threading.Lock is self._make_lock:
            threading.Lock = self._orig_lock  # type: ignore[assignment]
        if threading.RLock is self._make_rlock:
            threading.RLock = self._orig_rlock  # type: ignore[assignment]
        self._installed = False
        if _active is self:
            _active = None
        # Wrappers created while armed keep working (they own real
        # locks); they just stop growing the graph once uninstalled.


@contextmanager
def lock_monitor():
    """Arm a LockMonitor for the block; yields it (query cycles() after)."""
    mon = LockMonitor().install()
    try:
        yield mon
    finally:
        mon.uninstall()
