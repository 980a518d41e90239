"""Kernel-build telemetry: count the kernel signatures an engine needs.

The port's counterpart of the JAX package's `obs/compile.py`. There a
new shape signature of a jitted function is an XLA compile; here the
program whose shape is compile-time is the step kernel: ops/codegen.py
splices the query's tables and the capacity (lanes, node region, caps per
step) into csrc/nfa_step.cu, so every new (query, config) the engine
installs an advance for is a new kernel source -- on the card, a fresh
nvcc build unless csrc/_build/ already holds it. The GC mark kernel
(csrc/gc_mark.cu) takes every extent at launch and is built once per
process, so it has no signature to count.

`BatchedDeviceNFA` owns one watch (`engine.compile_watch`) and observes
the step's signature whenever it installs an advance: at construction and
at every `resize`. `gc_group` never reaches the generated source, so
`DrainController`'s cadence steps observe nothing; an autosizer's resize
observes one signature per new shape. A steady state whose knobs settled
is therefore compile-flat: `seen_count` stops moving.

A registry counts a signature once: every watch on one registry shares
its seen set, so an engine restored onto the registry of the engine it
replaces (a checkpoint round trip, a shard move) counts nothing new -- its
kernel is the library the process already built and loaded.

Registry series (the JAX names):

- ``cep_compiles_total{fn}``   new signatures observed
- ``cep_compile_seconds{fn}``  wall of the build (or cache load) that made
                               the signature's kernel loadable, when the
                               engine built it (on the card)
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Hashable, Optional, Tuple

from .registry import MetricsRegistry, default_registry

__all__ = ["CompileWatch", "COMPILE_BUCKETS"]

#: Build-wall buckets (seconds): a cache load takes milliseconds, an nvcc
#: build of the step kernel tens of seconds.
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)

#: registry -> {(fn, signature): seconds}: the signatures counted into it,
#: shared by every watch on that registry (module doc).
_SEEN: "weakref.WeakKeyDictionary[MetricsRegistry, Dict[Tuple[str, Hashable], Optional[float]]]" = (
    weakref.WeakKeyDictionary())
_SEEN_LOCK = threading.Lock()


class CompileWatch:
    """Counts distinct (function, signature) pairs into `registry`."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else default_registry()
        with _SEEN_LOCK:
            self._seen = _SEEN.setdefault(self.registry, {})
        self._m_compiles = self.registry.counter(
            "cep_compiles_total",
            "New kernel signatures (a new generated source: an nvcc build "
            "on the card unless cached) per kernel",
            labels=("fn",),
        )
        self._m_seconds = self.registry.histogram(
            "cep_compile_seconds",
            "Wall of the build or cache load that made a new signature's "
            "kernel loadable",
            labels=("fn",),
            buckets=COMPILE_BUCKETS,
        )

    def observe(self, fn: str, signature: Hashable, seconds: Optional[float] = None) -> bool:
        """Record one signature of `fn`; returns whether it was new. The
        wall, when given, is observed only for a new signature."""
        key = (fn, signature)
        with _SEEN_LOCK:
            if key in self._seen:
                return False
            self._seen[key] = seconds
        self._m_compiles.labels(fn=fn).inc()
        if seconds is not None:
            self._m_seconds.labels(fn=fn).observe(seconds)
        return True

    def compiles(self, fn: str) -> int:
        """Signatures observed for one function."""
        return int(self._m_compiles.labels(fn=fn).value)

    @property
    def seen_count(self) -> int:
        """Distinct (function, signature) pairs counted into the registry."""
        return len(self._seen)

    def builds(self) -> Dict[str, Any]:
        """JSON-ready summary: signatures and build seconds per function."""
        out: Dict[str, Any] = {}
        with _SEEN_LOCK:
            seen = list(self._seen.items())
        for (fn, _sig), secs in seen:
            entry = out.setdefault(fn, {"signatures": 0, "seconds": []})
            entry["signatures"] += 1
            if secs is not None:
                entry["seconds"].append(secs)
        return out
