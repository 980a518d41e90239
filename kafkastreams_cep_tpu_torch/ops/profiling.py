"""Observability: per-batch timing and the match-emit latency histogram.

The port's copy of the JAX package's `ops/profiling.py`, `BatchTimings`
only: the framework-owned metrics are the per-batch engine timings
(dispatch vs drain wall), a match-emit latency histogram (time from
`advance` dispatch to the drain that surfaced the match), and the batch,
drain, slot, match and drain-byte totals.

`BatchTimings` is a consumer of the obs registry (obs/registry.py): every
record_* call writes through the registry's counters and histograms, and
the ring buffer it keeps is only the bounded sample window for percentile
summaries (the registry's histograms bucket cumulatively and never reset;
replacing a BatchTimings over the same registry resets the percentile
window while the counters stay monotonic).

The JAX package's `device_trace` (a `jax.profiler` capture) is not
copied: the port's device profile (CUDA events or `torch.profiler`) is a
later slice (ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..obs.registry import MetricsRegistry

#: Emit-latency-flavored buckets (seconds): the 500 ms contract sits
#: mid-scale, with decade coverage on both sides.
LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
)


class BatchTimings:
    """Ring buffer of per-batch timing records with percentile summaries.

    Semantics under the async dispatch model: `advance_s` is the
    host dispatch wall (sync-free advances pipeline, so this is NOT device
    time); `drain_s` spans the blocking drain -- the only sync point -- so
    `advance dispatch -> drain return` is the match-emit latency an outside
    observer experiences.

    `registry`: the obs spine to write through (a private registry is
    created when none is given, so a standalone BatchTimings still
    exposes). All registry instruments are get-or-create, so several
    BatchTimings over one registry share the same counters.
    """

    def __init__(
        self,
        capacity: int = 1024,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.capacity = capacity
        self.registry = registry if registry is not None else MetricsRegistry()
        self._records: List[Dict[str, float]] = []
        self._t_first_undrained: Optional[float] = None
        r = self.registry
        self._m_advance = r.histogram(
            "cep_advance_dispatch_seconds",
            "Host dispatch wall of the batched advance (async; not device time)",
        )
        self._m_post = r.histogram(
            "cep_post_dispatch_seconds",
            "Host dispatch wall of the per-advance post pass (append + GC)",
        )
        self._m_drain = r.histogram(
            "cep_drain_seconds", "Blocking drain wall (the sync point)",
        )
        self._m_pull = r.histogram(
            "cep_drain_pull_seconds",
            "D2H transfer wall per drain",
        )
        self._m_decode = r.histogram(
            "cep_decode_seconds", "Host match materialization wall per drain",
        )
        self._m_emit = r.histogram(
            "cep_emit_latency_seconds",
            "Match-emit latency: first undrained advance dispatch -> drain "
            "return",
            buckets=LATENCY_BUCKETS,
        )
        self._m_batches = r.counter("cep_batches_total", "Batches advanced")
        self._m_drains = r.counter("cep_drains_total", "Drains performed")
        self._m_slots = r.counter(
            "cep_slots_total", "Dispatched [T, K] slots (padding included)",
        )
        self._m_matches = r.counter(
            "cep_matches_total", "Matches surfaced by drains",
        )
        self._m_bytes = r.counter(
            "cep_drain_bytes_total", "D2H bytes pulled by drains",
        )
        self._m_tunnel = r.gauge(
            "cep_tunnel_mbps",
            "Effective D2H rate of the latest byte-bearing drain",
        )

    # ------------------------------------------------------------- recording
    def record_advance(
        self, seconds: float, slots: int, post_s: float = 0.0
    ) -> None:
        """`slots` is the dispatched [T, K] slot count (padding included) --
        known host-side without a device sync; exact event totals live in
        the engine's n_events counter. `seconds` is the advance dispatch
        wall, `post_s` the post-pass (pend append + GC) dispatch wall."""
        now = time.perf_counter()
        if self._t_first_undrained is None:
            self._t_first_undrained = now - seconds - post_s
        self._m_advance.observe(seconds)
        self._m_post.observe(post_s)
        self._m_batches.inc()
        self._m_slots.inc(slots)
        self._push(
            dict(
                kind=0.0, seconds=seconds, slots=float(slots),
                post_s=post_s,
            )
        )

    def record_drain(
        self,
        seconds: float,
        matches: int,
        pull_s: float = 0.0,
        decode_s: float = 0.0,
        bytes_pulled: int = 0,
    ) -> None:
        """`seconds` spans the blocking drain; `pull_s` is the D2H
        transfer wall (dispatch -> data landed host-side), `decode_s` the
        host materialization, `bytes_pulled` the actual D2H volume (feeds
        `tunnel_mbps`)."""
        now = time.perf_counter()
        emit_latency = (
            now - self._t_first_undrained
            if self._t_first_undrained is not None
            else seconds
        )
        self._t_first_undrained = None
        self._m_drain.observe(seconds)
        self._m_pull.observe(pull_s)
        self._m_decode.observe(decode_s)
        self._m_emit.observe(emit_latency)
        self._m_drains.inc()
        self._m_matches.inc(matches)
        if bytes_pulled:
            self._m_bytes.inc(bytes_pulled)
            if pull_s > 0:
                self._m_tunnel.set(bytes_pulled / pull_s / 1e6)
        self._push(
            dict(
                kind=1.0, seconds=seconds, matches=float(matches),
                emit_latency=emit_latency, pull_s=pull_s,
                decode_s=decode_s, bytes=float(bytes_pulled),
            )
        )

    def _push(self, rec: Dict[str, float]) -> None:
        self._records.append(rec)
        if len(self._records) > self.capacity:
            del self._records[: len(self._records) - self.capacity]

    # ------------------------------------------------------------ summaries
    def emit_latencies_ms(self) -> np.ndarray:
        return np.asarray(
            [r["emit_latency"] * 1e3 for r in self._records if r["kind"] == 1.0]
        )

    def histogram(self, bins: Optional[List[float]] = None) -> Dict[str, Any]:
        """Match-emit latency histogram (ms buckets)."""
        lat = self.emit_latencies_ms()
        if bins is None:
            bins = [1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0]
        counts, edges = np.histogram(lat, bins=[0.0] + bins + [np.inf])
        return {
            "edges_ms": [0.0] + list(bins) + [float("inf")],
            "counts": [int(c) for c in counts],
            "n": int(lat.size),
        }

    #: components() keys -- always all present, whatever was recorded
    #: (no-drain-yet, zero-match drains, profile_sync compute walls alike);
    #: tunnel_mbps is None (never 0 or inf) until a drain pulled bytes.
    COMPONENT_KEYS = (
        "advance_ms", "post_ms", "drain_pull_ms", "decode_ms",
        "drain_bytes", "tunnel_mbps",
    )

    def components(self) -> Dict[str, Any]:
        """Per-component mean wall per batch/drain (ms) + effective tunnel
        rate: {advance, post, drain_pull, decode} plus `tunnel_mbps` =
        total pulled bytes / total D2H wall (None until a drain pulled
        data). advance/post are DISPATCH walls (sync-free advances
        pipeline) unless the engine runs profile_sync=True, in which case
        they are compute walls; drain_pull is dispatch -> landed, which
        includes the flatten pass's device time -- an upper bound on pure
        transfer."""
        adv = [r for r in self._records if r["kind"] == 0.0]
        dr = [r for r in self._records if r["kind"] == 1.0]

        def mean_ms(recs: List[Dict[str, float]], field: str) -> float:
            if not recs:
                return 0.0
            return float(
                np.mean([r.get(field, 0.0) for r in recs]) * 1e3
            )

        total_bytes = float(sum(r.get("bytes", 0.0) for r in dr))
        # Rate denominator: only byte-bearing drains' pull walls -- a
        # probe-only drain (bytes == 0, tiny pull_s) would otherwise drag
        # the effective rate below what the copies actually moved.
        total_pull = float(
            sum(r.get("pull_s", 0.0) for r in dr if r.get("bytes", 0.0) > 0)
        )
        return {
            "advance_ms": mean_ms(adv, "seconds"),
            "post_ms": mean_ms(adv, "post_s"),
            "drain_pull_ms": mean_ms(dr, "pull_s"),
            "decode_ms": mean_ms(dr, "decode_s"),
            "drain_bytes": total_bytes,
            "tunnel_mbps": (
                float(total_bytes / total_pull / 1e6)
                if total_pull > 0 and total_bytes > 0
                else None
            ),
        }

    def summary(self) -> Dict[str, float]:
        lat = self.emit_latencies_ms()
        adv = np.asarray(
            [r["seconds"] for r in self._records if r["kind"] == 0.0]
        )
        slots = sum(r.get("slots", 0.0) for r in self._records if r["kind"] == 0.0)
        matches = sum(r.get("matches", 0.0) for r in self._records if r["kind"] == 1.0)
        out: Dict[str, float] = {
            "batches": float(adv.size),
            "drains": float(lat.size),
            "slots": float(slots),
            "matches": float(matches),
        }
        if adv.size:
            out["advance_dispatch_ms_mean"] = float(adv.mean() * 1e3)
        if lat.size:
            out["emit_latency_ms_p50"] = float(np.percentile(lat, 50))
            out["emit_latency_ms_p99"] = float(np.percentile(lat, 99))
            out["emit_latency_ms_max"] = float(lat.max())
        return out
