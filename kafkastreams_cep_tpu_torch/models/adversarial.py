"""Adversarial workload generators: the soak plane's hostile traffic.

A copy of the JAX package's `models/adversarial.py`: the same seed gives
the same records.

The four model families shipped so far (stocks, letters, exchanges,
sensors) are *representative* workloads -- they exercise the engine the
way a healthy deployment would. Production traffic is not healthy: keys
skew onto hotspots, matches arrive in storms, sources stall their event
time, and tenants churn queries under a running fleet. This module
generates these four adversaries,
seeded, for the soak harness (faults/soak.py) and for targeted tests.

Design contract shared by every generator:

- **Incremental**: `chunk(n)` returns the next `n` events in arrival
  order; internal clocks/queues persist across calls, so a soak can pump
  a generator for hours without materializing the stream.
- **Deterministic**: two instances built with the same arguments yield
  identical streams (seeded `random.Random`, no wall-clock reads) -- a
  failing soak reproduces from its seed alone.
- **Well-formed per key**: letter payloads come from per-key block
  queues (the faults/harness.py block alphabet), so each key's
  sub-stream carries complete A->B->C runs regardless of how hostile the
  key interleaving gets -- matches keep flowing, which is the point: an
  adversarial generator that silences the match path stresses nothing.

`QueryChurnPlan` is the odd one out: query churn is not a record stream
but a schedule of topology rebuilds; the plan decides, per epoch, which
optional queries are live. The soak applies it by tearing the driver
down and rebuilding the topology -- the production "tenant registered /
deregistered a query" event.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.event import Event

__all__ = [
    "AdversarialGenerator",
    "KeySkewHotspot",
    "MatchStorm",
    "QueryChurnPlan",
    "WatermarkStall",
    "LETTER_BLOCKS",
]

#: Per-key payload blocks (the tests/test_faults.py alphabet): complete
#: A->B->C runs interleaved with partials and noise, so every key's
#: sub-stream completes matches at a steady, nonzero rate.
LETTER_BLOCKS: Tuple[str, ...] = ("ABC", "ABC", "AB", "BC", "X", "AXC", "Y")

#: Pure-noise letters (never selected by the A->B->C stages).
NOISE_LETTERS = "XYQZ"


class AdversarialGenerator:
    """Base: an incremental, seeded event stream.

    Subclasses implement `_next()` -> (key, value, timestamp_ms, topic)
    and may override `chunk` for arrival-order staging. `topics` lists
    every topic the generator produces into (the soak subscribes its
    query to exactly this set).
    """

    #: Display name (soak scenario key defaults to it).
    name = "adversarial"

    def __init__(self, seed: int, topic: str) -> None:
        self.rng = random.Random(seed)
        self.seed = seed
        self.topic = topic
        self.produced = 0
        self._ts = 1_000_000  # ms event clock
        #: Per-key pending letter queue (refilled from LETTER_BLOCKS).
        self._queues: Dict[str, List[str]] = {}

    @property
    def topics(self) -> List[str]:
        return [self.topic]

    def _letter(self, key: str) -> str:
        q = self._queues.setdefault(key, [])
        if not q:
            q.extend(self.rng.choice(LETTER_BLOCKS))
        return q.pop(0)

    def _next(self) -> Tuple[str, str, int, str]:  # pragma: no cover
        raise NotImplementedError

    def chunk(self, n: int) -> List[Event]:
        """The next `n` events in arrival order (offset left 0: the
        durable log assigns real offsets at produce time)."""
        out: List[Event] = []
        for _ in range(n):
            key, value, ts, topic = self._next()
            out.append(Event(key, value, ts, topic, 0, 0))
            self.produced += 1
        return out


class KeySkewHotspot(AdversarialGenerator):
    """Key-skew hotspot: one key absorbs `hot_frac` of all traffic.

    The batched engine parallelizes over keys, so a hotspot concentrates
    lane pressure, match chains and GC work on one lane while the cold
    keys idle -- the worst case for any per-key capacity sizing. Cold keys still trickle, so the key *set* stays wide.
    """

    name = "hotspot"

    def __init__(
        self,
        seed: int,
        topic: str = "hotspot",
        keys: int = 8,
        hot_frac: float = 0.9,
        tick_ms: int = 1,
    ) -> None:
        super().__init__(seed, topic)
        if not 0.0 < hot_frac <= 1.0:
            raise ValueError(f"hot_frac must be in (0, 1], got {hot_frac}")
        if keys < 1:
            raise ValueError(f"keys must be >= 1, got {keys}")
        self.keys = [f"h{i}" for i in range(keys)]
        self.hot_frac = float(hot_frac)
        self.tick_ms = int(tick_ms)

    def _next(self) -> Tuple[str, str, int, str]:
        self._ts += self.tick_ms
        if len(self.keys) == 1 or self.rng.random() < self.hot_frac:
            key = self.keys[0]
        else:
            key = self.rng.choice(self.keys[1:])
        return key, self._letter(key), self._ts, self.topic


class MatchStorm(AdversarialGenerator):
    """Match storms: long quiet stretches, then bursts where every
    record completes a pattern stage back-to-back across all keys.

    Quiet phases emit noise (plus rare partials), so the emission path
    idles; storm phases emit pure "ABC" cycles on every key, so the
    match rate jumps from ~0 to one match per 3 events x keys -- the
    drain/decode/emission stack's burst regime (sink pressure, latency
    histogram tails, emission-gate digest churn all spike at once).
    """

    name = "match_storm"

    def __init__(
        self,
        seed: int,
        topic: str = "storm",
        keys: int = 4,
        quiet_len: int = 140,
        storm_len: int = 60,
        tick_ms: int = 1,
    ) -> None:
        super().__init__(seed, topic)
        if quiet_len < 1 or storm_len < 1:
            raise ValueError("quiet_len and storm_len must be >= 1")
        self.keys = [f"s{i}" for i in range(max(1, keys))]
        self.quiet_len = int(quiet_len)
        self.storm_len = int(storm_len)
        self.tick_ms = int(tick_ms)
        self._phase_left = self.quiet_len
        self._storming = False
        self._cycle: Dict[str, int] = {}

    def _next(self) -> Tuple[str, str, int, str]:
        self._ts += self.tick_ms
        if self._phase_left <= 0:
            self._storming = not self._storming
            self._phase_left = (
                self.storm_len if self._storming else self.quiet_len
            )
            if self._storming:
                # A storm starts clean: every key restarts its ABC cycle
                # (a partial left over from the quiet phase would desync
                # the per-key run and mute part of the burst).
                self._cycle = {}
                self._queues = {}
        self._phase_left -= 1
        key = self.keys[self.produced % len(self.keys)]
        if self._storming:
            i = self._cycle.get(key, 0)
            self._cycle[key] = (i + 1) % 3
            return key, "ABC"[i], self._ts, self.topic
        # Quiet phase: noise with a rare partial (AB) to keep some live
        # runs resident across the storm boundary.
        if self.rng.random() < 0.05:
            return key, self.rng.choice("AB"), self._ts, self.topic
        return key, self.rng.choice(NOISE_LETTERS), self._ts, self.topic


class WatermarkStall(AdversarialGenerator):
    """Multi-source fan-in where one source stalls its event time.

    Each record lands on one of `sources` topics with a per-source
    delivery delay + jitter (the exchanges/sensors shape); after
    `stall_after` records, source `stall_source` goes permanently dark.
    A min-merge watermark keyed on source topics then stalls -- buffered
    records pile up behind the dark source's frozen clock until the
    per-source idle timeout fires and the merged watermark resumes.
    That pile-up/resume cycle is what the soak's `cep_watermark_lag_seconds`
    and `cep_reorder_occupancy` SLOs watch.

    `reorder_bound_ms` is the worst-case event-time displacement of the
    merged arrival stream: a gate with `lateness_ms >= reorder_bound_ms`
    reorders it losslessly (before the stall; post-stall admission is
    the late policy's business -- the soak pairs this generator with
    `late_policy="recompute-none"` so a spuriously-idled source never
    turns into silent drops).
    """

    name = "watermark_stall"

    def __init__(
        self,
        seed: int,
        topic: str = "stall",
        sources: int = 3,
        stall_source: int = 0,
        stall_after: int = 500,
        delays_ms: Sequence[int] = (0, 9, 17),
        jitter_ms: int = 3,
        tick_ms: int = 4,
        keys: int = 2,
    ) -> None:
        super().__init__(seed, topic)
        if sources < 2:
            raise ValueError(f"sources must be >= 2, got {sources}")
        if not 0 <= stall_source < sources:
            raise ValueError(f"stall_source out of range: {stall_source}")
        self.sources = int(sources)
        self.stall_source = int(stall_source)
        self.stall_after = int(stall_after)
        self.delays_ms = tuple(delays_ms)[:sources]
        if len(self.delays_ms) < sources:
            self.delays_ms = self.delays_ms + tuple(
                9 * i for i in range(len(self.delays_ms), sources)
            )
        self.jitter_ms = int(jitter_ms)
        self.tick_ms = int(tick_ms)
        self.keys = [f"w{i}" for i in range(max(1, keys))]

    @property
    def topics(self) -> List[str]:
        return [f"{self.topic}{i}" for i in range(self.sources)]

    @property
    def reorder_bound_ms(self) -> int:
        return max(self.delays_ms) - min(self.delays_ms) + self.jitter_ms

    @property
    def stalled(self) -> bool:
        return self.produced >= self.stall_after

    def chunk(self, n: int) -> List[Event]:
        """Stage `n` records, then emit them in ARRIVAL order (event
        time + per-source delay + jitter): each source's own feed stays
        in order while the merged stream interleaves out of order."""
        staged = []
        for i in range(n):
            self._ts += self.rng.choice((self.tick_ms, self.tick_ms,
                                         2 * self.tick_ms))
            live = [
                s for s in range(self.sources)
                if not (s == self.stall_source and self.stalled)
            ]
            src = self.rng.choice(live)
            key = self.rng.choice(self.keys)
            arrival = (
                self._ts + self.delays_ms[src]
                + self.rng.randint(0, self.jitter_ms)
            )
            staged.append((arrival, i, key, self._letter(key), self._ts, src))
            self.produced += 1
        staged.sort(key=lambda t: (t[0], t[1]))
        return [
            Event(key, val, ts, f"{self.topic}{src}", 0, 0)
            for (_arr, _i, key, val, ts, src) in staged
        ]


class QueryChurnPlan:
    """Seeded schedule of query add/remove epochs for the soak.

    `live(epoch)` returns the churn-query names live in that epoch --
    deterministic per seed, with every consecutive pair of epochs
    differing (each epoch boundary really is a churn event: the soak
    tears the driver down and rebuilds the topology, so restore,
    compile-cache and store-recovery paths run under traffic). Epoch 0
    always includes every query, so the churn stores exist (and carry
    state) before the first removal.
    """

    def __init__(
        self,
        seed: int,
        queries: Sequence[str] = ("churn-a", "churn-b"),
        period_s: float = 4.0,
    ) -> None:
        if not queries:
            raise ValueError("QueryChurnPlan needs at least one query")
        self.rng = random.Random(seed ^ 0x5EED)
        self.queries = tuple(queries)
        self.period_s = float(period_s)
        self._epochs: List[Tuple[str, ...]] = [self.queries]

    def epoch_at(self, elapsed_s: float) -> int:
        return int(max(0.0, elapsed_s) / self.period_s)

    def live(self, epoch: int) -> Tuple[str, ...]:
        while len(self._epochs) <= epoch:
            prev = self._epochs[-1]
            # Flip exactly one membership bit, chosen by the seed: the
            # new epoch always differs from the previous one.
            flip = self.rng.choice(self.queries)
            self._epochs.append(
                tuple(q for q in self.queries if (q in prev) != (q == flip))
            )
        return self._epochs[epoch]
