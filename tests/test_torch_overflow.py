"""The port's capacity contract against the JAX engine, on the CPU.

  * the fault the default `auto_drain` closes: with the engines'
    defaults, deferred decode over several advances and a ring of one
    page (`matches = T x matches_per_step`), the JAX engine drains before
    the ring can overflow and loses nothing; the port must do the same
    (before it had the guard it counted match_drops and returned fewer
    matches);
  * `on_overflow="block"` (tests/test_faults.py): a ring smaller than a
    page forces backpressure drains, zero drops, and the matches of a
    comfortably sized engine; under "drop" the same sizing loses matches
    and says so in `cep_overflow_dropped_total`; "raise" raises
    `CEPOverflowError` at the drain, carrying the drained matches;
  * the lane- and match-pressure cases of tests/test_differential.py
    (random patterns with folds and windows, lanes=4 or
    matches_per_step=1) under `auto_drain=True` with deferred decode:
    every key's match stream and every counter equal the JAX engine's.

Under auto_drain the test holds match streams and counters, not state: a
drain moves pend_min and so what the GC keeps, and when a drain happens
depends on when an asynchronous probe lands. The JAX side runs
`engine="xla"` with `exact_replay=False` and `provenance_sample=0`. Replay
off changes nothing here: the letters cases have no folds, and the
random fold patterns' streams never fold-collide (the compared counters
include `seq_collisions`), so the port's replay, on by default, never
fires; tests/test_torch_replay.py holds replay to the JAX engine at its
defaults.
"""
import random

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.faults.injection import CEPOverflowError as JaxOverflowError  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu.parallel import BatchedDeviceNFA as JaxBatched  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, TS0, letters_pattern  # noqa: E402

JAX_OFF = dict(engine="xla", exact_replay=False, provenance_sample=0.0,
               compile_telemetry=False)
DROPS = ("lane_drops", "node_drops", "match_drops")


def _json(out, to_json):
    return {k: [to_json(s) for s in v] for k, v in out.items()}


def _extend(acc, out, to_json):
    for k, seqs in out.items():
        acc.setdefault(k, []).extend(to_json(s) for s in seqs)


def test_default_auto_drain_loses_no_deferred_match():
    """Strict A->B->C over ABCABC... streams (one match every 3 events,
    never two in one step) at K=8, T=9, matches_per_step=1: six deferred
    advances into a ring of one page (9 ids) hold 18 matches a key; one
    drain. Both engines are built with their packages' defaults."""
    T, n_batches = 9, 6
    cfg = dict(CASES["letters"][3], matches_per_step=1, matches=T)
    keys = [f"k{i}" for i in range(8)]

    def streams(m):
        return {k: [m.Event(k, "ABC"[(i + j) % 3], TS0 + i, "t", 0, i)
                    for i in range(T * n_batches)] for j, k in enumerate(keys)}

    sj, sp = streams(J), streams(P)
    bx = JaxBatched(jax_compile_query(J.compile_pattern(letters_pattern(J)), None), keys=keys,
                    config=JaxEngineConfig(**cfg), **JAX_OFF)
    bp = P.BatchedDeviceNFA(P.compile_query(P.compile_pattern(letters_pattern()), None),
                            keys=keys, config=P.EngineConfig(**cfg), device="cpu")
    for b in range(n_batches):
        bx.advance_packed(bx.pack({k: s[b * T:(b + 1) * T] for k, s in sj.items()}),
                          decode=False)
        bp.advance_packed(bp.pack({k: s[b * T:(b + 1) * T] for k, s in sp.items()}),
                          decode=False)
    want, got = _json(bx.drain(), jax_json), _json(bp.drain(), P.sequence_to_json)
    assert all(bx.stats[c] == 0 for c in DROPS)
    assert min(map(len, want.values())) > cfg["matches"]
    assert bp.stats["match_drops"] == 0
    assert got == want
    assert bp.stats == bx.stats
    assert bp.metrics.get("cep_auto_drains_total").labels(trigger="ring_full").value > 0


def _matchy_events(m, key, n_batches, t=4):
    """tests/test_faults.py: batches of ABCA BCAB ... -- a completed
    match every 3 events."""
    return [[m.Event(key, "ABC"[(b * t + i) % 3], 1000 + b * t + i, "t", 0, b * t + i)
             for i in range(t)] for b in range(n_batches)]


#: tests/test_faults.py's sizing: pages of T x matches_per_step = 16 ids.
OVERFLOW_CFG = dict(lanes=8, nodes=256, matches_per_step=4)


def _port_engine(policy, matches):
    return P.BatchedDeviceNFA(P.compile_query(P.compile_pattern(letters_pattern()), None),
                              keys=["x", "y"], device="cpu",
                              config=P.EngineConfig(**OVERFLOW_CFG, matches=matches,
                                                    on_overflow=policy))


def _overflow_pair(policy, matches):
    bx = JaxBatched(jax_compile_query(J.compile_pattern(letters_pattern(J)), None),
                    keys=["x", "y"], registry=JaxRegistry(), **JAX_OFF,
                    config=JaxEngineConfig(**OVERFLOW_CFG, matches=matches,
                                           on_overflow=policy))
    return bx, _port_engine(policy, matches)


def _run_overflow(eng, m, to_json):
    for key in ("x", "y"):
        for evs in _matchy_events(m, key, 9):
            eng.advance_packed(eng.pack({key: evs}), decode=False)
    return _json(eng.drain(), to_json)


def test_overflow_block_backpressure_zero_drops_and_drop_is_loud():
    """A ring of 8 ids against pages of 16: "block" forces early drains
    and loses nothing (the matches of a ring of 1024, as the JAX engine's
    do, with as much backpressure); "drop" loses the JAX engine's
    matches, and counts them loud."""
    want = _run_overflow(_port_engine("drop", 1024), P, P.sequence_to_json)
    blocked_x, blocked_p = _overflow_pair("block", 8)
    assert _run_overflow(blocked_x, J, jax_json) == want
    assert _run_overflow(blocked_p, P, P.sequence_to_json) == want
    assert all(blocked_p.stats[c] == 0 for c in DROPS)
    bp_p = blocked_p.metrics.get("cep_overflow_backpressure_total").value
    assert bp_p > 0
    assert bp_p == blocked_x.metrics.get("cep_overflow_backpressure_total").value
    dropped_x, dropped_p = _overflow_pair("drop", 8)
    lost = _run_overflow(dropped_p, P, P.sequence_to_json)
    assert lost == _run_overflow(dropped_x, J, jax_json)
    assert sum(map(len, lost.values())) < sum(map(len, want.values()))
    assert dropped_p.stats == dropped_x.stats and dropped_p.stats["match_drops"] > 0
    loud = dropped_p.metrics.get("cep_overflow_dropped_total")
    assert loud.labels(counter="match_drops").value == dropped_p.stats["match_drops"]
    # The next drain reports only what was lost since this one.
    dropped_p.drain()
    assert loud.labels(counter="match_drops").value == dropped_p.stats["match_drops"]


def test_overflow_raise_escalates_with_the_drained_matches():
    from kafkastreams_cep_tpu_torch.streams.errors import CEPOverflowError

    bx, bp = _overflow_pair("raise", 8)
    with pytest.raises(JaxOverflowError) as jexc:
        _run_overflow(bx, J, jax_json)
    with pytest.raises(CEPOverflowError, match="capacity overflow") as pexc:
        _run_overflow(bp, P, P.sequence_to_json)
    got = _json(pexc.value.matches, P.sequence_to_json)
    assert got and got == _json(jexc.value.matches, jax_json)
    assert bp.stats == bx.stats
    # The loss was reported once: a clean drain after it does not raise.
    assert bp.drain() == {}


# ------------------------------------------- pressure differentials (auto_drain)
ALPHABET = ["A", "B", "C", "D"]


def random_pattern_extended(rng, m):
    """tests/test_differential.py's `random_pattern_extended`, built with
    package `m`."""
    n_stages = rng.randint(3, 4)
    qb = m.QueryBuilder()
    builder = None
    for i in range(n_stages):
        last = i == n_stages - 1
        strategy = (
            None if i == 0 else rng.choice(
                [None, m.Selected.with_skip_til_next_match(),
                 m.Selected.with_skip_til_any_match()])
        )
        name = f"s{i}"
        sel = qb.select(name) if strategy is None else qb.select(name, strategy)
        if builder is not None:
            sel = (builder.then().select(name) if strategy is None
                   else builder.then().select(name, strategy))
        if not last and i > 0:
            card = rng.randint(0, 4)
            if card == 1:
                sel = sel.one_or_more()
            elif card == 2:
                sel = sel.zero_or_more()
            elif card == 3:
                sel = sel.times(2)
            elif card == 4:
                sel = sel.optional()
        letter = rng.choice(ALPHABET[: 2 + i])
        pred = m.value() == letter
        if i > 0 and rng.random() < 0.5:
            pred = pred & (m.agg("cnt0", default=0) <= rng.randint(1, 3))
        builder = sel.where(pred)
        if i == 0 or rng.random() < 0.5:
            builder = builder.fold(f"cnt{i}" if i else "cnt0",
                                   m.agg("cnt0" if not i else f"cnt{i}", default=0) + 1)
    return builder.within(ms=rng.choice([4, 8, 16, 24])).build()


def random_stream(rng, n, m, key):
    """tests/test_differential.py's `random_stream` (timestamps advance
    0-2 ms an event)."""
    out, ts = [], TS0
    for i in range(n):
        ts += rng.choice([0, 1, 1, 2])
        out.append(m.Event(key, rng.choice(ALPHABET), ts, "t", 0, i))
    return out


PRESSURE = {
    # name: (seed base, EngineConfig keywords); T x matches_per_step fits
    # the ring, so the auto-drain guard is armed.
    "lane": (313_000, dict(lanes=4, nodes=512, matches=256, matches_per_step=16,
                           strict_windows=True)),
    "match_cap": (272_000, dict(lanes=64, nodes=1024, matches=16, matches_per_step=1,
                                strict_windows=True)),
}


@pytest.mark.parametrize("case,seed", [("lane", 0), ("match_cap", 0)])
def test_pressure_under_auto_drain_matches_jax(case, seed):
    base, cfg = PRESSURE[case]
    T, n_batches, keys = 16, 4, ["k0", "k1"]
    streams = []
    for m in (J, P):
        rng = random.Random(base + seed)
        pattern = random_pattern_extended(rng, m)
        streams.append((pattern, {k: random_stream(rng, T * n_batches, m, k) for k in keys}))
    (pj, sj), (pp, sp) = streams
    bx = JaxBatched(J.compile_pattern(pj), keys=keys, config=JaxEngineConfig(**cfg),
                    auto_drain=True, **JAX_OFF)
    bp = P.BatchedDeviceNFA(P.compile_pattern(pp), keys=keys, config=P.EngineConfig(**cfg),
                            device="cpu", auto_drain=True)
    want, got = {}, {}
    for b in range(n_batches):
        bx.advance_packed(bx.pack({k: s[b * T:(b + 1) * T] for k, s in sj.items()}),
                          decode=False)
        bp.advance_packed(bp.pack({k: s[b * T:(b + 1) * T] for k, s in sp.items()}),
                          decode=False)
        if b % 2:
            _extend(want, bx.drain(), jax_json)
            _extend(got, bp.drain(), P.sequence_to_json)
    assert got == want
    assert bp.stats == bx.stats
    drains = bp.metrics.get("cep_auto_drains_total").labels(trigger="ring_full").value
    assert drains > 0
    if case == "lane":
        assert bp.stats["match_drops"] == 0
    else:
        assert bp.stats["lane_drops"] == 0 and bp.stats["node_drops"] == 0
        assert bp.stats["match_drops"] > 0
