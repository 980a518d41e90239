"""The port's single-key `DeviceNFA` against the JAX package.

`DeviceNFA` (ops/device_nfa.py) runs one stream through the batched
engine's passes at K = 1. Checked on the CPU (the plain step and the
plain GC mark; chip_smoke.py runs the kernels):

  * the NFATest scenarios of tests/test_device_nfa.py (reference:
    NFATest.java:47-874) held to the JAX package's host oracle `NFA` --
    jax-free, so nothing compiles: matches in order, `runs`, `n_live`,
    and `live_runs` against the oracle's queue; each scenario through
    the native decoder and, at its batch splits, through the Python pool
    walk (`decode_chains`), and the stock golden (4 matches);
  * against the JAX `DeviceNFA` (its XLA step) at both packages'
    defaults, each drain through the native `decode_matches` (the JAX
    class's pool route): matches, and state and pool bitwise after every advance
    (each drain flushes the GC group), on the skip-till-any scenario,
    the fold scenario, tests/test_watermarks.py's skip-till-any pattern
    with a watermark column, and tests/test_torch_replay.py's fold seed
    72 on one key (its interval replays through the oracle); and that
    skip-till-any pattern deferred (a drain every few advances) at
    gc_group 3 and 4 under `pin_interval`, once at a lane capacity that
    drops lanes, state and pool compared at every drain;
  * `snapshot()` bytes equal the JAX engine's after the same events, and
    each package's snapshot restores on the other with equal matches
    after it;
  * the GC pins of a match-free stream, the replay ledger bound and the
    overflow policy, and `device=None` without a card.
"""
import itertools
import random
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.runtime import DeviceNFA as JaxDeviceNFA  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import STOCK_FIELDS, branchy_case  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stocks import (  # noqa: E402
    GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
)
from kafkastreams_cep_tpu_torch.ops.runtime import DeviceNFA  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.errors import CEPOverflowError  # noqa: E402

TS = 1_000_000
#: tests/test_device_nfa.py's EngineConfig.
CONFIG = dict(lanes=16, nodes=512, matches=64)
LETTERS = "ABCCDCDE"  # ev1..ev8 of tests/test_device_nfa.py


def _sel(m, strategy):
    return {"next": m.Selected.with_skip_til_next_match,
            "any": m.Selected.with_skip_til_any_match}[strategy]()


def _chain(m, stages):
    """A pattern from (name, letter, strategy or None, quantifier or None)."""
    b = None
    for name, letter, strategy, quant in stages:
        sel = (m.QueryBuilder() if b is None else b.then())
        sel = sel.select(name) if strategy is None else sel.select(name, _sel(m, strategy))
        if quant == "*":
            sel = sel.zero_or_more()
        elif quant == "+":
            sel = sel.one_or_more()
        elif quant == "?":
            sel = sel.optional()
        elif quant == "3":
            sel = sel.times(3)
        elif quant == "2?":
            sel = sel.times(2).optional()
        b = sel.where(m.value() == letter)
    return b.build()


def _stateful(m):
    return (
        m.QueryBuilder()
        .select("first").where(m.value() > 0)
        .fold("sum", m.value())
        .fold("count", 1 + (m.agg("sum") - m.agg("sum")))
        .then()
        .select("second").one_or_more()
        .where((m.agg("sum") // m.agg("count")) >= m.value())
        .fold("sum", m.agg("sum") + m.value())
        .fold("count", m.agg("count") + 1)
        .then()
        .select("latest").where((m.agg("sum") // m.agg("count")) < m.value())
        .build()
    )


F = ("first", "A", None, None)
#: name -> (pattern of a package, events, batch splits): the scenarios of
#: tests/test_device_nfa.py. Events are indices into LETTERS (its ev1..ev8),
#: a string of letters, or ("values", [...]).
SCENARIOS = {
    "stateful_condition": (_stateful, ("values", [5, 3, 4, 10]), (0, 1, 2)),
    "times_occurrences": (lambda m: _chain(m, [F, ("second", "C", None, "3"),
                                               ("latest", "E", None, None)]),
                          [0, 2, 3, 5, 7], (0, 2)),
    "zero_or_more_no_matching_inputs": (lambda m: _chain(m, [F, ("second", "C", None, "*"),
                                                             ("latest", "D", None, None)]),
                                        [0, 4], (0,)),
    "zero_or_more_matching_inputs": (lambda m: _chain(m, [F, ("second", "C", None, "*"),
                                                          ("latest", "D", None, None)]),
                                     [0, 2, 3, 4], (0, 1)),
    "optional_times_no_matching_inputs": (lambda m: _chain(m, [F, ("second", "C", None, "2?"),
                                                               ("latest", "D", None, None)]),
                                          [0, 4], (0,)),
    "optional_times_matching_inputs": (lambda m: _chain(m, [F, ("second", "C", None, "2?"),
                                                            ("latest", "D", None, None)]),
                                       [0, 2, 3, 4], (0, 3)),
    "times_skip_til_next_match": (lambda m: _chain(m, [F, ("second", "C", "next", "3"),
                                                       ("latest", "E", None, None)]),
                                  [0, 2, 3, 4, 5, 7], (0,)),
    "optional_stage_strict_contiguity": (lambda m: _chain(m, [F, ("second", "B", None, "?"),
                                                              ("latest", "C", None, None)]),
                                         [0, 2], (0,)),
    "one_run_strict_contiguity": (lambda m: _chain(m, [F, ("second", "B", None, None),
                                                       ("latest", "C", None, None)]),
                                  [0, 1, 2], (0, 1)),
    "one_run_multiple_match": (lambda m: _chain(m, [("firstStage", "A", None, None),
                                                    ("secondStage", "B", None, None),
                                                    ("thirdStage", "C", None, "+"),
                                                    ("latestState", "D", None, None)]),
                               [0, 1, 2, 3, 4], (0,)),
    "two_consecutive_skip_til_next_match": (
        lambda m: _chain(m, [F, ("second", "C", "next", None), ("latest", "D", "next", None)]),
        [0, 1, 2, 3, 4], (0,)),
    "two_consecutive_skip_til_next_match_and_multiple_match": (
        lambda m: _chain(m, [F, ("second", "C", "next", "+"), ("latest", "D", "next", None)]),
        [0, 1, 2, 3, 4], (0, 2)),
    "two_consecutive_skip_til_any_match": (
        lambda m: _chain(m, [F, ("second", "C", "any", None), ("latest", "D", "any", None)]),
        [0, 1, 2, 3, 4], (0, 1)),
    "multiple_match_and_skip_til_any_match": (
        lambda m: _chain(m, [F, ("second", "C", "any", "+"), ("latest", "D", None, None)]),
        [0, 1, 2, 3, 4], (0, 2)),
    "four_stage_two_consecutive_skip_til_any_match": (
        lambda m: _chain(m, [F, ("second", "B", None, None), ("three", "C", "any", None),
                             ("latest", "D", "any", None)]),
        [0, 1, 2, 3, 4], (0,)),
    "multiple_strategies": (
        lambda m: _chain(m, [F, ("second", "B", None, None), ("three", "C", "any", None),
                             ("latest", "D", "next", None)]),
        [0, 1, 2, 3, 4], (0,)),
    "skip_til_any_match_on_latest_stage": (
        lambda m: _chain(m, [F, ("second", "B", None, None), ("three", "C", None, None),
                             ("latest", "D", "any", None)]),
        [0, 1, 2, 4, 6], (0,)),
    "begin_one_or_more_merges_stage_groups": (
        lambda m: _chain(m, [("first", "C", None, "+"), ("latest", "D", None, None)]),
        "CCD", (0,)),
}


def _events(m, spec):
    """The scenario's events in package m (SCENARIOS says how specs read)."""
    if isinstance(spec, tuple):
        return [m.Event("key", v, TS, "t1", 0, i) for i, v in enumerate(spec[1])]
    if isinstance(spec, str):
        return [m.Event("k", v, TS + i, "t", 0, i) for i, v in enumerate(spec)]
    return [m.Event(f"ev{x + 1}", LETTERS[x], TS, "test", 0, x) for x in spec]


def _oracle(pattern, events):
    oracle = J.NFA.build(J.compile_pattern(pattern), J.AggregatesStore(), J.SharedVersionedBuffer())
    matches = [jax_json(s) for e in events for s in oracle.match_pattern(e)]
    return oracle, matches


def _queue(oracle):
    """The oracle's live queue as (stage, run id, last event offset)."""
    out = []
    for cs in oracle.computation_stages:
        last = cs.last_event
        out.append((cs.stage.name, cs.sequence, None if last is None else last.offset))
    return out


def _run(dev, events, bs):
    got = []
    if bs <= 0:
        got = dev.advance(list(events))
    else:
        for i in range(0, len(events), bs):
            got.extend(dev.advance(list(events[i:i + bs])))
    return [P.sequence_to_json(s) for s in got]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_jax_host_oracle(name):
    make, spec, splits = SCENARIOS[name]
    oracle, want = _oracle(make(J), _events(J, spec))
    for bs in splits:
        for native in (True, False):
            dev = DeviceNFA(P.compile_pattern(make(P)), config=P.EngineConfig(**CONFIG),
                            device="cpu", native=native)
            got = _run(dev, _events(P, spec), bs)
            label = f"{name} batch {bs} native={native}"
            assert got == want, label
            assert dev.runs == oracle.runs, label
            assert dev.n_live == len(oracle.computation_stages), label
            live = [(r["stage"], r["sequence"],
                     None if r["last_event"] is None else r["last_event"].offset)
                    for r in dev.live_runs()]
            assert live == _queue(oracle), label


def test_skip_til_any_match_on_latest_stage_queue_shape():
    """NFATest.java:774-834's queue assertions, in the queue's order."""
    make, spec, _ = SCENARIOS["skip_til_any_match_on_latest_stage"]
    events = _events(P, spec)
    dev = DeviceNFA(P.compile_pattern(make(P)), config=P.EngineConfig(**CONFIG), device="cpu")
    matches = dev.advance(events)
    assert dev.runs == 4 and len(matches) == 2
    live = dev.live_runs()
    assert [(r["stage"], r["sequence"], r["last_event"]) for r in live] == [
        ("three", 4, events[2]), ("first", 2, None)]


def test_stock_golden():
    schema = P.EventSchema(STOCK_FIELDS)
    dev = DeviceNFA(P.compile_pattern(stocks_pattern()), schema=schema,
                    config=P.EngineConfig(lanes=32, nodes=512, matches=64), device="cpu")
    out = []
    for i, e in enumerate(GOLDEN_EVENTS):
        out += dev.match_pattern(P.Event("K1", e, i, "t", 0, i))
    assert [P.sequence_to_json(s) for s in out] == GOLDEN_MATCHES


def _skipany(m, window_ms=16):
    return (
        m.QueryBuilder()
        .select("a").where(m.value() == "A").within(ms=window_ms)
        .then().select("b", m.Selected.with_skip_til_any_match())
        .where(m.value() == "B").within(ms=window_ms)
        .then().select("c", m.Selected.with_skip_til_next_match())
        .where(m.value() == "C").within(ms=window_ms)
        .build()
    )


def _in_order(m, n=48, seed=3):
    """tests/test_watermarks.py's `in_order_stream`."""
    rng = random.Random(seed)
    ts = TS
    out = []
    for i in range(n):
        ts += rng.choice((0, 1, 1, 2, 7))
        out.append(m.Event("K", rng.choice("ABCX"), ts, "t", 0, i))
    return out


def _branchy72(m):
    pattern, streams = branchy_case(72, ["kA", "kB", "kC"], dsl=m)
    return pattern, streams["kA"]


#: name -> (pattern and events of a package, EngineConfig keywords, batch,
#: watermark column, advances a drain): the cases held to the JAX
#: DeviceNFA.
JAX_CASES = {
    "skip_til_any": (lambda m: (SCENARIOS["two_consecutive_skip_til_any_match"][0](m),
                                _events(m, SCENARIOS["two_consecutive_skip_til_any_match"][1])),
                     CONFIG, 1, False, 1),
    "stateful_condition": (lambda m: (_stateful(m), _events(m, SCENARIOS["stateful_condition"][1])),
                           CONFIG, 2, False, 1),
    "watermark_skipany": (lambda m: (_skipany(m), _in_order(m)),
                          dict(lanes=32, nodes=512, matches=64, strict_windows=True), 12, True, 1),
    "branchy_seed72": (_branchy72, dict(lanes=256, nodes=4096, matches=2048,
                                        matches_per_step=256), 5, False, 1),
    "skipany_gc_group3_pin": (lambda m: (_skipany(m), _in_order(m)),
                              dict(lanes=32, nodes=512, matches=64, strict_windows=True,
                                   gc_group=3, pin_interval=True), 6, False, 4),
    "skipany_gc_group4_lane_drops": (lambda m: (_skipany(m), _in_order(m)),
                                     dict(lanes=10, nodes=512, matches=64, strict_windows=True,
                                          gc_group=4, pin_interval=True), 6, False, 3),
}


def _jax_pair(name):
    make, cfg, bs, wm, _drain_every = JAX_CASES[name]
    pj, ej = make(J)
    pp, ep = make(P)
    dj = JaxDeviceNFA(J.compile_pattern(pj), config=JaxEngineConfig(**cfg))
    dp = DeviceNFA(P.compile_pattern(pp), config=P.EngineConfig(**cfg), device="cpu")
    return dj, dp, ej, ep, bs, wm


class _CountingDecoder:
    """The native decoder, counting the pool decodes (`decode_matches`)
    and refusing the flat table decode the engine no longer takes."""

    def __init__(self):
        from kafkastreams_cep_tpu_torch.native import load_decoder

        self._dec = load_decoder()
        self.calls = 0

    def decode_matches(self, *args):
        self.calls += 1
        return self._dec.decode_matches(*args)


def _same_state(dj, dp):
    for tree_j, tree_p in ((dj.state, dp.state), (dj.pool, dp.pool)):
        bad = [n for n in tree_j
               if np.asarray(tree_j[n]).dtype != tree_p[n].numpy().dtype
               or not np.array_equal(np.asarray(tree_j[n]), tree_p[n][..., 0].numpy())]
        assert not bad, bad


def _advance_both(dj, dp, ej, ep, i, bs, wm, decode=True):
    cj, cp = ej[i:i + bs], ep[i:i + bs]
    wj = [e.timestamp for e in cj] if wm else None
    mj = [jax_json(s) for s in dj.advance(cj, decode=decode, watermark_ms=wj)]
    mp = [P.sequence_to_json(s) for s in dp.advance(cp, decode=decode, watermark_ms=wj)]
    return mj, mp


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_equals_the_jax_device_nfa_state_for_state(name):
    dj, dp, ej, ep, bs, wm = _jax_pair(name)
    drain_every = JAX_CASES[name][4]
    assert dp.exact_replay == dj.exact_replay
    # The drain goes the JAX class's pool route, through decode_matches.
    dp._decoder = decoder = _CountingDecoder()
    total = drains = fruitful = 0
    starts = range(0, len(ej), bs)
    for n, i in enumerate(starts):
        drained = (n + 1) % drain_every == 0 or i == starts[-1]
        mj, mp = _advance_both(dj, dp, ej, ep, i, bs, wm, decode=drained)
        assert mp == mj, f"{name} events {i}:"
        total += len(mj)
        if drained:
            _same_state(dj, dp)  # each drain flushed the group
            drains += 1
            fruitful += bool(mp)
    assert total > 0
    # One decode_matches call a drain with pending matches (and none for
    # an empty ring); the decoder has no flat entry point to call.
    assert 0 < fruitful <= decoder.calls <= drains
    if name.endswith("lane_drops"):
        assert dp.stats["lane_drops"] > 0
    assert dp.runs == dj.runs and dp.n_live == dj.n_live and dp.stats == dj.stats
    assert dp.replays == dj.replays
    if name == "branchy_seed72":
        assert dp.replays > 0 and total == 21  # tests/test_torch_replay.py's kA


def test_snapshot_bytes_equal_and_restore_across_packages():
    """After the same events both packages write the same frame; each
    package's frame restores on the other, and the restored engines give
    the uninterrupted run's matches."""
    dj, dp, ej, ep, bs, wm = _jax_pair("branchy_seed72")
    half = 10
    for i in range(0, half, bs):
        _advance_both(dj, dp, ej, ep, i, bs, wm)
    blob_j, blob_p = dj.snapshot(), dp.snapshot()
    assert blob_p == blob_j
    pp, _ = _branchy72(P)
    pj, _ = _branchy72(J)
    cfg = JAX_CASES["branchy_seed72"][1]
    rp = DeviceNFA.restore(P.compile_pattern(pp), blob_j, config=P.EngineConfig(**cfg), device="cpu")
    rj = JaxDeviceNFA.restore(J.compile_pattern(pj), blob_p, config=JaxEngineConfig(**cfg))
    for i in range(half, len(ej), bs):
        mj, mp = _advance_both(dj, dp, ej, ep, i, bs, wm)
        mrj, mrp = _advance_both(rj, rp, ej, ep, i, bs, wm)
        assert mp == mj == mrp == mrj, f"events {i}"
    assert rp.snapshot() == dp.snapshot()


def test_gc_pins_do_not_leak_on_match_free_streams():
    """A long match-free prefix of expiring runs keeps `pinned` empty and
    drops nothing; the first real match afterwards is emitted."""
    pattern = (P.QueryBuilder()
               .select("first").where(P.value() == "A")
               .then().select("latest").where(P.value() == "B").within(ms=4)
               .build())
    dev = DeviceNFA(P.compile_pattern(pattern), config=P.EngineConfig(lanes=16, nodes=64, matches=64),
                    device="cpu")
    offsets = itertools.count()
    ts = TS
    for _ in range(120):
        batch = []
        for _ in range(4):
            batch.append(P.Event("k", "A", ts, "t", 0, next(offsets)))
            ts += 8
        assert dev.advance(batch) == []
    assert int(dev.pool["pinned"].sum()) == 0
    assert dev.stats["node_drops"] == 0
    matches = dev.advance([P.Event("k", "A", ts, "t", 0, next(offsets)),
                           P.Event("k", "B", ts + 1, "t", 0, next(offsets))])
    assert dev.stats["node_drops"] == 0
    assert len(matches) == 1 and [e.value for e in matches[0]] == ["A", "B"]


def test_replay_ledger_bound_warns_and_raises(monkeypatch):
    pattern, events = _branchy72(P)
    monkeypatch.setattr(DeviceNFA, "REPLAY_LEDGER_MAX_EVENTS", 8)
    dev = DeviceNFA(P.compile_pattern(pattern), config=P.EngineConfig(
        **JAX_CASES["branchy_seed72"][1]), device="cpu")
    assert dev.exact_replay
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(0, 15, 5):
            dev.advance(events[i:i + 5], decode=False)
    assert dev._interval_overflow
    assert sum("ledger exceeded" in str(w.message) for w in caught) == 1
    dev.drain()
    assert not dev._interval_overflow
    raising = DeviceNFA(P.compile_pattern(pattern), config=P.EngineConfig(
        **JAX_CASES["branchy_seed72"][1], on_overflow="raise"), device="cpu")
    with pytest.raises(CEPOverflowError), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(0, 15, 5):
            raising.advance(events[i:i + 5], decode=False)


def test_overflow_policy_raises_with_the_drained_matches():
    make, spec, _ = SCENARIOS["two_consecutive_skip_til_any_match"]
    dev = DeviceNFA(P.compile_pattern(make(P)), config=P.EngineConfig(
        lanes=2, nodes=512, matches=64, on_overflow="raise"), device="cpu")
    with pytest.raises(CEPOverflowError) as info:
        dev.advance(_events(P, spec))
    assert isinstance(info.value.matches, list)
    assert dev.stats["lane_drops"] > 0


def test_no_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pattern = SCENARIOS["one_run_strict_contiguity"][0](P)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceNFA(P.compile_pattern(pattern))
