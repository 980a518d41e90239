"""The port's `runtime="host"` topology against the JAX package's.

The host runtime is the per-record `CEPProcessor` over the three host
stores; both packages run it without compiling anything. Inputs come
from numpy/random seeds; every comparison is exact:
  * a letters stream over 6 keys on two topics, with records replayed
    below a key's high-water mark on one topic and the same records past
    the marks of the other (the mark is per topic and partition): every
    output record and the sink topic's key and value bytes equal the JAX
    topology's;
  * the stock demo golden (4 matches);
  * a gated sensors stream over 3 units (the keyed path: an arrival
    releases other keys' records);
  * `CheckpointCodec`: a processor snapshot after the stock golden's
    first half is byte for byte the JAX processor's, and each package
    restores the other's and finishes with the same matches;
  * the trio's and `EventTimeStateStore`'s changelogs are byte for byte
    the JAX topology's, and each package's topology restores from the
    other's changelogs and finishes with the uninterrupted sink;
  * through `LogDriver`, a crash between commits: the sink holds each
    match once, and equals the JAX driver's; a record whose predicate
    raises is dead-lettered as the JAX driver does.
"""
import pickle
import random

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.models import sensors as jsens  # noqa: E402
from kafkastreams_cep_tpu.models import stocks as jstocks  # noqa: E402
from kafkastreams_cep_tpu.obs.registry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafkastreams_cep_tpu.streams.builder import ComplexStreamsBuilder as JaxBuilder  # noqa: E402
from kafkastreams_cep_tpu.streams.driver import LogDriver as JaxLogDriver  # noqa: E402
from kafkastreams_cep_tpu.streams.driver import produce as jax_produce  # noqa: E402
from kafkastreams_cep_tpu.streams.log import RecordLog as JaxRecordLog  # noqa: E402
from kafkastreams_cep_tpu.streams.processor import CEPProcessor as JaxCEPProcessor  # noqa: E402
from kafkastreams_cep_tpu.streams.serde import sequence_to_json as jax_json  # noqa: E402
from kafkastreams_cep_tpu_torch.models import sensors as psens  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import letters_pattern, letters_stream  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stocks import (  # noqa: E402
    GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
)
from kafkastreams_cep_tpu_torch.streams.driver import dlq_topic  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key  # noqa: E402
from kafkastreams_cep_tpu_torch.streams.processor import CEPProcessor  # noqa: E402

KEYS = [f"u{i}" for i in range(6)]
TOPICS = ("letters", "letters2")


def _letters_records():
    """(topic, key, value, timestamp, offset): 6 keys x 96 letters spread
    over two topics, plus three records replayed at their offsets on one
    topic (deduped) and the same records on the other topic past its
    marks (processed)."""
    rng = random.Random(11)
    streams = {k: letters_stream(rng, 96) for k in KEYS}
    recs, offs = [], {t: 0 for t in TOPICS}
    for i in range(96):
        for j, k in enumerate(KEYS):
            topic = TOPICS[(i + j) % 2]
            e = streams[k][i]
            recs.append((topic, k, e.value, e.timestamp, offs[topic]))
            offs[topic] += 1
    first = [r for r in recs if r[0] == TOPICS[0]][:3]
    recs += first  # below the mark of their key on "letters": skipped
    # The same records on "letters2", past its marks: processed.
    recs += [(TOPICS[1], k, v, ts, offs[TOPICS[1]] + j)
             for j, (_t, k, v, ts, _off) in enumerate(first)]
    return recs


def _rows(records, to_json):
    return [(r.key, to_json(r.value), r.timestamp, r.topic, r.partition, r.offset)
            for r in records]


def _sink(log, topic="matches"):
    return [(r.key, r.value, r.timestamp) for r in log.read(topic)]


def _host_topology(pkg, pattern, topics=TOPICS, log=None, **opts):
    """A host-runtime topology of `pkg`, on a registry of its own."""
    builder = (P.ComplexStreamsBuilder if pkg is P else JaxBuilder)(log=log)
    registry = (P.obs.registry.MetricsRegistry if pkg is P else JaxRegistry)()
    out = builder.stream(list(topics)).query("Q", pattern, runtime="host", registry=registry,
                                             **opts)
    if log is not None:
        out = out.to("matches")
    return builder.build(), out


@pytest.mark.parametrize("with_log", [False, True], ids=["no_log", "log"])
def test_letters_host_topology_equals_jax(with_log):
    """Records, sink bytes and the per-topic high-water-mark dedup."""
    logs = (P.RecordLog(), JaxRecordLog()) if with_log else (None, None)
    runs = {}
    for pkg, log in zip((P, J), logs):
        topo, out = _host_topology(pkg, letters_pattern(pkg), log=log)
        for topic, key, value, ts, off in _letters_records():
            topo.process(topic, key, value, timestamp=ts, offset=off)
        assert topo.flush() == []
        runs[pkg] = (out, topo.queries[0][1].processor)
    (p_out, p_proc), (j_out, j_proc) = runs[P], runs[J]
    p_rows = _rows(p_out.records, P.sequence_to_json)
    assert len(p_rows) >= 4
    assert p_rows == _rows(j_out.records, jax_json)
    skipped = p_proc.metrics.get("cep_processor_skipped_total").labels(query="q").value
    assert skipped == 3 == j_proc.metrics.get(
        "cep_processor_skipped_total").labels(query="q").value
    assert set(p_proc.nfa_store.find("u0").latest_offsets) == {"letters#0", "letters2#0"}
    if with_log:
        assert _sink(logs[0]) == _sink(logs[1])
        assert len(_sink(logs[0])) == len(p_rows)


def test_stock_golden_through_runtime_host():
    log, j_log = P.RecordLog(), JaxRecordLog()
    topo, out = _host_topology(P, stocks_pattern(), topics=("stock-events",), log=log)
    j_topo, _ = _host_topology(J, jstocks.stocks_pattern(), topics=("stock-events",),
                               log=j_log)
    for i, e in enumerate(GOLDEN_EVENTS):
        topo.process("stock-events", "K1", e, timestamp=i)
        j_topo.process("stock-events", "K1", dict(e), timestamp=i)
    assert [P.sequence_to_json(r.value) for r in out.records] == GOLDEN_MATCHES
    assert [r.value.decode() for r in log.read("matches")] == GOLDEN_MATCHES
    assert _sink(log) == _sink(j_log)


def _sensor_records(dsl_sens):
    """3 units' fan-in feeds, interleaved record by record in arrival
    order (each unit's offsets its own)."""
    feeds = [dsl_sens.sensors_stream(random.Random(40 + u), 60, key=f"unit{u}")
             for u in range(3)]
    out = []
    for i in range(60):
        for feed in feeds:
            out.append(feed[i])
    return out


def test_gated_sensors_host_keyed_path_equals_jax():
    """reorder_capacity > 0: the host processor's keyed path, where an
    arrival releases records of other keys; matches carry their own key."""
    runs = {}
    for pkg, sens in ((P, psens), (J, jsens)):
        log = P.RecordLog() if pkg is P else JaxRecordLog()
        topics = [f"sensor{s}" for s in range(4)]
        topo, out = _host_topology(
            pkg, sens.sensors_pattern(), topics=topics, log=log,
            reorder_capacity=256, lateness_ms=sens.REORDER_BOUND_MS)
        for e in _sensor_records(sens):
            topo.process(e.topic, e.key, dict(e.value), timestamp=e.timestamp,
                         offset=e.offset)
        topo.flush_event_time()
        runs[pkg] = (out, log, topo.event_time_health())
    (p_out, p_log, p_health), (j_out, j_log, j_health) = runs[P], runs[J]
    p_rows = _rows(p_out.records, P.sequence_to_json)
    assert len({r[0] for r in p_rows}) == 3
    assert p_rows == _rows(j_out.records, jax_json)
    assert _sink(p_log) == _sink(j_log)
    assert p_health == j_health and p_health["gated_queries"] == 1


def test_checkpoint_codec_bytes_equal_jax_and_restore_both_ways():
    """`CEPProcessor.snapshot()` (CheckpointCodec.encode_query_stores over
    NFA states with folds, lineage buffers and fold registers) after half
    the golden, on two keys: byte for byte the JAX processor's; each
    package restores the other's bytes and finishes with the golden."""
    half = len(GOLDEN_EVENTS) // 2
    p_proc = CEPProcessor("Stocks", P.compile_pattern(stocks_pattern()))
    j_proc = JaxCEPProcessor("Stocks", J.compile_pattern(jstocks.stocks_pattern()))
    for i, e in enumerate(GOLDEN_EVENTS[:half]):
        for key in ("K1", "K2"):
            p_proc.process(key, e, timestamp=i, topic="s", offset=i)
            j_proc.process(key, dict(e), timestamp=i, topic="s", offset=i)
    blob = p_proc.snapshot()
    assert blob == j_proc.snapshot()
    p_rest = CEPProcessor.restore("Stocks", P.compile_pattern(stocks_pattern()), j_proc.snapshot())
    j_rest = JaxCEPProcessor.restore(
        "Stocks", J.compile_pattern(jstocks.stocks_pattern()), blob)
    assert p_rest.snapshot() == blob
    p_got, j_got = [], []
    for i, e in enumerate(GOLDEN_EVENTS[half:], start=half):
        p_got += [P.sequence_to_json(s) for s in p_rest.process("K1", e, timestamp=i,
                                                                topic="s", offset=i)]
        j_got += [jax_json(s) for s in j_rest.process("K1", dict(e), timestamp=i,
                                                     topic="s", offset=i)]
    assert p_got == j_got and p_got
    assert set(p_got) <= set(GOLDEN_MATCHES)


def _gated_letters(pkg, log, **opts):
    return _host_topology(pkg, letters_pattern(pkg), log=log, reorder_capacity=16,
                          lateness_ms=3, **opts)


def _feed(topo, recs):
    for topic, key, value, ts, off in recs:
        topo.process(topic, key, value, timestamp=ts, offset=off)


#: The changelogs of the three stores a gated port query writes back at
#: the commit (streams/builder.py), where the JAX package's append every
#: record's put: these compare at their newest record per key, the state
#: a restore rebuilds. Every other changelog compares record by record.
_WRITE_BACK_CHANGELOGS = ("states-changelog", "matched-changelog", "aggregates-changelog")


def _changelogs(log, topics):
    """Each changelog's records, in order; those of the write-back stores
    compacted to the newest record per key. The emission watermark's
    value pickles its package's class, so it compares by content."""
    out = {}
    for t in topics:
        recs = [(r.key, r.value) for r in log.read(t)]
        if t.endswith(_WRITE_BACK_CHANGELOGS):
            recs = dict(recs)
        elif t.endswith("-emitted-changelog"):
            recs = [(k, pickle.loads(v).sink_pos) for k, v in recs]
        out[t] = recs
    return out


@pytest.mark.parametrize("source", ["jax", "port"])
def test_changelogs_equal_jax_and_restore_both_ways(source):
    """A gated host topology commits (flush_stores) after the first half:
    every changelog topic (states, buffers, aggregates, event time,
    emission watermark) holds the JAX topology's bytes, in order, the
    write-back stores' at their newest record per key. A topology of the
    other package rebuilt on a copy of those changelogs restores and
    finishes the stream: its sink equals the uninterrupted run's."""
    recs = [(t, k, v, ts + (2 if i % 7 == 0 else 0), off)  # disorder within lateness
            for i, (t, k, v, ts, off) in enumerate(_letters_records()[: 6 * 96])]
    half = len(recs) // 2
    logs = {P: P.RecordLog(), J: JaxRecordLog()}
    whole = {}
    for pkg, log in logs.items():
        topo, _out = _gated_letters(pkg, log)
        _feed(topo, recs[:half])
        topo.flush_stores()
        whole[pkg] = topo
    topics = sorted(t for t in logs[P].topics() if t.endswith("-changelog"))
    # (letters has no folds: no aggregates changelog)
    assert {t.split("-streamscep-")[-1] for t in topics} == {
        "states-changelog", "matched-changelog", "eventtime-changelog", "emitted-changelog"}
    assert topics == sorted(t for t in logs[J].topics() if t.endswith("-changelog"))
    assert _changelogs(logs[P], topics) == _changelogs(logs[J], topics)
    # The uninterrupted sink.
    _feed(whole[P], recs[half:])
    whole[P].flush_event_time()
    want = _sink(logs[P])
    # Restore into the other package from a copy of the source's log.
    src_pkg = J if source == "jax" else P
    dst_pkg = P if source == "jax" else J
    dst_log = P.RecordLog() if dst_pkg is P else JaxRecordLog()
    src_log = logs[src_pkg]
    for topic in topics + ["matches"]:
        for r in src_log.read(topic)[: len(logs[J].read(topic))]:
            dst_log.append(topic, r.key, r.value, timestamp=r.timestamp)
    topo, _out = _gated_letters(dst_pkg, dst_log)
    assert topo.restore_stores() > 0
    _feed(topo, recs[half:])
    topo.flush_event_time()
    got = _sink(dst_log)
    assert got == want and len(want) >= 2
    digests = [decode_sink_key(k)[1] for k, _v, _t in got]
    assert len(set(digests)) == len(digests)


def _produce_letters(pkg, log, poison_at=None):
    produce = P.produce if pkg is P else jax_produce
    recs = [r for r in _letters_records() if r[0] == TOPICS[0]]
    for n, (_t, key, value, ts, _off) in enumerate(recs):
        if n == poison_at:
            produce(log, "letters", key, {"not": "a letter"}, timestamp=ts)
        produce(log, "letters", key, value, timestamp=ts)


def _raising_letters_pattern(pkg):
    """letters, but the first stage's predicate (`<= "A"`, which is
    `== "A"` on upper-case letters) raises on a dict value."""
    return (pkg.QueryBuilder()
            .select("a").where(pkg.value() <= "A")
            .then().select("b").where(pkg.value() == "B")
            .then().select("c").where(pkg.value() == "C")
            .build())


def test_driver_crash_between_commits_sinks_each_match_once():
    """`LogDriver` over a host topology: polls of 10 records, a commit
    after every second poll, a crash after the fifth (its poll past the
    last commit is replayed). The restarted sink equals the uninterrupted
    run's and the JAX driver's, each match once; the record whose
    predicate raised is dead-lettered once, as by the JAX driver."""
    def drive(pkg, log, stop_after=None):
        topo, _out = _host_topology(pkg, _raising_letters_pattern(pkg), topics=("letters",),
                                    log=log)
        driver = (P.LogDriver if pkg is P else JaxLogDriver)(topo, group="g")
        polls = 0
        while stop_after is None or polls < stop_after:
            if not driver.poll(max_records=10, commit=False):
                break
            polls += 1
            if polls % 2 == 0:
                driver.commit()
        return driver

    runs = {}
    for pkg in (P, J):
        log = P.RecordLog() if pkg is P else JaxRecordLog()
        _produce_letters(pkg, log, poison_at=17)
        drive(pkg, log)
        runs[pkg] = (_sink(log), [(r.key, r.value) for r in log.read(dlq_topic("letters"))])
    assert runs[P] == runs[J]
    assert len(runs[P][0]) >= 2 and len(runs[P][1]) == 1
    log = P.RecordLog()
    _produce_letters(P, log, poison_at=17)
    drive(P, log, stop_after=5)
    driver = drive(P, log)
    assert driver.restored_records > 0
    sink = _sink(log)
    assert sink == runs[P][0]
    digests = [decode_sink_key(k)[1] for k, _v, _t in sink]
    assert len(set(digests)) == len(digests)
    assert len(log.read(dlq_topic("letters"))) == 1


def test_caching_store_builders_batch_changelogs_as_jax():
    """`QueryStoreBuilders` with caching on: the host processor's writes
    stay in `CachingKeyValueStore` until `flush()`, which pushes each
    key's last value down once; the changelog bytes equal the JAX
    stack's, and a fresh stack restores the same states."""
    from kafkastreams_cep_tpu.state.builders import QueryStoreBuilders as JaxBuilders
    from kafkastreams_cep_tpu_torch.state.builders import QueryStoreBuilders, restore_store

    logs, procs = {}, {}
    for pkg, builders_cls, proc_cls, pattern in (
        (P, QueryStoreBuilders, CEPProcessor, stocks_pattern()),
        (J, JaxBuilders, JaxCEPProcessor, jstocks.stocks_pattern()),
    ):
        log = P.RecordLog() if pkg is P else JaxRecordLog()
        qb = builders_cls("Stocks", pattern)
        for b in (qb.nfa, qb.buffer, qb.aggregates):
            b.with_caching_enabled()
        stores = qb.build_all(log, "app")
        proc = proc_cls("Stocks", qb.stages, nfa_store=stores["stocks-streamscep-states"],
                        buffer=stores["stocks-streamscep-matched"],
                        aggregates=stores["stocks-streamscep-aggregates"])
        for i, e in enumerate(GOLDEN_EVENTS):
            proc.process("K1", e if pkg is P else dict(e), timestamp=i, topic="s", offset=i)
        assert not log.topics()  # nothing appended before the flush
        for store in stores.values():
            store.flush()
        logs[pkg], procs[pkg] = log, (qb, stores)
    topics = sorted(logs[P].topics())
    assert len(topics) == 3 and topics == sorted(logs[J].topics())
    for t in topics:
        recs = [(r.key, r.value) for r in logs[P].read(t)]
        assert recs == [(r.key, r.value) for r in logs[J].read(t)]
        assert len(recs) == len({k for k, _v in recs})  # one append per key
    qb, stores = procs[P]
    fresh_qb = QueryStoreBuilders("Stocks", stocks_pattern())
    fresh = fresh_qb.build_all(logs[P], "app")
    assert sum(restore_store(s) for s in fresh.values()) == sum(
        len(logs[P].read(t)) for t in topics)
    assert fresh_qb.codec.encode_nfa_states(fresh["stocks-streamscep-states"].find("K1")) == \
        qb.codec.encode_nfa_states(stores["stocks-streamscep-states"].find("K1"))
