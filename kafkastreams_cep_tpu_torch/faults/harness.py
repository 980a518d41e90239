"""The chaos sweep's harness: golden-vs-chaos sink digests over a durable
pipeline rebuilt after every injected crash.

A copy of the JAX package's CI harness (its `tests/test_faults.py`
helpers), kept in the package so the chaos CLI (faults/__main__.py) needs
no test module. `runtime="cuda"` is the device runtime; `device=` in the
options names its device (None = the card).

"Identical" is checked on emission digests -- unique per match occurrence
(streams/emission.py) -- so multiset equality proves zero duplicates AND
zero losses at once.
"""
from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..obs.registry import MetricsRegistry
from ..ops.engine import EngineConfig
from ..pattern.builder import QueryBuilder
from ..pattern.expressions import value
from ..streams.builder import ComplexStreamsBuilder
from ..streams.driver import LogDriver, produce
from ..streams.emission import decode_sink_key
from ..streams.log import RecordLog
from .injection import FaultInjector, InjectedCrash, armed

POISON = "!poison!"

#: The driver-layer crash sites a seeded sweep draws from.
DRIVER_SITES = ("driver.pre_commit", "driver.post_commit", "log.torn_append")

DEVICE_CFG = EngineConfig(lanes=8, nodes=256, matches=256,
                          matches_per_step=4, nodes_per_step=8)
#: The device runtime's sweep options (the JAX package's CI shape).
DEVICE_OPTS = dict(config=DEVICE_CFG, batch_size=5, initial_keys=2)


def device_pattern():
    """Expression form (device-compilable) of the A->B->C query."""
    return (
        QueryBuilder()
        .select("select-A").where(value() == "A")
        .then().select("select-B").where(value() == "B")
        .then().select("select-C").where(value() == "C")
        .build()
    )


def letters_pattern():
    """Lambda form of the same query (host runtime); a poison value
    raises in its second predicate."""
    def pred_b(e, s):
        if e.value == POISON:
            raise RuntimeError("poison value reached a predicate")
        return e.value == "B"

    return (
        QueryBuilder()
        .select("select-A").where(lambda e, s: e.value == "A")
        .then().select("select-B").where(pred_b)
        .then().select("select-C").where(lambda e, s: e.value == "C")
        .build()
    )


def _stream(seed: int, n: int = 36) -> List[str]:
    """Seeded letter stream with guaranteed complete A->B->C runs: blocks
    of full matches interleaved with partial-run and noise blocks."""
    rng = random.Random(seed)
    out: list = []
    while len(out) < n:
        out.extend(rng.choice(("ABC", "ABC", "AB", "BC", "X", "AXC", "Y")))
    return out[:n]


def _build(log, runtime="host", registry=None, **device_opts):
    pattern = letters_pattern() if runtime == "host" else device_pattern()
    builder = ComplexStreamsBuilder(log=log, app_id="chaos")
    out = (
        builder.stream("letters")
        .query("q", pattern, runtime=runtime,
               registry=registry, **device_opts)
        .to("matches")
    )
    return builder.build(), out


def _sink_digests(log) -> List[Tuple[bytes, Any]]:
    """[(digest, value bytes)] for every sink record -- digests are unique
    per match occurrence, so multiset equality == no dupes, no losses."""
    out = []
    for rec in log.read("matches"):
        _key, digest = decode_sink_key(rec.key)
        assert digest is not None
        out.append((digest, rec.value))
    return out


def _golden(stream: Sequence[str], keys=("K",), runtime="host", **device_opts):
    """The fault-free run's sink content (fresh in-memory log)."""
    log = RecordLog()
    for i, ch in enumerate(stream):
        produce(log, "letters", keys[(i // 6) % len(keys)], ch, timestamp=i)
    topo, _out = _build(log, runtime=runtime, **device_opts)
    driver = LogDriver(topo, group="g")
    while driver.poll(max_records=4):
        pass
    return _sink_digests(log)


def _chaos(tmp_path, schedule, stream, keys=("K",), runtime="host",
           max_crashes=24, log_open: Optional[Callable[[], Any]] = None,
           **device_opts):
    """Drive the same stream against a durable log with `schedule` armed,
    rebuilding from disk after every simulated crash; returns the final
    sink content and the number of crashes survived. `log_open` swaps the
    durable-log factory (a SocketRecordLog onto a broker) -- a "crash"
    then drops the client while the broker-side bytes survive, exactly as
    the file path drops objects but keeps segments."""
    path = str(tmp_path / "wal")
    open_log = log_open or (lambda: RecordLog(path))
    log = open_log()
    for i, ch in enumerate(stream):
        produce(log, "letters", keys[(i // 6) % len(keys)], ch, timestamp=i)
    log.flush()
    crashes = 0
    registry = MetricsRegistry()
    with armed(FaultInjector(schedule, registry=registry)):
        while True:
            topo, _out = _build(log, runtime=runtime, **device_opts)
            try:
                driver = LogDriver(topo, group="g")
                while driver.poll(max_records=4):
                    pass
                break
            except InjectedCrash:
                crashes += 1
                if crashes > max_crashes:
                    raise RuntimeError("chaos harness did not converge")
                # Process death: durable bytes survive, objects do not.
                log.close()
                log = open_log()
    digests = _sink_digests(log)
    log.close()
    return digests, crashes
