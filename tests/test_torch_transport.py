"""The port's wire transport against the JAX package's.

The frames are the JAX package's byte for byte: the same scripted client
session sends the same request bytes from either package's client, and
either package's server answers the same requests with the same
response bytes. A port client works against a JAX server and a JAX
client against a port server, with the same offsets and records. Under
the `net.*` fault sites the port's pipeline stays exactly once against
its fault-free golden run.

Counterparts of the JAX package's tests/test_transport.py:
- its twelve RecordLog, store-stack and LogDriver tests ->
  `test_log_and_store_stack_equal_jax` here, one case each or two
  joined (the crash/resume case is `driver_restart_sink`);
- contract parity, driver end to end + healthz, windowed appends,
  partial writes, budget fail-stop, seeded jitter, server dedup,
  stall detection, heartbeat, garbage connection, broker torn append,
  dedup eviction, restore under disconnect and stall -> the test of the
  same name here (cases of `test_socket_client_behaviour` where short);
- seeded socket chaos host / device -> `test_socket_pipeline_seeded_chaos`
  (the device runtime on the CPU's plain kernels);
- test_loopback_soak_flagship_sized and test_soak_cli_socket_transport
  are slow-marked there; the soak CLI over sockets is held by
  tests/test_torch_soak.py and run on the card by chip_smoke.py phase 25.
"""
from __future__ import annotations

import importlib
import json
import os
import socket
import struct
import threading
import time

import pytest

import kafkastreams_cep_tpu as J
import kafkastreams_cep_tpu.streams.transport as jwire
import kafkastreams_cep_tpu_torch as P
import kafkastreams_cep_tpu_torch.streams.transport as pwire
from kafkastreams_cep_tpu_torch.faults import (
    FaultInjector,
    FaultPoint,
    FaultSchedule,
    armed,
)
from kafkastreams_cep_tpu_torch.faults import harness
from kafkastreams_cep_tpu_torch.obs.registry import MetricsRegistry
from kafkastreams_cep_tpu_torch.streams.emission import decode_sink_key

SESSION = bytes(range(16))


def _letters(QB):
    return (
        QB()
        .select("select-A").where(lambda e, s: e.value == "A")
        .then().select("select-B").where(lambda e, s: e.value == "B")
        .then().select("select-C").where(lambda e, s: e.value == "C")
        .build()
    )


def _topology(pkg, log):
    builder = pkg.ComplexStreamsBuilder(log=log, app_id="wire")
    out = builder.stream("letters").query("q", _letters(pkg.QueryBuilder), runtime="host").to("matches")
    return builder.build(), out


def _sink(log, topic="matches"):
    return sorted((decode_sink_key(r.key)[1], r.value) for r in log.read(topic))


# ------------------------------------------------------------- the frames
class _Tap:
    """A loopback proxy in front of a server that records the bytes each
    way (client -> server, server -> client)."""

    def __init__(self, upstream):
        self.upstream = upstream
        self.up = bytearray()
        self.down = bytearray()
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(1)
        self.address = self._lsock.getsockname()
        threading.Thread(target=self._serve, daemon=True, name="kct-test-tap").start()

    def _serve(self):
        conn, _ = self._lsock.accept()
        peer = socket.create_connection(self.upstream)

        def pump(src, dst, sink):
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    sink += data
                    dst.sendall(data)
            except OSError:
                pass
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

        t = threading.Thread(target=pump, args=(peer, conn, self.down), daemon=True)
        t.start()
        pump(conn, peer, self.up)
        t.join(5)
        self._lsock.close()


def _script(log):
    """One scripted session: appends with tombstones and a trace blob,
    reads, end offsets, enumeration, flush."""
    log.append("t", b"k1", b"v1", timestamp=5)
    log.append("t", b"k2", None)
    log.append("t", None, None, partition=3)
    log.append("u", b"k", b"v" * 300, timestamp=-7, trace=b"\x01" * 25)
    out = [
        [tuple(r) for r in log.read("t")],
        [tuple(r) for r in log.read("u")],
        log.read("t", start=1, max_records=1)[0].offset,
        log.end_offset("t"), log.end_offset("t", 3), log.end_offset("nope"),
        log.topics(), log.partitions("t"),
    ]
    log.flush()
    return out


@pytest.mark.parametrize("window", [1, 4])
def test_frames_byte_equal_both_ways(window):
    """Same session id and script: the port client's request bytes equal
    the JAX client's, and the port server's response bytes equal the JAX
    server's."""
    taps, results = {}, {}
    for name, wire, RL in (("jax", jwire, J.RecordLog), ("port", pwire, P.RecordLog)):
        server = wire.RecordLogServer(RL(), registry=None).start()
        tap = _Tap(server.address)
        client = wire.SocketRecordLog(tap.address, session=SESSION, window=window)
        try:
            results[name] = _script(client)
        finally:
            client.close()
            time.sleep(0.05)
            server.stop()
        taps[name] = tap
    assert results["port"] == results["jax"]
    assert bytes(taps["port"].up) == bytes(taps["jax"].up)
    assert bytes(taps["port"].down) == bytes(taps["jax"].down)
    assert len(taps["port"].up) > 200


def test_frame_helpers_equal_jax():
    for payload in (b"", b"x", bytes(range(256)) * 3):
        assert pwire._seal(payload) == jwire._seal(payload)
    for s in ("", "letters", "ü-topic"):
        assert pwire._pack_str(s) == jwire._pack_str(s)
    for b in (None, b"", b"abc"):
        assert pwire._pack_blob(b) == jwire._pack_blob(b)
    ops = [n for n in dir(jwire) if n.startswith("OP_")]
    assert ops and all(getattr(pwire, n) == getattr(jwire, n) for n in ops)
    assert (pwire.WIRE_VERSION, pwire.MAX_FRAME) == (jwire.WIRE_VERSION, jwire.MAX_FRAME)


# ----------------------------------------------------------- interop
@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_cross_package_client_and_server(client_pkg, server_pkg):
    """A client of one package against a server of the other: the same
    offsets and records as the same script against an in-memory log, and
    a driver over the wire sinks the same matches."""
    wires = {"jax": (jwire, J), "port": (pwire, P)}
    swire, spkg = wires[server_pkg]
    cwire, cpkg = wires[client_pkg]
    server = swire.RecordLogServer(spkg.RecordLog()).start()
    client = cwire.SocketRecordLog(server.address, window=2)
    try:
        got = _script(client)
        want = _script(P.RecordLog())
        assert got[2:] == want[2:]
        assert [r[:4] for r in got[0]] == [r[:4] for r in want[0]]
        for i, ch in enumerate("XABCABYC"):
            cpkg.produce(client, "letters", "K", ch, timestamp=i)
        topo, out = _topology(cpkg, client)
        cpkg.LogDriver(topo, group="g").poll()
        mem = P.RecordLog()
        for i, ch in enumerate("XABCABYC"):
            P.produce(mem, "letters", "K", ch, timestamp=i)
        ptopo, _ = _topology(P, mem)
        P.LogDriver(ptopo, group="g").poll()
        assert [r.value for r in client.read("matches")] == [r.value for r in mem.read("matches")]
        assert len(out.records) == len(mem.read("matches")) >= 1
    finally:
        client.close()
        server.stop()


# ------------------------------------------------------- the port's client
@pytest.fixture
def loopback():
    reg = MetricsRegistry()
    server = pwire.RecordLogServer(P.RecordLog(), registry=reg).start()
    clients = []

    def connect(**kw):
        kw.setdefault("registry", reg)
        c = pwire.SocketRecordLog(server.address, **kw)
        clients.append(c)
        return c

    yield server, connect
    for c in clients:
        try:
            c.close()
        except Exception:
            pass
    server.stop()


def test_socket_record_log_contract_parity(loopback):
    _server, connect = loopback
    log = connect()
    assert _script(log) == _script(P.RecordLog())


def test_socket_driver_end_to_end_and_healthz(loopback):
    server, connect = loopback
    log = connect(window=8, heartbeat_s=5.0)
    for i, ch in enumerate("XABC"):
        P.produce(log, "letters", "K", ch, timestamp=i)
    topo, out = _topology(P, log)
    driver = P.LogDriver(topo, group="g1")
    assert driver.poll() == 4
    assert len(out.records) == 1
    payload = json.loads(log.read("matches")[0].value.decode("utf-8"))
    assert [s["name"] for s in payload["events"]] == ["select-A", "select-B", "select-C"]
    h = driver.health()["transport"]
    assert h["mode"] == "socket" and h["connected"] is True and h["pending_appends"] == 0
    assert server.health()["peers"] == 1


def _case_windowed(connect):
    log = connect(window=4)
    assert [log.append("t", b"k", b"v%d" % i) for i in range(24)] == list(range(24))
    log.flush()
    assert [r.value for r in log.read("t")] == [b"v%d" % i for i in range(24)]
    h = log.health()
    assert h["backpressure_hits"] > 0 and h["pending_appends"] == 0 and h["window"] == 4


def _case_jitter(connect):
    a, b = connect(backoff_seed=42), connect(backoff_seed=42)
    assert [a._rng.random() for _ in range(8)] == [b._rng.random() for _ in range(8)]


def _case_heartbeat(connect):
    log = connect(heartbeat_s=0.1)
    log.append("t", b"k", b"v")
    time.sleep(0.5)
    h = log.health()
    assert h["connected"] is True and h["last_ok_age_s"] is not None and h["last_ok_age_s"] < 0.5


@pytest.mark.parametrize("case", [_case_windowed, _case_jitter, _case_heartbeat],
                         ids=["windowed_backpressure", "seeded_jitter", "heartbeat"])
def test_socket_client_behaviour(loopback, case):
    case(loopback[1])


def test_reconnect_backoff_budget_exhaustion_fail_stop(loopback):
    server, connect = loopback
    log = connect(retry_budget=3, backoff_base_s=0.001, backoff_cap_s=0.01)
    assert log.append("t", b"k", b"v") == 0
    server.stop()
    with pytest.raises(pwire.TransportError, match="unrecoverable"):
        for _ in range(4):
            log.append("t", b"k", b"v")
    assert log.health()["backoff_retries"] >= 3


def _roundtrip(sock, payload):
    sock.sendall(pwire._seal(payload))
    length, _crc = pwire._FRAME.unpack(pwire._recv_exact(sock, pwire._FRAME.size))
    return pwire._recv_exact(sock, length)


def _hello(sid):
    return pwire.OP_HELLO + pwire._U64.pack(0) + sid + pwire._U32.pack(pwire.WIRE_VERSION)


def _append(seq, value=b"v"):
    return (
        pwire.OP_APPEND + pwire._U64.pack(seq) + pwire._pack_str("t")
        + pwire._I32.pack(0) + pwire._I64.pack(7)
        + pwire._pack_blob(b"k") + pwire._pack_blob(value)
    )


def test_server_dedup_replayed_append_across_reconnects(loopback):
    server, _connect = loopback
    sid = b"\x01" * 16
    with socket.create_connection(server.address, timeout=5.0) as s:
        assert _roundtrip(s, _hello(sid))[:1] == pwire.OP_OK
        first = _roundtrip(s, _append(1))
        assert _roundtrip(s, _append(1)) == first
        assert struct.unpack_from("<q", first, 9)[0] == 0
    with socket.create_connection(server.address, timeout=5.0) as s2:
        assert struct.unpack_from("<Q", _roundtrip(s2, _hello(sid)), 9)[0] == 1
        assert struct.unpack_from("<q", _roundtrip(s2, _append(1)), 9)[0] == 0
    assert server.backing.end_offset("t") == 1


def test_garbage_connection_is_isolated(loopback):
    server, connect = loopback
    with socket.create_connection(server.address, timeout=5.0) as junk:
        junk.sendall(b"GET / HTTP/1.1\r\n\r\n")
    log = connect()
    assert log.append("t", b"k", b"v") == 0
    deadline = time.monotonic() + 2.0
    while server.health()["torn_frames"] < 1:
        assert time.monotonic() < deadline, "garbage frame never counted"
        time.sleep(0.01)


def test_dedup_eviction_replay_fences_session():
    server = pwire.RecordLogServer(P.RecordLog(), registry=MetricsRegistry(), dedup_cache=4).start()

    def err_text(resp):
        assert resp[:1] == pwire.OP_ERR
        (n,) = struct.unpack_from("<I", resp, 9)
        return resp[13:13 + n].decode("utf-8")

    try:
        with socket.create_connection(server.address, timeout=5.0) as s:
            assert _roundtrip(s, _hello(b"\x07" * 16))[:1] == pwire.OP_OK
            for seq in range(1, 9):
                assert _roundtrip(s, _append(seq, b"v%d" % seq))[:1] == pwire.OP_OK
            assert struct.unpack_from("<q", _roundtrip(s, _append(6, b"v6")), 9)[0] == 5
            msg = err_text(_roundtrip(s, _append(2, b"v2")))
            assert "dedup" in msg and "fenced" in msg
            assert "fenced" in err_text(_roundtrip(s, _append(9, b"v9")))
            assert server.backing.end_offset("t") == 8
        with socket.create_connection(server.address, timeout=5.0) as s2:
            assert _roundtrip(s2, _hello(b"\x08" * 16))[:1] == pwire.OP_OK
            assert struct.unpack_from("<q", _roundtrip(s2, _append(1)), 9)[0] == 8
    finally:
        server.stop()


# ------------------------------------------------- exactly once under faults
def test_wire_partial_write_torn_frame_resync_exactly_once(loopback):
    stream = "ABCXABCABCYABC"
    mem = P.RecordLog()
    for i, ch in enumerate(stream):
        P.produce(mem, "letters", "K", ch, timestamp=i)
    P.LogDriver(_topology(P, mem)[0], group="g").poll()
    golden = _sink(mem)
    assert len(golden) == 4
    server, connect = loopback
    schedule = FaultSchedule([FaultPoint("net.partial_write", h) for h in (2, 9, 17)])
    with armed(FaultInjector(schedule)):
        log = connect(window=4, backoff_seed=1)
        for i, ch in enumerate(stream):
            P.produce(log, "letters", "K", ch, timestamp=i)
        driver = P.LogDriver(_topology(P, log)[0], group="g")
        while driver.poll(max_records=4):
            pass
    assert _sink(log) == golden
    assert server.health()["torn_frames"] >= 1
    assert log.health()["reconnects"] >= 1


def test_stall_detection_reconnect_exactly_once():
    reg = MetricsRegistry()
    server = pwire.RecordLogServer(P.RecordLog(), registry=reg, stall_inject_s=1.2).start()
    log = None
    try:
        with armed(FaultInjector(FaultSchedule([FaultPoint("net.stall", 3)]))):
            log = pwire.SocketRecordLog(server.address, registry=reg, io_timeout_s=0.25)
            assert log.append("t", b"k", b"v1") == 0
            assert log.append("t", b"k", b"v2") == 1
        h = log.health()
        assert h["stalls"] >= 1 and h["disconnects"] >= 1 and h["connected"] is True
        time.sleep(1.3)
        assert [r.value for r in log.read("t")] == [b"v1", b"v2"]
    finally:
        if log is not None:
            log.close()
        server.stop()


def test_broker_torn_append_restart_recovery(tmp_path):
    server = pwire.RecordLogServer(P.RecordLog(str(tmp_path / "broker"))).start()
    log = None
    try:
        with armed(FaultInjector(FaultSchedule([FaultPoint("log.torn_append", 3)]))):
            log = pwire.SocketRecordLog(server.address, io_timeout_s=2.0)
            for i in range(6):
                assert log.append("t", b"k", b"v%d" % i) == i
        assert [r.value for r in log.read("t")] == [b"v%d" % i for i in range(6)]
        assert server.health()["restarts"] == 1
        assert log.health()["reconnects"] >= 1
    finally:
        if log is not None:
            log.close()
        server.stop()


WIRE_CHAOS_SITES = (
    "driver.pre_commit", "driver.post_commit", "log.torn_append",
    "net.partial_write", "net.disconnect",
)


@pytest.mark.parametrize("runtime,seed", [("host", 0), ("host", 1), ("host", 2), ("cuda", 0)])
def test_socket_pipeline_seeded_chaos(tmp_path, runtime, seed):
    """The chaos harness (faults/harness.py) with the durable log behind
    a loopback socket and wire damage in the schedule: the sink digests
    equal the fault-free golden run, each match once. The device runtime
    runs the plain kernels on the CPU."""
    opts = dict(harness.DEVICE_OPTS, device="cpu") if runtime == "cuda" else {}
    keys = ("k0", "k1") if runtime == "cuda" else ("K",)
    stream = harness._stream(seed)
    golden = harness._golden(stream, keys=keys, runtime=runtime, **opts)
    assert golden
    server = pwire.RecordLogServer(P.RecordLog(str(tmp_path / "broker"))).start()
    schedule = FaultSchedule.seeded(seed, sites=WIRE_CHAOS_SITES, n_points=4 if runtime == "host" else 3)
    try:
        chaos, _crashes = harness._chaos(
            tmp_path, schedule, stream, keys=keys, runtime=runtime,
            log_open=lambda: pwire.SocketRecordLog(server.address, backoff_seed=seed, io_timeout_s=2.0),
            **opts,
        )
        assert sorted(chaos) == sorted(golden)
        assert len({d for d, _v in chaos}) == len(chaos), "duplicate emission"
    finally:
        server.stop()


def test_driver_restore_over_wire_under_disconnect_and_stall(tmp_path):
    events = list("XABCYABCXABC")
    mem = P.RecordLog()
    for i, ch in enumerate(events):
        P.produce(mem, "letters", "K", ch, timestamp=i)
    gdriver = P.LogDriver(_topology(P, mem)[0], group="g")
    while gdriver.poll(max_records=3):
        pass
    golden = _sink(mem)
    reg = MetricsRegistry()
    server = pwire.RecordLogServer(P.RecordLog(str(tmp_path / "broker")), registry=reg,
                                   stall_inject_s=3.0).start()
    half = len(events) // 2
    try:
        log = pwire.SocketRecordLog(server.address, registry=reg, io_timeout_s=2.0)
        for i, ch in enumerate(events[:half]):
            P.produce(log, "letters", "K", ch, timestamp=i)
        driver = P.LogDriver(_topology(P, log)[0], group="g", registry=reg)
        while driver.poll(max_records=3):
            pass
        driver.close()
        log.close()
        schedule = FaultSchedule([
            FaultPoint("driver.restore", 1), FaultPoint("net.disconnect", 3),
            FaultPoint("net.disconnect", 9), FaultPoint("net.stall", 1),
        ])
        with armed(FaultInjector(schedule, registry=reg)):
            log2 = pwire.SocketRecordLog(server.address, registry=reg, io_timeout_s=2.0)
            driver2 = P.LogDriver(_topology(P, log2)[0], group="g", registry=reg)
            assert driver2.restored_records > 0
            assert driver2.position("letters", 0) == half  # never from zero
            for i, ch in enumerate(events[half:], start=half):
                P.produce(log2, "letters", "K", ch, timestamp=i)
            while driver2.poll(max_records=3):
                pass
            driver2.close()
        assert "net.disconnect" in {p.site for p in schedule.points if p.fired}
        final = _sink(log2)
        assert final == golden
        assert len({d for d, _v in final}) == len(final)
        assert reg._metrics["cep_retries_total"].labels(site="driver.restore").value >= 1
        log2.close()
    finally:
        server.stop()


# ------------------------------------------ the record log and store stack
def _stack_record_log(pkg, tmp_path):
    log = pkg.RecordLog()
    out = [log.append("t", b"k1", b"v1", timestamp=5), log.append("t", b"k2", None),
           log.append("t", b"k3", b"v3", partition=2)]
    return out + [[tuple(r)[:4] for r in log.read("t")], log.read("t", partition=2)[0].value,
                  log.end_offset("t"), log.topics(), log.partitions("t")]


def _stack_file_reload(pkg, tmp_path):
    path = str(tmp_path / pkg.__name__)
    log = pkg.RecordLog(path)
    for i in range(5):
        log.append("t", b"k%d" % i, b"v%d" % i, timestamp=i)
    log.close()
    again = pkg.RecordLog(path)
    return [tuple(r)[:4] for r in again.read("t")]


def _stack_driver_sink(pkg, tmp_path):
    log = pkg.RecordLog(str(tmp_path / (pkg.__name__ + "d")))
    for i, ch in enumerate("ABCXABCAB"):
        pkg.produce(log, "letters", "K", ch, timestamp=i)
    topo, _ = _topology(pkg, log)
    driver = pkg.LogDriver(topo, group="g")
    driver.poll(max_records=5)
    driver.close()
    log.close()
    log = pkg.RecordLog(str(tmp_path / (pkg.__name__ + "d")))
    topo, _ = _topology(pkg, log)
    driver = pkg.LogDriver(topo, group="g")
    for i, ch in enumerate("C", start=9):
        pkg.produce(log, "letters", "K", ch, timestamp=i)
    driver.poll()
    return [(r.offset, r.value) for r in log.read("matches")], driver.position("letters", 0)


def _sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _stack_torn_tail(pkg, tmp_path):
    path = str(tmp_path / (pkg.__name__ + "t"))
    log = pkg.RecordLog(path)
    log.append("t", b"k1", b"v1")
    log.append("t", b"k2", b"v2")
    log.close()
    fname = [f for f in os.listdir(path) if f.endswith(".log")][0]
    with open(f"{path}/{fname}", "ab") as f:
        f.write(b"\x00\x07\x00\x00")  # a header fragment: torn mid-append
    log = pkg.RecordLog(path)
    out = [[(r.key, r.value) for r in log.read("t")], log.append("t", b"k3", b"v3")]
    log.close()
    return out + [[r.key for r in pkg.RecordLog(path).read("t")]]


def _stack_store_wrappers(pkg, tmp_path):
    st = _sub(pkg, "state.store")
    inner = st.InMemoryKeyValueStore("s")
    wrapped = st.WrappedStateStore(inner)
    wrapped.put("a", 1)
    out = [inner.get("a"), wrapped.approximate_num_entries(), wrapped.delete("a"),
           inner.get("a"), st.WrappedStateStore(wrapped).unwrap() is inner]
    log = pkg.RecordLog()
    store = st.ChangeLoggingKeyValueStore(st.InMemoryKeyValueStore("s"), log, "s-changelog")
    for op in (("put", "a", 1), ("put", "a", 2), ("put", "b", 3), ("delete", "b")):
        getattr(store, op[0])(*op[1:])
    fresh = st.ChangeLoggingKeyValueStore(st.InMemoryKeyValueStore("s"), log, "s-changelog")
    out += [fresh.restore(), fresh.get("a"), fresh.get("b"), log.end_offset("s-changelog")]
    cached = st.CachingKeyValueStore(st.ChangeLoggingKeyValueStore(
        st.InMemoryKeyValueStore("c"), log, "cl"))
    cached.put("a", 1)
    cached.put("a", 2)
    cached.put("b", 5)
    cached.delete("b")
    out += [log.end_offset("cl"), dict(cached.items())]
    cached.flush()
    return out + [log.end_offset("cl")]


def _stack_builders_and_restore(pkg, tmp_path):
    b = _sub(pkg, "state.builders")
    qsb = b.QueryStoreBuilders("My Query", _letters(pkg.QueryBuilder))
    out = [qsb.nfa.name, qsb.buffer.name, qsb.aggregates.name,
           b.changelog_topic("app1", qsb.nfa.name)]
    log = pkg.RecordLog()
    out.append(type(qsb.nfa.build(log, app_id="app1")._kv).__name__)
    qsb.nfa.with_logging_enabled().with_caching_enabled()
    stack = qsb.nfa.build(log)._kv
    out.append((type(stack).__name__, type(stack.inner).__name__))
    qsb = b.QueryStoreBuilders("q", _letters(pkg.QueryBuilder))
    stores = qsb.build_all(log, app_id="a")
    proc = pkg.CEPProcessor("q", qsb.stages, nfa_store=stores[qsb.nfa.name],
                            buffer=stores[qsb.buffer.name], aggregates=stores[qsb.aggregates.name])
    for i, ch in enumerate("AB"):
        proc.process("K", ch, timestamp=i, topic="t", offset=i)
    qsb2 = b.QueryStoreBuilders("q", _letters(pkg.QueryBuilder))
    stores2 = qsb2.build_all(log, app_id="a")
    out.append(sum(b.restore_store(s) for s in stores2.values()))
    proc2 = pkg.CEPProcessor("q", qsb2.stages, nfa_store=stores2[qsb2.nfa.name],
                             buffer=stores2[qsb2.buffer.name],
                             aggregates=stores2[qsb2.aggregates.name])
    matches = proc2.process("K", "C", timestamp=2, topic="t", offset=2)
    return out + [[[(s.stage, [e.value for e in s.events]) for s in m.matched] for m in matches]]


def _stack_driver_offsets(pkg, tmp_path):
    log = pkg.RecordLog()
    for i, ch in enumerate("XABC"):
        pkg.produce(log, "letters", "K", ch, timestamp=i)
    topo, out = _topology(pkg, log)
    driver = pkg.LogDriver(topo, group="g1")
    got = [driver.poll(), len(out.records), [json.loads(r.value) for r in log.read("matches")],
           driver.poll(), driver.position("letters")]
    offsets = _sub(pkg, "streams.driver").OFFSETS_TOPIC
    return got + [len(log.read(offsets)) > 0]


def _stack_crash_before_commit(pkg, tmp_path):
    f = _sub(pkg, "faults")
    path = str(tmp_path / (pkg.__name__ + "c"))
    log = pkg.RecordLog(path)
    for i, ch in enumerate("ABCXABCABC"):
        pkg.produce(log, "letters", "K", ch, timestamp=i)
    log.flush()
    crashes = 0
    schedule = f.FaultSchedule([f.FaultPoint("driver.pre_commit", 1),
                                f.FaultPoint("driver.pre_commit", 2)])
    with f.armed(f.FaultInjector(schedule)):
        while True:
            try:
                driver = pkg.LogDriver(_topology(pkg, log)[0], group="g")
                while driver.poll(max_records=4):
                    pass
                break
            except f.InjectedCrash:
                crashes += 1
                log.close()
                log = pkg.RecordLog(path)
    decode = _sub(pkg, "streams.emission").decode_sink_key
    sink = sorted((decode(r.key)[1], r.value) for r in log.read("matches"))
    log.close()
    return crashes, sink


@pytest.mark.parametrize("case", [
    _stack_record_log, _stack_file_reload, _stack_torn_tail, _stack_store_wrappers,
    _stack_builders_and_restore, _stack_driver_offsets, _stack_driver_sink,
    _stack_crash_before_commit,
], ids=["record_log", "file_reload", "torn_tail", "store_wrappers", "builders_and_restore",
        "driver_sink_and_offsets", "driver_restart_sink", "crash_before_commit"])
def test_log_and_store_stack_equal_jax(tmp_path, case):
    """The JAX package's RecordLog, store-stack and LogDriver tests, each
    run on both packages: the port's outputs equal the JAX package's."""
    got = case(P, tmp_path)
    assert got == case(J, tmp_path)
    if case is _stack_crash_before_commit:
        assert got[0] == 2 and len(got[1]) == 3 == len({d for d, _v in got[1]})
