"""Chaos CLI: seeded fault sweeps and the SLO-gated production soak.

A mirror of the JAX package's `faults/__main__.py`. The sweep's harness
is the package's own (faults/harness.py), `--runtime` takes `host|cuda`,
and `--device` names the device runtime's device (the card by default).

Two modes share this entry point:

    # the chaos SWEEP (default; the original CLI): per-seed golden-vs-
    # chaos digest equality over a crash/rebuild pipeline
    python -m kafkastreams_cep_tpu_torch.faults --seeds 32 [--runtime cuda]

    # the production SOAK (faults/soak.py): scenario fleet + chaos +
    # self-scraped metrics time series + SLO verdict artifact
    python -m kafkastreams_cep_tpu_torch.faults soak --quick --out SOAK.json

    # WIRE TRANSPORT (streams/transport.py) -- terminal A
    # serves a RecordLog over a socket, terminal B runs a seeded chaos
    # pipeline against it (partial writes + disconnects injected client-
    # side) and pins digest equality vs a local fault-free golden run:
    python -m kafkastreams_cep_tpu_torch.faults --listen 9092 --listen-dir /tmp/wal
    python -m kafkastreams_cep_tpu_torch.faults --connect 127.0.0.1:9092

For each sweep seed it builds a fresh durable pipeline (letters query over
a file-backed RecordLog in a temp dir), computes the fault-free golden sink
stream, then replays the same stream under a seeded `FaultSchedule`,
rebuilding from disk after every simulated crash -- the harness of
faults/harness.py, sized for soaking rather than CI. Any divergence
(lost or duplicated match) prints the seed and exits nonzero, so a failing
seed reproduces with `--seeds-from N --seeds 1`.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    # Subcommand dispatch, backward compatible: bare flags keep running
    # the original sweep ("sweep" is accepted as its explicit name).
    if argv and argv[0] == "soak":
        from .soak import main as soak_main

        return soak_main(argv[1:])
    if argv and argv[0] == "sweep":
        argv = argv[1:]
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=16, help="how many seeds")
    ap.add_argument("--seeds-from", type=int, default=0, help="first seed")
    ap.add_argument("--runtime", default="host", choices=["host", "cuda"])
    ap.add_argument(
        "--device", default=None,
        help="the cuda runtime's device (default: the card; 'cpu' runs "
        "the plain kernels)",
    )
    ap.add_argument("--events", type=int, default=48, help="stream length")
    ap.add_argument("--points", type=int, default=3, help="faults per seed")
    ap.add_argument(
        "--http-port", type=int, default=None, metavar="PORT",
        help="serve the live introspection plane (/metrics /snapshot "
        "/healthz /tracez) over the process-default registry while the "
        "soak runs; 0 binds an ephemeral port (printed)",
    )
    ap.add_argument(
        "--listen", default=None, metavar="[HOST:]PORT",
        help="serve a RecordLog over the wire (streams/transport.py) "
        "until Ctrl-C (or --listen-for), instead of sweeping",
    )
    ap.add_argument(
        "--listen-dir", default=None, metavar="DIR",
        help="file-backed segment dir for --listen (default: in-memory)",
    )
    ap.add_argument(
        "--listen-for", type=float, default=None, metavar="SECONDS",
        help="stop the --listen server after this many seconds",
    )
    ap.add_argument(
        "--connect", default=None, metavar="HOST:PORT",
        help="run one seeded chaos pipeline (seed = --seeds-from) over a "
        "remote --listen RecordLogServer: net.partial_write and "
        "net.disconnect join the schedule, and the sink digests must "
        "equal a local fault-free golden run (needs a FRESH server log)",
    )
    args = ap.parse_args(argv)

    if args.listen is not None:
        return _serve(args)

    from . import FaultSchedule
    from .harness import DRIVER_SITES, _chaos, _golden, _stream

    if args.connect is not None:
        return _connect_run(args, FaultSchedule)

    sites = DRIVER_SITES + (
        ("engine.mid_drain",) if args.runtime == "cuda" else ()
    )
    opts, keys = _runtime_opts(args)
    failures = 0
    progress = {"seed": None, "done": 0, "failures": 0}
    server = None
    tracer = None
    if args.http_port is not None:
        # The soak's live plane: the chaos pipelines' drivers
        # report into the process-default registry, so /metrics shows the
        # driver layer moving mid-soak (polls/commits/restores/retries;
        # the harness arms its injector on a private registry, so
        # injected-fault totals stay out of this exposition); /healthz
        # reports soak progress + fault-arm state; /tracez carries the
        # soak's own per-seed spans (the harness-internal drivers keep
        # private tracers, so their restore/commit spans live in their
        # rings, not this server's).
        from ..obs import IntrospectionServer, SpanTracer, default_registry

        def _soak_health():
            return dict(progress, total_seeds=args.seeds,
                        runtime=args.runtime)

        tracer = SpanTracer(default_registry())
        server = IntrospectionServer(
            registry=default_registry(), tracer=tracer,
            health_fn=_soak_health, port=args.http_port,
        ).start()
        print(f"introspection plane: {server.url}")
    import contextlib

    for seed in range(args.seeds_from, args.seeds_from + args.seeds):
        stream = _stream(seed, n=args.events)
        golden = _golden(stream, keys=keys, runtime=args.runtime, **opts)
        schedule = FaultSchedule.seeded(seed, sites=sites,
                                        n_points=args.points)

        class _Tmp:
            def __truediv__(self, name):
                import pathlib

                return pathlib.Path(tempfile.mkdtemp()) / name

        span = (
            tracer.span(f"seed-{seed}")
            if tracer is not None else contextlib.nullcontext()
        )
        with span:
            chaos, crashes = _chaos(
                _Tmp(), schedule, stream, keys=keys,
                runtime=args.runtime, **opts
            )
        ok = sorted(chaos) == sorted(golden)
        print(
            f"seed {seed}: {len(golden)} matches, {crashes} crashes, "
            f"{'OK' if ok else 'DIVERGED'}"
        )
        if not ok:
            failures += 1
            print(f"  schedule: {schedule}")
        progress.update(seed=seed, done=progress["done"] + 1,
                        failures=failures)
    print(f"{args.seeds} seeds, {failures} divergent")
    if server is not None:
        server.stop()
    return 1 if failures else 0


def _runtime_opts(args):
    """(query options, keys) of the sweep's runtime: the device runtime
    on `--device` (the card by default; raises without one), or host."""
    if args.runtime != "cuda":
        return {}, ("K",)
    from ..parallel.batched import resolve_device
    from .harness import DEVICE_OPTS

    return dict(DEVICE_OPTS, device=resolve_device(args.device)), ("k0", "k1")


def _parse_addr(spec: str, default_host: str = "127.0.0.1"):
    host, _, port_s = spec.rpartition(":")
    return (host or default_host, int(port_s))


def _serve(args) -> int:
    """--listen: broker a RecordLog over the wire for remote --connect
    runs (or any SocketRecordLog). A pure host-side broker process."""
    import time

    from ..streams.log import RecordLog
    from ..streams.transport import RecordLogServer

    host, port = _parse_addr(args.listen)
    server = RecordLogServer(
        RecordLog(args.listen_dir), host=host, port=port
    ).start()
    addr = server.address
    where = args.listen_dir or "in-memory"
    print(f"RecordLogServer on {addr[0]}:{addr[1]} (backing: {where}); "
          "Ctrl-C to stop")
    try:
        if args.listen_for is not None:
            time.sleep(args.listen_for)
        else:
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.backing.close()
    return 0


def _connect_run(args, fault_schedule_cls) -> int:
    """--connect: the sweep harness once (seed = --seeds-from), with the
    durable log on the far side of a socket and the wire fault sites in
    the schedule. Digest equality vs the local fault-free golden run is
    the same exactly-once pin the CI suite enforces."""
    import pathlib
    import tempfile

    from ..streams.transport import SocketRecordLog
    from .harness import _chaos, _golden, _stream

    host, port = _parse_addr(args.connect)
    probe = SocketRecordLog((host, port))
    dirty = probe.end_offset("letters") or probe.end_offset("matches")
    probe.close()
    if dirty:
        print(f"--connect: the server log at {host}:{port} already has "
              "letters/matches records; exactly-once digests need a "
              "fresh --listen server", file=sys.stderr)
        return 2
    opts, keys = _runtime_opts(args)
    seed = args.seeds_from
    stream = _stream(seed, n=args.events)
    golden = _golden(stream, keys=keys, runtime=args.runtime, **opts)
    # log.torn_append lives in the REMOTE process (it is not armed
    # there), so the wire sweep schedules driver crashes + client-side
    # wire damage only.
    sites = ("driver.pre_commit", "driver.post_commit",
             "net.partial_write", "net.disconnect")
    schedule = fault_schedule_cls.seeded(
        seed, sites=sites, n_points=args.points
    )

    class _Tmp:
        def __truediv__(self, name):
            return pathlib.Path(tempfile.mkdtemp()) / name

    chaos, crashes = _chaos(
        _Tmp(), schedule, stream, keys=keys, runtime=args.runtime,
        log_open=lambda: SocketRecordLog(
            (host, port), backoff_seed=seed, io_timeout_s=2.0,
        ),
        **opts,
    )
    ok = sorted(chaos) == sorted(golden)
    print(f"connect {host}:{port} seed {seed}: {len(golden)} matches, "
          f"{crashes} crashes, {'OK' if ok else 'DIVERGED'}")
    if not ok:
        print(f"  schedule: {schedule}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
