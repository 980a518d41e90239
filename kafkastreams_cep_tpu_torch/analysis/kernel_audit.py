"""Kernel-build audit: replay epochs of the same shapes, assert nothing builds.

The runtime half of the recompile checker (analysis/recompile.py is the
static half), the port's counterpart of the JAX package's jit-cache
audit. There a churn epoch that recompiled for shapes already paid for
was the failure (the JAX soak's RSS leak); here the same failure is a
kernel build, a module load or a new kernel signature for a shape the
process already holds. The audit builds an engine with its compile watch
armed, runs one warm epoch -- deferred advances (the step kernel), the
pend append, the group flushes (the `gc_mark` and `gc_sweep` kernels),
the occupancy probes, a drain, and one snapshot restored onto the same
registry -- then reads three counters:

- ``cep_compiles_total{fn}`` of the engine's registry (obs/compile.py);
- the length of `kernel_build.BUILDS` (compiler runs of this process);
- `kernel_build.loaded_modules()` (modules launched on each device).

It then replays epochs of the same shapes, each with a drain, a
snapshot/restore round trip and a re-pack of identical traffic (the same
letters at later times). Any counter that moves is a finding (CEP-J01).
Counters are read as differences from the end of the warm epoch, so
what a cold build cache builds in the warm epoch never counts.

A [T, K] batch shape compiles nothing here (T and K are launch arguments
of every kernel); what is compile-time is the capacity the step kernel's
source is generated for. So `vary_shapes=True`, the seeded violation,
re-shapes the capacity each replay epoch (lanes and nodes doubled per
epoch, as an autosizer that never settles would): each new shape is a
new signature (on the card also a build or a cache load, and a module),
and the audit must report it.

On the card (`device=None` or a CUDA device) it runs the flagship
deployment: skip_any8, K = 2048, T = 64, lanes 320, nodes 8192, matches
2048 (models/skip_any.py), optionally on a key mesh (`mesh=`). With
`device="cpu"` it runs the same pattern at the tests' size (K = 4,
T = 16, lanes 32, nodes 512, matches 256). Both use `engine="cuda"`: on
CPU tensors the kernels' wrappers run their plain versions, so the
signatures still count while the builds and modules stay at zero.
"""
from __future__ import annotations

import random
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional

from .core import Finding

__all__ = ["run_kernel_build_audit", "kernel_counters"]

#: the tests' size on the CPU: (keys, events per batch, capacity).
CPU_SHAPE = (4, 16, dict(lanes=32, nodes=512, matches=256, matches_per_step=16,
                         nodes_per_step=32, strict_windows=True, pin_interval=True))


def kernel_counters(registry: Any) -> Dict[str, float]:
    """The audited counters: ``compiles:<fn>`` per kernel, ``builds`` and
    ``modules:<device>`` per device."""
    from ..ops import kernel_build

    out: Dict[str, float] = {}
    for val in registry.snapshot().get("cep_compiles_total", {}).get("values", []):
        labels = dict(val.get("labels", {}))
        out[f"compiles:{labels.get('fn', '?')}"] = float(val.get("value", 0))
    out["builds"] = float(len(kernel_build.BUILDS))
    for dev, n in kernel_build.loaded_modules().items():
        out[f"modules:{dev}"] = float(n)
    return out


def run_kernel_build_audit(
    device: Any = None,
    epochs: int = 2,
    batches_per_epoch: int = 4,
    vary_shapes: bool = False,
    mesh: Any = None,
    on_warm: Optional[Callable[[], None]] = None,
    report: Optional[Dict[str, Any]] = None,
) -> List[Finding]:
    """Findings (empty = pass) for the same-shape replay.

    `on_warm` is called once the warm epoch's counters are read (a caller
    may start watching the kernels' launches there); `report`, when
    given, receives the counters after the warm epoch and after each
    replay epoch, the matches drained and the engine's shape."""
    from ..models.skip_any import (
        FLAGSHIP_CONFIG, FLAGSHIP_KEYS, FLAGSHIP_T, TS0,
        skip_any8_pattern, skip_any8_stream,
    )
    from ..core.event import Event
    from ..obs.registry import MetricsRegistry
    from ..ops.engine import EngineConfig
    from ..ops.tables import compile_query
    from ..parallel.batched import BatchedDeviceNFA, resolve_device
    from ..pattern.compiler import compile_pattern

    if mesh is not None:
        dev = mesh.devices[0]
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        n_keys, T, cfg = FLAGSHIP_KEYS, FLAGSHIP_T, EngineConfig(**FLAGSHIP_CONFIG)
    else:
        n_keys, T, shape = CPU_SHAPE
        cfg = EngineConfig(**shape)
    query = compile_query(compile_pattern(skip_any8_pattern()), None)
    registry = MetricsRegistry()
    keys = [f"k{i}" for i in range(n_keys)]
    opts = dict(device=dev if mesh is None else None, mesh=mesh, engine="cuda",
                registry=registry, compile_telemetry=True)
    # One epoch's traffic: each key's letters, replayed at later times.
    rng = random.Random(7)
    per_epoch = T * batches_per_epoch
    letters = {k: [e.value for e in skip_any8_stream(rng, per_epoch)] for k in keys}
    state = {"eng": BatchedDeviceNFA(query, keys=keys, config=cfg, **opts),
             "offset": 0, "matches": 0}

    def epoch() -> None:
        """One traffic epoch of deferred advances at fixed [T, K], then a
        drain: the steady-state serving shape."""
        eng = state["eng"]
        base = state["offset"]
        for b in range(batches_per_epoch):
            lo = b * T
            batch = {k: [Event(k, v, TS0 + base + lo + i, "t", 0, base + lo + i)
                         for i, v in enumerate(letters[k][lo:lo + T])] for k in keys}
            eng.advance_packed(eng.pack(batch), decode=False)
        state["offset"] = base + per_epoch
        state["matches"] += sum(len(v) for v in eng.drain().values())

    def round_trip() -> None:
        """Snapshot and restore onto the same registry (the checkpoint
        path must ride the warm builds)."""
        old = state["eng"]
        blob = old.snapshot()
        old.close()
        state["eng"] = BatchedDeviceNFA.restore(query, blob, config=old.config, **opts)

    epoch()
    round_trip()
    warm = kernel_counters(registry)
    if report is not None:
        report.update(warm=dict(warm), epochs=[], keys=n_keys, T=T,
                      lanes=cfg.lanes, nodes=cfg.nodes, matches=cfg.matches,
                      device=str(dev), shards=state["eng"].n_shards)
    if on_warm is not None:
        on_warm()
    findings: List[Finding] = []
    for e in range(1, epochs + 1):
        if vary_shapes:
            c = state["eng"].config
            state["eng"].resize(replace(c, lanes=cfg.lanes << e, nodes=cfg.nodes << e))
        epoch()
        round_trip()
        epoch()  # the re-pack of identical traffic
        now = kernel_counters(registry)
        for name, count in sorted(now.items()):
            if count > warm.get(name, 0):
                findings.append(
                    Finding(
                        "kernel-audit", "CEP-J01",
                        "kafkastreams_cep_tpu_torch/parallel/batched.py", 0,
                        f"{name} rose {warm.get(name, 0):.0f} -> {count:.0f} "
                        f"during same-shape replay epoch {e}"
                        + (" (cep_compiles_total)" if name.startswith("compiles:") else "")
                        + " -- a kernel was built, loaded or counted again "
                        "for a shape the process already held",
                        context=f"kernel-audit:{name}:epoch{e}",
                    )
                )
        if report is not None:
            report["epochs"].append(dict(now))
        warm = now  # report each epoch's delta once
    state["eng"].close()
    if report is not None:
        report["matches_drained"] = state["matches"]
    return findings
