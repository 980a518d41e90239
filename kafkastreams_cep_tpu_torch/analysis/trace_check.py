"""tracectx: wire trace-context propagation completeness.

A copy of the JAX package's `analysis/trace_check.py` with its tables
remade over the port's `streams/`.

The fleet tracing contract is only as strong as its weakest hop: a
record's `TraceContext` blob rides every durable append (producer ->
broker -> migration copy -> sink/DLQ), and ONE forwarding site that
drops the ``trace=`` keyword silently unstitches every end-to-end span
that crosses it -- no test fails, the trace file just loses its story
mid-record. This checker makes the omission structural, the same move
serde_check made for checkpoint fields:

- **Forwarding sites** (CEP-W01): in the trace-plumbing modules
  (`TRACE_FILES`), every ``*.append(...)`` call that forwards a record
  (>= 3 call arguments -- topic/key/value shaped; plain ``list.append``
  takes one) must pass ``trace=``. Control-plane appends that carry no
  record (offset commits, changelog snapshots) are audited in place
  with ``# cep: trace-ok(reason)``.
- **Plumbing bindings** (CEP-W02): the named functions that thread the
  blob (client/server append paths, ingest stamping, sink/DLQ
  forwarding, partition moves) must still exist and still mention
  ``trace`` -- a rename or a refactor that quietly severs the chain is
  reported against this checker's binding table, so the table and the
  plumbing move together.

Findings (W for "wire"; CEP-T* belongs to the threads checker):
    CEP-W01  record-forwarding append() that drops the trace blob
    CEP-W02  trace-plumbing binding missing or no longer threading trace

Findings anchor to the call/def line so a ``# cep: trace-ok(reason)``
pragma can audit the intentional cases exactly where they live.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from .core import Finding, SourceFile
from .zerosync import function_index

#: Modules whose record-forwarding appends must propagate the blob.
TRACE_FILES = (
    "kafkastreams_cep_tpu_torch/streams/transport.py",
    "kafkastreams_cep_tpu_torch/streams/partition.py",
    "kafkastreams_cep_tpu_torch/streams/builder.py",
    "kafkastreams_cep_tpu_torch/streams/driver.py",
    "kafkastreams_cep_tpu_torch/streams/device_processor.py",
    "kafkastreams_cep_tpu_torch/streams/rebalance.py",
)

#: (file, qualified function) pairs that ARE the trace plumbing: each
#: must exist and reference ``trace`` somewhere in its body. Update this
#: table when the plumbing moves -- CEP-W02 findings name the stale row.
TRACE_BINDINGS = (
    ("kafkastreams_cep_tpu_torch/streams/transport.py",
     "SocketRecordLog.append"),
    ("kafkastreams_cep_tpu_torch/streams/transport.py", "RecordLogServer._apply"),
    ("kafkastreams_cep_tpu_torch/streams/transport.py", "_parse_records"),
    ("kafkastreams_cep_tpu_torch/streams/partition.py",
     "PartitionedRecordLog.append"),
    ("kafkastreams_cep_tpu_torch/streams/partition.py",
     "PartitionedRecordLog.move_partition"),
    ("kafkastreams_cep_tpu_torch/streams/builder.py", "Topology.stamp_ingest"),
    ("kafkastreams_cep_tpu_torch/streams/builder.py", "Topology._sink"),
    ("kafkastreams_cep_tpu_torch/streams/driver.py", "produce"),
    ("kafkastreams_cep_tpu_torch/streams/driver.py", "LogDriver._dead_letter"),
)

#: An append this long is a record-forwarding call (topic, key, value,
#: ...); list/deque appends take one argument and never trip it.
MIN_FORWARD_ARGS = 3

#: Positional arity at which the trace blob rides positionally
#: (topic, key, value, timestamp, partition, trace).
TRACE_POSITIONAL_ARITY = 6


def _propagates_trace(call: ast.Call) -> bool:
    if len(call.args) >= TRACE_POSITIONAL_ARITY:
        return True
    return any(kw.arg == "trace" for kw in call.keywords)


def _forwarding_appends(src: SourceFile) -> List[ast.Call]:
    out: List[ast.Call] = []
    for node in ast.walk(src.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "append"
            and len(node.args) + len(node.keywords) >= MIN_FORWARD_ARGS
        ):
            out.append(node)
    return out


def _mentions_trace(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == "trace":
            return True
        if isinstance(node, ast.arg) and node.arg == "trace":
            return True
        if isinstance(node, ast.keyword) and node.arg == "trace":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "trace":
            return True
        if isinstance(node, ast.Constant) and node.value == "trace":
            return True
    return False


def check(files: Sequence[SourceFile], root_dir: str) -> List[Finding]:
    by_path = {src.relpath: src for src in files}
    findings: List[Finding] = []

    for path in TRACE_FILES:
        src = by_path.get(path)
        if src is None:
            continue  # partial run without the module
        for call in _forwarding_appends(src):
            if _propagates_trace(call):
                continue
            findings.append(
                Finding(
                    "tracectx", "CEP-W01", path, call.lineno,
                    "record-forwarding append() without trace= -- the "
                    "wire trace context is dropped at this hop and every "
                    "end-to-end span crossing it unstitches (pass "
                    "trace=..., or audit a trace-free control-plane "
                    "append with # cep: trace-ok(reason))",
                    context=src.context_line(call.lineno),
                )
            )

    for path, qual in TRACE_BINDINGS:
        src = by_path.get(path)
        if src is None:
            continue
        fn = function_index(src).get(qual)
        if fn is None:
            findings.append(
                Finding(
                    "tracectx", "CEP-W02", path, 0,
                    f"trace plumbing binding names missing function "
                    f"{qual!r} -- the propagation chain moved; update "
                    "analysis/trace_check.py TRACE_BINDINGS",
                    context=f"binding:{qual}",
                )
            )
        elif not _mentions_trace(fn):
            findings.append(
                Finding(
                    "tracectx", "CEP-W02", path, fn.lineno,
                    f"{qual} no longer references `trace` -- this hop "
                    "stopped propagating the wire trace context (thread "
                    "the blob through, or update TRACE_BINDINGS if the "
                    "plumbing deliberately moved)",
                    context=f"plumbing:{qual}",
                )
            )
    return findings
