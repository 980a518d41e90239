"""Seeded trace-propagation violations.

Mutation fixture for tests/test_torch_lint.py (bound through
monkeypatched TRACE_FILES/TRACE_BINDINGS): a record-forwarding append
that drops the trace blob (CEP-W01) and a plumbing function that no
longer threads it (CEP-W02). NOT runnable production code.
"""


def forward(log, record):
    log.append(record.topic, record.key, record.value)  # CEP-W01


def forward_traced(log, record):
    log.append(record.topic, record.key, record.value, trace=record.trace)


def commit(log, group, pos):
    log.append("__offsets", group, pos)  # cep: trace-ok(offset commit marker: no record to trace)


def stamp_ingest(record):
    return record.value  # CEP-W02: the binding says this threads the trace
