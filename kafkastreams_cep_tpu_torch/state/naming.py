"""Store/namespace naming scheme for deployed queries (a copy of the JAX
package's `state/naming.py`).

Mirrors the reference naming contract
(reference: core/.../cep/state/QueryStores.java:32-52): each query owns
three stores named `<query>-streamscep-{matched,states,aggregates}`,
lowercased. Checkpoint directories and changelog streams reuse these names
so operators of the reference find the same layout here.
"""
from __future__ import annotations

STATES_SUFFIX = "-streamscep-states"
MATCHED_SUFFIX = "-streamscep-matched"
AGGREGATES_SUFFIX = "-streamscep-aggregates"
#: Emitted-match watermark store (exactly-once sink dedupe) and
#: the device-runtime engine checkpoint store -- same naming scheme as the
#: reference trio so operators find one layout.
EMITTED_SUFFIX = "-streamscep-emitted"
DEVICE_STATE_SUFFIX = "-streamscep-devicestate"
#: Host-runtime event-time gate store: reorder buffers +
#: watermark state + arrival marks, snapshotted at every commit flush.
EVENT_TIME_SUFFIX = "-streamscep-eventtime"


def normalize_query_name(query_name: str) -> str:
    # NOTE: the reference intends to strip whitespace but uses literal
    # String.replace (CEPProcessor.java:83) -- a no-op bug. We actually strip.
    return "".join(query_name.split()).lower()


def nfa_states_store(query_name: str) -> str:
    return normalize_query_name(query_name) + STATES_SUFFIX


def event_buffer_store(query_name: str) -> str:
    return normalize_query_name(query_name) + MATCHED_SUFFIX


def aggregates_store(query_name: str) -> str:
    return normalize_query_name(query_name) + AGGREGATES_SUFFIX


def emitted_store(query_name: str) -> str:
    return normalize_query_name(query_name) + EMITTED_SUFFIX


def device_state_store(query_name: str) -> str:
    return normalize_query_name(query_name) + DEVICE_STATE_SUFFIX


def event_time_store(query_name: str) -> str:
    return normalize_query_name(query_name) + EVENT_TIME_SUFFIX


def changelog_topic(app_id: str, store_name: str) -> str:
    """`<app-id>-<store-name>-changelog` (reference README.md:350-355)."""
    return f"{app_id}-{store_name}-changelog"
