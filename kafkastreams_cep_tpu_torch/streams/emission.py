"""Exactly-once match emission: the per-query emitted-match watermark.

A copy of the JAX package's `streams/emission.py`. The reference's
delivery guarantee to its sink topic is at-least-once: a crash between the
sink write and the consumer-offset commit replays the interval and
re-emits matches the sink already saw. This module closes that window for
the embedded pipeline without a transaction coordinator:

  * every emitted match carries its **sequence identity** -- a digest of
    the (stage -> event (topic, partition, offset) set) structure,
    occurrence-qualified so two legitimately identical matches in one
    window stay distinct -- embedded in the sink record key;
  * at commit, the gate persists an `EmitWatermark` (each sink topic's end
    offset) through the changelogged store stack;
  * on restore, the gate re-reads only the sink tail past its watermark:
    whatever landed there during the crash window is exactly the set of
    matches the sink already saw, and replay dedupes against it.

Unlike the JAX package's copy, the recovered digests outlive the commits
that follow a restore: a replay can regenerate a crash-window match
several commits later -- an event-time gate releases a restored buffered
record only when its watermark passes it, and a device micro-batch
flushes when it fills. So the gate keeps the digests replay has not yet
regenerated, and each commit persists them beside the watermark (which
still rolls to the sink's end): a second crash, or a migration, hands
them on. They go once the consumer has passed every source record that
existed at the recovery (`settle`, called by `LogDriver.commit`): a digest
that replay has not regenerated by then -- another query's on a shared
sink topic, say -- never will be.

The native sink-to-bytes decoder (native/decoder.cc `decode_matches_json`)
emits `sequence_ident_frames` byte for byte, so `admit_ident` and `admit`
give one digest for one match whichever format the engine decodes to.
"""
from __future__ import annotations

import hashlib
import pickle
import struct
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.sequence import Sequence
from ..state.nfa_store import EmissionStore, EmitWatermark

#: Sink record key framing version tag (see `encode_sink_key`).
SINK_KEY_TAG = "kct-sink-v1"


def _put(out: bytearray, data: bytes) -> None:
    out += struct.pack("<I", len(data))
    out += data


def identity_prefix(query: str, key: Any) -> bytes:
    """The (query, canonical key) frames that open every sequence
    identity. The user key -- an arbitrary object -- is canonicalized
    through one serialize/deserialize round trip (see
    `sequence_identity`)."""
    out = bytearray()
    _put(out, query.encode("utf-8"))
    key_bytes = pickle.dumps(key, protocol=pickle.HIGHEST_PROTOCOL)
    _put(
        out,
        pickle.dumps(
            pickle.loads(key_bytes), protocol=pickle.HIGHEST_PROTOCOL
        ),
    )
    return bytes(out)


def sequence_ident_frames(seq: Sequence) -> bytes:
    """The per-stage identity frame suffix of `sequence_identity`: what
    the native sink-to-bytes decoder (decoder.cc emit_bytes) emits as
    `ident`, byte-for-byte -- `EmissionGate.admit_ident` hashes
    `identity_prefix + frames` and must equal `admit`'s digest."""
    out = bytearray()
    for staged in seq.matched:
        _put(out, b"\x01")
        _put(out, staged.stage.encode("utf-8"))
        for e in staged.events:
            _put(out, e.topic.encode("utf-8"))
            out += struct.pack("<qq", int(e.partition), int(e.offset))
    return bytes(out)


def sequence_identity(query: str, key: Any, seq: Sequence) -> bytes:
    """Canonical identity bytes of one match: query, record key, and the
    per-stage matched event identities ((topic, partition, offset) -- the
    Event identity contract, core/event.py).

    Encoded by hand, NOT by pickling the structure: pickle memoizes by
    object identity, so the same logical match serializes differently
    before and after a changelog restore (shared topic strings become
    distinct decoded copies) and the digest would stop being a stable
    identity across crash recovery. The user key -- an arbitrary object --
    is canonicalized through one serialize/deserialize round trip for the
    same reason."""
    h = hashlib.blake2b(digest_size=16)
    h.update(identity_prefix(query, key))
    h.update(sequence_ident_frames(seq))
    return h.digest()


def encode_sink_key(key: Any, digest: bytes) -> bytes:
    """Sink record key: pickled (tag, original key, emission digest).

    The digest rides the sink record itself so the sink topic is the
    source of truth for "what the sink already saw" -- crash recovery
    re-reads the tail and dedupes with zero cross-topic atomicity
    requirements (README "Failure semantics")."""
    from ..state.store import default_serializer

    return default_serializer((SINK_KEY_TAG, key, digest))


def decode_sink_key(data: Optional[bytes]) -> Tuple[Any, Optional[bytes]]:
    """(original key, digest) from a sink record key; (raw, None) for
    records predating the identity framing."""
    from ..state.store import default_deserializer

    if data is None:
        return None, None
    try:
        decoded = default_deserializer(data)
    except Exception:
        return data, None
    if (
        isinstance(decoded, tuple)
        and len(decoded) == 3
        and decoded[0] == SINK_KEY_TAG
    ):
        return decoded[1], decoded[2]
    return decoded, None


class EmissionGate:
    """Per-query exactly-once admission for the emission path.

    `admit(key, seq)` returns the occurrence-qualified digest when the
    match must be emitted, or None when the sink already saw it (counted
    in `cep_emit_deduped_total{query}`)."""

    def __init__(
        self,
        query_name: str,
        store: Optional[EmissionStore] = None,
        registry: Optional[Any] = None,
    ) -> None:
        from ..obs.registry import default_registry

        self.query = query_name
        self.store = store if store is not None else EmissionStore()
        self.metrics = registry if registry is not None else default_registry()
        self._m_deduped = self.metrics.counter(
            "cep_emit_deduped_total",
            "Replayed matches the sink already saw, skipped by the "
            "emission gate (exactly-once recovery)",
            labels=("query",),
        ).labels(query=self.query)
        #: digests emitted (or recovered from the sink tail) since the
        #: last commit; the commit clears it -- see the module docstring's
        #: bounded-window argument.
        self._emitted: Set[bytes] = set()
        #: occurrence counter per base identity within the window: two
        #: legitimately identical matches (same stages, same events --
        #: possible under branching selection) get distinct digests, so
        #: the fault-free path NEVER drops a real duplicate; regeneration
        #: during replay renumbers identically (deterministic order).
        self._occurrence: Dict[bytes, int] = {}
        #: per-key identity_prefix cache for the bytes path: the prefix
        #: pickles the key twice per match otherwise. Bounded; cleared
        #: wholesale on overflow (keys are usually few and stable).
        self._prefix_cache: Dict[Any, bytes] = {}
        #: digests recovered after a crash that replay has not yet
        #: regenerated; persisted at each commit until `settle` (module
        #: docstring).
        self._recovered: Set[bytes] = set()

    # ------------------------------------------------------------- admission
    def admit(self, key: Any, seq: Sequence) -> Optional[bytes]:
        return self._qualify(sequence_identity(self.query, key, seq))

    def admit_ident(self, key: Any, ident: bytes) -> Optional[bytes]:
        """Bytes-path admission: `ident` is the per-stage identity frame
        suffix the native sink-to-bytes decoder emitted
        (`sequence_ident_frames`). The digest is bitwise-identical to
        `admit(key, seq)` on the same match -- the exactly-once window is
        shared across object- and bytes-mode emissions."""
        h = hashlib.blake2b(digest_size=16)
        h.update(self._key_prefix(key))
        h.update(ident)
        return self._qualify(h.digest())

    def _key_prefix(self, key: Any) -> bytes:
        try:
            cached = self._prefix_cache.get(key)
        except TypeError:  # unhashable key: compute every time
            return identity_prefix(self.query, key)
        if cached is None:
            if len(self._prefix_cache) >= 4096:
                self._prefix_cache.clear()
            cached = self._prefix_cache[key] = identity_prefix(
                self.query, key
            )
        return cached

    def _qualify(self, base: bytes) -> Optional[bytes]:
        n = self._occurrence.get(base, 0)
        self._occurrence[base] = n + 1
        digest = hashlib.blake2b(
            base + n.to_bytes(8, "little"), digest_size=16
        ).digest()
        if digest in self._emitted or digest in self._recovered:
            self._recovered.discard(digest)
            self._m_deduped.inc()
            return None
        self._emitted.add(digest)
        return digest

    # ------------------------------------------------------------ durability
    def commit(self, log: Optional[Any], sink_topics: List[str]) -> None:
        """Roll the watermark forward at the commit boundary: record each
        sink topic's current end offset and the recovered digests still
        waiting for their regeneration, and clear the window (committed
        consumer offsets now exceed every emitted match's completing
        offset, so nothing in it can regenerate)."""
        if log is not None and sink_topics:
            self.store.put(
                EmitWatermark(
                    sink_pos={t: log.end_offset(t) for t in sink_topics},
                    recovered=sorted(self._recovered),
                )
            )
        self._emitted.clear()
        self._occurrence.clear()

    def recover(self, log: Optional[Any], sink_topics: List[str]) -> int:
        """Seed the dedup set from the persisted outstanding digests and
        the sink tail past the persisted watermark: those records landed
        during the crash window (after the last commit), and replay will
        regenerate exactly them. Returns how many digests it holds."""
        self._emitted.clear()
        self._occurrence.clear()
        wm = self.store.get()
        # A watermark the JAX package wrote has no `recovered`.
        self._recovered = set(getattr(wm, "recovered", None) or ())
        if log is None or not sink_topics:
            return len(self._recovered)
        sink_pos = wm.sink_pos if wm is not None else {}
        for topic in sink_topics:
            for rec in log.read(topic, start=sink_pos.get(topic, 0)):
                _key, digest = decode_sink_key(rec.key)
                if digest is not None:
                    self._recovered.add(digest)
        return len(self._recovered)

    @property
    def outstanding(self) -> int:
        """Recovered digests replay has not regenerated yet."""
        return len(self._recovered)

    def settle(self) -> int:
        """Forget the recovered digests that replay has not regenerated:
        the caller has consumed every source record that existed when they
        were recovered, so none of them can come back. Returns how many
        went; the next commit persists the empty set."""
        n = len(self._recovered)
        self._recovered.clear()
        return n
