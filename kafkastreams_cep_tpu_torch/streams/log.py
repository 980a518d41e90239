"""Append-only record log: the framework's Kafka-role transport.

A copy of the JAX package's `streams/log.py` (without its fault-injection
hooks). The reference's only communication backend is the Kafka broker:
source and sink topics carry records, and one compacted changelog topic per
state store carries durability writes (reference: README.md:350-355,
ComplexStreamsBuilder.java:61-100). This module is the framework's
equivalent: an embedded, optionally file-backed log of (topic, partition)
streams with monotonically increasing offsets -- the egress of a query's
`.to(topic)` and the home of its stores' changelogs.

Framing (file-backed segments, one file per topic-partition):
  [u8 flags][i64 timestamp][i32 klen][key][i32 vlen][value]
with klen/vlen = -1 encoding None (a None value is a tombstone, as in a
compacted changelog topic). Offsets are implicit record ordinals.
"""
from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

_HEADER = struct.Struct("<bq")  # flags, timestamp
_LEN = struct.Struct("<i")


class LogRecord(NamedTuple):
    offset: int
    timestamp: int
    key: Optional[bytes]
    value: Optional[bytes]
    #: Opaque trace-context blob: carried in memory only, not persisted in
    #: the file framing (a reloaded segment yields trace=None).
    trace: Optional[bytes] = None


def _topic_filename(topic: str, partition: int) -> str:
    # Topics may contain characters unfit for filenames; escape conservatively.
    safe = "".join(c if c.isalnum() or c in "._-" else f"%{ord(c):02x}" for c in topic)
    return f"{safe}-{partition}.log"


class RecordLog:
    """An embedded multi-topic append-only log.

    In-memory by default; pass `path` for durable file-backed segments that
    reload on reopen (the crash/restart story the reference delegates to the
    Kafka cluster)."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, int], List[LogRecord]] = {}
        self._files: Dict[Tuple[str, int], object] = {}
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._load()

    # ------------------------------------------------------------------ io
    def _load(self) -> None:
        assert self.path is not None
        for fname in sorted(os.listdir(self.path)):
            if not fname.endswith(".log"):
                continue
            stem = fname[: -len(".log")]
            topic_esc, _, part_s = stem.rpartition("-")
            try:
                partition = int(part_s)
            except ValueError:
                continue
            topic = _unescape(topic_esc)
            records: List[LogRecord] = []
            fpath = os.path.join(self.path, fname)
            with open(fpath, "rb") as f:
                data = f.read()
            pos = 0
            while pos + _HEADER.size <= len(data):
                # A crash mid-append leaves a torn trailing record; stop at
                # the first incomplete frame and truncate it away so the
                # next append starts on a clean boundary.
                try:
                    _flags, ts = _HEADER.unpack_from(data, pos)
                    key, after_key = _read_blob(data, pos + _HEADER.size)
                    value, end = _read_blob(data, after_key)
                except _TornRecord:
                    break
                records.append(LogRecord(len(records), ts, key, value))
                pos = end
            if pos < len(data):
                with open(fpath, "r+b") as f:
                    f.truncate(pos)
            self._records[(topic, partition)] = records

    def _file_for(self, tp: Tuple[str, int]):
        if self.path is None:
            return None
        f = self._files.get(tp)
        if f is None:
            f = open(
                os.path.join(self.path, _topic_filename(tp[0], tp[1])), "ab"
            )
            self._files[tp] = f
        return f

    # ----------------------------------------------------------------- API
    def append(
        self,
        topic: str,
        key: Optional[bytes],
        value: Optional[bytes],
        timestamp: int = 0,
        partition: int = 0,
        trace: Optional[bytes] = None,
    ) -> int:
        """Append one record; returns its offset."""
        tp = (topic, partition)
        with self._lock:
            f = self._file_for(tp)
            records = self._records.setdefault(tp, [])
            offset = len(records)
            records.append(LogRecord(offset, timestamp, key, value, trace))
            if f is not None:
                f.write(_HEADER.pack(0, timestamp))
                _write_blob(f, key)
                _write_blob(f, value)
        return offset

    def read(
        self, topic: str, partition: int = 0, start: int = 0, max_records: Optional[int] = None
    ) -> List[LogRecord]:
        with self._lock:
            records = self._records.get((topic, partition), [])
            end = len(records) if max_records is None else min(len(records), start + max_records)
            return records[start:end]

    def end_offset(self, topic: str, partition: int = 0) -> int:
        with self._lock:
            return len(self._records.get((topic, partition), []))

    def topics(self) -> List[str]:
        with self._lock:
            return sorted({t for (t, _p) in self._records})

    def partitions(self, topic: str) -> List[int]:
        with self._lock:
            return sorted(p for (t, p) in self._records if t == topic)

    def flush(self) -> None:
        """Make every buffered append durable.

        Deliberately NOT wrapped in the transient-retry helper: on Linux a
        failed fsync marks the dirty pages clean, so a retry "succeeds"
        while the bytes never reached disk (fsyncgate) -- and commit()
        would then durably record offsets covering lost changelog/sink
        records. A flush failure here is fail-stop by design; the caller
        crashes before the offset append and replay recovers."""
        with self._lock:
            for f in self._files.values():
                f.flush()
                os.fsync(f.fileno())

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()


def _write_blob(f, data: Optional[bytes]) -> None:
    if data is None:
        f.write(_LEN.pack(-1))
    else:
        f.write(_LEN.pack(len(data)))
        f.write(data)


class _TornRecord(Exception):
    """A frame extends past the end of the segment file (torn write)."""


def _read_blob(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    if pos + _LEN.size > len(data):
        raise _TornRecord
    (n,) = _LEN.unpack_from(data, pos)
    pos += _LEN.size
    if n < 0:
        return None, pos
    if pos + n > len(data):
        raise _TornRecord
    return data[pos : pos + n], pos + n


def _unescape(escaped: str) -> str:
    out = []
    i = 0
    while i < len(escaped):
        c = escaped[i]
        if c == "%" and i + 2 < len(escaped):
            out.append(chr(int(escaped[i + 1 : i + 3], 16)))
            i += 3
        else:
            out.append(c)
            i += 1
    return "".join(out)
