"""Metrics registry: Counter/Gauge/Histogram with labels + exposition.

A copy of the JAX package's `obs/registry.py` (stdlib only). The port's
streams layer registers its counters here under the JAX package's
`cep_*` names: the emission gate's `cep_emit_deduped_total{query}` and
the device processor's `cep_device_processor_flushes_total{query}` /
`cep_device_processor_matches_total{query}`. Exposition is Prometheus
0.0.4 text (`to_prom_text`) and a JSON-able snapshot (`snapshot`);
`parse_prom_text` and `registry_from_snapshot` close the round trip.

Design constraints:
- Pure host-side Python: nothing here touches a device tensor.
- Bounded cardinality: each metric refuses more than `max_label_sets`
  distinct label-value sets (a runaway label is an outage in disguise).
- Histograms keep both cumulative prom buckets (exposition) and a bounded
  reservoir of recent samples (host-side percentiles).
"""
from __future__ import annotations

import itertools
import math
import re
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "FAULT_SERIES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "fault_series_totals",
    "next_instance_id",
    "parse_prom_text",
    "registry_from_snapshot",
]

#: The fault/robustness counter families every health surface
#: reports together: the soak artifact carries them as its `faults` block
#: (all-zero in a healthy run) and faults/soak_schema.py validates
#: the block against this exact key set.
FAULT_SERIES: Tuple[str, ...] = (
    "cep_faults_injected_total",
    "cep_retries_total",
    "cep_overflow_backpressure_total",
    "cep_overflow_dropped_total",
    "cep_driver_dead_letters_total",
    "cep_driver_restore_failures_total",
    "cep_checkpoint_corrupt_total",
    "cep_emit_deduped_total",
    # Event-time gate loss families (time/gate.py): records the
    # reorder stage discarded -- late beyond the watermark under
    # late_policy=drop, or reorder-buffer overflow under on_overflow=drop.
    "cep_late_dropped_total",
    "cep_reorder_overflow_dropped_total",
    # Wire-transport fault families (streams/transport.py):
    # evidence of connection damage and its recovery -- all zero on a
    # healthy loopback run, nonzero exactly when chaos (or a real
    # network) bit and the reconnect/replay machinery engaged.
    "cep_transport_retries_total",
    "cep_transport_disconnects_total",
    "cep_transport_stalls_total",
    "cep_transport_torn_frames_total",
    "cep_transport_dedup_total",
    "cep_transport_server_restarts_total",
)


def fault_series_totals(*registries: "MetricsRegistry") -> Dict[str, float]:
    """Label-summed totals of every FAULT_SERIES counter across the given
    registries (0.0 for families never registered) -- one flat dict a
    health check can assert all-zero on."""
    out: Dict[str, float] = {name: 0.0 for name in FAULT_SERIES}
    for reg in registries:
        for name in FAULT_SERIES:
            metric = reg.get(name)
            if metric is None:
                continue
            out[name] += sum(
                child.value for _lv, child in metric._sorted_children()
            )
    return out


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram bucket upper bounds (seconds-flavored, prom-style).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prom value formatting: integers render bare, +Inf as prom spells it."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_suffix(
    label_names: Tuple[str, ...], label_values: Tuple[str, ...],
    extra: Optional[Tuple[str, str]] = None,
) -> str:
    pairs = list(zip(label_names, label_values))
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
    )
    return "{" + inner + "}"


class _Metric:
    """One named metric family: label-set children live under it."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Tuple[str, ...] = (),
        max_label_sets: int = 4096,
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.max_label_sets = max_label_sets
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- children
    def labels(self, **labels: Any) -> Any:
        """The child for one label-value set (created on first use)."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[ln]) for ln in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    raise ValueError(
                        f"{self.name}: label cardinality exceeds "
                        f"{self.max_label_sets} distinct label sets"
                    )
                child = self._make_child()
                self._children[key] = child
            return child

    def _default_child(self) -> Any:
        """The label-less child (metrics declared without labels)."""
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                "use .labels(...)"
            )
        return self.labels()

    def _make_child(self) -> Any:  # pragma: no cover - overridden
        raise NotImplementedError

    # ----------------------------------------------------------- exposition
    def _sorted_children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    """Monotonic counter; `inc()` on the metric hits the label-less child."""

    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    """Free-moving gauge; `set()` on the metric hits the label-less child."""

    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("buckets", "bucket_counts", "sum", "count",
                 "_samples", "_reservoir", "_lock")

    def __init__(self, buckets: Tuple[float, ...], reservoir: int) -> None:
        self.buckets = buckets
        self.bucket_counts = [0] * (len(buckets) + 1)  # trailing +Inf
        self.sum = 0.0
        self.count = 0
        self._reservoir = reservoir
        self._samples: List[float] = []
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            i = 0
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    break
            else:
                i = len(self.buckets)
            self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1
            self._samples.append(v)
            if len(self._samples) > self._reservoir:
                del self._samples[: len(self._samples) - self._reservoir]

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100] over the bounded sample reservoir (recent window);
        None before the first observation."""
        import numpy as np

        s = self.samples()
        if not s:
            return None
        return float(np.percentile(np.asarray(s), q))

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative count)], ending with (+Inf, count)."""
        out: List[Tuple[float, int]] = []
        acc = 0
        for ub, c in zip(self.buckets, self.bucket_counts):
            acc += c
            out.append((ub, acc))
        out.append((math.inf, self.count))
        return out


class Histogram(_Metric):
    """Prom-style cumulative-bucket histogram + bounded sample reservoir."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Tuple[str, ...] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        reservoir: int = 1024,
        max_label_sets: int = 4096,
    ) -> None:
        super().__init__(name, help, label_names, max_label_sets)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        self.reservoir = reservoir

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets, self.reservoir)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def percentile(self, q: float) -> Optional[float]:
        return self._default_child().percentile(q)

    def mean(self) -> Optional[float]:
        return self._default_child().mean()

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum


class MetricsRegistry:
    """Named metric families with get-or-create registration.

    Re-registering an existing name returns the existing family when the
    type and label names match (so a fresh BatchTimings over the same
    registry continues the same counters -- prom semantics) and raises on a
    mismatch (two subsystems fighting over one name is a bug)."""

    def __init__(self, max_label_sets: int = 4096) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self.max_label_sets = max_label_sets

    # ---------------------------------------------------------- registration
    def _get_or_create(self, cls, name: str, help: str, labels, **kwargs):
        label_names = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or (
                    existing.label_names != label_names
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.label_names}"
                    )
                if isinstance(existing, Histogram) and "buckets" in kwargs:
                    want = tuple(sorted(float(b) for b in kwargs["buckets"]))
                    if want != existing.buckets:
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"buckets {existing.buckets}, requested {want}"
                        )
                return existing
            metric = cls(
                name, help, label_names,
                max_label_sets=kwargs.pop("max_label_sets", self.max_label_sets),
                **kwargs,
            )
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labels: Iterable[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(
        self, name: str, help: str = "", labels: Iterable[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        buckets: Optional[Sequence[float]] = None,
        reservoir: int = 1024,
    ) -> Histogram:
        """`buckets=None` means "don't care": get-or-create accepts the
        existing family's layout (DEFAULT_BUCKETS when creating). Explicit
        buckets must match an existing family's exactly -- two subsystems
        disagreeing on one name's layout is a bug, not a merge."""
        kwargs: Dict[str, Any] = {"reservoir": reservoir}
        if buckets is not None:
            kwargs["buckets"] = buckets
        return self._get_or_create(Histogram, name, help, labels, **kwargs)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # ------------------------------------------------------------ exposition
    def to_prom_text(self) -> str:
        """Prometheus 0.0.4 text exposition (names and label sets sorted,
        so the output is deterministic -- golden-file testable)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for lvals, child in m._sorted_children():
                if m.kind == "histogram":
                    for ub, cum in child.cumulative_buckets():
                        suffix = _label_suffix(
                            m.label_names, lvals, ("le", _fmt(ub))
                        )
                        lines.append(f"{name}_bucket{suffix} {cum}")
                    base = _label_suffix(m.label_names, lvals)
                    lines.append(f"{name}_sum{base} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{base} {child.count}")
                else:
                    suffix = _label_suffix(m.label_names, lvals)
                    lines.append(f"{name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every metric family and child."""
        out: Dict[str, Any] = {}
        for name in self.names():
            m = self._metrics[name]
            values: List[Dict[str, Any]] = []
            for lvals, child in m._sorted_children():
                entry: Dict[str, Any] = {
                    "labels": dict(zip(m.label_names, lvals)),
                }
                if m.kind == "histogram":
                    entry["count"] = child.count
                    entry["sum"] = child.sum
                    entry["buckets"] = {
                        _fmt(ub): cum
                        for ub, cum in child.cumulative_buckets()
                    }
                else:
                    entry["value"] = child.value
                values.append(entry)
            out[name] = {
                "type": m.kind,
                "help": m.help,
                "label_names": list(m.label_names),
                "values": values,
            }
        return out


#: Process-global default registry: the always-on spine for layers without
#: an obvious owner (host CEPProcessor, LogDriver when none is passed).
#: Engine instances default to private registries instead -- their gauges
#: are per-instance (pend occupancy, gc phase); when engines DO share a
#: registry, those gauges carry an `instance` label (next_instance_id) so
#: the series never interleave.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


_INSTANCE_SEQ = itertools.count()


def next_instance_id() -> str:
    """Process-monotonic engine instance id for the `instance` label on
    per-instance gauges (one sequence across all engine classes, so two
    engines sharing a registry can never collide)."""
    return str(next(_INSTANCE_SEQ))


# --------------------------------------------------------------- round-trip
def registry_from_snapshot(
    snap: Mapping[str, Any], max_label_sets: Optional[int] = None
) -> MetricsRegistry:
    """Rebuild a registry holding exactly a snapshot's values (histograms
    restore buckets/sum/count; the sample reservoir is not serialized, so
    percentiles are unavailable on the rebuilt copy -- exposition only).
    `max_label_sets` overrides the rebuilt registry's cardinality bound
    (obs/merge.py uses it so a fleet-wide merge stays bounded too)."""
    reg = (
        MetricsRegistry()
        if max_label_sets is None
        else MetricsRegistry(max_label_sets=max_label_sets)
    )
    for name, fam in snap.items():
        kind = fam["type"]
        label_names = tuple(fam.get("label_names", ()))
        if kind == "histogram":
            buckets = []
            for entry in fam["values"]:
                buckets = [
                    float(b) for b in entry["buckets"] if b != "+Inf"
                ]
                break
            metric = reg.histogram(
                name, fam.get("help", ""), labels=label_names,
                buckets=buckets or DEFAULT_BUCKETS,
            )
            for entry in fam["values"]:
                child = metric.labels(**entry["labels"])
                cum_prev = 0
                per_bucket = []
                for b in sorted(
                    (float(k) for k in entry["buckets"] if k != "+Inf")
                ):
                    cum = int(entry["buckets"][_fmt(b)])
                    per_bucket.append(cum - cum_prev)
                    cum_prev = cum
                child.bucket_counts = per_bucket + [
                    int(entry["count"]) - cum_prev
                ]
                child.sum = float(entry["sum"])
                child.count = int(entry["count"])
        else:
            metric = (reg.counter if kind == "counter" else reg.gauge)(
                name, fam.get("help", ""), labels=label_names
            )
            for entry in fam["values"]:
                child = metric.labels(**entry["labels"])
                child._value = float(entry["value"])
    return reg


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label_value(raw: str) -> str:
    """Single left-to-right pass (chained str.replace would corrupt values
    containing literal backslashes, e.g. '\\\\n' -> backslash+newline)."""
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPES.get(m.group(1), m.group(0)), raw
    )


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return math.inf
    if tok == "-Inf":
        return -math.inf
    return float(tok)


def parse_prom_text(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse 0.0.4 exposition text into {sample_name: {label set: value}}.

    Histogram series appear under their exposition names (`X_bucket`,
    `X_sum`, `X_count`) -- this is the wire view, exactly what a scraper
    would ingest; scripts/check_bench_schema.py compares it against the
    JSON snapshot to prove the two expositions agree."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable prom line: {line!r}")
        labels: List[Tuple[str, str]] = []
        if m.group("labels"):
            for lm in _LABEL_PAIR_RE.finditer(m.group("labels")):
                labels.append(
                    (lm.group(1), _unescape_label_value(lm.group(2)))
                )
        out.setdefault(m.group("name"), {})[tuple(labels)] = _parse_value(
            m.group("value")
        )
    return out
