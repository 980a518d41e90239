"""Observability: metrics registry, exposition, span tracer, and the
fleet's registry merge and self-scraped time series (the JAX package's
`obs/` exports)."""
from .compile import CompileWatch
from .http import IntrospectionServer
from .merge import merge_registries, merge_snapshots
from .registry import (
    FAULT_SERIES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    fault_series_totals,
    parse_prom_text,
    registry_from_snapshot,
)
from .scrape import MetricsScraper, TimeSeries
from .trace import SpanTracer
from .trace_export import chrome_trace, write_chrome_trace

__all__ = [
    "CompileWatch",
    "Counter",
    "chrome_trace",
    "write_chrome_trace",
    "FAULT_SERIES",
    "Gauge",
    "Histogram",
    "IntrospectionServer",
    "MetricsRegistry",
    "MetricsScraper",
    "SpanTracer",
    "TimeSeries",
    "default_registry",
    "fault_series_totals",
    "merge_registries",
    "merge_snapshots",
    "parse_prom_text",
    "registry_from_snapshot",
]
