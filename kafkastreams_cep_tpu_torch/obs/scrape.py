"""Self-scraped metrics time series: the soak plane's memory of a run.

A copy of the JAX package's `obs/scrape.py` (stdlib only).

A verdict on an hours-long run cannot come from final counter values
alone: "occupancy is 400 at the end" reads the same whether it spiked
once or climbed monotonically for three hours -- and only the second is
a leak. The `MetricsScraper` polls a Prometheus exposition (normally the
pipeline's OWN `/metrics` endpoint, the exact bytes an external scraper
would see) on a wall-clock cadence into bounded per-metric rings of
``(wall_ts, value)`` samples, and `TimeSeries` turns a ring into the
judgments a soak gates on: min/max/last, counter rates, and a linear-fit
drift slope (leak detection).

Aggregation: one ring per *sample name*, label sets folded -- summed for
cumulative series (`*_total`, histogram `_count`/`_sum`/`_bucket`),
maxed for gauges (ten queries' watermark lags answer "how far behind is
the worst one", not "what is the sum of lags"). The fold keeps an
hours-long scrape bounded regardless of label cardinality.

The scraper also samples the process's resident set (`process_rss_bytes`
from /proc/self/status, with a getrusage fallback) every tick, so host
memory rides the same drift machinery as the device gauges.

Everything here is host-side stdlib + the obs registry's own parser;
scraping can never sync the device (it reads the same rendered text any
curl would).
"""
from __future__ import annotations

import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from .registry import MetricsRegistry, parse_prom_text

__all__ = ["MetricsScraper", "TimeSeries", "rss_bytes"]

#: Sample-name suffixes folded by SUM across label sets (cumulative
#: series); everything else folds by MAX (gauges).
_SUM_SUFFIXES = ("_total", "_count", "_sum", "_bucket")


def rss_bytes() -> Optional[float]:
    """Current resident set size in bytes (None when unreadable).

    /proc/self/status VmRSS is the live value; the getrusage fallback is
    ru_maxrss (a high-water mark -- monotone, so drift fits on it are
    conservative: a real leak still shows, a recovered spike reads flat).
    """
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    try:
        import resource

        return float(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        )
    except Exception:
        return None


class TimeSeries:
    """Bounded ring of (wall_ts, value) samples + the verdict helpers."""

    __slots__ = ("maxlen", "_t", "_v")

    def __init__(self, maxlen: int = 4096) -> None:
        self.maxlen = int(maxlen)
        self._t: List[float] = []
        self._v: List[float] = []

    def append(self, t: float, v: float) -> None:
        self._t.append(float(t))
        self._v.append(float(v))
        if len(self._t) > self.maxlen:
            del self._t[: len(self._t) - self.maxlen]
            del self._v[: len(self._v) - self.maxlen]

    def __len__(self) -> int:
        return len(self._t)

    @property
    def n(self) -> int:
        return len(self._t)

    @property
    def last(self) -> Optional[float]:
        return self._v[-1] if self._v else None

    @property
    def min(self) -> Optional[float]:
        return min(self._v) if self._v else None

    @property
    def max(self) -> Optional[float]:
        return max(self._v) if self._v else None

    @property
    def span_s(self) -> float:
        return self._t[-1] - self._t[0] if len(self._t) >= 2 else 0.0

    def rate_per_s(self) -> Optional[float]:
        """Average increase rate over the window -- the counter helper
        (first-to-last; resets are upstream's business, counters here
        come from one process's monotone registry)."""
        if len(self._t) < 2 or self.span_s <= 0:
            return None
        return (self._v[-1] - self._v[0]) / self.span_s

    def slope_per_s(self) -> Optional[float]:
        """Least-squares drift slope (units/second): the leak detector.

        A spike contributes symmetric residuals and fits ~flat; a
        monotone climb fits its climb rate. None below 3 samples or a
        degenerate (zero-span) window.
        """
        n = len(self._t)
        if n < 3 or self.span_s <= 0:
            return None
        t0 = self._t[0]
        ts = [t - t0 for t in self._t]
        mean_t = sum(ts) / n
        mean_v = sum(self._v) / n
        var_t = sum((t - mean_t) ** 2 for t in ts)
        if var_t <= 0:
            return None
        cov = sum(
            (t - mean_t) * (v - mean_v) for t, v in zip(ts, self._v)
        )
        return cov / var_t

    def summary(self) -> Dict[str, Any]:
        """The artifact shape (faults/soak_schema.py SOAK_SERIES_KEYS): a
        judge distinguishes a leak (slope ~ (max-min)/span) from a spike
        (slope ~ 0 with max >> last) without re-running the soak."""
        slope = self.slope_per_s()
        return {
            "n": self.n,
            "min": self.min,
            "max": self.max,
            "last": self.last,
            "slope_per_s": 0.0 if slope is None else slope,
        }


class MetricsScraper:
    """Polls a /metrics exposition into per-sample-name TimeSeries.

    `url`: the introspection plane's base URL (e.g. `driver.http.url`);
    scrapes fetch `url + "/metrics"` over real HTTP -- the soak observes
    itself through the same bytes an external Prometheus would. Pass
    `registry` instead to scrape in-process (unit tests, serverless
    runs); exactly one of the two must be given.

    `scrape_once()` is the synchronous core (deterministic tests call it
    directly with a pinned `now`); `start()` runs it on a daemon thread
    every `every_s` seconds until `stop()`. Scrape failures increment
    `errors` and never raise into the soak -- a flaky observer must not
    fail the system under observation (the verdict reports the error
    count; a soak with zero successful scrapes fails its own evidence
    bar instead).
    """

    def __init__(
        self,
        url: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        every_s: float = 0.5,
        maxlen: int = 4096,
        sample_rss: bool = True,
        timeout_s: float = 5.0,
    ) -> None:
        if (url is None) == (registry is None):
            raise ValueError("pass exactly one of url= or registry=")
        self.url = url
        self.registry = registry
        self.every_s = max(0.01, float(every_s))
        self.maxlen = int(maxlen)
        self.sample_rss = bool(sample_rss)
        self.timeout_s = float(timeout_s)
        self.series: Dict[str, TimeSeries] = {}
        self.scrapes = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- scraping
    def _fetch_text(self) -> str:
        if self.registry is not None:
            return self.registry.to_prom_text()
        return urllib.request.urlopen(
            self.url + "/metrics", timeout=self.timeout_s
        ).read().decode("utf-8")

    def scrape_once(self, now: Optional[float] = None) -> bool:
        """One scrape tick; returns True when samples landed."""
        t = time.time() if now is None else float(now)
        try:
            parsed = parse_prom_text(self._fetch_text())
        except Exception:
            self.errors += 1  # cep: thread-ok(stop joins the scraper thread before its final main-thread scrape; roots never overlap)
            return False
        for name, by_labels in parsed.items():
            vals = list(by_labels.values())
            if not vals:
                continue
            folded = (
                sum(vals)
                if name.endswith(_SUM_SUFFIXES)
                else max(vals)
            )
            ring = self.series.get(name)
            if ring is None:
                ring = self.series[name] = TimeSeries(self.maxlen)  # cep: thread-ok(stop joins the scraper thread before its final main-thread scrape; roots never overlap)
            ring.append(t, folded)
        if self.sample_rss:
            rss = rss_bytes()
            if rss is not None:
                ring = self.series.get("process_rss_bytes")
                if ring is None:
                    ring = self.series["process_rss_bytes"] = TimeSeries(  # cep: thread-ok(stop joins the scraper thread before its final main-thread scrape; roots never overlap)
                        self.maxlen
                    )
                ring.append(t, rss)
        self.scrapes += 1  # cep: thread-ok(stop joins the scraper thread before its final main-thread scrape; roots never overlap)
        return True

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MetricsScraper":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.every_s):
                self.scrape_once()

        self._thread = threading.Thread(
            target=_loop, name="kct-soak-scraper", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_scrape: bool = True) -> None:
        self._stop.set()
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            # A scrape stuck in urlopen can outlive the join timeout;
            # final-scraping concurrently with it would race the rings
            # (the thread-ok pragmas in scrape_once rely on this check).
            wedged = self._thread.is_alive()
            self._thread = None
        if final_scrape and not wedged:
            # The run's last state must be in the rings even when the
            # soak ends between ticks (short --quick runs especially).
            self.scrape_once()

    def __enter__(self) -> "MetricsScraper":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # ------------------------------------------------------------ summaries
    def get(self, name: str) -> Optional[TimeSeries]:
        return self.series.get(name)

    def summaries(
        self, names: Optional[Sequence[str]] = None
    ) -> Dict[str, Dict[str, Any]]:
        """{sample name: summary} for `names` (every ring when None);
        names never scraped are simply absent -- the soak's schema treats
        a missing SLO series as missing evidence, not as zero."""
        if names is None:
            names = sorted(self.series)
        out: Dict[str, Dict[str, Any]] = {}
        for name in names:
            ring = self.series.get(name)
            if ring is not None and ring.n:
                out[name] = ring.summary()
        return out
