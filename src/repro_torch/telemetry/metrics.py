"""Mergeable metric primitives behind the tracker interface.

Three shapes cover everything the cache/serving stack reports:

  - :class:`Histogram` — log-bucket latency/size distribution.  Buckets
    grow geometrically (default ``2**(1/4)``, ≤ ~9% relative error per
    bucket), so the whole dynamic range from sub-microsecond enqueues to
    multi-second flush waits fits in a small dict.  Quantile estimation
    (p50/p95/p99) reads the cumulative bucket counts; ``merge`` adds two
    histograms bucket-by-bucket, which is what makes per-shard (or
    per-process) collection composable.
  - :class:`WindowedSeries` — a value aggregated per fixed-width window of
    a (logical or wall) time axis: hit-ratio-over-time is the windowed
    mean of 0/1 hit observations, occupancy-over-time the windowed mean
    of the resident count, promotion rate the windowed count.  Windows
    are keyed sparsely, so long idle stretches cost nothing.
  - :class:`MetricsRegistry` — the named surface over both plus plain
    counters and gauges; :class:`~repro_torch.telemetry.tracker.InMemoryTracker`
    owns one.  Registries merge (shard-mergeable: disjoint or overlapping
    name sets both compose), and ``snapshot()`` renders one nested dict
    for reports and CI assertions.

Nothing in this module imports torch or numpy — the metric path must stay
importable (and cheap) for host-only consumers.
"""
from __future__ import annotations

import math

__all__ = ["Histogram", "WindowedSeries", "MetricsRegistry"]

# default bucket growth: 4 buckets per octave -> worst-case relative
# quantile error of sqrt(growth) ~ 9%
_DEFAULT_GROWTH = 2.0 ** 0.25


class Histogram:
    """Log-bucket histogram with exact count/sum/min/max and estimated
    quantiles.

    Observations ``v > 0`` land in bucket ``floor(log(v)/log(growth))``;
    zero and negative observations (a timer that underflowed the clock
    resolution) are counted in a dedicated zero bucket that sorts below
    every log bucket.  Two histograms with the same ``growth`` merge by
    adding bucket counts — the shard-mergeable property the registry and
    the composite tracker rely on.
    """

    __slots__ = ("growth", "_log_g", "buckets", "zeros", "count", "total",
                 "vmin", "vmax")

    def __init__(self, growth: float = _DEFAULT_GROWTH):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.buckets: dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if value <= 0.0:
            self.zeros += 1
            return
        b = math.floor(math.log(value) / self._log_g)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError("cannot merge histograms with different growth "
                             f"({self.growth} vs {other.growth})")
        for b, n in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.zeros += other.zeros
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 <= q <= 1): the geometric midpoint
        of the bucket holding the target rank, clamped to the exact
        observed [min, max]."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        seen = self.zeros
        if seen >= target and self.zeros:
            return max(0.0, self.vmin)
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= target:
                mid = self.growth ** (b + 0.5)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin if self.count else math.nan,
                "max": self.vmax if self.count else math.nan,
                **self.percentiles()}


class WindowedSeries:
    """A value aggregated over fixed-width windows of a time axis.

    ``add(t, v)`` folds ``v`` into window ``t // window``; windows are
    sparse (a dict keyed by window index).  ``series()`` renders the
    ordered list of per-window rows — ``mean`` is hit-ratio when the
    observations are 0/1 hit indicators, occupancy when they are resident
    counts, and ``count``/``sum`` give windowed rates.  Merging adds
    window aggregates pairwise, so per-shard series compose exactly.
    """

    __slots__ = ("window", "_sum", "_count")

    def __init__(self, window: int = 256):
        self.window = max(1, int(window))
        self._sum: dict[int, float] = {}
        self._count: dict[int, int] = {}

    def add(self, t: float, value: float) -> None:
        k = int(t) // self.window
        self._sum[k] = self._sum.get(k, 0.0) + float(value)
        self._count[k] = self._count.get(k, 0) + 1

    def merge(self, other: "WindowedSeries") -> "WindowedSeries":
        if other.window != self.window:
            raise ValueError("cannot merge series with different windows "
                             f"({self.window} vs {other.window})")
        for k, s in other._sum.items():
            self._sum[k] = self._sum.get(k, 0.0) + s
            self._count[k] = self._count.get(k, 0) + other._count[k]
        return self

    def __len__(self) -> int:
        return len(self._sum)

    def series(self) -> list[dict]:
        return [{"t": k * self.window, "mean": self._sum[k] / self._count[k],
                 "sum": self._sum[k], "count": self._count[k]}
                for k in sorted(self._sum)]


class MetricsRegistry:
    """Named counters, gauges, histograms, and windowed series.

    The single metrics surface an :class:`~repro_torch.telemetry.tracker.
    InMemoryTracker` accumulates into.  All accessors create-on-first-use
    so emitters never pre-register; ``merge`` composes registries from
    shards/processes; ``snapshot`` renders the nested report dict.
    """

    def __init__(self, window: int = 256,
                 growth: float = _DEFAULT_GROWTH):
        self.window = max(1, int(window))
        self.growth = float(growth)
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self.series: dict[str, WindowedSeries] = {}

    # ------------------------------------------------------------ emitters
    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def record(self, name: str, t: float, value: float) -> None:
        self.get_series(name).add(t, value)

    # ------------------------------------------------------------ accessors
    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(self.growth)
        return h

    def get_series(self, name: str) -> WindowedSeries:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = WindowedSeries(self.window)
        return s

    # ------------------------------------------------------------- compose
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for k, v in other.counters.items():
            self.inc(k, v)
        self.gauges.update(other.gauges)          # last write wins
        for k, h in other.histograms.items():
            self.histogram(k).merge(h)
        for k, s in other.series.items():
            self.get_series(k).merge(s)
        return self

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
            "series": {k: s.series() for k, s in self.series.items()},
        }
