"""Pluggable tracker interface — the one observability surface every
layer of the cache/serving stack emits through.

The shape follows levanter's ``Tracker``: a small abstract emitter API
(counters, gauges, histogram observations, spans, scoped children) with
concrete sinks behind it —

  - :class:`NoopTracker` (and the shared :data:`NOOP` instance): every
    method is a ``pass``; attaching it must be observationally *and*
    decision-wise identical to attaching nothing (enforced by the parity
    test in ``tests/test_telemetry.py`` and the overhead bound in
    ``benchmarks/telemetry_overhead_bench.py``).
  - :class:`InMemoryTracker`: accumulates into a
    :class:`~repro_torch.telemetry.metrics.MetricsRegistry` (log-bucket
    histograms, windowed series) plus a
    :class:`~repro_torch.telemetry.tracing.TraceBuffer` for spans — the sink
    benchmarks and tests read back.
  - :class:`JsonlTracker`: streams every record as one JSON line to a
    file (the ``--tracker jsonl:<path>`` benchmark flag), buffered and
    thread-safe.
  - :class:`CompositeTracker`: fans every record out to child trackers.

Scoping: ``tracker.child("backend")`` returns a view that prefixes every
metric name with ``backend.`` — the facade hands the device backends and
the tier manager scoped children of its own tracker, so one sink sees
the whole stack under a consistent naming scheme (see
``docs/observability.md`` for the scheme).

Trackers are observation-only sinks: they are shared, not copied, by
``copy.deepcopy`` (``__deepcopy__`` returns ``self``), so a facade
``checkpoint()`` never clones a file handle or a half-filled registry.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Optional, Sequence

from .metrics import MetricsRegistry
from .tracing import TraceBuffer

__all__ = ["Tracker", "NoopTracker", "NOOP", "InMemoryTracker",
           "JsonlTracker", "CompositeTracker", "make_tracker"]

_NULL_SPAN = contextlib.nullcontext()       # reusable & reentrant


class Tracker:
    """Abstract emitter interface (all methods default to no-ops).

    ``tags`` are optional low-cardinality labels (e.g. ``{"tier":
    "host"}``); sinks may fold them into the name or record them
    verbatim.  ``observe(..., t=...)`` additionally feeds a windowed
    time series keyed by ``t`` (logical request time or wall seconds) —
    that is how hit-ratio-over-time and occupancy-over-time are built.
    """

    def count(self, name: str, n: float = 1,
              tags: Optional[dict] = None) -> None:
        pass

    def gauge(self, name: str, value: float,
              tags: Optional[dict] = None) -> None:
        pass

    def observe(self, name: str, value: float, t: Optional[float] = None,
                tags: Optional[dict] = None) -> None:
        pass

    def span(self, name: str, tags: Optional[dict] = None):
        """Context manager timing a scoped operation."""
        return _NULL_SPAN

    def add_span(self, name: str, t0: float, t1: float, *, track: int = 0,
                 tags: Optional[dict] = None) -> None:
        """Record a span whose endpoints the caller already stamped
        (``time.perf_counter`` seconds)."""
        pass

    def child(self, prefix: str) -> "Tracker":
        """A scoped view prefixing every metric/span name."""
        return _ScopedTracker(self, prefix)

    def percentiles(self, name: str) -> Optional[dict]:
        """p50/p95/p99 for a histogram, or None when this sink (or the
        name) has no distribution."""
        return None

    def snapshot(self) -> dict:
        return {}

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()

    # observation-only sink: checkpoint deep copies share it, never clone
    def __deepcopy__(self, memo) -> "Tracker":
        return self


class NoopTracker(Tracker):
    """Explicit no-op sink; ``child`` returns itself (no wrapper cost)."""

    def child(self, prefix: str) -> "NoopTracker":
        return self


NOOP = NoopTracker()


class _ScopedTracker(Tracker):
    """Name-prefixing view over a parent tracker."""

    def __init__(self, base: Tracker, prefix: str):
        self._base = base
        self._prefix = prefix.rstrip(".") + "."

    def count(self, name, n=1, tags=None):
        self._base.count(self._prefix + name, n, tags)

    def gauge(self, name, value, tags=None):
        self._base.gauge(self._prefix + name, value, tags)

    def observe(self, name, value, t=None, tags=None):
        self._base.observe(self._prefix + name, value, t, tags)

    def span(self, name, tags=None):
        return self._base.span(self._prefix + name, tags)

    def add_span(self, name, t0, t1, *, track=0, tags=None):
        self._base.add_span(self._prefix + name, t0, t1, track=track,
                            tags=tags)

    def percentiles(self, name):
        return self._base.percentiles(self._prefix + name)

    def snapshot(self):
        return self._base.snapshot()

    def flush(self):
        self._base.flush()

    def close(self):                        # scoped views never own the sink
        self._base.flush()


def _tagged(name: str, tags: Optional[dict]) -> str:
    """Fold low-cardinality tags into the metric name (``name{k=v}``),
    sorted for a stable key."""
    if not tags:
        return name
    inner = ",".join(f"{k}={tags[k]}" for k in sorted(tags))
    return f"{name}{{{inner}}}"


class InMemoryTracker(Tracker):
    """Registry + trace-buffer sink (the read-back tracker).

    ``window`` sets the windowed-series bucket width (logical-time units
    for cache series).  All emitters are thread-safe: the async admission
    worker and the request path may emit concurrently.
    """

    def __init__(self, window: int = 256, max_events: int = 100_000):
        self.registry = MetricsRegistry(window=window)
        self.trace = TraceBuffer(max_events=max_events)
        self._lock = threading.Lock()

    def count(self, name, n=1, tags=None):
        with self._lock:
            self.registry.inc(_tagged(name, tags), n)

    def gauge(self, name, value, tags=None):
        with self._lock:
            self.registry.set_gauge(_tagged(name, tags), value)

    def observe(self, name, value, t=None, tags=None):
        key = _tagged(name, tags)
        with self._lock:
            self.registry.observe(key, value)
            if t is not None:
                self.registry.record(key, t, value)

    def span(self, name, tags=None):
        return self.trace.span(name, tags=tags)

    def add_span(self, name, t0, t1, *, track=0, tags=None):
        self.trace.add_span(name, t0, t1, track=track, tags=tags)

    def percentiles(self, name):
        with self._lock:
            h = self.registry.histograms.get(name)
            return None if h is None else h.percentiles()

    def series(self, name) -> list[dict]:
        with self._lock:
            s = self.registry.series.get(name)
            return [] if s is None else s.series()

    def counter(self, name) -> float:
        with self._lock:
            return self.registry.counters.get(name, 0)

    def snapshot(self):
        with self._lock:
            return self.registry.snapshot()

    def export_chrome(self, path: str) -> str:
        return self.trace.export_chrome(path)


class JsonlTracker(Tracker):
    """Streams one JSON line per record to ``path`` (append mode).

    Lines are ``{"kind": "count"|"gauge"|"observe"|"span", "name": ...,
    ...}``; ``wall`` stamps ``time.time()`` so runs interleave sensibly.
    Writes are buffered (``buffer`` lines) and flushed on ``flush``/
    ``close``; the file opens lazily on first record.
    """

    def __init__(self, path: str, buffer: int = 256):
        self.path = path
        self._buffer_n = max(1, int(buffer))
        self._lines: list[str] = []
        self._fh = None
        self._lock = threading.Lock()

    def _write(self, rec: dict) -> None:
        rec["wall"] = time.time()
        with self._lock:
            self._lines.append(json.dumps(rec))
            if len(self._lines) >= self._buffer_n:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._lines:
            return
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write("\n".join(self._lines) + "\n")
        self._fh.flush()
        self._lines.clear()

    def count(self, name, n=1, tags=None):
        self._write({"kind": "count", "name": name, "n": n,
                     **({"tags": tags} if tags else {})})

    def gauge(self, name, value, tags=None):
        self._write({"kind": "gauge", "name": name, "value": value,
                     **({"tags": tags} if tags else {})})

    def observe(self, name, value, t=None, tags=None):
        self._write({"kind": "observe", "name": name, "value": value,
                     **({"t": t} if t is not None else {}),
                     **({"tags": tags} if tags else {})})

    @contextlib.contextmanager
    def _timed_span(self, name, tags):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add_span(name, t0, time.perf_counter(), tags=tags)

    def span(self, name, tags=None):
        return self._timed_span(name, tags)

    def add_span(self, name, t0, t1, *, track=0, tags=None):
        self._write({"kind": "span", "name": name, "t0": t0,
                     "dur_s": max(0.0, t1 - t0), "track": track,
                     **({"tags": tags} if tags else {})})

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        with self._lock:
            self._flush_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class CompositeTracker(Tracker):
    """Fans every record out to a list of child trackers."""

    def __init__(self, parts: Sequence[Tracker]):
        self.parts = list(parts)

    def count(self, name, n=1, tags=None):
        for p in self.parts:
            p.count(name, n, tags)

    def gauge(self, name, value, tags=None):
        for p in self.parts:
            p.gauge(name, value, tags)

    def observe(self, name, value, t=None, tags=None):
        for p in self.parts:
            p.observe(name, value, t, tags)

    @contextlib.contextmanager
    def _multi_span(self, name, tags):
        with contextlib.ExitStack() as stack:
            for p in self.parts:
                stack.enter_context(p.span(name, tags))
            yield self

    def span(self, name, tags=None):
        return self._multi_span(name, tags)

    def add_span(self, name, t0, t1, *, track=0, tags=None):
        for p in self.parts:
            p.add_span(name, t0, t1, track=track, tags=tags)

    def percentiles(self, name):
        for p in self.parts:
            out = p.percentiles(name)
            if out is not None:
                return out
        return None

    def snapshot(self):
        out: dict = {}
        for p in self.parts:
            snap = p.snapshot()
            if snap:
                out[type(p).__name__] = snap
        return out

    def flush(self):
        for p in self.parts:
            p.flush()

    def close(self):
        for p in self.parts:
            p.close()


def make_tracker(spec: Any, window: int = 256) -> Optional[Tracker]:
    """Resolve a tracker spec: ``None``/``""`` → None (telemetry off),
    a :class:`Tracker` instance passes through, and strings select a
    sink — ``"noop"``, ``"memory"``, ``"jsonl:<path>"`` — with ``+``
    composing several (``"memory+jsonl:/tmp/t.jsonl"``)."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, Tracker):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"expected a Tracker or spec string, got {spec!r}")
    parts = []
    for item in spec.split("+"):
        item = item.strip()
        if item == "noop":
            parts.append(NOOP)
        elif item in ("memory", "mem"):
            parts.append(InMemoryTracker(window=window))
        elif item.startswith("jsonl:"):
            parts.append(JsonlTracker(item[len("jsonl:"):]))
        else:
            raise ValueError(
                f"unknown tracker spec {item!r}; expected 'noop', "
                f"'memory', or 'jsonl:<path>' (combine with '+')")
    return parts[0] if len(parts) == 1 else CompositeTracker(parts)
