"""Span-based request-path tracing with Chrome trace-event export.

A :class:`TraceBuffer` records named spans — either live via the
``span()`` context manager (enter/exit stamps ``time.perf_counter``) or
retroactively via ``add_span(name, t0, t1)`` with timestamps the caller
already holds (the serving engine stamps request arrival/completion
itself).  ``to_chrome()`` renders the buffer as Chrome trace-event JSON
(the ``chrome://tracing`` / Perfetto ``traceEvents`` format), so a
serving run's request lifecycle — arrive → hit / queue → fill → complete
— loads straight into a trace viewer.

``annotate(name)`` is the kernel-launch passthrough: it returns a
``torch.profiler.record_function`` range, so the span shows up beside the
CUDA kernels in traces captured with ``torch.profiler.profile``.  Device
backends wrap their fused launches in it.

Trace ids are process-monotonic ints from :func:`next_trace_id` —
decisions must never depend on telemetry, so ids come from a counter,
not a random source.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Optional

__all__ = ["TraceBuffer", "annotate", "next_trace_id"]

_trace_ids = itertools.count(1)


def next_trace_id() -> int:
    """Monotonic per-process trace/request id (deterministic, not random)."""
    return next(_trace_ids)


def annotate(name: str):
    """``torch.profiler.record_function`` range around kernel launches."""
    import torch
    return torch.profiler.record_function(name)


class TraceBuffer:
    """Bounded in-memory span store with Chrome trace-event export.

    Spans are ``(name, t0, dur, track, tags)`` with times in seconds on
    the ``time.perf_counter`` clock; export converts to the microsecond
    timestamps Chrome expects, relative to the buffer's construction
    origin.  ``max_events`` bounds memory on long runs (oldest spans are
    dropped in blocks; the drop count is reported in the export metadata
    so a truncated trace is never mistaken for a complete one).
    """

    def __init__(self, max_events: int = 100_000):
        self.origin = time.perf_counter()
        self.max_events = int(max_events)
        self.events: list[tuple] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.events)

    def add_span(self, name: str, t0: float, t1: float, *, track: int = 0,
                 tags: Optional[dict] = None) -> None:
        """Record one completed span (perf_counter seconds)."""
        with self._lock:
            self.events.append((name, t0, max(0.0, t1 - t0), track, tags))
            if len(self.events) > self.max_events:
                cut = max(1, self.max_events // 10)
                del self.events[:cut]
                self.dropped += cut

    @contextlib.contextmanager
    def span(self, name: str, *, track: int = 0, tags: Optional[dict] = None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add_span(name, t0, time.perf_counter(), track=track,
                          tags=tags)

    # ------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Render as a Chrome trace-event JSON object (``traceEvents`` in
        the "X" complete-event form; load via chrome://tracing, Perfetto,
        or ``json.load``)."""
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
        trace_events = [
            {"name": name, "cat": "repro", "ph": "X",
             "ts": (t0 - self.origin) * 1e6, "dur": dur * 1e6,
             "pid": 0, "tid": track, "args": dict(tags) if tags else {}}
            for name, t0, dur, track, tags in events]
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": dropped}}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path
