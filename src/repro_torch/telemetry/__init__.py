"""Telemetry for the cache: pluggable trackers
(:mod:`~repro_torch.telemetry.tracker`), mergeable metric primitives
(:mod:`~repro_torch.telemetry.metrics`), span tracing with Chrome
trace-event export (:mod:`~repro_torch.telemetry.tracing`) and text/JSON
summaries of a tracker (:mod:`~repro_torch.telemetry.report`).  Strictly
observation-only: decisions are identical with any tracker attached."""
from .metrics import Histogram, MetricsRegistry, WindowedSeries
from .report import render_text, summarize, write_report
from .tracing import TraceBuffer, annotate, next_trace_id
from .tracker import (NOOP, CompositeTracker, InMemoryTracker, JsonlTracker,
                      NoopTracker, Tracker, make_tracker)

__all__ = ["Tracker", "NoopTracker", "NOOP", "InMemoryTracker",
           "JsonlTracker", "CompositeTracker", "make_tracker", "Histogram",
           "MetricsRegistry", "WindowedSeries", "TraceBuffer", "annotate",
           "next_trace_id", "summarize", "render_text", "write_report"]
