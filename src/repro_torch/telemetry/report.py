"""Summary rendering for tracker snapshots — text for humans/CI logs,
JSON for ``bench_results`` artifacts.

``summarize(tracker)`` collapses an :class:`~repro_torch.telemetry.tracker.
InMemoryTracker` (or any tracker exposing ``snapshot()``) into one
JSON-serializable dict; ``render_text`` pretty-prints it with aligned
columns and SI-ish latency units; ``write_report`` does both to disk.
Benchmarks use these so every suite reports through the same surface
instead of hand-formatting its own rows.
"""
from __future__ import annotations

import json
import math
from typing import Optional

from .tracker import Tracker

__all__ = ["summarize", "render_text", "write_report"]


def summarize(tracker: Tracker) -> dict:
    """One JSON-serializable summary dict for a tracker's accumulated
    state (empty sections are dropped)."""
    snap = tracker.snapshot() or {}
    return {k: v for k, v in snap.items() if v}


def _fmt_seconds(v: float) -> str:
    if v != v:                               # nan
        return "nan"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def _fmt(v: float) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    return str(int(v)) if isinstance(v, (int, float)) else str(v)


def render_text(snapshot: dict, title: str = "telemetry",
                series_tail: int = 6) -> str:
    """Aligned text rendering of a ``summarize``/``snapshot`` dict.

    Histograms print count/mean/p50/p95/p99 (latency-formatted — the
    stack's histograms are second-valued timings); series print the last
    ``series_tail`` windows as ``t:mean`` pairs.
    """
    lines = [f"== {title} =="]
    counters = snapshot.get("counters", {})
    if counters:
        lines.append("-- counters")
        width = max(len(k) for k in counters)
        for k in sorted(counters):
            lines.append(f"  {k:<{width}}  {_fmt(counters[k])}")
    gauges = snapshot.get("gauges", {})
    if gauges:
        lines.append("-- gauges")
        width = max(len(k) for k in gauges)
        for k in sorted(gauges):
            lines.append(f"  {k:<{width}}  {_fmt(gauges[k])}")
    hists = snapshot.get("histograms", {})
    if hists:
        lines.append("-- histograms (count mean p50 p95 p99)")
        width = max(len(k) for k in hists)
        for k in sorted(hists):
            h = hists[k]
            lines.append(
                f"  {k:<{width}}  n={h['count']}"
                f" mean={_fmt_seconds(h['mean'])}"
                f" p50={_fmt_seconds(h['p50'])}"
                f" p95={_fmt_seconds(h['p95'])}"
                f" p99={_fmt_seconds(h['p99'])}")
    series = snapshot.get("series", {})
    if series:
        lines.append(f"-- series (last {series_tail} windows, t:mean)")
        width = max(len(k) for k in series)
        for k in sorted(series):
            tail = series[k][-series_tail:]
            vals = " ".join(f"{row['t']}:{row['mean']:.3f}" for row in tail)
            lines.append(f"  {k:<{width}}  {vals}")
    if len(lines) == 1:
        lines.append("  (empty)")
    return "\n".join(lines)


def write_report(tracker: Tracker, json_path: Optional[str] = None,
                 title: str = "telemetry") -> str:
    """Summarize ``tracker``; optionally persist the JSON summary; return
    the text rendering (callers print it)."""
    summary = summarize(tracker)
    if json_path is not None:
        with open(json_path, "w") as f:
            json.dump(summary, f, indent=1, default=_json_default)
    return render_text(summary, title=title)


def _json_default(v):
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None
    raise TypeError(f"not JSON serializable: {type(v)}")
