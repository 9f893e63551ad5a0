"""Reading the program's own profiler spans (``repro_torch.telemetry.
tracing.annotate``) in a traced stretch, beside :mod:`harness.trace`'s
timeline: for each span that opened, how often it opened, the device
seconds and launches of the kernels launched inside it, and the
device-idle seconds while the host was inside it; and how many of the
benchmark's own ``bench.`` spans (steps or calls) the stretch holds.

A program span is any host range named by the program's convention,
``<layer>/<part>``: lower-case words of letters, digits and ``_`` joined
by ``/`` and nothing else (:data:`CONVENTION`).  No profiler op of
PyTorch's (``aten::``), runtime call (``cuda``), autograd node
(``autograd::engine::``) or span of the benchmark's (``bench.``) is named
so.  Nothing here names a span: a metric file names the one it reads
(:func:`per_call`).

A kernel counts toward every span open on the host when the call that
launched it was made (the profiler's correlation: the launch call, a
``cuda*`` runtime event, and the kernel share a correlation id), so a
nested span's kernels count toward its parent too; the host issues work
from one thread at a time (the backward runs while the caller waits).
An idle gap (between the merged device intervals that
:func:`harness.trace.read` takes as busy) counts toward the innermost
program span open at the gap's midpoint, the rule ``idle_gaps`` uses."""
from __future__ import annotations

import bisect
import re

import torch

from . import trace

#: the program's span names: ``layer/part``, lower-case, no spaces or colons
CONVENTION = re.compile(r"[a-z][a-z0-9_]*(/[a-z0-9_]+)+")


def is_program_span(name: str) -> bool:
    return CONVENTION.fullmatch(name) is not None


def read(events) -> dict:
    """``events``: the profiler's FunctionEvents (times in microseconds).
    Returns ``spans`` {name: {calls, device_s, launches, idle_s}} for
    every program span that opened, and ``bench_calls``."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    host_names = {e.name for e in host}
    # a span's device-side row carries its host-side name; only kernels,
    # copies and sets ran on the device
    dev = [e for e in events
           if e.device_type == cuda and e.name not in host_names]
    ran = {e.id: e.time_range.end - e.time_range.start for e in dev}
    calls = sorted((e.time_range.start, ran[e.id]) for e in host
                   if e.name.startswith("cu") and e.id in ran)
    starts = [t for t, _ in calls]
    spans: dict = {}
    opened = []
    for e in host:
        if not is_program_span(e.name):
            continue
        a, b = e.time_range.start, e.time_range.end
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        s = spans.setdefault(e.name, {"calls": 0, "device_s": 0.0,
                                      "launches": 0, "idle_s": 0.0})
        s["calls"] += 1
        s["launches"] += hi - lo
        s["device_s"] += sum(d for _, d in calls[lo:hi]) / 1e6
        opened.append((a, b, e.name))
    busy = trace._merge([(e.time_range.start, e.time_range.end)
                         for e in dev])
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        inside = [(b - a, n) for a, b, n in opened if a <= mid <= b]
        if inside:
            spans[min(inside)[1]]["idle_s"] += (start - end) / 1e6
    return {"spans": spans,
            "bench_calls": sum(e.name.startswith(trace.BENCH_SPAN)
                               for e in host)}


def per_call(rec: dict, kind: str, span: str, field: str,
             scale: float = 1.0):
    """``span``'s ``field`` (``device_s``, ``launches`` or ``idle_s``) a
    traced step or call of a ``kind`` run, times ``scale``; None where the
    run is of another kind, was not traced, or the span launched nothing
    on the device there."""
    tr = rec.get("trace")
    if rec["kind"] != kind or not tr or not tr.get("bench_calls"):
        return None
    s = tr["spans"].get(span)
    if not s or not s["launches"]:
        return None
    return s[field] * scale / tr["bench_calls"]
