"""Reading the program's own profiler spans (``repro_torch.telemetry.
tracing.annotate``) in a traced stretch, beside :mod:`harness.trace`'s
timeline: for each span of :data:`PROGRAM_SPANS`, how often it opened, the
device seconds and launches of the kernels launched inside it, and the
device-idle seconds while the host was inside it; and how many of the
benchmark's own ``bench.`` spans (steps or calls) the stretch holds.

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

import torch

from . import trace

#: the program's spans, at its layer boundaries
PROGRAM_SPANS = ("attention/grad", "optim/adamw", "model/unembed",
                 "moe/experts", "moe/slots")


def read(events) -> dict:
    """``events``: the profiler's FunctionEvents (times in microseconds).
    Returns ``spans`` {name: {calls, device_s, launches, idle_s}} for
    every name of :data:`PROGRAM_SPANS`, and ``bench_calls``."""
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
    spans = {n: {"calls": 0, "device_s": 0.0, "launches": 0, "idle_s": 0.0}
             for n in PROGRAM_SPANS}
    opened = []
    for e in host:
        if e.name not in spans:
            continue
        a, b = e.time_range.start, e.time_range.end
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        s = spans[e.name]
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
