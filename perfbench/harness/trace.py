"""Reading the device timeline of a traced stretch of a run from
``torch.profiler`` (CUPTI activity on the card): the seconds in which an
operation ran on the device (the union of their intervals), the traced
window's wall, the device time of each kernel by name, the idle gaps
between operations, named by what the host was doing then, and the
program's spans (:mod:`harness.spans`).  Nothing is written to disk."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

BENCH_SPAN = "bench."       # the record_function spans the drivers open


def traced(fn) -> dict:
    """Run ``fn()`` under the profiler, the device synchronised at both
    ends, and read its timeline (:func:`read`)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return read(prof.events(), wall)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost(spans):
    """The host ops not nested in another, as disjoint sorted (start,
    end, name) intervals."""
    out = []
    for a, b, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if out and a < out[-1][1]:
            continue
        out.append((a, b, name))
    return out


def read(events, wall_s: float) -> dict:
    """``events``: the profiler's FunctionEvents; times in microseconds.
    Returns ``busy_s``, ``window_s``, ``kernels`` {name: seconds},
    ``launches`` {name: count}, ``device_ops`` and ``idle_gaps`` (the ten
    largest, as [name, seconds] pairs), and :func:`harness.spans.read`'s
    ``spans`` and ``bench_calls``.  A gap is named by the outermost host
    op open at its midpoint, the benchmark's and the program's spans left
    out, so that the op under a span names it."""
    from . import spans
    events = list(events)
    cuda = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != cuda}
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            # a span's device-side row carries its host-side name; only
            # kernels, copies and sets ran on the device
            if e.name not in host_names:
                dev.append((tr.start, tr.end, e.name))
        elif not (e.name.startswith(BENCH_SPAN)
                  or spans.is_program_span(e.name)):
            host.append((tr.start, tr.end, e.name))
    kernels, launches = defaultdict(float), defaultdict(int)
    for a, b, name in dev:
        kernels[name] += (b - a) / 1e6
        launches[name] += 1
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    tops = _outermost(host)
    starts = [a for a, _, _ in tops]
    gaps = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid) - 1
        name = tops[i][2] if i >= 0 and tops[i][1] >= mid else "host: none"
        gaps[name] += (start - end) / 1e6

    def top10(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_s, "window_s": wall_s, "kernels": dict(kernels),
            "launches": dict(launches), "device_ops": top10(kernels),
            "idle_gaps": top10(gaps), **spans.read(events)}
