"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 chip_profile.py [--trace-len N]

Replays the same RAC request path as ``chip_smoke.py`` (OASST-style trace
at D=768, capacity 65,536, chunk 512, ``backend="kernel"`` on the card)
twice:

  1. under ``torch.profiler`` (CPU + CUDA activity): wall time, device
     time by kernel, and the device's idle share of the wall;
  2. under ``cProfile``: host time by function (cProfile slows the host
     side, so read its shares, not its absolute seconds).

Prints a JSON line per run.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def replay(trace):
    from repro_torch.core import make_rac, run_policy_batched
    t0 = time.perf_counter()
    st = run_policy_batched(trace, 65_536, make_rac(), hit_mode="semantic",
                            backend="kernel", device="cuda", chunk=512)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-len", type=int, default=72_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device is available")
    from repro_torch.core import OASSTConfig, oasst_style_trace
    from repro_torch.kernels import _build
    _build.library()
    trace = oasst_style_trace(OASSTConfig(dim=768, trace_len=args.trace_len,
                                          seed=0))
    print(torch.cuda.get_device_name(0), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, wall = replay(trace)
    # only the device's own events (kernels and copies): the CPU ops and
    # the record_function ranges above them report the same device time
    # again, and a range's device-side row carries its host-side name
    events = prof.key_averages()
    host_names = {ev.key for ev in events
                  if ev.device_type != torch.autograd.DeviceType.CUDA}
    kernels = {}
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key in host_names:
            continue
        kernels[ev.key[:120]] = {"device_ms": ev.self_device_time_total / 1e3,
                                 "calls": ev.count}
    busy_ms = sum(k["device_ms"] for k in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])[:12]
    print(json.dumps({
        "run": "torch.profiler", "requests": len(trace.requests),
        "hits": st.hits, "evictions": st.evictions, "wall_s": wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "by_kernel": dict(top)}), flush=True)

    prof_host = cProfile.Profile()
    prof_host.enable()
    st, wall = replay(trace)
    prof_host.disable()
    stats = pstats.Stats(prof_host, stream=io.StringIO())
    total = stats.total_tt
    rows = []
    for (path, line, fn), (_cc, nc, tt, ct, _) in stats.stats.items():
        rows.append({"fn": f"{os.path.basename(path)}:{line}({fn})",
                     "calls": nc, "self_share": tt / total,
                     "cum_share": ct / total})
    top_self = sorted(rows, key=lambda r: -r["self_share"])[:12]
    top_cum = sorted(rows, key=lambda r: -r["cum_share"])[:16]
    print(json.dumps({"run": "cProfile", "wall_s": wall,
                      "top_self": top_self, "top_cum": top_cum}), flush=True)


if __name__ == "__main__":
    main()
