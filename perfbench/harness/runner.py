"""One run of a cell, as ``run.py`` makes it: the context a driver is
given, the driver found by the traffic's name, and the result line built
from the driver's record by the metric readers the cell's metrics name."""
from __future__ import annotations

import dataclasses
import sys

from . import spec

#: top-level module names that must not be loaded (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver is given for one run."""
    cell: dict
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    system: object = None          # None: the program under test


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def context(name: str, seed: int, seconds: float, trace: bool,
            t_start: float, **kw) -> Context:
    bench = spec.benchmark()
    cell = spec.cell(bench, name)
    return Context(
        cell=cell,
        config=spec.load_json(spec.config_file(bench, cell["config"])),
        traffic=spec.load_json(spec.traffic_file(cell["traffic"])),
        workload=spec.load_json(spec.workload_file(name)),
        seed=seed, seconds=seconds, trace=trace, t_start=t_start, **kw)


def drive(ctx: Context) -> dict:
    """The cell's driver over ``ctx``: its record (see the drivers), with
    the device's name and power limit."""
    import torch
    from . import device
    drv = spec.load_module(spec.driver_file(ctx.traffic["driver"]),
                           f"perfbench_driver_{ctx.traffic['driver']}")
    dev = torch.device(ctx.device)
    power = device.power_limit_w() if dev.type == "cuda" else None
    rec = drv.run(ctx)
    rec["device"] = device.name(dev)
    rec["power_limit_w"] = power
    return rec


def result(ctx: Context, rec: dict, chips: int) -> dict:
    """The result line of a run from the driver's record."""
    from . import check, device
    import torch
    bench = spec.benchmark()
    metrics = {}
    for m in spec.metrics_of(bench, ctx.cell["name"], ctx.trace):
        reader = spec.load_module(spec.metric_file(m["name"]),
                                  "perfbench_metric_" + m["name"])
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, shown = check.judge(rec["numbers"],
                                 ctx.workload.get("limits", {}))
    dev = torch.device(ctx.device)
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": device.name(dev), "count": chips,
                      "memory_peak_bytes": rec["peak_bytes"],
                      "power_limit_w": rec.get("power_limit_w")}}
    tr = rec.get("trace")
    if ctx.trace and tr:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["check"] = shown
    return out


