"""Tiny configurations of the benchmark's families and a context on the
CPU, for the tests."""
from __future__ import annotations

import time

from harness import runner, spec


def config(name: str, dtype: str = "bfloat16") -> dict:
    """``configs/<name>.json`` cut to its family's tiny size
    (``families/<reference>.py``'s ``TINY``)."""
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    return dict(cfg, dtype=dtype, **spec.family(cfg).TINY)


def context(cell: str, dtype: str = "bfloat16", seed: int = 2 ** 31 + 5,
            config_name: str | None = None, **kw) -> runner.Context:
    """``cell``'s context on the CPU at a tiny size: its configuration's
    family (or ``config_name``'s) cut down, its traffic at batch 4 and 32
    to 64 tokens, a window of 0.3 s, the cell's own limits."""
    bench = spec.benchmark()
    c = spec.cell(bench, cell)
    tf = spec.load_json(spec.traffic_file(c["traffic"]))
    tf.update(batch=4, seq=32 if tf["driver"] == "train" else 64)
    wl = spec.load_json(spec.workload_file(cell))
    if "check_calls" in wl:
        wl["check_calls"] = 2
    return runner.Context(cell=c, config=config(config_name or c["config"],
                                                dtype),
                          traffic=tf, workload=wl, seed=seed, seconds=0.3,
                          trace=False, t_start=time.perf_counter(),
                          device="cpu", **kw)
