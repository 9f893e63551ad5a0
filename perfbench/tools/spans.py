"""The program's spans in a cell's traced run, on the card: one run of the
cell as ``run.py --trace 1`` makes it, and what each program span in the
traced stretch (``harness.spans``, read into the run's record by
``harness.trace``) took a step or call; or the cost of one span's enter
and exit.

    python3 perfbench/tools/spans.py --workload <cell> --seed <n> \
        [--seconds 10] [--out spans.jsonl]
    python3 perfbench/tools/spans.py --cost 100000

A cell's run prints its result line as ``run.py`` would, then one JSON
line: for each span, the calls, device ms, kernel launches and idle ms a
traced step or call, and the readings of :data:`READINGS`, worked out
here apart from the metric files that report them
(``metrics/attention_grad_ms.train.py``, ...), as a check on those.
``--cost`` times ``annotate``'s enter and exit with the profiler off and
on (CPU and CUDA activity), in microseconds a span."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from harness import runner  # noqa: E402

#: the per-layer readings: (name, span, field, scale a step or call)
READINGS = {
    "train": [("attention_grad_ms.train", "attention/grad", "device_s", 1e3),
              ("optimizer_idle_ms.train", "optim/adamw", "idle_s", 1e3),
              ("optimizer_launches.train", "optim/adamw", "launches", 1)],
    "prefill": [("unembed_ms.prefill", "model/unembed", "device_s", 1e3),
                ("moe_ms.prefill", "moe/experts", "device_s", 1e3),
                ("moe_slots_ms.prefill", "moe/slots", "device_s", 1e3)],
}


def per_step(tr: dict, kind: str) -> dict:
    """Each span's calls, device ms, launches and idle ms a traced step
    or call, and the readings of :data:`READINGS` where the span ran."""
    n = max(tr["bench_calls"], 1)
    table = {name: {"calls": s["calls"] / n,
                    "device_ms": 1e3 * s["device_s"] / n,
                    "launches": s["launches"] / n,
                    "idle_ms": 1e3 * s["idle_s"] / n}
             for name, s in tr["spans"].items()}
    readings = {m: tr["spans"][span][field] * scale / n
                for m, span, field, scale in READINGS[kind]
                if span in tr["spans"]}
    return {"steps_or_calls": tr["bench_calls"], "spans": table,
            "readings": readings,
            "wall_ms": 1e3 * tr["window_s"] / n,
            "busy_ms": 1e3 * tr["busy_s"] / n,
            "idle_ms": 1e3 * (tr["window_s"] - tr["busy_s"]) / n}


def span_cost(n: int) -> dict:
    """Microseconds a span, entered and left ``n`` times in a row, with
    the profiler off and on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry.tracing import annotate

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with annotate("optim/adamw"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n
    off = [loop() for _ in range(3)]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = [loop() for _ in range(3)]
    return {"spans": n, "us_off": off, "us_on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.cost:
        line = span_cost(args.cost)
    else:
        ctx = runner.context(args.workload, args.seed, args.seconds, True,
                             T_START)
        rec = runner.drive(ctx)
        out = runner.result(ctx, rec, ctx.cell["chips"])
        print(json.dumps(out), flush=True)
        line = {"workload": args.workload, "seed": args.seed,
                "device": rec["device"],
                "power_limit_w": rec["power_limit_w"],
                "correct": out["correct"],
                **per_step(rec["trace"], rec["kind"])}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
