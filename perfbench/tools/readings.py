"""The readings the correctness limits are set from, on the card, in one
process: for each seed, one run of a cell (a short window, no trace) with
the program, the control or a fault in the program's place, and the
numbers its check compares.

    python3 perfbench/tools/readings.py --workload <cell> \
        --seeds 11,12,13 --as program|control|fault:<name> \
        [--seconds 1] [--out readings.jsonl]

One JSON line a seed on standard output (and appended to ``--out``).
The faults are ``harness.control``'s: train ``unchanged``, ``half_batch``,
``labels_altered``; prefill ``half_batch``, ``token_altered``,
``quarter_altered``.  A prefill line also carries each checked prompt's
error (``prompt_errs``), from which a per-prompt limit is set.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from harness import control, device, runner  # noqa: E402


def system_for(ctx, what: str):
    kind = ctx.traffic["driver"]
    if what == "program":
        return None
    if what == "control":
        return (control.ControlTrain(ctx.config, ctx.traffic, ctx.device)
                if kind == "train" else
                control.ControlPrefill(ctx.config, ctx.device))
    name = what.split(":", 1)[1]
    if kind == "train":
        return control.TRAIN_FAULTS[name](ctx.config, ctx.traffic, ctx.device)
    return control.PREFILL_FAULTS[name](ctx.config, ctx.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="what", default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = runner.context(args.workload, seed, args.seconds, False, t0,
                             device=args.device)
        ctx.system = system_for(ctx, args.what)
        if args.device == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats()
        rec = runner.drive(ctx)
        line = {"workload": args.workload, "seed": seed, "as": args.what,
                "numbers": rec["numbers"], "calls_or_steps": rec["attempted"],
                "window_s": rec["window_s"], "setup_s": rec["setup_s"],
                "units": rec["units"], "peak_bytes": rec["peak_bytes"],
                "device": rec["device"], "power_limit_w": rec["power_limit_w"],
                "prompt_errs": rec.get("prompt_errs"),
                "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del ctx, rec
        device.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
