"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the traffic's
``driver`` (``drivers/<driver>.py``) sets up, runs the measured window of
``--seconds`` and checks what the window produced against the plain
reference.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones (and ``breakdown``), each read by
``metrics/<name>.py``.  The last line of standard output is one JSON
object; the numbers the check compared are the last lines of standard
error.  Exits non-zero, printing no result, without the card the cell
asks for, or if the JAX package or JAX itself was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import check, runner
    ctx = runner.context(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    chips = ctx.cell["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    rec = runner.drive(ctx)
    bad = runner.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    out = runner.result(ctx, rec, chips)
    check.print_check(out["check"], out["correct"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
