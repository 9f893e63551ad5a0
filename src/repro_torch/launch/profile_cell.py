"""Dry-run profiler: the per-op (``--by opcode``) or per-function (``--by
meta``: the innermost model and kernel functions on the stack) top-N
breakdown of one (arch x shape) cell's flops, HBM bytes and collective
link bytes, one rank's, from :mod:`repro_torch.launch.op_cost`; after
``repro/launch/profile_cell.py``.  Runs on the CPU in a fake world.

    PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
        --arch qwen1.5-110b --shape decode_32k [--by meta|opcode] [--top 15]
"""
from __future__ import annotations

import argparse
import math


def profile(arch: str, shape: str, multi_pod: bool = False,
            top: int = 15, by: str = "opcode"):
    from repro_torch.launch.dryrun import build_cell, run_cell
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_world
    from repro_torch.launch.op_cost import OpCost

    with fake_world(math.prod(PRODUCTION_SHAPES[multi_pod][0])):
        cell = build_cell(arch, shape, multi_pod)
        counter = OpCost(by=by)
        run_cell(cell, counter)
    bd = counter.breakdown
    print(f"== {arch} × {shape} ({'2x16x16' if multi_pod else '16x16'}) ==")
    print(f"-- HBM traffic by {by} (GB/device/step) --")
    for k, v in bd["hbm_bytes"].most_common(top):
        print(f"  {v/1e9:10.1f}  {k}")
    print(f"-- flops by {by} (G) --")
    for k, v in bd["flops"].most_common(top):
        print(f"  {v/1e9:10.1f}  {k}")
    print(f"-- collective link-bytes by {by} (GB) --")
    for k, v in bd["coll_bytes"].most_common(top):
        print(f"  {v/1e9:10.1f}  {k}")
    print(f"-- memory: arguments {cell.argument_bytes/2**30:.2f} GiB, "
          f"peak allocated by the step {counter.peak/2**30:.2f} GiB --")
    return bd["hbm_bytes"], bd["flops"], bd["coll_bytes"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--by", default="opcode", choices=["opcode", "meta"])
    ap.add_argument("--top", type=int, default=15)
    a = ap.parse_args(argv)
    profile(a.arch, a.shape, a.multi_pod, a.top, a.by)


if __name__ == "__main__":
    main()
