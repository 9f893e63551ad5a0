"""B8 (flash_attention) side by side on one card: each checkout's kernel at
chip_smoke.py's bf16 FLASH_SHAPES (device ms per call, from a CUDA graph of
many calls) and the paper LM's prefill of B=2 x 1,000 tokens (host wall ms
and CUDA-event ms per call), the checkouts timed in turns, each in a process
of its own that builds that checkout's kernels; one more prefill under
torch.profiler gives the card's busy time and B8's part of it.

    python3 chip_ab_flash.py ROOT [ROOT ...]
    python3 chip_ab_flash.py --ablate

ROOT is a directory holding ``src/repro_torch``: to hold a change against
its parent, unpack the parent's package into a directory ``.gitignore``
lists (``git archive <parent> src/repro_torch | tar -x -C build/parent``)
and run ``build/parent . . build/parent``.  ``--ablate`` writes variants of
this checkout's ``csrc/flash_attention.cu`` under ``build/ablate/`` (one
P.V product instead of three; P not split; no turns between the consumer
warpgroups; a multiply in place of ex2; the first, second and fourth
together) and times them in turns with the checkout.  A variant computes
wrong values: it only says where the kernel's time goes.  Needs a CUDA
card; prints one JSON line per run and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's bf16 FLASH_SHAPES: (B, H, Hkv, S, D), graph reps
SHAPES = [((1, 15, 5, 4096, 64), 20), ((2, 15, 5, 1000, 64), 50),
          ((1, 15, 5, 32768, 64), 3)]
PREFILL_B, PREFILL_S = 2, 1_000
_SRC = "src/repro_torch/csrc/flash_attention.cu"
_RS = "    wgmma_rs(acc, {}, vd);\n"
_EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
_SPLIT = "    split3(sc[2 * j], sc[2 * j + 1], ph[j], pm[j], pl[j]);"
_TURNS = ('  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kConsumers) '
          ': "memory");',
          '  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(kConsumers)'
          '\n               : "memory");')
EDITS = {
    "one_pv": [(_RS.format("pm + 4 * kk") + _RS.format("pl + 4 * kk"), "")],
    "no_split": [(_SPLIT, "    ph[j] = pm[j] = pl[j] = "
                          "__float_as_uint(sc[2 * j]);")],
    "no_turns": [(t, "") for t in _TURNS],
    "no_ex2": [(_EX2, "  y = x * 0.001f;")],
}
EDITS["floor"] = EDITS["one_pv"] + EDITS["no_split"] + EDITS["no_ex2"]


def child(root: str, prefill: bool) -> dict:
    """Time one checkout's B8 (and prefill) in this process."""
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import _build, flash_attention as fa
    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not {root}'s")
    _build.library()
    gen = torch.Generator("cuda").manual_seed(2)

    def graph_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    out = {"root": root, "build_s": _build.build_seconds}
    for (b, h, hkv, s, d), reps in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((b, h, s, d), (b, hkv, s, d),
                                          (b, hkv, s, d)))
        out[f"B={b} H={h} Hkv={hkv} S={s} D={d}"] = graph_ms(
            lambda: fa.flash_attention(q, k, v), reps)
        del q, k, v
    if prefill:
        from repro_torch.configs import get_config
        from repro_torch.models import Model, make_prefill_step
        cfg = get_config("paper")
        model = Model(cfg, "cuda")
        params = model.init(torch.Generator("cuda").manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            2, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to("cuda")
        step = make_prefill_step(model)
        batch = {"tokens": tokens}
        step(params, batch)
        torch.cuda.synchronize()
        walls, events = [], []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            step(params, batch)
            e1.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            events.append(e0.elapsed_time(e1))
        out["prefill_wall_ms"] = walls
        out["prefill_event_ms"] = events
        # one more under torch.profiler: the card's busy time, and B8's
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(params, batch)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out["prefill_device_ms"] = sum(
            e.time_range.elapsed_us() for e in kernels) / 1e3
        out["prefill_b8_device_ms"] = sum(
            e.time_range.elapsed_us() for e in kernels
            if "flash_kernel" in e.name) / 1e3
    return out


def ablation_roots() -> list[str]:
    """Write the variants of this checkout's kernel; returns their roots."""
    with open(os.path.join(HERE, _SRC)) as f:
        src = f.read()
    roots = []
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"--ablate {name}: the kernel no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        root = os.path.join(HERE, "build", "ablate", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(HERE, "src", "repro_torch"),
                        os.path.join(root, "src", "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        with open(os.path.join(root, _SRC), "w") as f:
            f.write(text)
        roots.append(root)
    return roots


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(args[1]),
                               "--no-prefill" not in args)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab_flash.py: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args == ["--ablate"]:
        variants = ablation_roots()
        roots, extra = [HERE] + variants, ["--no-prefill"]
        roots = roots + roots
    elif args and not any(a.startswith("-") for a in args):
        roots, extra = [os.path.abspath(a) for a in args], []
    else:
        raise SystemExit(__doc__)
    runs = []
    for root in roots:
        res = subprocess.run([sys.executable, __file__, "--child", root,
                              *extra], capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"{root}: exit {res.returncode}\n"
                             f"{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)


if __name__ == "__main__":
    main()
