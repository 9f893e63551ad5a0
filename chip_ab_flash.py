"""B8 (flash_attention) side by side on one card: each checkout's kernel at
chip_smoke.py's bf16 FLASH_SHAPES (device ms per call, from a CUDA graph of
many calls) and the paper LM's prefill of B=2 x 1,000 tokens (host wall ms
and CUDA-event ms per call), the checkouts timed in turns, each in a process
of its own that builds that checkout's kernels; one more prefill under
torch.profiler gives the card's busy time and B8's part of it.  With
``--top1`` the same for B1 (sim_top1, sim_top1_multi) at chip_smoke.py's
shapes, on seeded unit rows.

    python3 chip_ab_flash.py [--top1] ROOT [ROOT ...]
    python3 chip_ab_flash.py [--top1] --ablate

ROOT is a directory holding ``src/repro_torch``: to hold a change against
its parent, unpack the parent's package into a directory ``.gitignore``
lists (``git archive <parent> src/repro_torch | tar -x -C build/parent``)
and run ``build/parent . . build/parent``.  ``--ablate`` writes variants of
this checkout's ``csrc/flash_attention.cu`` under ``build/ablate/`` (one
P.V product instead of three; P not split; no turns between the consumer
warpgroups; a multiply in place of ex2; the first, second and fourth
together) and times them in turns with the checkout; with ``--top1``,
of ``csrc/sim_top1.cu`` (three stages and three blocks an SM instead of two
and four; no split of the candidates; no split of the queries; no
wgmma; only the candidates' copies).  A variant computes wrong values
(but for the stage count): it only says where the kernel's time goes.
Needs a CUDA card; prints one JSON line per run and the card's name and
power limit.
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

# B1: chip_smoke.py's shapes, (label, Q, N or (P, S)), graph reps
TOP1_SRC = "src/repro_torch/csrc/sim_top1.cu"
TOP1_SHAPES = [("Q=512 N=65,537", 512, 65_537, 20), ("Q=8 N=65,537", 8,
                                                        65_537, 50),
               ("Q=512 T=4,096", 512, 4_096, 50), ("union Q=1 N=8", 1, 8,
                                                      200),
               ("union Q=16 N=128", 16, 128, 200),
               ("multi Q=512 P=15 S=6,852", 512, (15, 6_852), 10),
               ("multi Q=16 P=15 S=6,852", 16, (15, 6_852), 20)]
_T1_SPLIT = "    for (int it = 0; it < BN * KC / 4 / kThreads; ++it) {"
_T1_FRAG = ("      const float x[4] = {qs[swz(r0, 8 * s + tig)], "
            "qs[swz(r1, 8 * s + tig)],\n"
            "                          qs[swz(r0, 8 * s + tig + 4)],\n"
            "                          qs[swz(r1, 8 * s + tig + 4)]};")
_T1_MMA = "      wgmma_tf32(acc, {}, sw128({} + 32 * s), {});"
_T1_QCOPY = "      for (int e = tid; e < qrows * PER_ROW; e += kThreads) {"
TOP1_EDITS = {
    "three_stages": [("constexpr int NS = 2; ", "constexpr int NS = 3; "),
                     ("__launch_bounds__(kThreads, 4)",
                      "__launch_bounds__(kThreads, 3)")],
    "no_split": [(_T1_SPLIT, "    for (int it = 0; it < 0; ++it) {")],
    "no_afrag": [(_T1_FRAG, "      const float x[4] = {1.f, 2.f, 3.f, "
                            "4.f};")],
    "no_wgmma": [(_T1_MMA.format(a, b, c), "")
                 for a, b, c in (("ah[s]", "hs", "s > 0"),
                                 ("ah[s]", "ls", "1"),
                                 ("al[s]", "hs", "1"))],
}
TOP1_EDITS["copies_only"] = (
    TOP1_EDITS["no_split"] + TOP1_EDITS["no_afrag"] + TOP1_EDITS["no_wgmma"]
    + [(_T1_QCOPY, "      for (int e = tid; e < 0; e += kThreads) {")])


def child(root: str, prefill: bool, top1: bool) -> dict:
    """Time one checkout's B8 (and prefill), or its B1, in this process."""
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
    if top1:
        from repro_torch.kernels import similarity_topk as st
        rng = np.random.default_rng(0)

        def unit(*shape):
            x = rng.standard_normal(shape).astype(np.float32)
            x /= np.linalg.norm(x, axis=-1, keepdims=True)
            return torch.from_numpy(x).to("cuda")
        queries = unit(512, 768)
        for label, nq, n, reps in TOP1_SHAPES:
            q = queries[:nq].contiguous()
            if isinstance(n, tuple):
                slabs = unit(*n, 768)
                counts = torch.full((n[0],), n[1], dtype=torch.int32,
                                    device="cuda")
                out[label] = graph_ms(
                    lambda: st.sim_top1_multi(q, slabs, counts), reps)
            else:
                c = unit(n, 768)
                out[label] = graph_ms(lambda: st.sim_top1(q, c, n), reps)
        return out
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


def ablation_roots(top1: bool) -> list[str]:
    """Write the variants of this checkout's kernel; returns their roots."""
    path = TOP1_SRC if top1 else _SRC
    with open(os.path.join(HERE, path)) as f:
        src = f.read()
    roots = []
    for name, edits in (TOP1_EDITS if top1 else EDITS).items():
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
        with open(os.path.join(root, path), "w") as f:
            f.write(text)
        roots.append(root)
    return roots


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(args[1]),
                               "--no-prefill" not in args,
                               "--top1" in args)), flush=True)
        return
    top1 = "--top1" in args
    args = [a for a in args if a != "--top1"]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab_flash.py: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args == ["--ablate"]:
        variants = ablation_roots(top1)
        roots, extra = [HERE] + variants, ["--no-prefill"]
        roots = roots + roots
    elif args and not any(a.startswith("-") for a in args):
        roots, extra = [os.path.abspath(a) for a in args], []
    else:
        raise SystemExit(__doc__)
    if top1:
        extra = ["--top1"]
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
