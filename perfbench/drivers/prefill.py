"""Prefill traffic: a closed loop of prefill calls, each of ``batch``
prompts of ``seq`` uniform token ids drawn on the device from the seed
and the call's index; a call returns the last-position logits, which the
run keeps.

Set-up draws the weights and warms up with ``warmup_calls`` calls on
prompts of their own.  With ``--trace 1``, ``trace_calls`` more calls
run under the profiler after the window.  Once the window has closed and
the program's state is freed, the reference prefills the prompts of
``check_calls`` of the window's calls (the cell's ``workloads`` file; one
where it names none), drawn from the seed, and their logits are
compared."""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import check, counts, device, program, seeds, trace, weights
from harness.traffic import prompt_tokens
from reference import common


def run(ctx) -> dict:
    cfg, tf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    b, s = tf["batch"], tf["seq"]
    system = ctx.system or program.PrefillSystem(cfg, dev)
    seed_w = seeds.derive(ctx.seed, seeds.WEIGHTS)

    def prompt(i: int, tag: int = seeds.PROMPTS) -> torch.Tensor:
        return prompt_tokens(cfg["vocab_size"], b, s,
                             seeds.derive(ctx.seed, tag, i), dev)

    params = weights.draw(cfg, seed_w, dev)
    for w in range(tf["warmup_calls"]):
        system.prefill(params, prompt(w, seeds.WARMUP))
    device.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    outs = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        with record_function("bench.prefill"):
            # a copy: the returned rows may be a view of every position's
            # logits
            outs.append(system.prefill(params, prompt(len(outs))).clone())
    device.sync(dev)
    window_s = time.perf_counter() - t0
    n = len(outs)
    peaks = counts.PEAKS.get(device.name(dev))
    a = counts.attention_shape(cfg)
    rec = {"kind": "prefill", "setup_s": setup_s, "window_s": window_s,
           "attempted": n * b, "failed": 0, "units": n * b * s,
           "flops": n * counts.prefill_flops(cfg, b, s),
           "peak_bytes": device.peak_bytes(dev),
           "b8_bound_s": None if peaks is None else counts.b8_bound_s(
               b, a["h"], a["hkv"], s, a["d"], a["dv"], peaks)}

    if ctx.trace:
        def calls_traced():
            for j in range(tf["trace_calls"]):
                with record_function("bench.prefill"):
                    system.prefill(params, prompt(tf["warmup_calls"] + j,
                                                  seeds.WARMUP))
        rec["trace"] = trace.traced(calls_traced)

    rng = np.random.default_rng(seeds.derive(ctx.seed, seeds.SAMPLE))
    picked = sorted(rng.choice(n, size=min(ctx.workload.get("check_calls",
                                                            1), n),
                               replace=False).tolist())
    mine = [outs[j] for j in picked]
    del outs, params, system
    device.free()
    ref = check.prefill_reference(cfg, seed_w, [prompt(j) for j in picked],
                                  dev, common.Numerics())
    rec["numbers"], rec["prompt_errs"] = check.prefill_numbers(
        mine, ref, ctx.workload.get("prompt_limit"))
    return rec
