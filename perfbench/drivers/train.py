"""Training traffic: a closed loop of train steps on batches of ``batch``
sequences of ``seq`` tokens from the frozen token corpus, every step's
rows new.

Set-up draws the weights, builds the step and drives it through the
first ``checked_steps`` steps (past the learning rate's warm-up),
reading their losses, step 1's gradient (from the optimizer's first
moment), each leaf's change and the optimizer's moments after them;
those steps also warm up every shape.  The window's batches are drawn and copied to
the card in set-up, as a data loader running ahead would have them.  The
same step object and state then run the window.  With ``--trace 1``, after the window: ``split_steps`` steps
composed by hand and timed by CUDA events (gradient; update), then
``trace_steps`` steps under the profiler.  The reference then follows the
checked steps from the same weights and batches, drawn again."""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from harness import check, counts, device, program, seeds, trace, weights
from harness.traffic import TokenCorpus
from reference import common


def run(ctx) -> dict:
    cfg, tf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    system = ctx.system or program.TrainSystem(cfg, tf, dev)
    seed_w = seeds.derive(ctx.seed, seeds.WEIGHTS)
    corpus = TokenCorpus(cfg["vocab_size"], tf["seq"], tf["batch"],
                         seeds.derive(ctx.seed, seeds.DATA), tf["corpus"])
    paths = weights.paths(cfg)
    b1 = tf["adamw"]["b1"]

    params0 = weights.draw(cfg, seed_w, dev)
    params, opt = params0, system.init_opt(params0)
    losses = []
    for i in range(tf["checked_steps"]):
        if i == 1:
            device.sync(dev)
            t1 = time.perf_counter()
        with record_function("bench.train_step"):
            params, opt, met = system.step(params, opt,
                                           corpus.on_device(i, dev))
        losses.append(met["loss"])
        if i == 0:
            grad = torch.stack([weights.get(opt["m"], k).float().norm()
                                for k in paths]) / (1 - b1)
    device.sync(dev)
    step_s = (time.perf_counter() - t1) / (tf["checked_steps"] - 1)
    change = torch.stack([(weights.get(params, k).float()
                           - weights.get(params0, k).float()).norm()
                          for k in paths])
    moments = {n: torch.stack([weights.get(opt[n], k).float().norm()
                               for k in paths]).tolist() for n in ("m", "v")}
    prog = {"loss": [float(x) for x in losses], "grad": grad.tolist(),
            "change": change.tolist(), **moments}
    del params0, met, grad, change
    # the batches of the window and the traced steps, drawn and on the card
    # before the window, as a loader that runs ahead hands them: enough for
    # twice the window at the checked steps' pace
    first = tf["checked_steps"]
    extra = tf["split_steps"] + tf["trace_steps"] if ctx.trace else 0
    ready = [corpus.on_device(first + k, dev)
             for k in range(int(2 * ctx.seconds / step_s) + 2 + extra)]

    def batch(k: int) -> dict:
        return (ready[k - first] if k - first < len(ready)
                else corpus.on_device(k, dev))
    device.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    i = tf["checked_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        with record_function("bench.train_step"):
            params, opt, _ = system.step(params, opt, batch(i))
        i += 1
    device.sync(dev)
    window_s = time.perf_counter() - t0
    steps = i - tf["checked_steps"]
    rec = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
           "attempted": steps, "failed": 0,
           "units": steps * tf["batch"] * tf["seq"],
           "flops": steps * counts.train_flops(cfg, tf["batch"], tf["seq"]),
           "peak_bytes": device.peak_bytes(dev)}

    if ctx.trace and dev.type == "cuda":
        evs = []
        for _ in range(tf["split_steps"]):
            params, opt, ev = system.split_step(params, opt, batch(i))
            evs.append(ev)
            i += 1
        device.sync(dev)
        rec["grad_ms"] = [e[0].elapsed_time(e[1]) for e in evs]
        rec["optimizer_ms"] = [e[1].elapsed_time(e[2]) for e in evs]

    if ctx.trace:
        def steps_traced():
            nonlocal params, opt, i
            for _ in range(tf["trace_steps"]):
                with record_function("bench.train_step"):
                    params, opt, _ = system.step(params, opt, batch(i))
                i += 1
        rec["trace"] = trace.traced(steps_traced)

    del params, opt, system, ready
    device.free()
    batches = [corpus.on_device(k, dev) for k in range(tf["checked_steps"])]
    ref = check.train_reference(cfg, tf, seed_w, batches, dev,
                                common.Numerics())
    rec["numbers"] = check.train_numbers(prog, ref)
    return rec
