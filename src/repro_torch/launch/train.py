"""Training driver with checkpoint/restart and deterministic resume, after
``repro/launch/train.py``: the same flags and printed lines, plus
``--device`` (the card by default; ``cpu`` runs on the host).

  - checkpoint every ``--ckpt-every`` steps (atomic; ``distributed/
    checkpoint.py``);
  - on start, restore the newest committed step and resume the data cursor
    (the same batch stream, bit for bit);
  - per-step heartbeats and straggler detection
    (``distributed/fault_tolerance.py``), one host here.

The model's attention runs on B8 in the forward pass (and again in each
block's recompute, ``cfg.remat``); its gradient is the plain attention's,
recomputed (``kernels/flash_attention.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --batch 8 --seq 256 --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector)
from repro_torch.models import build_model, make_train_step, smoke_variant
from repro_torch.optim import AdamWConfig, adamw_init


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100,
                    help="total schedule length")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="halt early (schedule still spans --steps)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What a run did: its losses (one a step from ``start``), the wall
    seconds of each step (the host waits for the loss), of each checkpoint
    save and of the restore (None when it started fresh), and the final
    parameters and optimizer state."""
    losses: list
    step_s: list
    save_s: list
    restore_s: float | None
    start: int
    params: dict
    opt_state: dict


def run(args: argparse.Namespace) -> TrainRun:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = build_model(cfg, args.device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum)

    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))

    params = model.init(torch.Generator(model.device).manual_seed(0))
    opt_state = adamw_init(params)
    start, restore_s = 0, None
    if args.ckpt_dir:
        t0 = time.perf_counter()
        state, extra = restore_checkpoint(args.ckpt_dir,
                                          {"params": params, "opt": opt_state})
        if state is not None:
            params, opt_state = state["params"], state["opt"]
            start = int(extra["cursor"])
            restore_s = time.perf_counter() - t0
            print(f"[train] restored step {start} from {args.ckpt_dir}")

    hb = HeartbeatMonitor(n_hosts=1)
    straggler = StragglerDetector(n_hosts=1)
    losses, step_s, save_s = [], [], []
    t0 = time.perf_counter()
    for step in range(start, args.stop_at or args.steps):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in data.batch_at(step).items()}
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        step_s.append(time.perf_counter() - ts)
        hb.beat(0, step)
        flagged = straggler.observe([step_s[-1]])
        if flagged:
            print(f"[train] straggler flagged: hosts {flagged}")
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"[train] step {step+1} loss {loss:.4f} "
                  f"({dt/args.log_every*1000:.0f} ms/step)", flush=True)
            t0 = time.perf_counter()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            tc = time.perf_counter()
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            extra={"cursor": step + 1})
            save_s.append(time.perf_counter() - tc)
    if len(losses) >= 20:
        first = float(np.mean(losses[:10]))
        last = float(np.mean(losses[-10:]))
        print(f"[train] loss first10 {first:.4f} -> last10 {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return TrainRun(losses, step_s, save_s, restore_s, start, params,
                    opt_state)


def main(argv=None):
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    main()
