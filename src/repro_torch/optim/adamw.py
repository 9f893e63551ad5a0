"""AdamW with cosine schedule and global-norm clipping, after
``repro/optim/adamw.py``.

Functions on the nested dict/list trees of tensors that hold parameters
and gradients (:mod:`repro_torch.tree`), in the reference's order of
operations: the fp32 global-norm clip, fp32 moments, bias correction with
``b ** step`` in fp32, decoupled weight decay added to the update before
the learning rate, the result cast back to the parameter's dtype.
``torch.optim.AdamW`` orders these differently, so it is not used.  The
optimizer state is ``{"m": tree, "v": tree, "step": int32 scalar}`` on
the parameters' device; ``adamw_update`` returns new trees and leaves its
inputs untouched, as the reference's pure function does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.telemetry.tracing import annotate
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_frac`` of it at ``total_steps``; fp32 on ``step``'s
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / float(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Any) -> dict:
    """Zero fp32 moments shaped like ``params`` and step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``, the
    metrics as fp32 scalars on the device (nothing is read on the
    host).  The whole update is one profiler span, ``optim/adamw``."""
    with annotate("optim/adamw"):
        step = state["step"] + 1
        g_leaves = tree_leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in g_leaves))
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = cosine_lr(cfg, step)
        step_f = step.to(torch.float32)
        corr1 = 1 - cfg.b1 ** step_f
        corr2 = 1 - cfg.b2 ** step_f

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
            mhat = m_new / corr1
            vhat = v_new / corr2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
            p_new = p.to(torch.float32) - lr * delta
            return p_new.to(p.dtype), m_new, v_new

        out = [upd(*x) for x in zip(tree_leaves(params), g_leaves,
                                    tree_leaves(state["m"]),
                                    tree_leaves(state["v"]))]
        new_state = {"m": tree_unflatten(state["m"], [o[1] for o in out]),
                     "v": tree_unflatten(state["v"], [o[2] for o in out]),
                     "step": step}
        return (tree_unflatten(params, [o[0] for o in out]), new_state,
                {"grad_norm": gnorm, "lr": lr})
