"""Training and serving step factories, after ``repro/models/steps.py``:
the loss, the train step (with gradient accumulation), the prefill step
and the greedy decode step.  Each is a function of (params, state, batch)
on the nested trees of tensors (:mod:`repro_torch.tree`), as the
reference's are of pytrees; the train step returns new trees."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import costing
from repro_torch.distributed import spmd
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .model import Model


def make_loss_fn(model: Model) -> Callable:
    """``loss_fn(params, batch)``: the next-token cross entropy of
    ``batch["labels"]`` (B,S; positions with a negative label are masked)
    in fp32 over the padded vocabulary, plus a z-loss of 1e-4 · logz²,
    summed and divided by the number of unmasked positions (at least
    1)."""
    def loss_fn(params, batch):
        logits = model.forward(params, batch)           # (B,S,V)
        labels = torch.as_tensor(batch["labels"], device=model.device)
        logits = logits.to(torch.float32)
        logz = spmd.logsumexp(logits)
        # a masked label may be negative: gather any row there, it is
        # multiplied by 0
        gold = spmd.take_last(logits, labels.clamp_min(0).long()
                              .unsqueeze(-1))               # (B,S,1)
        mask = (labels >= 0).to(torch.float32)
        nll = (logz.unsqueeze(-1) - gold).squeeze(-1) * mask
        # small z-loss stabilizes big-vocab training
        zloss = 1e-4 * torch.square(logz) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        return (nll.sum() + zloss.sum()) / denom

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``value_and_grad`` of a ``loss_fn(params, batch)``, as the reference
    takes it: returns ``(loss, grads)``, the gradients a tree shaped like
    ``params`` in each parameter's dtype, from ``torch.autograd.grad``
    over detached copies of the leaves (the caller's tensors are not
    marked).  A leaf the loss does not reach (an xLSTM layer's unselected
    cell) gets zeros, as the reference's 0/1 blend of both cells gives
    it."""
    def run(params, batch):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    return run


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    accum_steps: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with optional gradient accumulation: the batch is split
    into ``accum_steps`` microbatches along its first axis, run one after
    another, their gradients summed in fp32, then loss and gradients
    divided by ``accum_steps``, so peak activation memory scales with the
    microbatch (the loop is :func:`repro_torch.costing.scan`'s).
    ``metrics``: ``loss``, ``grad_norm``, ``lr`` (fp32 device
    scalars)."""
    grad_fn = value_and_grad(make_loss_fn(model))

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if accum_steps <= 1:
            loss, grads = grad_fn(params, batch)
        else:
            micro = {k: costing.split(v, accum_steps)
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)

            def step(i, acc):
                l_i, g_i = grad_fn(params, {k: v[i] for k, v in
                                            micro.items()})
                return (acc[0] + l_i, tree_map(
                    lambda a, b: a + b.to(torch.float32), acc[1], g_i)), None
            (loss, grads), _ = costing.scan(accum_steps, step, (loss, grads))
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, batch)
        next_tok = logits.argmax(dim=-1)     # first maximum, as jnp.argmax
        return next_tok, logits, cache

    return decode_step
