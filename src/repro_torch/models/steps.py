"""Serving step factories, after ``repro/models/steps.py``: the prefill
step and the greedy decode step.  The loss and train step wait for
training (``ROADMAP.md`` queue A item 12)."""
from __future__ import annotations

from typing import Callable

from .model import Model


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
