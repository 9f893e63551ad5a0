"""The system under test: the port (``repro_torch``), built from a
configuration file and reached only through its public entry points, the
train step (``models.make_train_step``, composed of ``value_and_grad`` and
``optim.adamw_update``) and the prefill step (``models.make_prefill_step``
-> ``Model.prefill``).  Of the program the drivers read only what these
return (the optimizer's state among it) and the kernel names in the
profiler's timeline.

A driver takes a system object; the readings tool and the tests put the
control (the reference in the program's place) or a broken step there."""
from __future__ import annotations

import torch

from . import spec, weights


def port_kwargs(cfg: dict, remat: bool) -> dict:
    """The ``ModelConfig`` keywords every family takes from a
    configuration file."""
    return dict(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], vocab_size=cfg["vocab_size"],
        mlp={"silu": "swiglu"}[cfg["hidden_act"]],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"], remat=remat)


def model_config(cfg: dict, remat: bool = True):
    """The port's ``ModelConfig`` for a configuration file, built by its
    family (``families/<reference>.py``), which refuses what the port
    cannot run as the file states."""
    return spec.family(cfg).model_config(cfg, port_kwargs(cfg, remat))


def check_layout(model, cfg: dict) -> None:
    """The program takes the tree the benchmark draws: every leaf of its
    own (meta) init at the benchmark's path, shape and dtype."""
    from repro_torch.tree import tree_paths
    mine = {p: (tuple(s), dt) for p, s, dt, _ in weights.layout(cfg)}
    theirs = {tuple(p): (tuple(t.shape), t.dtype)
              for p, t in tree_paths(model.init_shapes())}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()), key=str)[:6]
        raise RuntimeError(f"the program's parameters differ from the "
                           f"benchmark's layout: {diff}")


class TrainSystem:
    """The port's train step: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``split_step`` is the same step composed by
    hand, the gradient and the update timed apart by CUDA events."""

    def __init__(self, cfg: dict, traffic: dict, device):
        from repro_torch.models import (Model, make_loss_fn, make_train_step,
                                        value_and_grad)
        from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
        self.model = Model(model_config(cfg, traffic["remat"]), device)
        check_layout(self.model, cfg)
        self.opt_cfg = AdamWConfig(**traffic["adamw"])
        self._step = make_train_step(self.model, self.opt_cfg,
                                     traffic["accum_steps"])
        self._grad = value_and_grad(make_loss_fn(self.model))
        self._update = adamw_update
        self.init_opt = adamw_init

    def step(self, params, opt_state, batch):
        return self._step(params, opt_state, batch)

    def split_step(self, params, opt_state, batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        _, grads = self._grad(params, batch)
        ev[1].record()
        params, opt_state, _ = self._update(self.opt_cfg, params, grads,
                                            opt_state)
        ev[2].record()
        return params, opt_state, ev


class PrefillSystem:
    """The port's prefill step: ``prefill(params, tokens) -> (B, V)``
    last-position logits."""

    def __init__(self, cfg: dict, device):
        from repro_torch.models import Model, make_prefill_step
        self.model = Model(model_config(cfg, remat=False), device)
        check_layout(self.model, cfg)
        self._prefill = make_prefill_step(self.model)

    def prefill(self, params, tokens):
        return self._prefill(params, {"tokens": tokens})

