"""The control and the faults: stand-ins for the program that a correct
check has to refuse.  The control is the plain reference in the
program's place, computed in fp8 (``reference.common.Numerics("fp8")``),
the nearest precision below the configurations' bf16.  The faults break
the program's own step underneath an otherwise unchanged run.  Neither is
used by the benchmark's runs: the readings tool (``tools/readings.py``)
reads them on the card, and the tests on the CPU."""
from __future__ import annotations

import torch

from . import check, program, weights
from reference import common


def _tree(paths, values: dict) -> dict:
    tree: dict = {}
    for k in paths:
        weights._put(tree, k, values[k])
    return tree


class ControlTrain:
    """The reference's train step in fp8, with the program's interface:
    the optimizer state ``{"m": tree, "v": tree, "step": int}``."""

    def __init__(self, cfg: dict, traffic: dict, device,
                 precision: str = "fp8"):
        self.cfg, self.opt = cfg, traffic["adamw"]
        self.paths = weights.paths(cfg)
        self.num = common.Numerics(precision)

    def init_opt(self, params):
        z = {k: torch.zeros(weights.get(params, k).shape,
                            device=weights.get(params, k).device)
             for k in self.paths}
        return {"m": _tree(self.paths, z), "v": _tree(self.paths, z),
                "step": 0}

    def step(self, params, opt_state, batch):
        def flat(t):
            return {k: weights.get(t, k) for k in self.paths}
        loss, g = check.ref_grad(self.cfg, flat(params), batch, self.num)
        p, m, v, _ = check.ref_adamw(self.opt, flat(params),
                                     flat(opt_state["m"]),
                                     flat(opt_state["v"]), g,
                                     opt_state["step"] + 1)
        return (_tree(self.paths, p),
                {"m": _tree(self.paths, m), "v": _tree(self.paths, v),
                 "step": opt_state["step"] + 1},
                {"loss": torch.tensor(loss)})

    def split_step(self, params, opt_state, batch):
        raise NotImplementedError("the control is not timed")


class ControlPrefill:
    """The reference's prefill in fp8, with the program's interface."""

    def __init__(self, cfg: dict, device, precision: str = "fp8"):
        self.cfg, self.num = cfg, common.Numerics(precision)

    def prefill(self, params, tokens):
        def W(path):
            return weights.get(params, path).float()
        with torch.no_grad():
            return common.prefill_logits(self.cfg, W, tokens, self.num)


class Unchanged(program.TrainSystem):
    """Fault: a step that returns its state unchanged (its loss computed)."""

    def step(self, params, opt_state, batch):
        _, _, met = super().step(params, opt_state, batch)
        return params, opt_state, met


class HalfBatch(program.TrainSystem):
    """Fault: half of the batch left out, the mean taken over the rest."""

    def step(self, params, opt_state, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return super().step(params, opt_state, half)


class LabelsAltered(program.TrainSystem):
    """Fault: every label altered where the feed produces it (the tokens
    themselves in place of the next ones)."""

    def step(self, params, opt_state, batch):
        return super().step(params, opt_state,
                            {"tokens": batch["tokens"],
                             "labels": batch["tokens"]})


class HalfPrompts(program.PrefillSystem):
    """Fault: half of the batch left out; its rows repeat the others'."""

    def prefill(self, params, tokens):
        half = super().prefill(params, tokens[:max(1, tokens.shape[0] // 2)])
        return half.repeat(2, 1)[:tokens.shape[0]]


class TokenAltered(program.PrefillSystem):
    """Fault: each prompt's last token altered where it is produced."""

    def prefill(self, params, tokens):
        t = tokens.clone()
        t[:, -1] = (t[:, -1] + 1) % self.model.cfg.vocab_size
        return super().prefill(params, t)


class QuarterAltered(program.PrefillSystem):
    """Fault: the last token of a quarter of the prompts altered where it
    is produced; the other rows sound."""

    def prefill(self, params, tokens):
        t = tokens.clone()
        q = tokens.shape[0] // 4
        t[:q, -1] = (t[:q, -1] + 1) % self.model.cfg.vocab_size
        return super().prefill(params, t)


TRAIN_FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch,
                "labels_altered": LabelsAltered}
PREFILL_FAULTS = {"half_batch": HalfPrompts, "token_altered": TokenAltered,
                  "quarter_altered": QuarterAltered}
