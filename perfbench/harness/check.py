"""What decides ``correct``: the program's outputs against the plain
reference's (``reference/``), on the weights and inputs the benchmark drew
and draws again here, after the program's state is freed.  Each number is
held to a limit of its own from the cell's ``workloads/<cell>.json``; how
each limit was set is in ``PERF.md``.

Training: the checked steps' losses, the gradient of step 1 as the
optimizer got it (worked out from its first moment), each leaf's change
over the checked steps and the optimizer's two moments after them; a
norm's gap is taken by the worst leaf, against the reference's norm of
that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient lies under a thousandth of the median leaf's are left
out of the change (round-off alone moves them under Adam).  Prefill:
each checked prompt's last-position logits, as a relative L2 error (the
largest, the median, and the share of prompts over a per-prompt limit),
and the gap by which the logit of the program's greedy token lies under
the reference's best."""
from __future__ import annotations

import math
import statistics
import sys

import torch

from . import weights
from reference import common

EXCLUDE_BELOW = 1e-3


def _gap(prog: list[float], ref: list[float], keep=None) -> float:
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def ref_grad(cfg: dict, p: dict, batch: dict, num: common.Numerics):
    """The reference's mean loss and gradients ({path: fp32}) of a batch at
    parameters ``p`` ({path: tensor}), in blocks of rows."""
    leaves = {k: t.detach().float().clone().requires_grad_()
              for k, t in p.items()}
    tok, lab = batch["tokens"], batch["labels"]
    rows = max(1, 4096 // tok.shape[1])
    total = 0.0
    for lo in range(0, tok.shape[0], rows):
        part = common.loss_sum(cfg, leaves.__getitem__, tok[lo:lo + rows],
                               lab[lo:lo + rows], num) / tok.numel()
        part.backward()
        total += float(part.detach())
    return total, {k: leaves[k].grad for k in p}


def ref_adamw(opt: dict, p: dict, m: dict, v: dict, g: dict, step: int):
    """One AdamW step in the port's order of operations (global-norm clip,
    fp32 moments, bias correction, decoupled decay, the result stored in
    the parameter's dtype): new (p, m, v) and the clip's scale."""
    gnorm = math.sqrt(sum(float((x * x).sum()) for x in g.values()))
    scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
    lr = common.cosine_lr(opt, step)
    c1, c2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
    p2, m2, v2 = {}, {}, {}
    for k in p:
        gs = g[k].float() * scale
        m2[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * gs
        v2[k] = opt["b2"] * v[k] + (1 - opt["b2"]) * gs * gs
        delta = (m2[k] / c1) / (torch.sqrt(v2[k] / c2) + opt["eps"])
        pf = p[k].float()
        p2[k] = (pf - lr * (delta + opt["weight_decay"] * pf)).to(p[k].dtype)
    return p2, m2, v2, scale


def train_reference(cfg: dict, traffic: dict, seed_w: int, batches,
                    device, num: common.Numerics) -> dict:
    """The reference's first ``len(batches)`` steps from the weights of
    ``seed_w``: losses, step 1's gradient norms a leaf (``grad``: as the
    optimizer gets them, clipped; ``grad_raw``: before the clip), each
    leaf's change over the steps and the norms of its two moments after
    them, the parameters held in the configuration's dtype between steps
    as the configuration states."""
    common.fp32_products()
    paths = weights.paths(cfg)
    tree = weights.draw(cfg, seed_w, device)
    p0 = {k: weights.get(tree, k) for k in paths}
    p = dict(p0)
    m = {k: torch.zeros(t.shape, device=t.device) for k, t in p.items()}
    v = dict(m)
    out: dict = {"loss": []}
    for step, batch in enumerate(batches, start=1):
        loss, g = ref_grad(cfg, p, batch, num)
        p, m, v, scale = ref_adamw(traffic["adamw"], p, m, v, g, step)
        if step == 1:
            out["grad_raw"] = [float(g[k].norm()) for k in paths]
            out["grad"] = [x * scale for x in out["grad_raw"]]
        out["loss"].append(loss)
        del g
    out["change"] = [float((p[k].float() - p0[k].float()).norm())
                     for k in paths]
    out["m"] = [float(m[k].norm()) for k in paths]
    out["v"] = [float(v[k].norm()) for k in paths]
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad_raw"])
    keep = [x >= EXCLUDE_BELOW * med for x in ref["grad_raw"]]
    gaps = [abs(a - b) for a, b in zip(prog["loss"], ref["loss"])]
    return {
        "loss_gap": max(gaps), "loss_gap_step1": gaps[0],
        "grad_gap": _gap(prog["grad"], ref["grad"]),
        "change_gap": _gap(prog["change"], ref["change"], keep),
        "change_leaves_left_out": float(keep.count(False)),
        "m_gap": _gap(prog["m"], ref["m"]),
        "v_gap": _gap(prog["v"], ref["v"])}


def prefill_reference(cfg: dict, seed_w: int, prompts: list, device,
                      num: common.Numerics) -> list[torch.Tensor]:
    """The reference's last-position logits (fp32) of each (B, S) prompt
    tensor, on the weights of ``seed_w``."""
    common.fp32_products()
    tree = weights.draw(cfg, seed_w, device)

    def W(path):
        return weights.get(tree, path).float()
    with torch.no_grad():
        return [common.prefill_logits(cfg, W, t, num) for t in prompts]


def prefill_numbers(prog: list[torch.Tensor], ref: list[torch.Tensor],
                    prompt_limit: float | None = None
                    ) -> tuple[dict, list[float]]:
    """Over the checked prompts: ``logit_err``, the largest relative L2
    error of a prompt's last-position logits; ``logit_err_median``, the
    median one; with ``prompt_limit``, ``prompt_share_over``, the share of
    prompts whose error lies above it; ``top1_gap``, the widest gap by
    which the logit of the program's greedy token lies under the
    reference's best.  Also each prompt's error."""
    errs, gaps = [], []
    for y, r in zip(prog, ref):
        y, r = y.float(), r.float()
        errs += (torch.linalg.vector_norm(y - r, dim=-1)
                 / torch.linalg.vector_norm(r, dim=-1)).tolist()
        best = r.max(dim=-1).values
        mine = r.gather(-1, y.argmax(dim=-1, keepdim=True))[:, 0]
        gaps.append((best - mine).max().item())
    out = {"logit_err": max(errs),
           "logit_err_median": statistics.median(errs)}
    if prompt_limit is not None:
        out["prompt_share_over"] = (sum(e > prompt_limit for e in errs)
                                    / len(errs))
    out["top1_gap"] = max(gaps)
    return out, errs


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` (every limited number finite and at or under its limit;
    a number with no limit is printed and not compared) and the numbers
    beside their limits, as the result line carries them."""
    shown, ok = {}, bool(limits)
    for name, value in numbers.items():
        limit = limits.get(name)
        shown[name] = {"value": value, "limit": limit}
        if limit is not None and not (math.isfinite(value)
                                      and value <= limit):
            ok = False
    if any(name not in numbers for name in limits):
        ok = False
    return ok, shown


def print_check(shown: dict, correct: bool) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, x in shown.items():
        lim = "not compared" if x["limit"] is None else f"limit {x['limit']}"
        print(f"check {name} {x['value']!r} {lim}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr, flush=True)
