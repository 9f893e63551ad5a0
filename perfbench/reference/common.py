"""The plain reference: the configurations' mathematics in plain PyTorch,
fp32 throughout (TF32 off), with no kernel, cache or batching of the
program.  It imports nothing of the program.  It reads the weights the
benchmark drew, through ``W(path)`` (an fp32 tensor), and works out
everything else itself.

``Numerics("fp8")`` is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale (amax / 448), accumulated in fp32,
the nearest precision below the bf16 that the configurations state.  In
a gradient the rounding passes the gradient straight through.

The model: token embedding, the decoder blocks of the configuration's
family (``llama.py``, ``deepseek_v2.py``), a final RMSNorm and the
unembedding; logits over the padded vocabulary.
"""
from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
_SCORE_BYTES = 1 << 30      # the largest score tile a chunk of queries makes


class Numerics:
    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32)
        return x + (xq * scale - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def fp32_products():
    """Plain fp32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def plain_rope(cfg: dict) -> None:
    """Refuse a ``rope_scaling`` that changes the rotary embedding.  The
    reference rotates at ``rope_theta`` alone, which is right for no
    scaling and for YaRN at ``factor`` <= 1: there DeepSeek-V2's
    ``yarn_get_mscale`` is 1 (the softmax scale and the cos/sin tables
    unscaled) and the interpolated frequencies equal the extrapolated."""
    rs = cfg.get("rope_scaling")
    if rs is not None and not (rs.get("type") == "yarn"
                               and rs.get("factor", 1) <= 1):
        raise ValueError(f"rope_scaling {rs!r} changes the rotary "
                         "embedding, which this reference does not model")


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B,S,H,D) at positions 0..S-1, the two halves
    of the head dim rotated as pairs (i, i + D/2)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    c = torch.cos(ang).float()[None, :, None, :]
    sn = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def causal_attention(q, k, v, scale: float, num: Numerics):
    """q (B,S,H,D), k (B,S,Hkv,D), v (B,S,Hkv,Dv) -> (B,S,H,Dv): query
    head h reads kv head h // (H/Hkv); query i sees keys j <= i.  Queries
    go in chunks, each over the keys up to its last row."""
    b, s, h, _ = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B,H,S,·)
    rows = max(1, min(s, _SCORE_BYTES // (4 * b * h * s)))
    outs = []
    for lo in range(0, s, rows):
        hi = min(s, lo + rows)
        sc = num.mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2)) * scale
        qi = torch.arange(lo, hi, device=q.device)[:, None]
        kj = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        outs.append(num.mm(torch.softmax(sc, dim=-1), v[:, :, :hi]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(x, wi, wg, wo, num: Numerics):
    return num.mm(F.silu(num.mm(x, wg)) * num.mm(x, wi), wo)


def family(cfg: dict):
    return importlib.import_module(f"reference.{cfg['reference']}")


def hidden(cfg: dict, W, tokens: torch.Tensor, num: Numerics):
    """The final-normed hidden states (B,S,d) of ``tokens`` (B,S)."""
    fam = family(cfg)
    x = W(("emb", "tok"))[tokens]
    for i in range(cfg["num_hidden_layers"]):
        x = fam.block(cfg, W, i, x, num)
    return rmsnorm(x, W(("emb", "norm_f", "scale")), cfg["rms_norm_eps"])


def unembed(cfg: dict, W, h: torch.Tensor, num: Numerics):
    w = (W(("emb", "tok")).T if cfg["tie_word_embeddings"]
         else W(("emb", "unembed")))
    return num.mm(h, w)


def prefill_logits(cfg: dict, W, tokens: torch.Tensor, num: Numerics):
    """Last-position logits (B, V_padded) of a prefill of ``tokens``."""
    return unembed(cfg, W, hidden(cfg, W, tokens, num)[:, -1], num)


def loss_sum(cfg: dict, W, tokens, labels, num: Numerics):
    """The summed next-token cross entropy over the padded vocabulary plus
    the z-loss 1e-4 logz^2, over every position (the batch's labels are
    all valid)."""
    logits = unembed(cfg, W, hidden(cfg, W, tokens, num), num)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold + 1e-4 * logz * logz).sum()


def cosine_lr(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac
