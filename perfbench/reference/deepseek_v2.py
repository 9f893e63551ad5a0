"""A DeepSeek-V2 decoder block as configured here (see the configuration's
``departures``): multi-head latent attention without a query latent
(queries at qk_nope + qk_rope, keys and values decompressed from the
kv_lora latent, one rotary key shared by the heads, scale
1/sqrt(qk_nope + qk_rope)); then a mixture of experts: fp32 softmax
routing over the routed experts, the top k by probability (ties to the
lower expert), their weights renormalised, each expert keeping the first
ceil(T k capacity_factor / E) of its (token, expert) pairs in token-major
order and dropping the rest; SwiGLU experts, plus the shared experts as
one SwiGLU of their summed width."""
from __future__ import annotations

import torch

from .common import causal_attention, plain_rope, rmsnorm, rope, swiglu


def mla(cfg: dict, w, a, num):
    b, s, d = a.shape
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    hd, rh, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    plain_rope(cfg)
    th = cfg["rope_theta"]
    q = num.mm(a, w("attn", "wq").reshape(d, h * (hd + rh))).view(
        b, s, h, hd + rh)
    q = torch.cat([q[..., :hd], rope(q[..., hd:], th)], dim=-1)
    c = num.mm(a, w("attn", "wdkv"))
    k_rope = rope(num.mm(a, w("attn", "wkr"))[:, :, None, :], th)
    k_nope = num.mm(c, w("attn", "wuk").reshape(r, h * hd)).view(b, s, h, hd)
    v = num.mm(c, w("attn", "wuv").reshape(r, h * dv)).view(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rh)], dim=-1)
    o = causal_attention(q, k, v, (hd + rh) ** -0.5, num)
    return num.mm(o.reshape(b, s, h * dv), w("attn", "wo").reshape(h * dv,
                                                                    d))


def moe(cfg: dict, w, a, num):
    b, s, d = a.shape
    xt = a.reshape(b * s, d)
    t, e, k = xt.shape[0], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(xt @ w("moe", "router"), dim=-1)   # fp32 router
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    if cfg["norm_topk_prob"]:
        topv = topv / topv.sum(-1, keepdim=True)
    cap = max(1, -(-int(t * k * cfg["capacity_factor"]) // e))
    pair_expert = topi.reshape(-1)
    pair_token = torch.arange(t, device=a.device).repeat_interleave(k)
    pair_weight = topv.reshape(-1)
    wi, wg, wo = w("moe", "wi"), w("moe", "wg"), w("moe", "wo")
    y = torch.zeros_like(xt)
    for j in range(e):
        kept = (pair_expert == j).nonzero()[:cap, 0]
        tok = pair_token[kept]
        out = swiglu(xt[tok], wi[j], wg[j], wo[j], num)
        y.index_add_(0, tok, out * pair_weight[kept, None])
    y = y + swiglu(xt, w("moe", "shared", "wi"), w("moe", "shared", "wg"),
                   w("moe", "shared", "wo"), num)
    return y.view(b, s, d)


def block(cfg: dict, W, i: int, x, num):
    eps = cfg["rms_norm_eps"]

    def w(*k):
        return W(("blocks", i) + k)
    x = x + mla(cfg, w, rmsnorm(x, w("ln1", "scale"), eps), num)
    return x + moe(cfg, w, rmsnorm(x, w("ln2", "scale"), eps), num)
