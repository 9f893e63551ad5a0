"""A DeepSeek-V3 decoder block as configured here (see the configuration's
``departures``), written from the published description.

Multi-head latent attention: queries through the ``q_lora_rank`` latent
(``wq_a``), its RMSNorm and ``wq_b``, at qk_nope + qk_rope; the KV latent
``a wdkv`` RMS-normed (``kv_a_layernorm``) before the keys and values are
decompressed from it; one rotary key shared by the heads; the rotary
embedding with YaRN's frequencies (:func:`yarn_rope`), and the softmax
scale (1 + 0.1 mscale_all_dim ln factor)^2 / sqrt(qk_nope + qk_rope).  The
rotary pairs are (i, i + D/2), as ``common.rope`` rotates them.

The second half: a dense SwiGLU MLP of ``intermediate_size`` in the first
``first_k_dense_replace`` layers; in the others a mixture of experts
routed as ``noaux_tc`` does over all ``n_routed_experts``: sigmoid scores
in fp32, ``e_score_correction_bias`` (the router leaf's last row) added
for the choice alone, each of ``n_group`` groups scored by the sum of its
two best biased scores, the ``topk_group`` best groups kept (the rest
masked to -inf), the top ``num_experts_per_tok`` of what is left (ties to
the lower expert and group), their unbiased scores normalised to sum 1
and times ``routed_scaling_factor``.  A layer holds the ``n_routed_experts /
ep_size`` experts of expert-parallel rank 0 and adds only their part of
the routed sum; each keeps the first ceil(T k capacity_factor / E) of its
(token, expert) pairs in token-major order.  The shared expert, a SwiGLU
of ``n_shared_experts`` x ``moe_intermediate_size``, is added whole."""
from __future__ import annotations

import math

import torch

from .common import causal_attention, rmsnorm, swiglu


def yarn_m(factor: float, mscale: float) -> float:
    """``yarn_get_mscale``: 1 + 0.1 mscale ln(factor), 1 at factor <= 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: dict, dim: int) -> torch.Tensor:
    """(dim/2,) float64 rotary frequencies: theta^(-2i/dim) for the pairs
    that turn more than ``beta_fast`` times over the original context,
    those over ``factor`` for the pairs that turn fewer than ``beta_slow``
    times, a linear ramp between (the pair index where a frequency makes
    ``b`` turns: dim ln(L / (2 pi b)) / (2 ln theta), floored and
    ceiled)."""
    rs, theta = cfg["rope_scaling"], cfg["rope_theta"]
    base = theta ** -(torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    if rs is None:
        return base

    def pair(turns):
        return dim * math.log(rs["original_max_position_embeddings"] / (
            turns * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(pair(rs["beta_fast"])), 0)
    hi = min(math.ceil(pair(rs["beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    ramp = ((i - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    return base * (1 - ramp) + base / rs["factor"] * ramp


def softmax_scale(cfg: dict) -> float:
    d = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    rs = cfg["rope_scaling"]
    m = yarn_m(rs["factor"], rs["mscale_all_dim"]) if rs else 1.0
    return m * m / math.sqrt(d)


def yarn_rope(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,D) rotated at positions 0..S-1 by YaRN's frequencies, the
    cos/sin times m(mscale) / m(mscale_all_dim)."""
    s, d = x.shape[1], x.shape[-1]
    rs = cfg["rope_scaling"]
    ang = (torch.arange(s, dtype=torch.float64)[:, None]
           * yarn_inv_freq(cfg, d)).to(x.device)
    m = (yarn_m(rs["factor"], rs["mscale"])
         / yarn_m(rs["factor"], rs["mscale_all_dim"])) if rs else 1.0
    c = (torch.cos(ang) * m).float()[None, :, None, :]
    sn = (torch.sin(ang) * m).float()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def mla(cfg: dict, w, a, num):
    b, s, d = a.shape
    h, r, ql = (cfg["num_attention_heads"], cfg["kv_lora_rank"],
                cfg["q_lora_rank"])
    hd, rh, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    eps = cfg["rms_norm_eps"]
    q = rmsnorm(num.mm(a, w("attn", "wq_a")), w("attn", "q_norm", "scale"),
                eps)
    q = num.mm(q, w("attn", "wq_b").reshape(ql, h * (hd + rh))).view(
        b, s, h, hd + rh)
    q = torch.cat([q[..., :hd], yarn_rope(cfg, q[..., hd:])], dim=-1)
    c = rmsnorm(num.mm(a, w("attn", "wdkv")), w("attn", "kv_norm", "scale"),
                eps)
    k_rope = yarn_rope(cfg, num.mm(a, w("attn", "wkr"))[:, :, None, :])
    k_nope = num.mm(c, w("attn", "wuk").reshape(r, h * hd)).view(b, s, h, hd)
    v = num.mm(c, w("attn", "wuv").reshape(r, h * dv)).view(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rh)], dim=-1)
    o = causal_attention(q, k, v, softmax_scale(cfg), num)
    return num.mm(o.reshape(b, s, h * dv), w("attn", "wo").reshape(h * dv,
                                                                    d))


def route(cfg: dict, xt, router):
    """``noaux_tc`` over all experts: (weights (T,k), experts (T,k)).
    ``router`` (d + 1, E), fp32: the router, then the bias as its last
    row."""
    (t, d), e = xt.shape, cfg["n_routed_experts"]
    g, k = cfg["n_group"], cfg["num_experts_per_tok"]
    scores = torch.sigmoid(xt @ router[:d])
    choice = (scores + router[d]).view(t, g, e // g)
    group_score = choice.sort(dim=-1, descending=True).values[..., :2].sum(-1)
    kept = group_score.sort(dim=-1, descending=True,
                            stable=True).indices[:, :cfg["topk_group"]]
    in_kept = torch.zeros(t, g, dtype=torch.bool, device=xt.device)
    in_kept[torch.arange(t, device=xt.device)[:, None], kept] = True
    choice = choice.masked_fill(~in_kept[..., None], float("-inf"))
    topi = choice.view(t, e).sort(dim=-1, descending=True,
                                  stable=True).indices[:, :k]
    topv = scores.gather(1, topi)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
    return topv * cfg["routed_scaling_factor"], topi


def moe(cfg: dict, w, a, num, e_lo: int = 0):
    """The MoE of a layer that holds the experts [e_lo, e_lo + E/ep_size):
    their part of the routed sum, plus the shared expert."""
    b, s, d = a.shape
    xt = a.reshape(b * s, d)
    t, e, k = xt.shape[0], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    topv, topi = route(cfg, xt, w("moe", "router"))
    cap = max(1, -(-int(t * k * cfg["capacity_factor"]) // e))
    pair_expert = topi.reshape(-1)
    pair_token = torch.arange(t, device=a.device).repeat_interleave(k)
    pair_weight = topv.reshape(-1)
    wi, wg, wo = w("moe", "wi"), w("moe", "wg"), w("moe", "wo")
    y = torch.zeros_like(xt)
    for j in range(wi.shape[0]):
        kept = (pair_expert == e_lo + j).nonzero()[:cap, 0]
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
    m = rmsnorm(x, w("ln2", "scale"), eps)
    if i < cfg["first_k_dense_replace"]:
        return x + swiglu(m, w("mlp", "wi"), w("mlp", "wg"), w("mlp", "wo"),
                          num)
    return x + moe(cfg, w, m, num)
