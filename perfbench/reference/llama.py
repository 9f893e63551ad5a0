"""A Llama decoder block (SmolLM): RMSNorm, grouped-query attention with
rotary embeddings on every head dim, RMSNorm, SwiGLU MLP; both halves
residual."""
from __future__ import annotations

from .common import causal_attention, plain_rope, rmsnorm, rope, swiglu


def block(cfg: dict, W, i: int, x, num):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hkv, eps = cfg["num_key_value_heads"], cfg["rms_norm_eps"]
    hd = cfg.get("head_dim") or d // h
    b, s, _ = x.shape

    def w(*k):
        return W(("blocks", i) + k)
    a = rmsnorm(x, w("ln1", "scale"), eps)
    q = num.mm(a, w("attn", "wq").reshape(d, h * hd)).view(b, s, h, hd)
    k = num.mm(a, w("attn", "wk").reshape(d, hkv * hd)).view(b, s, hkv, hd)
    v = num.mm(a, w("attn", "wv").reshape(d, hkv * hd)).view(b, s, hkv, hd)
    plain_rope(cfg)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = causal_attention(q, k, v, hd ** -0.5, num)
    x = x + num.mm(o.reshape(b, s, h * hd), w("attn", "wo").reshape(h * hd,
                                                                    d))
    m = rmsnorm(x, w("ln2", "scale"), eps)
    return x + swiglu(m, w("mlp", "wi"), w("mlp", "wg"), w("mlp", "wo"), num)
