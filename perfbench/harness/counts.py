"""The work of a step and of a kernel, counted from shapes alone, and the
card's published peaks.  Frozen with the benchmark: a change to the
program cannot change what its time is divided by.

Conventions: a multiply-add is 2 FLOPs; a causal pass scores ``S (S+1) /
2`` (query, key) pairs a head; a kernel's bytes are each input read once
and each output written once.
"""
from __future__ import annotations

from . import weights

#: NVIDIA H100 SXM5 (80 GB HBM3) data sheet: dense bf16 tensor-core rate
#: and HBM bandwidth, at the full 700 W
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "hbm_bytes_s": 3.35e12}}


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_shape(cfg: dict) -> dict:
    """B8's heads for a configuration: query heads, kv heads, the Q/K
    head dim and V's."""
    h = cfg["num_attention_heads"]
    if cfg["model_type"] == "deepseek_v2":
        return {"h": h, "hkv": h,
                "d": cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                "dv": cfg["v_head_dim"]}
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    return {"h": h, "hkv": cfg["num_key_value_heads"], "d": hd, "dv": hd}


def b8_flops(b: int, h: int, s: int, d: int, dv: int) -> float:
    """One causal B8 call: Q K^T and P V over the causal half."""
    return 2.0 * b * h * causal_pairs(s) * (d + dv)


def b8_bytes(b: int, h: int, hkv: int, s: int, d: int, dv: int,
             itemsize: int = 2) -> float:
    """Q, K and V read once, O written once."""
    return float(itemsize * b * s * (h * d + hkv * d + hkv * dv + h * dv))


def b8_bound_s(b: int, h: int, hkv: int, s: int, d: int, dv: int,
               peaks: dict) -> float:
    """The least time one call could take on the card: the larger of its
    FLOPs at the bf16 peak and its bytes at the HBM bandwidth."""
    return max(b8_flops(b, h, s, d, dv) / peaks["bf16_flops"],
               b8_bytes(b, h, hkv, s, d, dv) / peaks["hbm_bytes_s"])


def active_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies through in the decoder stack (MoE: the
    top-k routed experts, the shared ones and the router), embedding and
    unembedding excluded."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["model_type"] == "llama":
        hd = cfg.get("head_dim") or d // h
        hkv = cfg["num_key_value_heads"]
        attn = d * h * hd * 2 + d * hkv * hd * 2
        mlp = 3 * d * cfg["intermediate_size"]
        return cfg["num_hidden_layers"] * (attn + mlp)
    hd, rh = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    attn = (d * h * (hd + rh) + d * r + r * h * hd + r * h * dv + d * rh
            + h * dv * d)
    f = cfg["moe_intermediate_size"]
    moe = (3 * d * f * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
           + d * cfg["n_routed_experts"])
    return cfg["num_hidden_layers"] * (attn + moe)


def attention_flops(cfg: dict, b: int, s: int) -> float:
    """The causal attention products of one forward over (b, s)."""
    a = attention_shape(cfg)
    return cfg["num_hidden_layers"] * b8_flops(b, a["h"], s, a["d"], a["dv"])


def prefill_flops(cfg: dict, b: int, s: int) -> float:
    """One prefill call of (b, s): every position through the stack and
    the unembedding of the last position only (what a prefill returns)."""
    d = cfg["hidden_size"]
    unembed = 2.0 * b * d * weights.padded_vocab(cfg)
    return (2.0 * active_params_per_token(cfg) * b * s
            + attention_flops(cfg, b, s) + unembed)


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies through in a training step: the decoder
    stack's and the unembedding's (a tied table counted once, as the
    unembedding; the embedding lookup multiplies nothing)."""
    return (active_params_per_token(cfg)
            + cfg["hidden_size"] * weights.padded_vocab(cfg))


def train_flops(cfg: dict, b: int, s: int) -> float:
    """One training step of (b, s) tokens: 6 x the weights a token
    multiplies through x tokens, plus the causal attention products three
    times (forward, and twice in the backward); recomputation is not
    counted."""
    return (6.0 * matmul_params_per_token(cfg) * b * s
            + 3.0 * attention_flops(cfg, b, s))
