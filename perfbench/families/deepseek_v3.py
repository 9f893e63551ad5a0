"""The DeepSeek-V3 family as the configurations here run it (see a
configuration's ``departures``): multi-head latent attention with a query
latent, the KV latent's norm and YaRN; the first ``first_k_dense_replace``
layers dense SwiGLU MLPs, the rest mixtures of experts routed by
``noaux_tc`` (sigmoid scores, a selection bias, group-limited top-k) over
all ``n_routed_experts``, of which a layer holds expert-parallel rank 0's
share (``n_routed_experts / ep_size``), beside a shared expert; as the
benchmark lays out its weights, builds the port's model of it, counts its
work and cuts it to a tiny size for the CPU tests.  The plain reference
of the same block is ``reference/deepseek_v3.py``."""
from __future__ import annotations

import torch

#: the sizes the CPU tests cut a configuration of this family to: 16
#: experts in 4 groups (2 kept), top 4, a layer holding half of them, one
#: dense layer before two MoE layers; YaRN as the file states it
TINY = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
            q_lora_rank=32, n_routed_experts=16, n_group=4, topk_group=2,
            num_experts_per_tok=4, n_shared_experts=1, ep_size=2,
            first_k_dense_replace=1, num_hidden_layers=3, vocab_size=512)
#: whether the fp8 control is refused by a cell's limits at :data:`TINY`:
#: the MoE's routing flips, which set its limit at the full size, hardly
#: happen in three tiny layers
TINY_CONTROL_REFUSED = False


def _held(cfg: dict) -> int:
    return cfg["n_routed_experts"] // cfg["ep_size"]


def block_layout(cfg: dict, i: int, pd) -> list:
    """``(path, shape, dtype, init)`` of block ``i``'s leaves, paths under
    the block, the two norms first.  The router's selection bias
    (``e_score_correction_bias``) is its last row, drawn like the router so
    that it moves selections."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, rh = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, ql, dv = cfg["kv_lora_rank"], cfg["q_lora_rank"], cfg["v_head_dim"]
    out = [(("ln1", "scale"), (d,), pd, "ones"),
           (("ln2", "scale"), (d,), pd, "ones"),
           (("attn", "wq_a"), (d, ql), pd, "normal"),
           (("attn", "q_norm", "scale"), (ql,), pd, "ones"),
           (("attn", "wq_b"), (ql, h, hd + rh), pd, "normal"),
           (("attn", "wdkv"), (d, r), pd, "normal"),
           (("attn", "kv_norm", "scale"), (r,), pd, "ones"),
           (("attn", "wuk"), (r, h, hd), pd, "normal"),
           (("attn", "wuv"), (r, h, dv), pd, "normal"),
           (("attn", "wkr"), (d, rh), pd, "normal"),
           (("attn", "wo"), (h, dv, d), pd, "normal")]
    if i < cfg["first_k_dense_replace"]:
        f = cfg["intermediate_size"]
        return out + [(("mlp", "wi"), (d, f), pd, "normal"),
                      (("mlp", "wg"), (d, f), pd, "normal"),
                      (("mlp", "wo"), (f, d), pd, "normal")]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs, el = f * cfg["n_shared_experts"], _held(cfg)
    # the router and its bias are held in fp32, whatever the model's dtype
    return out + [(("moe", "router"), (d + 1, e), torch.float32, "normal"),
                  (("moe", "wi"), (el, d, f), pd, "normal"),
                  (("moe", "wg"), (el, d, f), pd, "normal"),
                  (("moe", "wo"), (el, f, d), pd, "normal"),
                  (("moe", "shared", "wi"), (d, fs), pd, "normal"),
                  (("moe", "shared", "wg"), (d, fs), pd, "normal"),
                  (("moe", "shared", "wo"), (fs, d), pd, "normal")]


def model_config(cfg: dict, common: dict):
    """The port's ``ModelConfig``: its MoE family with MLA, the query
    latent, the latent's norm, YaRN, the ``sigmoid_group`` router, the
    expert share and the leading dense layers.  What the port would run
    otherwise than the file states is refused."""
    from repro_torch.models.config import ModelConfig, YaRN
    rs = cfg["rope_scaling"]
    if rs is not None and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs!r}: the port scales by YaRN "
                         "only")
    if cfg["v_head_dim"] != cfg["qk_nope_head_dim"]:
        raise ValueError("the port's MLA takes V at the nope head dim")
    if (cfg["scoring_func"], cfg["topk_method"]) != ("sigmoid", "noaux_tc") \
            or not cfg["norm_topk_prob"]:
        raise ValueError("the port routes this family by noaux_tc with "
                         "normalised sigmoid weights only")
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    if (e % cfg["ep_size"] or e % cfg["n_group"] or cfg["moe_layer_freq"] != 1
            or cfg["topk_group"] * e // cfg["n_group"] < k):
        raise ValueError("experts must split evenly into the groups and the "
                         "shares, every layer past the dense ones be MoE, "
                         "and the kept groups hold k experts")
    if cfg.get("num_nextn_predict_layers"):
        raise ValueError("the port runs no multi-token prediction layer")
    f = cfg["moe_intermediate_size"]
    return ModelConfig(
        family="moe", attention="mla", head_dim=cfg["qk_nope_head_dim"],
        rope_head_dim=cfg["qk_rope_head_dim"],
        kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=cfg["q_lora_rank"],
        kv_latent_norm=True,
        rope_scaling=None if rs is None else YaRN(
            factor=float(rs["factor"]),
            original_max_position=rs["original_max_position_embeddings"],
            beta_fast=float(rs["beta_fast"]),
            beta_slow=float(rs["beta_slow"]), mscale=float(rs["mscale"]),
            mscale_all_dim=float(rs["mscale_all_dim"])),
        d_ff=cfg["intermediate_size"], expert_d_ff=f, n_experts=e,
        n_shared_experts=cfg["n_shared_experts"], top_k=k,
        capacity_factor=cfg["capacity_factor"], router="sigmoid_group",
        n_group=cfg["n_group"], topk_group=cfg["topk_group"],
        routed_scale=float(cfg["routed_scaling_factor"]),
        ep_size=cfg["ep_size"],
        first_dense_layers=cfg["first_k_dense_replace"], **common)


def attention_shape(cfg: dict) -> dict:
    """B8's heads: every query head its own kv head, Q/K at the nope and
    rotary dims together, V at its own."""
    h = cfg["num_attention_heads"]
    return {"h": h, "hkv": h,
            "d": cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"]}


def active_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies through in the decoder stack on this
    chip, embedding and unembedding excluded: MLA with the query latent in
    every layer; the dense MLP in the leading layers; in each MoE layer
    the shared expert, the router and the routed experts at the share's
    expected k x (experts held) / E experts a token (8 x 8 / 256 = 0.25 in
    the published deployment at EP32).  The rows a held expert's buffer
    is padded with are not work."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, rh = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, ql, dv = cfg["kv_lora_rank"], cfg["q_lora_rank"], cfg["v_head_dim"]
    attn = (d * ql + ql * h * (hd + rh) + d * r + r * h * hd + r * h * dv
            + d * rh + h * dv * d)
    n_layers, n_dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    routed = 3 * d * f * cfg["num_experts_per_tok"] * _held(cfg) // e
    moe = 3 * d * f * cfg["n_shared_experts"] + d * e + routed
    return (n_layers * attn + n_dense * 3 * d * cfg["intermediate_size"]
            + (n_layers - n_dense) * moe)
