"""The DeepSeek-V2 family as the configurations here run it (see a
configuration's ``departures``): multi-head latent attention without a
query latent, and every layer a mixture of experts with shared experts
beside the routed ones and an fp32 router; as the benchmark lays out its
weights, builds the port's model of it, counts its work and cuts it to a
tiny size for the CPU tests.  The plain reference of the same block is
``reference/deepseek_v2.py``."""
from __future__ import annotations

import torch

from reference.common import plain_rope

#: the sizes the CPU tests cut a configuration of this family to
TINY = dict(hidden_size=64, moe_intermediate_size=32, num_attention_heads=4,
            num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1, num_hidden_layers=2,
            vocab_size=512)
#: whether the fp8 control is refused by a cell's limits at :data:`TINY`:
#: the MoE's routing flips, which set its limit at the full size, hardly
#: happen in two tiny layers
TINY_CONTROL_REFUSED = False


def block_layout(cfg: dict, i: int, pd) -> list:
    """``(path, shape, dtype, init)`` of block ``i``'s leaves, paths under
    the block, the two norms first."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, rh = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, e = cfg["kv_lora_rank"], cfg["n_routed_experts"]
    f = cfg["moe_intermediate_size"]
    fs = f * cfg["n_shared_experts"]
    return [(("ln1", "scale"), (d,), pd, "ones"),
            (("ln2", "scale"), (d,), pd, "ones"),
            (("attn", "wq"), (d, h, hd + rh), pd, "normal"),
            (("attn", "wdkv"), (d, r), pd, "normal"),
            (("attn", "wuk"), (r, h, hd), pd, "normal"),
            (("attn", "wuv"), (r, h, cfg["v_head_dim"]), pd, "normal"),
            (("attn", "wkr"), (d, rh), pd, "normal"),
            (("attn", "wo"), (h, cfg["v_head_dim"], d), pd, "normal"),
            # the router is held in fp32, whatever the model's dtype
            (("moe", "router"), (d, e), torch.float32, "normal"),
            (("moe", "wi"), (e, d, f), pd, "normal"),
            (("moe", "wg"), (e, d, f), pd, "normal"),
            (("moe", "wo"), (e, f, d), pd, "normal"),
            (("moe", "shared", "wi"), (d, fs), pd, "normal"),
            (("moe", "shared", "wg"), (d, fs), pd, "normal"),
            (("moe", "shared", "wo"), (fs, d), pd, "normal")]


def model_config(cfg: dict, common: dict):
    """The port's ``ModelConfig``: its MoE family with MLA.  The port's MLA
    takes V at the nope head dim and no query latent, and rotates at
    ``rope_theta`` alone, so a scaling that would change that is refused
    rather than run unscaled."""
    from repro_torch.models.config import ModelConfig
    plain_rope(cfg)
    if cfg["v_head_dim"] != cfg["qk_nope_head_dim"] or cfg["q_lora_rank"]:
        raise ValueError("the port's MLA takes V at the nope head dim "
                         "and no query latent")
    f = cfg["moe_intermediate_size"]
    return ModelConfig(
        family="moe", attention="mla", head_dim=cfg["qk_nope_head_dim"],
        rope_head_dim=cfg["qk_rope_head_dim"],
        kv_lora_rank=cfg["kv_lora_rank"], d_ff=f, expert_d_ff=f,
        n_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"],
        top_k=cfg["num_experts_per_tok"],
        capacity_factor=cfg["capacity_factor"], **common)


def attention_shape(cfg: dict) -> dict:
    """B8's heads: every query head its own kv head, Q/K at the nope and
    rotary dims together, V at its own."""
    h = cfg["num_attention_heads"]
    return {"h": h, "hkv": h,
            "d": cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"]}


def active_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies through in the decoder stack: MLA, the
    top-k routed experts, the shared ones and the router; embedding and
    unembedding excluded."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, rh = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    attn = (d * h * (hd + rh) + d * r + r * h * hd + r * h * dv + d * rh
            + h * dv * d)
    f = cfg["moe_intermediate_size"]
    moe = (3 * d * f * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
           + d * cfg["n_routed_experts"])
    return cfg["num_hidden_layers"] * (attn + moe)
