"""The Llama family (SmolLM): grouped-query attention with rotary
embeddings on every head dim and a SwiGLU MLP, as the benchmark lays out
its weights, builds the port's model of it, counts its work and cuts it
to a tiny size for the CPU tests.  The plain reference of the same block
is ``reference/llama.py``."""
from __future__ import annotations

from reference.common import plain_rope

#: the sizes the CPU tests cut a configuration of this family to: wide and
#: deep enough that fp8 products (the control) show
TINY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, num_hidden_layers=4,
            vocab_size=512)
#: whether the fp8 control is refused by a cell's limits at :data:`TINY`
TINY_CONTROL_REFUSED = True


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def block_layout(cfg: dict, i: int, pd) -> list:
    """``(path, shape, dtype, init)`` of block ``i``'s leaves, paths under
    the block, the two norms first."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hkv, hd = cfg["num_key_value_heads"], _head_dim(cfg)
    f = cfg["intermediate_size"]
    return [(("ln1", "scale"), (d,), pd, "ones"),
            (("ln2", "scale"), (d,), pd, "ones"),
            (("attn", "wq"), (d, h, hd), pd, "normal"),
            (("attn", "wk"), (d, hkv, hd), pd, "normal"),
            (("attn", "wv"), (d, hkv, hd), pd, "normal"),
            (("attn", "wo"), (h, hd, d), pd, "normal"),
            (("mlp", "wi"), (d, f), pd, "normal"),
            (("mlp", "wg"), (d, f), pd, "normal"),
            (("mlp", "wo"), (f, d), pd, "normal")]


def model_config(cfg: dict, common: dict):
    """The port's ``ModelConfig``: its dense family.  The port rotates at
    ``rope_theta`` alone, so a scaling that would change that is refused
    rather than run unscaled."""
    from repro_torch.models.config import ModelConfig
    plain_rope(cfg)
    return ModelConfig(family="dense", head_dim=cfg.get("head_dim") or 0,
                       d_ff=cfg["intermediate_size"], **common)


def attention_shape(cfg: dict) -> dict:
    """B8's heads: query heads, kv heads, the Q/K head dim and V's."""
    hd = _head_dim(cfg)
    return {"h": cfg["num_attention_heads"],
            "hkv": cfg["num_key_value_heads"], "d": hd, "dv": hd}


def active_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies through in the decoder stack, embedding
    and unembedding excluded."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, hkv = _head_dim(cfg), cfg["num_key_value_heads"]
    attn = d * h * hd * 2 + d * hkv * hd * 2
    mlp = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + mlp)
