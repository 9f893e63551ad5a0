"""Model configuration — one dataclass covering every assigned architecture
(the port's own copy of ``repro/models/config.py``; ``pdtype``/``cdtype``
are torch dtypes).

Families: dense | moe | hybrid | ssm | encdec | vlm.  All dims are the exact
assignment numbers; ``padded_vocab`` rounds the embedding table up to a
multiple of ``VOCAB_PAD``, as the reference does, so parameters carry over
with their shapes.  The port's model stack runs every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

VOCAB_PAD = 2048      # the reference's embedding-table rounding


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention
    attention: str = "full"      # full | mla | sliding | none
    qkv_bias: bool = False
    sliding_window: int = 0      # for attention == "sliding"
    rope_theta: float = 10_000.0

    # mlp
    mlp: str = "swiglu"          # swiglu | geglu | relu2 | gelu

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek)
    kv_lora_rank: int = 0
    rope_head_dim: int = 64

    # SSM (mamba-style; hymba parallel heads)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # xLSTM
    slstm_at: Sequence[int] = ()
    xlstm_expand: int = 2

    # enc-dec / multimodal frontends (stubs provide precomputed embeddings)
    n_enc_layers: int = 0
    n_frontend_tokens: int = 0   # audio frames / image patches
    frontend: str = "none"       # none | audio | vision

    # numerics / compile scalability
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    # "none": full recompute; "save_boundaries": keep post-norm TP-region
    # inputs (±memory/collective trade — §Perf measured it a net loss when
    # weight gathers dominate; kept as a knob)
    remat_policy: str = "none"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ---------------------------------------------------------------- utils
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch hold a 500k context (long_500k shape)?"""
        return self.family in ("ssm",) or (
            self.family == "hybrid" and self.attention == "sliding")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), unpadded."""
        d, hd, v = self.d_model, self.hd, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            di = self.xlstm_expand * d
            per_layer = 2 * d * di + di * (3 * di) + 2 * d   # rough xLSTM block
        else:
            if self.attention == "mla":
                qk = d * (self.n_heads * (hd + self.rope_head_dim))
                kv = d * self.kv_lora_rank + self.kv_lora_rank * self.n_heads * (hd + hd)
                o = self.n_heads * hd * d
                per_layer += qk + kv + o + d * self.rope_head_dim
            elif self.attention != "none":
                per_layer += d * self.n_heads * hd            # q
                per_layer += 2 * d * self.n_kv_heads * hd     # k, v
                per_layer += self.n_heads * hd * d            # o
            if self.is_moe:
                e_ff = self.expert_d_ff or self.d_ff
                n_in = 2 if self.mlp in ("swiglu", "geglu") else 1
                per_layer += self.n_experts * (n_in + 1) * d * e_ff
                per_layer += self.n_shared_experts * (n_in + 1) * d * e_ff
                per_layer += d * self.n_experts                # router
            elif self.d_ff > 0:
                n_in = 2 if self.mlp in ("swiglu", "geglu") else 1
                per_layer += (n_in + 1) * d * self.d_ff
            if self.family == "hybrid" and self.ssm_state > 0:
                di = self.ssm_expand * d
                per_layer += 2 * d * di + di * d + di * (2 * self.ssm_state + 1)
            per_layer += 2 * d                                 # norms
        total = emb + self.n_layers * per_layer
        if self.n_enc_layers:
            enc_layer = 4 * d * self.n_heads * hd + 3 * d * self.d_ff + 2 * d
            total += self.n_enc_layers * enc_layer
            total += self.n_layers * (2 * d * self.n_kv_heads * hd +
                                      2 * d * self.n_heads * hd)  # cross-attn
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


def shape_config(shape) -> "ShapeConfig":
    """A cell's :class:`ShapeConfig`: ``shape`` itself, or the one of
    :data:`SHAPES` it names."""
    return shape if isinstance(shape, ShapeConfig) else SHAPES[shape]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        expert_d_ff=64 if cfg.expert_d_ff else 0,
        capacity_factor=4.0,     # tiny-T smoke batches: avoid routing drops
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        rope_head_dim=16 if cfg.kv_lora_rank else 64,
        ssm_state=min(cfg.ssm_state, 8),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        slstm_at=tuple(i for i in cfg.slstm_at if i < 2),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frontend_tokens=min(cfg.n_frontend_tokens,
                              8 if cfg.frontend == "vision" else 16),
        param_dtype="float32",
        compute_dtype="float32",
        scan_layers=False,
        remat=False,
    )
