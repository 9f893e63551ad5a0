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
class YaRN:
    """DeepSeek's YaRN rotary scaling (``rope_scaling`` of type ``yarn``):
    the rotary frequencies blended between ``theta``'s and theirs over
    ``factor``, by a ramp over the pairs whose wavelength lies between
    ``beta_fast`` and ``beta_slow`` turns of ``original_max_position``;
    cos/sin times ``m(mscale) / m(mscale_all_dim)`` and the softmax scale
    times ``m(mscale_all_dim)**2``, where ``m(a) = 1 + 0.1 a ln(factor)``
    (:mod:`repro_torch.models.layers`, ``yarn_*``)."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


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

    # MoE routing: "softmax" (top-k of the softmax, renormalised) or
    # "sigmoid_group" (DeepSeek-V3's noaux_tc: sigmoid scores, a
    # selection-only bias, the best ``topk_group`` of ``n_group`` groups,
    # the chosen scores renormalised times ``routed_scale``)
    router: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    # expert parallelism: a layer holds n_experts // ep_size of the experts
    # it routes over (rank 0's share on one device)
    ep_size: int = 1
    # the first layers of an MoE model that are dense MLPs of d_ff
    first_dense_layers: int = 0

    # MLA (deepseek)
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    q_lora_rank: int = 0         # > 0: queries through a normed latent
    kv_latent_norm: bool = False  # RMSNorm on the KV latent (kv_a_layernorm)
    rope_scaling: Optional[YaRN] = None   # MLA only

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

    def __post_init__(self):
        if self.rope_scaling is not None and self.attention != "mla":
            raise ValueError("YaRN rotary scaling is taken by MLA only")
        if self.router not in ("softmax", "sigmoid_group"):
            raise ValueError(f"unknown router {self.router!r}")

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
    def experts_held(self) -> int:
        """Routed experts a layer holds: its share of ``n_experts``."""
        return self.n_experts // self.ep_size

    def moe_layer(self, i: int) -> bool:
        """Whether decoder layer ``i`` is an MoE layer (the first
        ``first_dense_layers`` of an MoE model are dense)."""
        return self.is_moe and i >= self.first_dense_layers

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch hold a 500k context (long_500k shape)?"""
        return self.family in ("ssm",) or (
            self.family == "hybrid" and self.attention == "sliding")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), unpadded."""
        d, hd, v = self.d_model, self.hd, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = dense_extra = 0
        if self.family == "ssm":
            di = self.xlstm_expand * d
            per_layer = 2 * d * di + di * (3 * di) + 2 * d   # rough xLSTM block
        else:
            if self.attention == "mla":
                qk = self.n_heads * (hd + self.rope_head_dim)
                ql, r = self.q_lora_rank, self.kv_lora_rank
                qk = d * ql + ql + ql * qk if ql else d * qk  # latent, norm
                kv = d * r + r * self.n_heads * (hd + hd)
                kv += r if self.kv_latent_norm else 0
                o = self.n_heads * hd * d
                per_layer += qk + kv + o + d * self.rope_head_dim
            elif self.attention != "none":
                per_layer += d * self.n_heads * hd            # q
                per_layer += 2 * d * self.n_kv_heads * hd     # k, v
                per_layer += self.n_heads * hd * d            # o
            n_in = 2 if self.mlp in ("swiglu", "geglu") else 1
            mlp = (n_in + 1) * d * self.d_ff
            if self.is_moe:
                e_ff = self.expert_d_ff or self.d_ff
                moe = (self.experts_held + self.n_shared_experts) * (
                    n_in + 1) * d * e_ff + d * self.n_experts  # + router
                if self.router == "sigmoid_group":
                    moe += self.n_experts                      # its bias
                per_layer += moe
                # the leading dense layers hold an MLP in place of the MoE
                dense_extra = min(self.first_dense_layers,
                                  self.n_layers) * (mlp - moe)
            elif self.d_ff > 0:
                per_layer += mlp
            if self.family == "hybrid" and self.ssm_state > 0:
                di = self.ssm_expand * d
                per_layer += 2 * d * di + di * d + di * (2 * self.ssm_state + 1)
            per_layer += 2 * d                                 # norms
        total = emb + self.n_layers * per_layer + dense_extra
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
