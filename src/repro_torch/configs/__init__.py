"""Assigned architecture configs (exact assignment numbers) + the paper's
serving config: the port's own copies of ``repro/configs/``.
``get_config(arch_id)`` returns the full ModelConfig;
``input_specs(cfg, shape)`` returns meta-tensor stand-ins for every model
input of that (arch x shape) cell: no allocation.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig, shape_config

ARCH_IDS = [
    "gemma_7b", "qwen15_110b", "smollm_360m", "nemotron4_340b",
    "deepseek_v2_lite_16b", "grok1_314b", "hymba_15b", "xlstm_125m",
    "whisper_medium", "internvl2_26b",
]

# canonical assignment ids -> module names
ALIASES = {
    "gemma-7b": "gemma_7b",
    "qwen1.5-110b": "qwen15_110b",
    "smollm-360m": "smollm_360m",
    "nemotron-4-340b": "nemotron4_340b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "grok-1-314b": "grok1_314b",
    "hymba-1.5b": "hymba_15b",
    "xlstm-125m": "xlstm_125m",
    "whisper-medium": "whisper_medium",
    "internvl2-26b": "internvl2_26b",
    "paper": "paper",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def shape_cells(cfg: ModelConfig) -> list[str]:
    """The assigned shape cells this arch runs."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def input_specs(cfg: ModelConfig, shape) -> dict:
    """Meta tensors for every model input of this cell (``shape`` a name of
    ``SHAPES`` or a ``ShapeConfig``), the reference's
    shapes and dtypes (token ids int32).  For decode shapes the KV/state
    cache is included under ``"cache"`` (:meth:`Model.cache_spec`'s
    shapes; MLA's ``c_kv`` and ``k_rope`` are column views of one row
    buffer, as :meth:`Model.init_cache` makes them)."""
    from repro_torch.models.model import Model

    sc: ShapeConfig = shape_config(shape)
    b, s = sc.global_batch, sc.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    specs: dict = {}
    if sc.kind == "train":
        specs["tokens"] = meta((b, s))
        specs["labels"] = meta((b, s))
    elif sc.kind == "prefill":
        specs["tokens"] = meta((b, s))
    else:  # decode: one new token against a cache of seq_len
        specs["tokens"] = meta((b, 1))
        specs["pos"] = meta((b,))
        specs["cache"] = Model(cfg, "meta").init_cache(b, s)
    if cfg.frontend == "audio":
        # decode consumes the encoder's output, computed at prefill
        key = "enc_out" if sc.kind == "decode" else "audio_embeds"
        specs[key] = meta((b, cfg.n_frontend_tokens, cfg.d_model),
                          cfg.cdtype)
    if cfg.frontend == "vision" and sc.kind != "decode":
        specs["image_embeds"] = meta((b, cfg.n_frontend_tokens,
                                      cfg.d_model), cfg.cdtype)
    return specs
