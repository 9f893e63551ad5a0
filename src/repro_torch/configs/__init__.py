"""Assigned architecture configs (exact assignment numbers) + the paper's
serving config: the port's own copies of ``repro/configs/``.
``get_config(arch_id)`` returns the full ModelConfig.

The reference's ``input_specs`` (JAX ``ShapeDtypeStruct`` stand-ins whose
only caller is its dry run) waits for the dry-run tooling of ``ROADMAP.md``
queue A item 12; training needs none.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

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
