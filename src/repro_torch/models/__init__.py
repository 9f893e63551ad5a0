"""The port's model stack: the decoder-only LMs of the dense, MoE/MLA,
hybrid (attention + Mamba) and xLSTM families, the encoder-decoder
(whisper) and the VLM backbone, their attention on the hand-written
kernels (B8 for prefill, B9 for decode)."""
from .config import SHAPES, ModelConfig, ShapeConfig, smoke_variant
from .model import Model, build_model, params_from_reference
from .steps import make_decode_step, make_prefill_step

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "smoke_variant", "Model",
           "build_model", "params_from_reference", "make_prefill_step",
           "make_decode_step"]
