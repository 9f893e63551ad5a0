"""The port's model stack: the decoder-only LMs of the dense, MoE/MLA,
hybrid (attention + Mamba) and xLSTM families, the encoder-decoder
(whisper) and the VLM backbone, their attention on the hand-written
kernels (B8 for prefill and training, B9 for decode), and the loss and
train step."""
from .config import SHAPES, ModelConfig, ShapeConfig, smoke_variant
from .model import Model, build_model, params_from_reference
from .steps import (make_decode_step, make_loss_fn, make_prefill_step,
                    make_train_step, value_and_grad)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "smoke_variant", "Model",
           "build_model", "params_from_reference", "make_prefill_step",
           "make_decode_step", "make_loss_fn", "make_train_step",
           "value_and_grad"]
