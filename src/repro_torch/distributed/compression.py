"""Gradient compression: int8 quantized all-reduce with error feedback,
after ``repro/distributed/compression.py``.

Gradients are quantized per tensor to int8 around one fp32 scale before
the data-parallel all-reduce, and the quantization error is fed back into
the next step's gradient (error feedback keeps SGD/Adam unbiased in
expectation): 4× less collective traffic; optional, off by default.
Functions on the nested trees of tensors (:mod:`repro_torch.tree`); the
per-tensor codec is :mod:`repro_torch.kernels.quant`'s.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import dequantize_int8, quantize_int8
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads",
           "decompress_grads", "init_residuals"]


def compress_grads(grads, residuals):
    """Returns (quantized tree, scales tree, new residuals tree)."""
    def one(g, r):
        g_fb = g.to(torch.float32) + r
        q, s = quantize_int8(g_fb)
        return q, s, g_fb - dequantize_int8(q, s)
    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residuals))]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_grads(q, s):
    return tree_map(dequantize_int8, q, s)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
