"""Causal GQA prefill attention: ``csrc/flash_attention.cu`` and its
wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.attention_ref`) for CPU tensors;
anything else raises.  The kernel masks the ragged tail of S itself, so
nothing is padded, and it reads and writes by strides: a (B,S,H,D)
projection passed as its ``transpose(1, 2)`` view goes in without a copy,
and the output keeps q's strides.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

#: kernel launches made by :func:`flash_attention` (plain integer)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)


def _check(q, k, v) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B,H,S,D) and k/v "
                         f"(B,Hkv,S,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 \
            or h % hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype "
                         f"of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    return b, h, s, d, hkv


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention: q (B,H,S,D), k/v (B,Hkv,S,D), H a multiple of
    Hkv (query head ``h`` reads kv head ``h // (H/Hkv)``), scale
    1/sqrt(D).  Returns (B,H,S,D) in q's dtype (fp32 or bf16; fp32
    arithmetic) with q's strides.  On the card D is 64 or 128 and the
    head dim of every operand is contiguous."""
    global launches
    b, h, s, d, hkv = _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return ref.attention_ref(q, k, v, causal=True)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{_HEAD_DIMS} on the card")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
    out = torch.empty_like(q)     # q's strides if dense, else contiguous
    if b == 0 or h == 0 or s == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)))
    lib = _build.library()
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        s, d, strides, int(q.dtype == torch.bfloat16), d ** -0.5, dev.index,
        _build.stream_of(q)), "flash_attention")
    launches += 1
    return out
