"""Causal GQA prefill attention: ``csrc/flash_attention.cu`` and its
wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.attention_ref`) for CPU tensors;
anything else raises.  bf16 inputs go to the Hopper kernel (wgmma fed by
TMA loads), fp32 inputs to the SIMT kernel.  Both mask the ragged tail of
S themselves, so nothing is padded, and read and write by strides: a
(B,S,H,D) projection passed as its ``transpose(1, 2)`` view goes in without
a copy, and the output keeps q's strides.  TMA takes a bf16 operand only
where its base and its batch, head and sequence strides are multiples of
16 bytes (:func:`check_tma`); the wrapper raises on anything else rather
than copy it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

#: kernel launches made by :func:`flash_attention` (plain integer)
launches = 0
#: of those, launches of the Hopper (wgmma + TMA) kernel: every bf16 call
wgmma_launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# the head dims of configs/ and of every smoke_variant (32)
_HEAD_DIMS = (32, 64, 128, 192, 256)


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


def _check_head(d: int, operands) -> None:
    """D in ``_HEAD_DIMS`` and the head dim contiguous, for both kernels;
    ``operands`` holds ``(name, strides)`` pairs, strides over (B,H,S,D)."""
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{_HEAD_DIMS} on the card")
    for name, strides, *_ in operands:
        if strides[3] != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")


def check_tma(d: int, operands) -> None:
    """Raise ValueError where the Hopper kernel's TMA loads cannot take an
    operand: ``operands`` holds ``(name, strides, data_ptr)`` of q, k and v,
    strides in bf16 elements over (B,H,S,D).  D must be one of
    ``_HEAD_DIMS`` and the head dim contiguous; the base address and the
    batch, head and sequence strides must be multiples of 16 bytes, the
    strides below 2^40 bytes."""
    _check_head(d, operands)
    for name, strides, ptr in operands:
        if ptr % 16:
            raise ValueError(f"flash_attention: {name}'s base address is "
                             "not 16-byte aligned (TMA)")
        for axis, st in zip(("batch", "head", "sequence"), strides[:3]):
            nbytes = st * 2
            if nbytes % 16 or not 0 <= nbytes < 2 ** 40:
                raise ValueError(
                    f"flash_attention: {name}'s {axis} stride of {nbytes} "
                    "bytes is not a multiple of 16 below 2^40 (TMA)")


def _tma_strides(t: torch.Tensor) -> tuple[int, ...]:
    """t's strides, a size-1 axis given its dense stride (TMA reads only
    index 0 there, but checks every stride)."""
    dense = t.shape[3]
    out = [1] * 4
    for i in (2, 1, 0):
        out[i] = t.stride(i) if t.shape[i] > 1 else dense
        dense *= t.shape[i]
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention: q (B,H,S,D), k/v (B,Hkv,S,D), H a multiple of
    Hkv (query head ``h`` reads kv head ``h // (H/Hkv)``), scale
    1/sqrt(D).  Returns (B,H,S,D) in q's dtype (fp32 or bf16; fp32
    arithmetic) with q's strides.  On the card D is 32, 64, 128, 192 or
    256 and the head dim of every operand is contiguous; bf16 operands
    also pass :func:`check_tma`."""
    global launches, wgmma_launches
    b, h, s, d, hkv = _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return ref.attention_ref(q, k, v, causal=True)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    bf16 = q.dtype == torch.bfloat16
    stride_of = _tma_strides if bf16 else torch.Tensor.stride
    operands = [(name, stride_of(t), t.data_ptr())
                for name, t in (("q", q), ("k", k), ("v", v))]
    if bf16:
        check_tma(d, operands)
    else:
        _check_head(d, operands)
    out = torch.empty_like(q)     # q's strides if dense, else contiguous
    if b == 0 or h == 0 or s == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        stride_of(t)[i] for t in (q, k, v, out) for i in (0, 1, 2)))
    lib = _build.library()
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        s, d, strides, int(bf16), d ** -0.5, dev.index,
        _build.stream_of(q)), "flash_attention")
    launches += 1
    wgmma_launches += bf16
    return out
