"""One-token GQA decode attention over a KV cache:
``csrc/decode_attention.cu`` and its wrapper.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``.
The wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.decode_attention_ref`) for CPU
tensors; anything else raises.  ``pos`` stays on the card: the kernel
reads it there, so a decode step makes no host sync for it.
"""
from __future__ import annotations

import functools

import torch

from . import _build, ref

#: kernel launches made by :func:`decode_attention` (plain integer)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# the head dims of configs/ and of every smoke_variant (32)
_HEAD_DIMS = (32, 64, 128, 192, 256)
# splits of each row's keys: enough blocks for a few per SM, at most this
_MAX_SPLIT = 32
_KEY_TILE = 32          # keys per tile in the kernel


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _n_split(b: int, hkv: int, s_max: int, n_sm: int) -> int:
    """Splits of each (batch, kv head) row's valid keys: about eight blocks
    per SM over the whole grid, no more splits than key tiles."""
    want = -(-8 * n_sm // (b * hkv))
    return max(1, min(_MAX_SPLIT, want, -(-s_max // _KEY_TILE)))


def _check(q, k, v, pos) -> tuple[int, int, int, int, int]:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: expected q (B,H,D) and k/v "
                         f"(B,S,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    _, s_max, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or h % hkv != 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: q, k, v must share one dtype "
                         f"of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"decode_attention: pos must be (B,) int32, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    dev = q.device
    for name, t in (("k", k), ("v", v), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {dev}")
    return b, h, d, s_max, hkv


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """q (B,H,D); k/v (B,S,Hkv,D); pos (B,) int32, the newest valid cache
    index of each row (keys ``[0, pos]``).  Returns (B,H,D) in q's dtype
    (fp32 or bf16; fp32 arithmetic).  On the card D is 32, 64, 128, 192
    or 256 and every tensor contiguous; ``pos`` past the cache attends to
    all of it."""
    global launches
    b, h, d, s_max, hkv = _check(q, k, v, pos)
    dev = q.device
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in "
                         f"{_HEAD_DIMS} on the card")
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    if s_max == 0:
        raise ValueError("decode_attention: empty cache")
    splits = _n_split(b, hkv, s_max, _sm_count(dev.index))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(b * h * splits * d, dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(b * h * splits * 2, dtype=torch.float32,
                              device=dev)
    lib = _build.library()
    _build.check(lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, s_max, hkv,
        h // hkv, d, splits, int(q.dtype == torch.bfloat16), d ** -0.5,
        dev.index, _build.stream_of(q)), "decode_attention")
    launches += 1
    return out
