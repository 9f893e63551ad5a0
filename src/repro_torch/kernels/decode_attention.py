"""One-token GQA decode attention over a KV cache:
``csrc/decode_attention.cu`` and its wrapper.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``.
The wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.decode_attention_ref`) for CPU
tensors; anything else raises.  ``pos`` stays on the card: the kernel
reads it there, so a decode step makes no host sync for it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

#: kernel launches made by :func:`decode_attention` (plain integer)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# the head dims of configs/ and of every smoke_variant (32)
_HEAD_DIMS = (32, 64, 128, 192, 256)
# the split plan: four waves of the card's resident blocks were every row's
# cache full, and no split longer than _MAX_KEYS keys
_WAVES, _MAX_KEYS = 4, 2048


def stage_keys(d: int, dtype: torch.dtype) -> int:
    """Keys of one stage of the kernel's ring (``Shape::KS``): 128 for key
    rows up to 128 bytes, 64 up to 512, else 32."""
    row = d * (2 if dtype == torch.bfloat16 else 4)
    return 128 if row <= 128 else 64 if row <= 512 else 32


def split_plan(rows: int, s_max: int, keys: int, wave: int) -> int:
    """Splits of each (batch, kv head) row's valid keys: enough blocks for
    ``_WAVES`` waves of the ``wave`` blocks the card holds at once, were
    every row's cache full, and none longer than ``_MAX_KEYS`` keys; at
    most one stage of ``keys`` each.  The kernel divides the keys up to
    each row's ``pos`` (read on the card) among them, so a short row's
    later splits are empty."""
    want = max(-(-_WAVES * wave // rows), -(-s_max // _MAX_KEYS))
    return max(1, min(want, -(-s_max // keys)))


@functools.lru_cache(maxsize=None)
def _slots(index: int, g: int, d: int, bf16: bool, stages: int) -> int:
    """The blocks at (G, D, dtype, ring stages) the card holds at once (-1:
    the kernel does not take this G at this D)."""
    slots = ctypes.c_int(0)
    _build.check(_build.library().decode_attention_slots(
        g, d, int(bf16), stages, index, ctypes.addressof(slots)),
        "decode_attention_slots")
    return slots.value


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
    or 256, G = H / Hkv at most 16, every tensor contiguous and k/v
    16-byte aligned (TMA reads them); ``pos`` past the cache attends to
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
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must start on a "
                             "16-byte boundary (TMA reads it)")
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    if s_max == 0:
        raise ValueError("decode_attention: empty cache")
    bf16 = q.dtype == torch.bfloat16
    keys = stage_keys(d, q.dtype)
    # the wave of full rings plans the splits; a split then takes the
    # ring stages it needs
    wave = _slots(dev.index, h // hkv, d, bf16, -(-s_max // keys))
    if wave < 0:
        raise ValueError(f"decode_attention: {h // hkv} query heads a kv "
                         f"head at head dim {d} do not fit the kernel")
    splits = split_plan(b * hkv, s_max, keys, wave)
    longest = -(-s_max // splits)              # keys of the longest split
    stages = -(-longest // keys)
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
        h // hkv, d, splits, stages, int(bf16), d ** -0.5,
        dev.index, _build.stream_of(q)), "decode_attention")
    launches += 1
    return out
