"""One-token GQA decode attention over a KV cache, V's head dim free of
K's and V possibly a column-prefix view of the K rows (MLA's absorbed
decode): ``csrc/decode_attention.cu`` and its wrapper.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``.
The wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.decode_attention_ref`) for CPU
tensors; anything else raises.  ``pos`` stays on the card: the kernel
reads it there, so a decode step makes no host sync for it.

On ``meta`` tensors (the dry run) the wrapper is shape-only
(:func:`_shape_only`): it builds the output and reports the kernel's
FLOPs and bytes over the whole cache (the reference's jitted step scores
every slot under a mask) to :func:`repro_torch.costing.charge`.  DTensor
inputs follow the cache's layout: batch and kv heads split the query as
they split the cache, and a cache split along its sequence gives each
rank a partial softmax over its keys, summed across ranks (a ``Partial``
output), as XLA's sharded softmax does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import costing

from . import _build, ref

#: kernel launches made by :func:`decode_attention` (plain integer)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# the (K, V) head dims the kernel takes: every dense and hybrid config's
# and smoke variant's (32 to 256, V as wide as K) and MLA's absorbed
# decode, deepseek-v2-lite-16b's 512 latent + 64 rope columns with V the
# latent 512 and its smoke variant's 64 + 16 with V at 64
SHAPES = ((32, 32), (64, 64), (128, 128), (192, 192), (256, 256),
          (576, 512), (80, 64))
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
def _slots(index: int, g: int, d: int, dv: int, v_in_k: bool, bf16: bool,
           stages: int) -> int:
    """The blocks at (G, D, Dv, V in K, dtype, ring stages) the card holds
    at once (-1: the kernel does not take this G at these head dims)."""
    slots = ctypes.c_int(0)
    _build.check(_build.library().decode_attention_slots(
        g, d, dv, int(v_in_k), int(bf16), stages, index,
        ctypes.addressof(slots)), "decode_attention_slots")
    return slots.value


def v_in_k(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether v is a column-prefix view of k's rows: the same storage,
    base and strides, its head dim no wider (the kernel then reads each
    cache row once, for the scores and the values)."""
    return (v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
            and v.shape[3] <= k.shape[3])


def _check(q, k, v, pos) -> tuple[int, int, int, int, int, int]:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"decode_attention: expected q (B,H,D), k "
                         f"(B,S,Hkv,D) and v (B,S,Hkv,Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    _, s_max, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or h % hkv != 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
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
    return b, h, d, v.shape[3], s_max, hkv


def _shape_only(q, k, v) -> torch.Tensor:
    """B9 on meta tensors: the output, no arithmetic; charges the kernel's
    FLOPs (2 (D + Dv) a scored slot, every slot of the cache) and bytes
    (q, the k and v rows its heads read, once where v is a view of k, the
    output) for this rank's shards."""
    b, h, d = q.shape
    s_max, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (d, dv) not in SHAPES:
        raise ValueError(f"decode_attention: head dims (D, Dv) = ({d}, "
                         f"{dv}) not in {SHAPES} on the card")
    flops = 2.0 * b * h * s_max * (d + dv)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    if not isinstance(k, DTensor):
        out = q.new_empty((b, h, dv))
        costing.charge("decode_attention", flops,
                       _nbytes(q, out) + _kv_bytes(k, v))
        return out
    mesh = k.device_mesh
    qpl = (q.placements if isinstance(q, DTensor)
           else [Replicate()] * mesh.ndim)
    kp, qp, op = [], [], []
    for i, p in enumerate(k.placements):
        if p.is_shard() and p.dim in (0, 1, 2):
            kp.append(p)
            qp.append({0: Shard(0), 1: Replicate(), 2: Shard(1)}[p.dim])
            op.append({0: Shard(0), 1: Partial(), 2: Shard(1)}[p.dim])
            continue
        # the cache is whole on this mesh dim: follow the query
        qq = qpl[i]
        if qq.is_shard() and qq.dim == 0:
            kp.append(Shard(0))
        else:
            kp.append(Replicate())
        qq = qq if qq.is_shard() and qq.dim in (0, 1) else Replicate()
        qp.append(qq)
        op.append(qq)
    if not isinstance(q, DTensor):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kp).to_local()
    vl = v.redistribute(mesh, kp).to_local()
    out = ql.new_empty((ql.shape[0], ql.shape[1], dv))
    g = h // hkv
    need = min(kl.shape[2], -(-ql.shape[1] // g)) / kl.shape[2]
    frac = ql.numel() / q.numel() * kl.shape[1] / s_max
    costing.charge("decode_attention", flops * frac,
                   _nbytes(ql, out) + need * _kv_bytes(kl, vl))
    return DTensor.from_local(out, mesh, op, run_check=False)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _kv_bytes(k, v) -> int:
    """Bytes of the cache rows: k's, plus v's unless v is a column view of
    k (one storage, same offset and strides: the kernel reads each row
    once)."""
    shared = (k.untyped_storage()._cdata == v.untyped_storage()._cdata
              and k.storage_offset() == v.storage_offset()
              and k.stride() == v.stride())
    return _nbytes(k) if shared else _nbytes(k, v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """q (B,H,D); k (B,S,Hkv,D); v (B,S,Hkv,Dv); pos (B,) int32, the
    newest valid cache index of each row (keys ``[0, pos]``); ``scale``
    (default 1/sqrt(D)) multiplies the scores.  Returns (B,H,Dv) in q's
    dtype (fp32 or bf16; fp32 arithmetic).  On the card (D, Dv) is one of
    :data:`SHAPES`, G = H / Hkv at most 16, q, k and pos contiguous, v
    contiguous or a column-prefix view of k (:func:`v_in_k`: the kernel
    then reads each row once, with no copy), k/v 16-byte aligned (TMA
    reads them); ``pos`` past the cache attends to all of it."""
    global launches
    b, h, d, dv, s_max, hkv = _check(q, k, v, pos)
    scale = d ** -0.5 if scale is None else float(scale)
    dev = q.device
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, scale)
    if dev.type == "meta":
        return _shape_only(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    if (d, dv) not in SHAPES:
        raise ValueError(f"decode_attention: head dims (D, Dv) = ({d}, "
                         f"{dv}) not in {SHAPES} on the card")
    in_k = v_in_k(k, v)
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not (t.is_contiguous() or (name == "v" and in_k)):
            raise ValueError(f"decode_attention: {name} must be contiguous"
                             + (" or a column-prefix view of k"
                                if name == "v" else ""))
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must start on a "
                             "16-byte boundary (TMA reads it)")
    out = q.new_empty((b, h, dv))
    if b == 0 or h == 0:
        return out
    if s_max == 0:
        raise ValueError("decode_attention: empty cache")
    bf16 = q.dtype == torch.bfloat16
    keys = stage_keys(d, q.dtype)
    # the wave of full rings plans the splits; a split then takes the
    # ring stages it needs
    wave = _slots(dev.index, h // hkv, d, dv, in_k, bf16,
                  -(-s_max // keys))
    if wave < 0:
        raise ValueError(f"decode_attention: {h // hkv} query heads a kv "
                         f"head at head dims ({d}, {dv}) do not fit the "
                         "kernel")
    splits = split_plan(b * hkv, s_max, keys, wave)
    longest = -(-s_max // splits)              # keys of the longest split
    stages = -(-longest // keys)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(b * h * splits * dv, dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(b * h * splits * 2, dtype=torch.float32,
                              device=dev)
    lib = _build.library()
    _build.check(lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, s_max, hkv,
        h // hkv, d, dv, int(in_k), splits, stages, int(bf16), scale,
        dev.index, _build.stream_of(q)), "decode_attention")
    launches += 1
    return out
