"""GQA prefill attention, causal (optionally banded to a sliding window)
or not (over K/V of their own length: an encoder's self-attention, cross
attention), with V's head dim free of Q's and K's:
``csrc/flash_attention.cu`` and its wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.attention_ref`) for CPU tensors;
anything else raises.  bf16 inputs go to the Hopper kernel (wgmma fed by
TMA loads), fp32 inputs to the SIMT kernel.  Both mask the ragged tails of
S and T themselves, so nothing is padded, and read and write by strides: a
(B,S,H,D) projection passed as its ``transpose(1, 2)`` view goes in without
a copy, and the output keeps q's strides.  TMA takes a bf16 operand only
where its base and its batch, head and sequence strides are multiples of
16 bytes (:func:`check_tma`); the wrapper raises on anything else rather
than copy it.

The gradient (the reference's B8 has none: it trains through its XLA
``sdpa``) is the plain version's, recomputed in the backward pass: on a
CUDA tensor :func:`flash_attention` is a ``torch.autograd.Function`` whose
forward launches the kernel and saves q, k and v (not the output), and
whose backward is :func:`attention_grad`, autograd of ``attention_ref``
on the saved inputs, a chunk of queries at a time past
``NAIVE_MAX_SEQ`` so that only a (…, chunk, T) score tile is live, as
the reference's ``sdpa`` rematerialises its query chunks.  On a CPU
tensor autograd runs through ``attention_ref`` directly.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) the same
``Function`` runs with a shape-only forward (:func:`_shape_only`): it
builds the output, reports the kernel's FLOPs and bytes to the dry run's
counter (:func:`repro_torch.costing.charge`) and materialises no score
tensor; its backward is the card's, :func:`attention_grad`.  DTensor
inputs are laid out so that each rank's shards form a problem of their
own (batch and heads as q's, the keys whole where q is split along its
sequence), and the stub sees those local shards.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import costing
from repro_torch.telemetry.tracing import annotate

from . import _build, ref

#: kernel launches made by :func:`flash_attention` (plain integer)
launches = 0
#: of those, launches of the Hopper (wgmma + TMA) kernel: every bf16 call
wgmma_launches = 0

#: past this many queries the backward recomputes attention in chunks of
#: ``Q_CHUNK`` (the reference's ``sdpa``: ``_NAIVE_MAX_SEQ``, ``q_chunk``)
NAIVE_MAX_SEQ = 1024
Q_CHUNK = 512

_DTYPES = (torch.float32, torch.bfloat16)
# the (Q/K, V) head dims the kernels take: every dense config's and smoke
# variant's (32 to 256, V as wide as K) and MLA's decompressed heads,
# deepseek-v2-lite-16b's 128 + 64 rope columns with V at 128 and its smoke
# variant's 32 + 16 with V at 32
SHAPES = ((32, 32), (64, 64), (128, 128), (192, 192), (256, 256),
          (192, 128), (48, 32))
_HEAD_DIMS = tuple(sorted({d for d, _ in SHAPES}))


def _check(q, k, v, causal: bool, window: int
           ) -> tuple[int, int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: expected q (B,H,S,D), k "
                         f"(B,Hkv,T,D) and v (B,Hkv,T,Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0], k.shape[3]) != (b, d) or (causal and t != s) \
            or hkv == 0 or h % hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}"
                         + (" (causal: T must equal S)" if causal else ""))
    if window < 0 or (window > 0 and not causal):
        raise ValueError(f"flash_attention: window {window} (a window must "
                         "be >= 0, and only a causal pass takes one)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype "
                         f"of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on "
                             f"{q.device}")
    return b, h, s, t, d, hkv, dv


def _check_head(d: int, operands) -> None:
    """D (Q's and K's head dim) in ``_HEAD_DIMS`` and the head dim
    contiguous, for both kernels; ``operands`` holds ``(name, strides)``
    pairs, strides over (B,H,S,D)."""
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


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B,H,S,Dv) output laid out as q is (the model's (B,S,H,D)
    projections come as transposed views; the output follows them)."""
    if dv == q.shape[3]:
        return torch.empty_like(q)    # q's strides if dense, else contiguous
    order = sorted(range(3), key=lambda i: -q.stride(i))
    buf = torch.empty([q.shape[i] for i in order] + [dv], dtype=q.dtype,
                      device=q.device)
    return buf.permute([order.index(i) for i in range(3)] + [3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention of q (B,H,S,D) over k (B,Hkv,T,D), v (B,Hkv,T,Dv), H a
    multiple of Hkv (query head ``h`` reads kv head ``h // (H/Hkv)``),
    scale 1/sqrt(D).  ``causal``: T == S and query ``i`` attends to keys
    ``j <= i``; ``window > 0`` keeps key ``j`` only where ``j > i -
    window`` (the kernels skip key tiles outside the band).  Not
    ``causal``: every query attends to all T keys, T free of S, and no
    window.  Returns (B,H,S,Dv) in q's dtype (fp32 or bf16; fp32
    arithmetic), laid out as q is.  On the card (D, Dv) is one of
    :data:`SHAPES` and the head dim of every operand is contiguous; bf16
    operands also pass :func:`check_tma`.  Differentiable in q, k and v
    (:func:`attention_grad` on the card)."""
    causal = bool(causal)
    if q.device.type in ("cuda", "meta"):
        return _FlashAttention.apply(q, k, v, window, causal)
    _check(q, k, v, causal, window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return ref.attention_ref(q, k, v, causal=causal, window=window)


class _FlashAttention(torch.autograd.Function):
    """B8 forward, the plain version's gradient recomputed backward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool):
        ctx.window, ctx.causal = window, causal
        if q.device.type == "meta":
            out, (q, k, v), ctx.layout = _shape_only(q, k, v, window, causal)
        else:
            out = _launch(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if q.device.type == "meta" and ctx.layout is not None:
            grads = _local_grad(q, k, v, dout, ctx.causal, ctx.window,
                                *ctx.layout)
        else:
            grads = attention_grad(q, k, v, dout, ctx.causal, ctx.window)
        return (*grads, None, None)


def attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, causal: bool = True, window: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref(q, k, v, causal, window)`` against
    the output gradient ``dout`` (B,H,S,Dv), each in its input's dtype and
    shape: autograd of the plain version, recomputed on the inputs.  Past
    :data:`NAIVE_MAX_SEQ` queries, one chunk of :data:`Q_CHUNK` queries at
    a time (their scores over all T keys, then freed), dk and dv summed
    over the chunks in fp32.  Inside the profiler span
    ``attention/grad``."""
    s = q.shape[2]
    step = s if s <= NAIVE_MAX_SEQ else Q_CHUNK
    with annotate("attention/grad"), torch.enable_grad():
        kf = k.detach().to(torch.float32).requires_grad_()
        vf = v.detach().to(torch.float32).requires_grad_()
        dq, dk, dv = [], None, None
        for lo in range(0, s, step):
            qc = q[:, :, lo:lo + step].detach().to(
                torch.float32).requires_grad_()
            out = ref.attention_ref(qc, kf, vf, causal=causal,
                                    window=window, q_start=lo)
            gq, gk, gv = torch.autograd.grad(
                out, (qc, kf, vf),
                dout[:, :, lo:lo + step].to(torch.float32))
            dq.append(gq)
            dk = gk if dk is None else dk + gk
            dv = gv if dv is None else dv + gv
        return (torch.cat(dq, dim=2).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype))


def pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head scores: every pair without
    ``causal``, else keys ``j <= i`` (and ``j > i - window``)."""
    if not causal:
        return s * t
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _kv_need(h_local: int, hkv_local: int, g: int) -> int:
    """The kv heads a rank's ``h_local`` query heads read (of its
    ``hkv_local``), a divisor of ``h_local``."""
    need = min(hkv_local, -(-h_local // g))
    while h_local % need:
        need += 1
    return need


def _shape_only(q, k, v, window: int, causal: bool):
    """B8 on meta tensors: the output, no arithmetic; charges the kernel's
    FLOPs (2 (D + Dv) a scored pair) and bytes (q, the k and v heads its
    query heads read, the output) for this rank's shards.  Returns (the
    output, the (redistributed) q, k, v, and for DTensors the layout
    (q's placements, k's) the backward runs in, else None)."""
    b, h, s, t, d, hkv, dv = _check(q, k, v, causal, window)
    if (d, dv) not in SHAPES:
        raise ValueError(f"flash_attention: head dims (D, Dv) = ({d}, {dv})"
                         f" not in {SHAPES} on the card")
    flops = 2.0 * b * h * pairs(s, t, causal, window) * (d + dv)
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(q, DTensor):
        out = _out_like(q, dv)
        costing.charge("flash_attention", flops, _nbytes(q, k, v, out))
        return out, (q, k, v), None
    mesh = q.device_mesh
    qp, kp = [], []
    for i, p in enumerate(q.placements):
        if p.is_partial() or (p.is_shard() and p.dim == 3):
            p = Replicate()
        qp.append(p)
        # keys sharded with q by batch, and by heads where Hkv divides;
        # whole where q is split along its sequence
        keep = p.is_shard() and (p.dim == 0 or (
            p.dim == 1 and hkv % mesh.size(i) == 0))
        kp.append(p if keep else Replicate())
    q, k, v = (q.redistribute(mesh, qp), k.redistribute(mesh, kp),
               v.redistribute(mesh, kp))
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    out = _out_like(ql, dv)
    need = _kv_need(ql.shape[1], kl.shape[1], h // hkv) / kl.shape[1]
    costing.charge("flash_attention", flops * ql.numel() / q.numel(),
                   _nbytes(ql, out) + need * _nbytes(kl, vl))
    return (DTensor.from_local(out, mesh, qp, run_check=False), (q, k, v),
            (qp, kp))


def _local_grad(q, k, v, dout, causal: bool, window: int, qp, kp):
    """The meta backward of DTensors laid out as :func:`_shape_only` laid
    them out: :func:`attention_grad` on each rank's shards (its query
    heads and the kv heads they read); dk and dv are partial sums over
    the mesh dims that split q but not k."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = q.device_mesh
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    dl = dout.redistribute(mesh, qp).to_local()
    need = _kv_need(ql.shape[1], kl.shape[1], q.shape[1] // k.shape[1])
    dq, dk, dv = attention_grad(ql, kl[:, :need], vl[:, :need], dl, causal,
                                window)
    if need < kl.shape[1]:
        dk = torch.cat([dk, dk.new_zeros((dk.shape[0], kl.shape[1] - need,
                                          *dk.shape[2:]))], dim=1)
        dv = torch.cat([dv, dv.new_zeros((dv.shape[0], vl.shape[1] - need,
                                          *dv.shape[2:]))], dim=1)
    gp = [p if p.is_shard() else (Partial() if pq.is_shard() else p)
          for p, pq in zip(kp, qp)]
    return (DTensor.from_local(dq, mesh, qp, run_check=False),
            DTensor.from_local(dk, mesh, gp, run_check=False),
            DTensor.from_local(dv, mesh, gp, run_check=False))


def _launch(q, k, v, window: int, causal: bool) -> torch.Tensor:
    """The CUDA launch behind :func:`flash_attention` (checked inputs on a
    CUDA device)."""
    global launches, wgmma_launches
    b, h, s, t, d, hkv, dv = _check(q, k, v, causal, window)
    dev = q.device
    if (d, dv) not in SHAPES:
        raise ValueError(f"flash_attention: head dims (D, Dv) = ({d}, {dv})"
                         f" not in {SHAPES} on the card")
    bf16 = q.dtype == torch.bfloat16
    stride_of = _tma_strides if bf16 else torch.Tensor.stride
    operands = [(name, stride_of(x), x.data_ptr())
                for name, x in (("q", q), ("k", k), ("v", v))]
    if bf16:
        check_tma(d, operands)
    else:
        _check_head(d, operands)
    out = _out_like(q, dv)
    if b == 0 or h == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    strides = (ctypes.c_longlong * 12)(*(
        stride_of(x)[i] for x in (q, k, v, out) for i in (0, 1, 2)))
    lib = _build.library()
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        s, t, d, dv, strides, int(bf16), d ** -0.5, window, int(causal),
        dev.index, _build.stream_of(q)), "flash_attention")
    launches += 1
    wgmma_launches += bf16
    return out
