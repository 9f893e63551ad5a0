"""Occupancy-masked Eq. 1 victim scoring: ``csrc/victim_value.cu`` and its
wrapper, and the launch path shared with B3 (``csrc/rac_value.cu``).

Replaces ``repro/kernels/decision.py::victim_value_pallas``, the victim leg
of :func:`~repro_torch.kernels.ops.fused_decide`, and
``::victim_value_multi_pallas``, its ``lax.map`` policy stack
(:func:`victim_value_multi`: a policy grid axis, one launch).  The
wrappers launch the CUDA kernel for CUDA tensors and take the plain
versions (:mod:`~repro_torch.kernels.ref`) for CPU tensors.

Both kernels run one body (``csrc/eq1_value.cuh``): one wave of blocks, V
entries a thread from 16-byte loads where every base is 16-byte aligned
(:func:`value_plan`, the scalar walk otherwise), topic tables staged in
shared memory where they fit (:func:`stage_plan`), and programmatic
dependent launch.  A launch's arguments travel as one packed block
(``Eq1Args``), so the host pays one ctypes argument.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from . import _build, ref
from .similarity_topk import _check

#: kernel launches made by :func:`victim_value` (plain integer)
launches = 0
#: of those, the launches whose bases took the vector path
vec_launches = 0
#: kernel launches made by :func:`victim_value_multi` (one per stacked call)
multi_launches = 0
#: of those, the launches whose bases took the vector path
multi_vec_launches = 0

#: entries a vector chunk (``kEq1V``: one 16-byte load of 4-byte entries)
V = 4
#: threads a block (at most ``kEq1Threads``, 256) with the topic tables
#: staged (few blocks: each copies both tables) and gathered (many: a
#: scattered gather is served one line at a time by an SM's L1, so the
#: gathers spread over every SM)
STAGED_THREADS, GATHER_THREADS = 256, 64
#: both topic tables staged in shared memory up to this many bytes
#: (``kEq1StageMax``); larger tables are gathered
STAGE_MAX = 192 * 1024

# Eq1Args (csrc/eq1_value.cuh): tsi, tid, mask, tp_last, t_last, out,
# stream; n, n_topics, n_pol, n_vec, t_now, kind, v, staged, blocks,
# threads, device; t_now_f, neg_alpha; 4 bytes of padding
_ARGS = struct.Struct("<7Q11i2f4x")
KIND_VICTIM, KIND_RAC_F32, KIND_RAC_I32 = 0, 1, 2

_SLOTS: dict = {}
_PLANS: dict = {}
_F32, _I32 = torch.float32, torch.int32


def value_plan(n: int, aligned: bool, slots: int, v: int,
               threads: int) -> tuple[int, int]:
    """(blocks, n_vec) of one Eq. 1 launch over ``n`` entries a table.
    Entries ``[0, n_vec)`` go in V-wide chunks (``n_vec`` the largest
    multiple of V, 0 unless every base is 16-byte aligned), the rest one
    at a time; thread ``g`` of the grid takes chunks ``g, g + stride, ...``
    and then entries ``n_vec + g, n_vec + g + stride, ...``.  The grid is
    one wave at most (``slots``, the blocks the card holds at once) and no
    more blocks than the work fills."""
    n_vec = n - n % v if aligned else 0
    work = n_vec // v + (n - n_vec)
    return max(1, min(slots, -(-work // threads))), n_vec


def stage_plan(n_topics: int, aligned: bool) -> bool:
    """Whether a launch stages its topic tables in shared memory: one bulk
    copy a table needs 16-byte bases (``aligned``) and whole 16-byte rows
    (T % 4 == 0), and both tables (8 T bytes) within :data:`STAGE_MAX`."""
    return aligned and n_topics % 4 == 0 and 8 * n_topics <= STAGE_MAX


def _slots(kind: int, dev: int, staged: bool, n_topics: int,
           threads: int) -> int:
    """The blocks of this kernel the card holds at once, asked of the card
    once per (kernel, device, V, block size, staged topic count)."""
    key = (kind, dev, V, threads, staged and n_topics)
    if key not in _SLOTS:
        entry = "victim_value_slots" if kind == KIND_VICTIM \
            else "rac_value_slots"
        got = ctypes.c_int(0)
        args = _ARGS.pack(0, 0, 0, 0, 0, 0, 0, 0, n_topics, 1, 0, 0, kind,
                          V, int(staged), 1, threads, dev, 0.0, 0.0)
        _build.check(getattr(_build.library(), entry)(
            args, ctypes.addressof(got)), entry)
        _SLOTS[key] = max(1, got.value)
    return _SLOTS[key]


def _plan(key: tuple) -> tuple[int, int, bool, int]:
    """(blocks, n_vec, staged, threads) of a launch, remembered by its
    key."""
    kind, dev, n, n_topics, _, aligned, tables16 = key[:7]
    staged = stage_plan(n_topics, tables16)
    threads = STAGED_THREADS if staged else GATHER_THREADS
    if len(_PLANS) >= 4_096:
        _PLANS.clear()
    plan = _PLANS[key] = (*value_plan(n, aligned, _slots(
        kind, dev, staged, n_topics, threads), V, threads), staged, threads)
    return plan


def eq1_args(kind: int, tsi: torch.Tensor, tid: torch.Tensor, mask,
             tp_last: torch.Tensor, t_last: torch.Tensor, out: torch.Tensor,
             n: int, n_topics: int, n_pol: int, t_now: int, t_now_f: float,
             neg_alpha: float) -> tuple[bytes, bool]:
    """The packed arguments of one Eq. 1 launch on the card, and whether
    its bases took the vector path."""
    dev = tsi.get_device()
    p_tsi, p_tid, p_tp, p_tl, p_out = (
        tsi.data_ptr(), tid.data_ptr(), tp_last.data_ptr(),
        t_last.data_ptr(), out.data_ptr())
    p_mask = 0 if mask is None else mask.data_ptr()
    # 16-byte vectors of 4-byte entries (an occupancy mask too; a bool mask
    # is read V bytes at a time); each policy's row on 16 bytes
    aligned = (p_tsi | p_tid | p_out | (p_mask if kind == KIND_VICTIM
                                         else 0)) % 16 == 0 \
        and p_mask % V == 0 and (n_pol == 1 or n % 4 == 0)
    key = (kind, dev, n, n_topics, n_pol, aligned, (p_tp | p_tl) % 16 == 0,
           V, STAGED_THREADS, GATHER_THREADS, STAGE_MAX)
    blocks, n_vec, staged, threads = _PLANS.get(key) or _plan(key)
    # the raw stream, as _build.stream_of reads it, without a call between
    return _ARGS.pack(p_tsi, p_tid, p_mask, p_tp, p_tl, p_out,
                      torch._C._cuda_getCurrentRawStream(dev), n, n_topics,
                      n_pol, n_vec, t_now, kind, V, staged, blocks, threads,
                      dev, t_now_f, neg_alpha), n_vec > 0


def _tables_ok(di: int, ndim: int, tsi, tid, occ, tp_last, t_last) -> bool:
    """The common case on card ``di`` (>= 0) in few attribute reads: the
    slot and topic tables in their dtypes, contiguous, of matching shapes
    with one row a policy, on that card.  Anything else takes
    :func:`_check_tables`, which raises with the reason."""
    return di >= 0 and tsi.dim() == ndim \
        and tsi.dtype is _F32 and tid.dtype is _I32 and occ.dtype is _I32 \
        and tp_last.dtype is _F32 and t_last.dtype is _I32 \
        and tsi.is_contiguous() and tid.is_contiguous() \
        and occ.is_contiguous() and tp_last.is_contiguous() \
        and t_last.is_contiguous() and tid.shape == tsi.shape == occ.shape \
        and t_last.shape == tp_last.shape \
        and tp_last.shape[:-1] == tsi.shape[:-1] \
        and tid.get_device() == occ.get_device() == di \
        and tp_last.get_device() == t_last.get_device() == di


def _check_tables(ndim: int, dev: torch.device, tsi, tid, occ, tp_last,
                  t_last) -> None:
    _check("tsi", tsi, torch.float32, ndim, dev)
    _check("tid", tid, torch.int32, ndim, dev)
    _check("occ", occ, torch.int32, ndim, dev)
    _check("tp_last", tp_last, torch.float32, ndim, dev)
    _check("t_last", t_last, torch.int32, ndim, dev)
    if tid.shape != tsi.shape or occ.shape != tsi.shape \
            or t_last.shape != tp_last.shape \
            or tp_last.shape[:-1] != tsi.shape[:-1]:
        raise ValueError("victim_value: slot tables of one shape and topic "
                         "tables of one shape, one row a policy, expected; "
                         f"got {tuple(tsi.shape)} {tuple(tid.shape)} "
                         f"{tuple(occ.shape)} {tuple(tp_last.shape)} "
                         f"{tuple(t_last.shape)}")


def victim_value(tsi: torch.Tensor, tid: torch.Tensor, occ: torch.Tensor,
                 tp_last: torch.Tensor, t_last: torch.Tensor, t_now: int,
                 alpha: float) -> torch.Tensor:
    """tsi (N,) f32; tid (N,) i32 (-1 = free); occ (N,) i32 (0 = free ->
    +inf); tp_last (T,) f32, t_last (T,) i32 topic tables; ``t_now`` a
    runtime int.  Returns (N,) f32."""
    global launches, vec_launches
    di = tsi.get_device() if tsi.is_cuda else -1
    if not _tables_ok(di, 1, tsi, tid, occ, tp_last, t_last):
        _check_tables(1, tsi.device, tsi, tid, occ, tp_last, t_last)
    if di < 0:
        if tsi.device.type == "cpu":
            return ref.victim_value_ref(tsi, tid, occ, tp_last, t_last,
                                        int(t_now), alpha)
        raise ValueError(f"victim_value: unsupported device {tsi.device}")
    n, n_topics = tsi.shape[0], tp_last.shape[0]
    out = torch.empty_like(tsi)
    if n == 0:
        return out
    if n_topics == 0:
        raise ValueError("victim_value: empty topic tables")
    args, vec = eq1_args(KIND_VICTIM, tsi, tid, occ, tp_last, t_last, out,
                         n, n_topics, 1, int(t_now), 0.0, -alpha)
    _build.check(_build.library().victim_value_launch(args), "victim_value")
    launches += 1
    vec_launches += vec
    return out


def victim_value_multi(tsi: torch.Tensor, tid: torch.Tensor,
                       occ: torch.Tensor, tp_last: torch.Tensor,
                       t_last: torch.Tensor, t_now: int,
                       alpha: float) -> torch.Tensor:
    """Policy-stacked :func:`victim_value`: slot tables tsi (P, N) f32,
    tid (P, N) i32, occ (P, N) i32; topic tables tp_last (P, T) f32,
    t_last (P, T) i32; one shared runtime ``t_now``.  Returns (P, N) f32
    from ONE launch (the policy is a grid axis)."""
    global multi_launches, multi_vec_launches
    di = tsi.get_device() if tsi.is_cuda else -1
    if not _tables_ok(di, 2, tsi, tid, occ, tp_last, t_last):
        _check_tables(2, tsi.device, tsi, tid, occ, tp_last, t_last)
    n_pol, n = tsi.shape
    if n_pol == 0:
        raise ValueError("victim_value_multi: P >= 1 policies expected")
    if di < 0:
        if tsi.device.type == "cpu":
            return ref.victim_value_multi_ref(tsi, tid, occ, tp_last,
                                              t_last, int(t_now), alpha)
        raise ValueError(f"victim_value_multi: unsupported device "
                         f"{tsi.device}")
    n_topics = tp_last.shape[1]
    out = torch.empty_like(tsi)
    if n == 0:
        return out
    if n_topics == 0:
        raise ValueError("victim_value_multi: empty topic tables")
    args, vec = eq1_args(KIND_VICTIM, tsi, tid, occ, tp_last, t_last, out,
                         n, n_topics, n_pol, int(t_now), 0.0, -alpha)
    _build.check(_build.library().victim_value_launch(args),
                 "victim_value_multi")
    multi_launches += 1
    multi_vec_launches += vec
    return out


def floor_launch(args: bytes) -> None:
    """Launch an empty kernel with the grid, shared memory and attributes
    packed in ``args`` (from :func:`eq1_args`): the launch floor a timing
    stands beside.  Counted nowhere."""
    _build.check(_build.library().eq1_value_floor(args), "eq1_value_floor")
