"""Occupancy-masked Eq. 1 victim scoring: ``csrc/victim_value.cu`` and its
wrapper.

Replaces ``repro/kernels/decision.py::victim_value_pallas``, the victim leg
of :func:`~repro_torch.kernels.ops.fused_decide`, and
``::victim_value_multi_pallas``, its ``lax.map`` policy stack
(:func:`victim_value_multi`: a policy grid axis, one launch).  The
wrappers launch the CUDA kernel for CUDA tensors and take the plain
versions (:mod:`~repro_torch.kernels.ref`) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .similarity_topk import _check

#: kernel launches made by :func:`victim_value` (plain integer)
launches = 0
#: kernel launches made by :func:`victim_value_multi` (one per stacked call)
multi_launches = 0


def victim_value(tsi: torch.Tensor, tid: torch.Tensor, occ: torch.Tensor,
                 tp_last: torch.Tensor, t_last: torch.Tensor, t_now: int,
                 alpha: float) -> torch.Tensor:
    """tsi (N,) f32; tid (N,) i32 (-1 = free); occ (N,) i32 (0 = free ->
    +inf); tp_last (T,) f32, t_last (T,) i32 topic tables; ``t_now`` a
    runtime int.  Returns (N,) f32."""
    global launches
    dev = tsi.device
    _check("tsi", tsi, torch.float32, 1, dev)
    _check("tid", tid, torch.int32, 1, dev)
    _check("occ", occ, torch.int32, 1, dev)
    _check("tp_last", tp_last, torch.float32, 1, dev)
    _check("t_last", t_last, torch.int32, 1, dev)
    if dev.type == "cpu":
        return ref.victim_value_ref(tsi, tid, occ, tp_last, t_last,
                                    int(t_now), alpha)
    if dev.type != "cuda":
        raise ValueError(f"victim_value: unsupported device {dev}")
    n, n_topics = tsi.shape[0], tp_last.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    if n_topics == 0:
        raise ValueError("victim_value: empty topic tables")
    lib = _build.library()
    _build.check(lib.victim_value_launch(
        tsi.data_ptr(), tid.data_ptr(), occ.data_ptr(), tp_last.data_ptr(),
        t_last.data_ptr(), n, n_topics, int(t_now), -float(alpha),
        out.data_ptr(), dev.index, _build.stream_of(tsi)), "victim_value")
    launches += 1
    return out


def victim_value_multi(tsi: torch.Tensor, tid: torch.Tensor,
                       occ: torch.Tensor, tp_last: torch.Tensor,
                       t_last: torch.Tensor, t_now: int,
                       alpha: float) -> torch.Tensor:
    """Policy-stacked :func:`victim_value`: slot tables tsi (P, N) f32,
    tid (P, N) i32, occ (P, N) i32; topic tables tp_last (P, T) f32,
    t_last (P, T) i32; one shared runtime ``t_now``.  Returns (P, N) f32
    from ONE launch (the policy is a grid axis)."""
    global multi_launches
    dev = tsi.device
    _check("tsi", tsi, torch.float32, 2, dev)
    _check("tid", tid, torch.int32, 2, dev)
    _check("occ", occ, torch.int32, 2, dev)
    _check("tp_last", tp_last, torch.float32, 2, dev)
    _check("t_last", t_last, torch.int32, 2, dev)
    n_pol, n = tsi.shape
    n_topics = tp_last.shape[1]
    if tid.shape != tsi.shape or occ.shape != tsi.shape \
            or tuple(t_last.shape) != tuple(tp_last.shape) \
            or tp_last.shape[0] != n_pol or n_pol == 0:
        raise ValueError("victim_value_multi: slot tables (P, N) and topic "
                         "tables (P, T), P >= 1, expected")
    if dev.type == "cpu":
        return ref.victim_value_multi_ref(tsi, tid, occ, tp_last, t_last,
                                          int(t_now), alpha)
    if dev.type != "cuda":
        raise ValueError(f"victim_value_multi: unsupported device {dev}")
    out = torch.empty((n_pol, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    if n_topics == 0:
        raise ValueError("victim_value_multi: empty topic tables")
    lib = _build.library()
    _build.check(lib.victim_value_multi_launch(
        tsi.data_ptr(), tid.data_ptr(), occ.data_ptr(), tp_last.data_ptr(),
        t_last.data_ptr(), n, n_topics, n_pol, int(t_now), -float(alpha),
        out.data_ptr(), dev.index, _build.stream_of(tsi)),
        "victim_value_multi")
    multi_launches += 1
    return out
