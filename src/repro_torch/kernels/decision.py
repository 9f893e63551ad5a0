"""Occupancy-masked Eq. 1 victim scoring: ``csrc/victim_value.cu`` and its
wrapper.

Replaces ``repro/kernels/decision.py::victim_value_pallas``, the victim leg
of :func:`~repro_torch.kernels.ops.fused_decide`.  The wrapper launches
the CUDA kernel for CUDA tensors and takes the plain version
(:func:`~repro_torch.kernels.ref.victim_value_ref`) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .similarity_topk import _check

#: kernel launches made by :func:`victim_value` (plain integer)
launches = 0


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
