"""Per-eviction RAC Eq. 1 scoring: ``csrc/rac_value.cu`` and its wrapper.

Replaces ``repro/kernels/rac_value.py::rac_value_pallas``.  Like the TPU
kernel it takes ``t_last`` as f32 and subtracts after the cast.  The
wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.rac_value_ref`) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .similarity_topk import _check

#: kernel launches made by :func:`rac_value` (plain integer)
launches = 0


def rac_value(tsi: torch.Tensor, tid: torch.Tensor, tp_last: torch.Tensor,
              t_last: torch.Tensor, alpha: float,
              t_now: int) -> torch.Tensor:
    """tsi (N,) f32; tid (N,) i32; tp_last (T,) f32, t_last (T,) f32 topic
    tables.  Returns (N,) f32."""
    global launches
    dev = tsi.device
    _check("tsi", tsi, torch.float32, 1, dev)
    _check("tid", tid, torch.int32, 1, dev)
    _check("tp_last", tp_last, torch.float32, 1, dev)
    _check("t_last", t_last, torch.float32, 1, dev)
    if dev.type == "cpu":
        return ref.rac_value_ref(tsi, tid, tp_last, t_last, alpha, t_now)
    if dev.type != "cuda":
        raise ValueError(f"rac_value: unsupported device {dev}")
    n, n_topics = tsi.shape[0], tp_last.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    if n_topics == 0:
        raise ValueError("rac_value: empty topic tables")
    lib = _build.library()
    _build.check(lib.rac_value_launch(
        tsi.data_ptr(), tid.data_ptr(), tp_last.data_ptr(), t_last.data_ptr(),
        n, n_topics, float(t_now), -float(alpha), out.data_ptr(), dev.index,
        _build.stream_of(tsi)), "rac_value")
    launches += 1
    return out
