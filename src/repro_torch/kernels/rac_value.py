"""Per-eviction RAC Eq. 1 scoring: ``csrc/rac_value.cu`` and its wrapper.

Replaces ``repro/kernels/rac_value.py::rac_value_pallas`` and, with a
validity mask, the select that ``repro/kernels/ops.py::rac_value_masked``
fuses with it (one launch).  Like the TPU kernel it subtracts after
casting ``t_last`` to f32; ``t_last`` may come as f32 or as int32, which
the kernel casts itself (no cast launch).  The wrapper launches the CUDA
kernel for CUDA tensors (the launch path of
:mod:`~repro_torch.kernels.decision`) and takes the plain version
(:func:`~repro_torch.kernels.ref.rac_value_ref`) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .decision import KIND_RAC_F32, KIND_RAC_I32, eq1_args
from .similarity_topk import _check

#: kernel launches made by :func:`rac_value` (plain integer)
launches = 0
#: of those, the launches whose bases took the vector path
vec_launches = 0

_F32, _I32 = torch.float32, torch.int32


def _check_inputs(dev, tsi, tid, tp_last, t_last, valid) -> None:
    _check("tsi", tsi, _F32, 1, dev)
    _check("tid", tid, _I32, 1, dev)
    _check("tp_last", tp_last, _F32, 1, dev)
    _check("t_last", t_last, _I32 if t_last.dtype is _I32 else _F32, 1, dev)
    if valid is not None:
        _check("valid", valid, torch.bool, 1, dev)
    n = tsi.shape[0]
    if tid.shape[0] != n or t_last.shape[0] != tp_last.shape[0] \
            or (valid is not None and valid.shape[0] != n):
        raise ValueError(f"rac_value: tsi, tid (and valid) of one length and "
                         f"topic tables of one length expected; got {n}, "
                         f"{tid.shape[0]}, {tp_last.shape[0]}, "
                         f"{t_last.shape[0]}")


def rac_value(tsi: torch.Tensor, tid: torch.Tensor, tp_last: torch.Tensor,
              t_last: torch.Tensor, alpha: float, t_now: int,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """tsi (N,) f32; tid (N,) i32; tp_last (T,) f32, t_last (T,) f32 or
    i32 topic tables; ``valid`` None or (N,) bool, False scoring +inf.
    Returns (N,) f32."""
    global launches, vec_launches
    i32 = t_last.dtype is _I32
    # on the card, the common case in few attribute reads; anything else
    # takes the per-tensor checks, which raise with the reason
    di = tsi.get_device() if tsi.is_cuda else -1
    if di < 0 or not (
            tsi.dtype is _F32 and tid.dtype is _I32
            and tp_last.dtype is _F32 and (i32 or t_last.dtype is _F32)
            and tsi.stride() == tid.stride() == tp_last.stride()
            == t_last.stride() == (1,) and tid.shape == tsi.shape
            and t_last.shape == tp_last.shape
            and tid.get_device() == di
            and tp_last.get_device() == t_last.get_device() == di
            and (valid is None or (valid.dtype is torch.bool
                                   and valid.stride() == (1,)
                                   and valid.shape == tsi.shape
                                   and valid.get_device() == di))):
        _check_inputs(tsi.device, tsi, tid, tp_last, t_last, valid)
    if di < 0:
        if tsi.device.type == "cpu":
            vals = ref.rac_value_ref(tsi, tid, tp_last,
                                     t_last.float() if i32 else t_last,
                                     alpha, t_now)
            return vals if valid is None else torch.where(valid, vals,
                                                          float("inf"))
        raise ValueError(f"rac_value: unsupported device {tsi.device}")
    n, n_topics = tsi.shape[0], tp_last.shape[0]
    out = torch.empty_like(tsi)
    if n == 0:
        return out
    if n_topics == 0:
        raise ValueError("rac_value: empty topic tables")
    args, vec = eq1_args(KIND_RAC_I32 if i32 else KIND_RAC_F32, tsi, tid,
                         valid, tp_last, t_last, out, n, n_topics, 1, 0,
                         t_now, -alpha)
    _build.check(_build.library().rac_value_launch(args), "rac_value")
    launches += 1
    vec_launches += vec
    return out
