"""Top-1 cosine retrieval: the ``csrc/sim_top1.cu`` kernel and its wrapper.

Replaces ``repro/kernels/similarity_topk.py::sim_top1_pallas``.  The
wrapper launches the CUDA kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.ref.sim_top1_ref`) for CPU tensors;
anything else raises.  The kernel needs no padding: it masks the ragged
query and candidate edges itself.
"""
from __future__ import annotations

import torch

from . import _build, ref

#: kernel launches made by :func:`sim_top1` (plain integer; reset freely)
launches = 0

# blocks to aim for: a few waves over the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132


def split_plan(nq: int, nc: int, small: bool) -> tuple[int, int]:
    """(splits, candidate tiles per split) for the split-N grid: enough
    splits that ``query tiles x splits`` fills the card, never more than
    there are candidate tiles."""
    # the two tile shapes of csrc/sim_top1.cu (query rows x candidate cols)
    rows, cols = (8, 128) if small else (64, 64)
    q_tiles = -(-nq // rows)
    c_tiles = -(-nc // cols)
    want = max(1, min(c_tiles, -(-_TARGET_BLOCKS // q_tiles)))
    per = -(-c_tiles // want)
    return -(-c_tiles // per), per


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def sim_top1(queries: torch.Tensor, candidates: torch.Tensor,
             n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D) f32, candidates (N, D) f32 -> (vals (Q,) f32,
    idx (Q,) i32).  Columns at or past ``n_valid`` score -inf; ties go to
    the lower index; an all-masked row is ``(-inf, 0)``."""
    global launches
    dev = candidates.device
    _check("queries", queries, torch.float32, 2, dev)
    _check("candidates", candidates, torch.float32, 2, dev)
    if queries.shape[1] != candidates.shape[1]:
        raise ValueError(f"width mismatch: {tuple(queries.shape)} vs "
                         f"{tuple(candidates.shape)}")
    if dev.type == "cpu":
        return ref.sim_top1_ref(queries, candidates, int(n_valid))
    if dev.type != "cuda":
        raise ValueError(f"sim_top1: unsupported device {dev}")
    nq, d = queries.shape
    nc = candidates.shape[0]
    vals = torch.empty(nq, dtype=torch.float32, device=dev)
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    if nc == 0:
        return vals.fill_(float("-inf")), idx.zero_()
    small = nq <= 16
    nsplit, per = split_plan(nq, nc, small)
    part_v = torch.empty((nsplit, nq), dtype=torch.float32, device=dev)
    part_i = torch.empty((nsplit, nq), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.check(lib.sim_top1_launch(
        queries.data_ptr(), candidates.data_ptr(), nq, nc, d,
        max(-1, min(int(n_valid), nc)), int(small), nsplit, per,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, _build.stream_of(candidates)), "sim_top1")
    launches += 1
    return vals, idx
