"""Cosine retrieval kernels and their wrappers: Top-1 (``csrc/sim_top1.cu``)
and Top-K in fp32 and int8 (``csrc/sim_topk.cu``).

Replace ``repro/kernels/similarity_topk.py::sim_top1_pallas``,
``::sim_topk_pallas`` and ``::sim_topk_q8_pallas``.  Each wrapper launches
its CUDA kernel for CUDA tensors and takes the plain version
(:mod:`~repro_torch.kernels.ref`) for CPU tensors; anything else raises.
The kernels need no padding: they mask the ragged query, candidate and
depth edges themselves.  Each wrapper counts its own launches.
"""
from __future__ import annotations

import torch

from . import _build, ref

#: kernel launches made by :func:`sim_top1` (plain integer; reset freely)
launches = 0
#: the part of ``launches`` whose count ``n_valid`` was read on the card
dev_n_valid_launches = 0
#: kernel launches made by :func:`sim_topk` (fp32 Top-K)
topk_launches = 0
#: kernel launches made by :func:`sim_topk_q8` (int8 Top-K)
topk_q8_launches = 0

# blocks to aim for: a few waves over the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132
# the two tile shapes of the kernels (query rows x candidate cols)
_SMALL_TILE, _WIDE_TILE = (8, 128), (64, 64)
# a Top-K block keeps its K-lists in shared memory up to this many bytes
_LIST_SMEM = 16384


def split_plan(nq: int, nc: int, small: bool,
               min_cols: int = 1) -> tuple[int, int]:
    """(splits, candidate tiles per split) for the split-N grid: enough
    splits that ``query tiles x splits`` fills the card, never more than
    there are candidate tiles, and none with fewer than ``min_cols``
    candidates (a Top-K split should hold more than its K)."""
    rows, cols = _SMALL_TILE if small else _WIDE_TILE
    q_tiles = -(-nq // rows)
    c_tiles = max(1, -(-nc // cols))
    want = max(1, min(c_tiles, -(-_TARGET_BLOCKS // q_tiles),
                      nc // max(1, min_cols)))
    per = -(-c_tiles // want)
    return -(-c_tiles // per), per


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_pair(q: torch.Tensor, c: torch.Tensor) -> None:
    if q.shape[1] != c.shape[1]:
        raise ValueError(f"width mismatch: {tuple(q.shape)} vs "
                         f"{tuple(c.shape)}")


def sim_top1(queries: torch.Tensor, candidates: torch.Tensor,
             n_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D) f32, candidates (N, D) f32 -> (vals (Q,) f32,
    idx (Q,) i32).  Columns at or past ``n_valid`` score -inf; ties go to
    the lower index; an all-masked row is ``(-inf, 0)``.

    ``n_valid`` is a host int, or a 1-element int32 tensor on the
    candidates' device that the kernel reads itself (no host sync)."""
    global launches, dev_n_valid_launches
    dev = candidates.device
    _check("queries", queries, torch.float32, 2, dev)
    _check("candidates", candidates, torch.float32, 2, dev)
    _check_pair(queries, candidates)
    on_dev = isinstance(n_valid, torch.Tensor)
    if on_dev and (n_valid.dtype != torch.int32 or n_valid.numel() != 1
                   or n_valid.device != dev):
        raise ValueError(f"n_valid: expected one int32 on {dev}, got "
                         f"{n_valid.dtype} {tuple(n_valid.shape)} on "
                         f"{n_valid.device}")
    if dev.type == "cpu":
        return ref.sim_top1_ref(queries, candidates,
                                n_valid if on_dev else int(n_valid))
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
    host_nv = nc if on_dev else max(-1, min(int(n_valid), nc))
    lib = _build.library()
    _build.check(lib.sim_top1_launch(
        queries.data_ptr(), candidates.data_ptr(), nq, nc, d, host_nv,
        n_valid.data_ptr() if on_dev else None, int(small), nsplit, per,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, _build.stream_of(candidates)), "sim_top1")
    launches += 1
    dev_n_valid_launches += on_dev
    return vals, idx


def _topk_launch(q, c, qscale, cscale, n_valid: int, k: int):
    """Shared launch of the fp32 (``qscale is None``) and int8 Top-K."""
    dev = c.device
    nq, d = q.shape
    nc = c.shape[0]
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    small = nq <= 16
    limit = max(0, min(int(n_valid), nc))
    nsplit, per = split_plan(nq, max(limit, 1), small, min_cols=2 * k)
    rows = (_SMALL_TILE if small else _WIDE_TILE)[0]
    in_smem = rows * k * 8 <= _LIST_SMEM
    part_v = torch.empty((nsplit, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nsplit, nq, k), dtype=torch.int32, device=dev)
    q8 = qscale is not None
    # 16-byte int8 loads need whole 16-byte rows on 16-byte boundaries
    vec = q8 and d % 16 == 0 and q.data_ptr() % 16 == 0 \
        and c.data_ptr() % 16 == 0
    lib = _build.library()
    _build.check(lib.sim_topk_launch(
        q.data_ptr(), c.data_ptr(),
        qscale.data_ptr() if q8 else None, cscale.data_ptr() if q8 else None,
        int(q8), int(vec), nq, nc, d, limit, k, int(small), nsplit, per,
        int(in_smem), part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, _build.stream_of(c)), "sim_topk")
    return vals, idx


def _check_k(k: int, nc: int) -> None:
    if not 1 <= k <= nc:
        raise ValueError(f"k={k} must lie in [1, {nc}] (the candidates)")


def sim_topk(queries: torch.Tensor, candidates: torch.Tensor, n_valid: int,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D) f32, candidates (N, D) f32 -> (vals (Q, K) f32,
    idx (Q, K) i32), each row sorted descending with ties toward the lower
    index.  Columns at or past ``n_valid`` score -inf; a row with fewer
    than K live columns ends in (-inf, any index).  Any 1 <= K <= N."""
    global topk_launches
    dev = candidates.device
    _check("queries", queries, torch.float32, 2, dev)
    _check("candidates", candidates, torch.float32, 2, dev)
    _check_pair(queries, candidates)
    _check_k(k, candidates.shape[0])
    if dev.type == "cpu":
        return ref.sim_topk_ref(queries, candidates, int(n_valid), k)
    if dev.type != "cuda":
        raise ValueError(f"sim_topk: unsupported device {dev}")
    out = _topk_launch(queries, candidates, None, None, n_valid, k)
    topk_launches += 1
    return out


def sim_topk_q8(q8: torch.Tensor, qscale: torch.Tensor, c8: torch.Tensor,
                cscale: torch.Tensor, n_valid: int,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K over per-row-quantized rows: ``q8`` (Q, D) int8 with
    ``qscale`` (Q,) f32, ``c8`` (N, D) int8 with ``cscale`` (N,) f32.
    Scores are ``(float(q8 . c8) * qscale) * cscale``, bit-equal to the
    plain version; order, ties and masking as :func:`sim_topk`."""
    global topk_q8_launches
    dev = c8.device
    _check("q8", q8, torch.int8, 2, dev)
    _check("qscale", qscale, torch.float32, 1, dev)
    _check("c8", c8, torch.int8, 2, dev)
    _check("cscale", cscale, torch.float32, 1, dev)
    _check_pair(q8, c8)
    if qscale.shape[0] != q8.shape[0] or cscale.shape[0] != c8.shape[0]:
        raise ValueError("one scale per row expected")
    _check_k(k, c8.shape[0])
    if dev.type == "cpu":
        return ref.sim_topk_q8_ref(q8, qscale, c8, cscale, int(n_valid), k)
    if dev.type != "cuda":
        raise ValueError(f"sim_topk_q8: unsupported device {dev}")
    out = _topk_launch(q8, c8, qscale, cscale, n_valid, k)
    topk_q8_launches += 1
    return out
