"""Cosine retrieval kernels and their wrappers: Top-1 (``csrc/sim_top1.cu``)
and Top-K in fp32 (``csrc/sim_topk_f32.cu``) and int8
(``csrc/sim_topk_q8.cu`` on the tensor cores where TMA can read the rows,
else ``csrc/sim_topk.cu`` on ``__dp4a``: :func:`q8_route`), the Top-1 and
the int8 Top-K also stacked over a policy grid axis for the multi-policy
arena.

Replace ``repro/kernels/similarity_topk.py::sim_top1_pallas``,
``::sim_topk_pallas`` and ``::sim_topk_q8_pallas``, and the ``lax.map``
policy stacks over them in ``repro/kernels/ops.py``
(``sim_top1_multi_raw``, ``sim_topk_q8_multi_raw``).  Each wrapper launches
its CUDA kernel for CUDA tensors and takes the plain version
(:mod:`~repro_torch.kernels.ref`) for CPU tensors; anything else raises.
The kernels need no padding: they mask the ragged query, candidate and
depth edges themselves.  The fp32 Top-K also takes rows a stride apart
(the routing matrix's device mirror pads its rows to a 16-byte pitch).
Each wrapper counts its own launches.

The Top-1 kernels score in three-way TF32 on the tensor cores (the split
and its error bound in ``csrc/sim_top1.cu``): one arithmetic for every
shape, so a (query, row) pair scores the same bits whatever launched it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

#: kernel launches made by :func:`sim_top1` (plain integer; reset freely)
launches = 0
#: the part of ``launches`` whose count ``n_valid`` was read on the card
dev_n_valid_launches = 0
#: kernel launches made by :func:`sim_topk` (fp32 Top-K)
topk_launches = 0
#: the part of ``topk_launches`` that ran on the ring kernels of
#: ``csrc/sim_topk_f32.cu`` (the file holds every fp32 Top-K kernel, so a
#: run that counts fewer went elsewhere)
topk_f32_launches = 0
#: kernel launches made by :func:`sim_topk_q8` (int8 Top-K)
topk_q8_launches = 0
#: the part of ``topk_q8_launches`` that ran on the ``wgmma`` kernel
topk_q8_wgmma_launches = 0
#: kernel launches made by :func:`sim_top1_multi` (one per stacked call)
multi_launches = 0
#: kernel launches made by :func:`sim_topk_q8_multi` (one per stacked call)
topk_q8_multi_launches = 0
#: the part of ``topk_q8_multi_launches`` that ran on the ``wgmma`` kernel
topk_q8_multi_wgmma_launches = 0

# blocks to aim for: a few waves over the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132
# the two tile shapes of the Top-K kernels (query rows x candidate cols);
# the Top-1 kernel has one, the wide one
_SMALL_TILE, _WIDE_TILE = (8, 128), (64, 64)
# a Top-K block keeps its K-lists in shared memory up to this many bytes
_LIST_SMEM = 16384
# the int8 wgmma kernel keeps its query tile resident: D up to this
_WGMMA_MAX_D = 1024
# the fp32 Top-K (csrc/sim_topk_f32.cu): queries up to this take the skinny
# kernel (32-row warp tiles, up to four warps a block), more the wide one
# (128 x 128 tiles)
_F32_SKINNY_Q, _F32_ROWS, _F32_MAX_WARPS, _F32_WIDE = 16, 32, 4, 128


def q8_route(d: int, *ptrs: int) -> str:
    """The kernel an int8 Top-K call of depth ``d`` over operands at the
    data pointers ``ptrs`` runs on: ``"wgmma"`` (``csrc/sim_topk_q8.cu``)
    where TMA can read the rows, i.e. ``d`` a multiple of 16 (the row
    stride TMA takes), at most 1,024 (the resident query tile) and every
    base 16-byte aligned; ``"dp4a"`` (``csrc/sim_topk.cu``) otherwise.  By
    shape alone, never on a failure."""
    if d % 16 == 0 and 0 < d <= _WGMMA_MAX_D \
            and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "dp4a"


def split_plan(nq: int, nc: int, small: bool, min_cols: int = 1,
               groups: int = 1, wave: int | None = None) -> tuple[int, int]:
    """(splits, candidate tiles per split) for the split-N grid: enough
    splits that ``query tiles x groups x splits`` fills the card, never
    more than there are candidate tiles, and none with fewer than
    ``min_cols`` candidates (a Top-K split should hold more than its K).
    ``groups`` is the number of stacked slabs sharing the grid.  With
    ``wave`` (the blocks the card holds at once) the grid stops at one
    wave where the query tiles leave room: the longest splits that fill
    it, and no block waits for a second wave."""
    rows, cols = _SMALL_TILE if small else _WIDE_TILE
    q_tiles = -(-nq // rows) * groups
    c_tiles = max(1, -(-nc // cols))
    fill = wave // q_tiles if wave else -(-_TARGET_BLOCKS // q_tiles)
    want = max(1, min(c_tiles, fill, nc // max(1, min_cols)))
    per = -(-c_tiles // want)
    return -(-c_tiles // per), per


def f32_plan(nq: int, limit: int, k: int, n_sm: int,
             wave) -> tuple[int, int, int]:
    """(warps a block, splits, tiles a split) of the fp32 Top-K over
    ``limit`` live candidates; ``wave(warps)`` is the blocks the card holds
    at once with that many warps a block.  Q <= 16 (the skinny kernel):
    32-row tiles, four warps a block where there are four tiles an SM and
    fewer below, so a short matrix still spreads over the card; Q > 16 (the
    wide kernel): 128 x 128 tiles over the query tiles.  Either way one
    wave of blocks, none with fewer than K candidates (a split's list
    should fill)."""
    skinny = nq <= _F32_SKINNY_Q
    tiles = max(1, -(-limit // (_F32_ROWS if skinny else _F32_WIDE)))
    warps = max(1, min(_F32_MAX_WARPS, tiles // n_sm)) if skinny else 1
    q_tiles = 1 if skinny else -(-nq // _F32_WIDE)
    want = max(1, min(-(-tiles // warps), wave(warps) // q_tiles,
                      limit // k))
    per = -(-tiles // want)
    return warps, -(-tiles // per), per


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device, rows: bool = False) -> None:
    """dtype, rank and device, and contiguity; ``rows``: unit stride along
    each row only, rows any stride apart (not overlapping)."""
    if rows and t.dim() == 2:
        laid = (t.shape[1] <= 1 or t.stride(1) == 1) \
            and (t.shape[0] <= 1 or t.stride(0) >= t.shape[1])
    else:
        laid = t.is_contiguous()
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not laid:
        what = "row-contiguous" if rows else "contiguous"
        raise ValueError(f"{name}: expected a {what} {ndim}-D {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _rows16(t: torch.Tensor) -> bool:
    """Rows a kernel can copy 16 bytes at a time: 16-byte-aligned base
    and a row stride of whole 16-byte units."""
    pitch = t.stride(0) * t.element_size()
    return t.data_ptr() % 16 == 0 and (t.shape[0] <= 1 or pitch % 16 == 0)


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
    nsplit, per = split_plan(nq, nc, small=False)
    part_v = torch.empty((nsplit, nq), dtype=torch.float32, device=dev)
    part_i = torch.empty((nsplit, nq), dtype=torch.int32, device=dev)
    host_nv = nc if on_dev else max(-1, min(int(n_valid), nc))
    lib = _build.library()
    _build.check(lib.sim_top1_launch(
        queries.data_ptr(), candidates.data_ptr(), nq, nc, d, host_nv,
        n_valid.data_ptr() if on_dev else None, nsplit, per,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, _build.stream_of(candidates)), "sim_top1")
    launches += 1
    dev_n_valid_launches += on_dev
    return vals, idx


_WAVES: dict = {}
_F32_SLOTS: dict = {}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _f32_slots(dev: torch.device, nq: int, d: int, k: int, warps: int,
               vec: bool) -> tuple[int, bool]:
    """The blocks of an fp32 Top-K launch the card holds at once, and
    whether its K > 32 lists fit in shared memory: asked of the card once
    per shape (``sim_topk_f32_slots``)."""
    # the kernel and its shared memory follow the query rows it pads to
    rows = 1 << (nq - 1).bit_length() if nq <= _F32_SKINNY_Q else _F32_WIDE
    key = (dev.index, rows, d, k, warps, vec)
    if key not in _F32_SLOTS:
        slots, in_smem = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(_build.library().sim_topk_f32_slots(
            nq, d, k, warps, int(vec), dev.index, ctypes.addressof(slots),
            ctypes.addressof(in_smem)), "sim_topk_f32_slots")
        _F32_SLOTS[key] = (max(1, slots.value), bool(in_smem.value))
    return _F32_SLOTS[key]


def _topk_f32(q: torch.Tensor, c: torch.Tensor, n_valid: int, k: int):
    """The fp32 Top-K launch (``csrc/sim_topk_f32.cu``); False when there
    was nothing to launch."""
    dev = c.device
    nq, d = q.shape
    nc = c.shape[0]
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return (vals, idx), False
    limit = max(0, min(int(n_valid), nc))
    # the skinny kernel copies only the candidates, the wide one both
    vec = _rows16(c) and (nq <= _F32_SKINNY_Q or _rows16(q))
    warps, nsplit, per = f32_plan(
        nq, limit, k, _sm_count(dev.index),
        lambda w: _f32_slots(dev, nq, d, k, w, vec)[0])
    in_smem = _f32_slots(dev, nq, d, k, warps, vec)[1]
    part_v = torch.empty((nsplit, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nsplit, nq, k), dtype=torch.int32, device=dev)
    lists = None
    if k > 32 and not in_smem:  # two buffers of k entries a row
        skinny = nq <= _F32_SKINNY_Q
        rows = 1 << (nq - 1).bit_length() if skinny else _F32_WIDE
        blocks = nsplit * (1 if skinny else -(-nq // _F32_WIDE))
        lists = torch.empty(blocks * rows * 4 * k, dtype=torch.float32,
                            device=dev)
    _build.check(_build.library().sim_topk_f32_launch(
        q.data_ptr(), q.stride(0), c.data_ptr(), c.stride(0), nq, nc, d,
        limit, k, int(vec), warps, nsplit, per, int(in_smem),
        None if lists is None else lists.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), dev.index,
        _build.stream_of(c)), "sim_topk_f32")
    return (vals, idx), True


def _wgmma_wave(dev: torch.device, d: int, k: int, in_smem: bool,
                multi: bool) -> int:
    """The blocks of the int8 wgmma kernel the card holds at once for this
    depth and K (its shared memory bounds the blocks an SM), asked of the
    card once per shape."""
    key = (dev.index, d, k, in_smem, multi)
    if key not in _WAVES:
        slots = ctypes.c_int(0)
        _build.check(_build.library().sim_topk_q8_wgmma_slots(
            d, k, int(in_smem), int(multi), dev.index,
            ctypes.addressof(slots)), "sim_topk_q8_wgmma_slots")
        _WAVES[key] = max(1, slots.value)
    return _WAVES[key]


def _topk_q8_launch(q, c, qscale, cscale, n_valid, k: int, counts=None):
    """Shared launch of the single-slab and stacked int8 Top-K.  With
    ``counts`` (a (P,) int32 tensor on the card) ``c`` is a (P, S, D)
    stack, ``cscale`` (P, S), and the outputs are (P, Q, K).  Returns the
    outputs and the kernel that ran: ``"dp4a"`` or ``"wgmma"``
    (:func:`q8_route`), or None when there was nothing to launch."""
    dev = c.device
    nq, d = q.shape
    n_pol = 1 if counts is None else c.shape[0]
    nc = c.shape[-2]
    shape = (nq, k) if counts is None else (n_pol, nq, k)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    route = q8_route(d, q.data_ptr(), c.data_ptr())
    wgmma = route == "wgmma"
    if nq == 0:
        return (vals, idx), None
    # the wgmma kernel has one tile shape, the wide one
    small = nq <= 16 and not wgmma
    # stacked counts live on the card: plan the splits for full slabs, the
    # P slabs sharing one grid's worth of blocks (a Top-K block folds many
    # tiles into its lists, so long splits pay; measured on an H100,
    # ``PERF.md``)
    limit = nc if counts is not None else max(0, min(int(n_valid), nc))
    rows = (_SMALL_TILE if small else _WIDE_TILE)[0]
    in_smem = rows * k * 8 <= _LIST_SMEM
    wave = _wgmma_wave(dev, d, k, in_smem, counts is not None) if wgmma \
        else None
    nsplit, per = split_plan(nq, max(limit, 1), small, min_cols=2 * k,
                             groups=n_pol, wave=wave)
    part_v = torch.empty((n_pol, nsplit, nq, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((n_pol, nsplit, nq, k), dtype=torch.int32,
                         device=dev)
    # 16-byte int8 loads need whole 16-byte rows on 16-byte boundaries
    vec = d % 16 == 0 and q.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
    lib = _build.library()
    scales = (qscale.data_ptr(), cscale.data_ptr())
    outs = (part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), dev.index, _build.stream_of(c))
    tail = (k, int(small), nsplit, per, int(in_smem), *outs)
    if wgmma:
        err = lib.sim_topk_q8_wgmma_launch(
            q.data_ptr(), c.data_ptr(), *scales, nq, nc, d,
            limit if counts is None else 0,
            None if counts is None else counts.data_ptr(),
            0 if counts is None else n_pol, k, nsplit, per, int(in_smem),
            *outs)
    elif counts is None:
        err = lib.sim_topk_launch(q.data_ptr(), c.data_ptr(), *scales,
                                  int(vec), nq, nc, d, limit, *tail)
    else:
        err = lib.sim_topk_multi_launch(q.data_ptr(), c.data_ptr(), *scales,
                                        int(vec), nq, nc, d,
                                        counts.data_ptr(), n_pol, *tail)
    _build.check(err, "sim_topk")
    return (vals, idx), route


def _check_k(k: int, nc: int) -> None:
    if not 1 <= k <= nc:
        raise ValueError(f"k={k} must lie in [1, {nc}] (the candidates)")


def sim_topk(queries: torch.Tensor, candidates: torch.Tensor, n_valid: int,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D) f32, candidates (N, D) f32 -> (vals (Q, K) f32,
    idx (Q, K) i32), each row sorted descending with ties toward the lower
    index.  Columns at or past ``n_valid`` score -inf; a row with fewer
    than K live columns ends in (-inf, any index).  Any 1 <= K <= N.  Both
    operands may be row-major views whose rows lie a stride apart; every
    score is one fp32 fmaf chain in ascending depth, the same bits for a
    pair whatever the launch."""
    global topk_launches, topk_f32_launches
    dev = candidates.device
    _check("queries", queries, torch.float32, 2, dev, rows=True)
    _check("candidates", candidates, torch.float32, 2, dev, rows=True)
    _check_pair(queries, candidates)
    _check_k(k, candidates.shape[0])
    if dev.type == "cpu":
        return ref.sim_topk_ref(queries, candidates, int(n_valid), k)
    if dev.type != "cuda":
        raise ValueError(f"sim_topk: unsupported device {dev}")
    out, ran = _topk_f32(queries, candidates, n_valid, k)
    topk_launches += ran
    topk_f32_launches += ran
    return out


def sim_topk_q8(q8: torch.Tensor, qscale: torch.Tensor, c8: torch.Tensor,
                cscale: torch.Tensor, n_valid: int,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K over per-row-quantized rows: ``q8`` (Q, D) int8 with
    ``qscale`` (Q,) f32, ``c8`` (N, D) int8 with ``cscale`` (N,) f32.
    Scores are ``(float(q8 . c8) * qscale) * cscale``, bit-equal to the
    plain version; order, ties and masking as :func:`sim_topk`."""
    global topk_q8_launches, topk_q8_wgmma_launches
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
    out, route = _topk_q8_launch(q8, c8, qscale, cscale, n_valid, k)
    topk_q8_launches += route is not None
    topk_q8_wgmma_launches += route == "wgmma"
    return out


def _check_counts(n_valid: torch.Tensor, n_pol: int,
                  device: torch.device) -> None:
    if not isinstance(n_valid, torch.Tensor):
        raise ValueError("n_valid: expected a (P,) int32 tensor")
    _check("n_valid", n_valid, torch.int32, 1, device)
    if n_pol < 1 or n_valid.shape[0] != n_pol:
        raise ValueError(f"n_valid: expected one count for each of the "
                         f"{n_pol} (>= 1) slabs, got {n_valid.shape[0]}")


def sim_top1_multi(queries: torch.Tensor, slabs: torch.Tensor,
                   n_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Policy-stacked Top-1: queries (B, D) f32, slabs (P, S, D) f32,
    n_valid (P,) int32 on the slabs' device -> (vals (P, B) f32,
    idx (P, B) i32).  Slice p is :func:`sim_top1` of slab p under count
    ``n_valid[p]`` (bit-equal on the card), from ONE launch: the policy is
    a grid axis and the kernel reads each count itself."""
    global multi_launches
    dev = slabs.device
    _check("queries", queries, torch.float32, 2, dev)
    _check("slabs", slabs, torch.float32, 3, dev)
    n_pol, n_slots, d = slabs.shape
    _check_counts(n_valid, n_pol, dev)
    if queries.shape[1] != d:
        raise ValueError(f"width mismatch: {tuple(queries.shape)} vs "
                         f"{tuple(slabs.shape)}")
    if dev.type == "cpu":
        return ref.sim_top1_multi_ref(queries, slabs, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"sim_top1_multi: unsupported device {dev}")
    nq = queries.shape[0]
    vals = torch.empty((n_pol, nq), dtype=torch.float32, device=dev)
    idx = torch.empty((n_pol, nq), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    if n_slots == 0:
        return vals.fill_(float("-inf")), idx.zero_()
    # each policy gets the splits a single-slab launch would: P times the
    # blocks, so the grid's last wave is a small share of it (fewer,
    # longer splits measured slower on an H100, ``PERF.md``)
    nsplit, per = split_plan(nq, n_slots, small=False)
    part_v = torch.empty((n_pol, nsplit, nq), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((n_pol, nsplit, nq), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.check(lib.sim_top1_multi_launch(
        queries.data_ptr(), slabs.data_ptr(), nq, n_slots, d,
        n_valid.data_ptr(), n_pol, nsplit, per,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, _build.stream_of(slabs)), "sim_top1_multi")
    multi_launches += 1
    return vals, idx


def sim_topk_q8_multi(q8: torch.Tensor, qscale: torch.Tensor,
                      slabs8: torch.Tensor, cscales: torch.Tensor,
                      n_valid: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Policy-stacked int8 Top-K: q8 (B, D) int8 with qscale (B,) f32,
    slabs8 (P, S, D) int8 with cscales (P, S) f32, n_valid (P,) int32 on
    the slabs' device -> (vals (P, B, K) f32, idx (P, B, K) i32).  Slice p
    is :func:`sim_topk_q8` of slab p under count ``n_valid[p]``, from ONE
    launch (the policy is a grid axis)."""
    global topk_q8_multi_launches, topk_q8_multi_wgmma_launches
    dev = slabs8.device
    _check("q8", q8, torch.int8, 2, dev)
    _check("qscale", qscale, torch.float32, 1, dev)
    _check("slabs8", slabs8, torch.int8, 3, dev)
    _check("cscales", cscales, torch.float32, 2, dev)
    n_pol, n_slots, d = slabs8.shape
    _check_counts(n_valid, n_pol, dev)
    if q8.shape[1] != d:
        raise ValueError(f"width mismatch: {tuple(q8.shape)} vs "
                         f"{tuple(slabs8.shape)}")
    if qscale.shape[0] != q8.shape[0] \
            or tuple(cscales.shape) != (n_pol, n_slots):
        raise ValueError("one scale per row expected")
    _check_k(k, n_slots)
    if dev.type == "cpu":
        return ref.sim_topk_q8_multi_ref(q8, qscale, slabs8, cscales,
                                         n_valid, k)
    if dev.type != "cuda":
        raise ValueError(f"sim_topk_q8_multi: unsupported device {dev}")
    out, route = _topk_q8_launch(q8, slabs8, qscale, cscales, 0, k,
                              counts=n_valid)
    topk_q8_multi_launches += route is not None
    topk_q8_multi_wgmma_launches += route == "wgmma"
    return out
