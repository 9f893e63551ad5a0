"""Public dispatch wrappers around the CUDA kernels.

The counterparts of ``repro/kernels/ops.py``'s main-path entry points,
with the same signatures apart from ``use_pallas``/``interpret``: the
device is the device of the tensors passed in (numpy inputs follow the
first tensor argument, or the CPU when there is none).  On the CPU every
kernel wrapper takes its plain version; on a CUDA device it launches its
kernel or raises.  The kernels mask ragged edges themselves, so nothing
is padded and every output has the caller's shapes.

``dispatch_stats`` is the process-global launch/transfer ledger:
``launches`` counts one per public wrapper call (one fused dispatch each,
as in the reference; the kernel modules' own ``launches`` counters count
real kernel launches), ``host_syncs`` counts device->host
materializations, and ``kernel_s`` accumulates the blocked-on-device wall
time of ``run_timed`` intervals.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .decision import victim_value as _victim_value
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .decision import victim_value_multi as _victim_value_multi
from .rac_value import rac_value as _rac_value
from .similarity_topk import sim_top1 as _sim_top1
from .similarity_topk import sim_top1_multi as _sim_top1_multi
from .similarity_topk import sim_topk as _sim_topk
from .similarity_topk import sim_topk_q8 as _sim_topk_q8
from .similarity_topk import sim_topk_q8_multi as _sim_topk_q8_multi

dispatch_stats = {"launches": 0, "host_syncs": 0, "kernel_s": 0.0}


def count_launch(n: int = 1) -> None:
    """Tick the dispatch counter (one fused dispatch issued)."""
    dispatch_stats["launches"] += n


def to_host(x):
    """Materialize ``x`` on the host as numpy, counting the sync when it
    is a tensor (numpy inputs pass through uncounted)."""
    if isinstance(x, torch.Tensor):
        dispatch_stats["host_syncs"] += 1
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_host_tuple(xs):
    """Materialize a tuple of tensors as ONE counted sync — the fused
    decision pass's single device->host transfer per chunk."""
    dispatch_stats["host_syncs"] += 1
    return tuple(x.detach().cpu().numpy() for x in xs)


def _synchronize(out) -> None:
    flat = out if isinstance(out, (tuple, list)) else (out,)
    for x in flat:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def run_timed(fn, tracker=None, name: str = "kernel"):
    """Run ``fn`` (a zero-arg closure dispatching device work), wait for
    the device (``torch.cuda.synchronize``), and charge the interval to
    ``dispatch_stats["kernel_s"]``; with a tracker attached the interval
    is also emitted as a trace span."""
    t0 = time.perf_counter()
    out = fn()
    _synchronize(out)
    t1 = time.perf_counter()
    dispatch_stats["kernel_s"] += t1 - t0
    if tracker is not None:
        tracker.add_span(f"kernel/{name}", t0, t1)
    return out


def _counted(fn):
    """Wrap a public dispatch wrapper so every call ticks ``launches``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        count_launch()
        return fn(*args, **kwargs)

    return wrapper


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _as(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous tensor of ``dtype`` on ``device`` (``x`` itself
    when it already is one)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == dtype and x.device == device and x.is_contiguous():
            return x
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


def _counts(n_valid, n_pol: int, n_slots: int,
            dev: torch.device) -> torch.Tensor:
    """Per-policy counts as a (P,) int32 tensor on ``dev`` (default: every
    slot), the stacked kernels' device-read ``n_valid``."""
    if n_valid is None:
        n_valid = np.full(n_pol, n_slots, dtype=np.int32)
    return _as(n_valid, torch.int32, dev).reshape(n_pol)


def _sim_top1_raw(queries, candidates, n_valid, dev):
    c = _as(candidates, torch.float32, dev)
    if n_valid is None:
        n_valid = c.shape[0]
    elif not isinstance(n_valid, torch.Tensor):
        n_valid = int(n_valid)
    return _sim_top1(_as(queries, torch.float32, dev), c, n_valid)


def _rows(x, dev: torch.device) -> torch.Tensor:
    """``x`` as float32 rows on ``dev``: a float32 tensor there whose rows
    are unit-stride is taken as it is (a padded mirror's view keeps its
    pitch), anything else as :func:`_as`."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32 \
            and x.device == dev and x.dim() == 2 \
            and (x.shape[1] <= 1 or x.stride(1) == 1):
        return x
    return _as(x, torch.float32, dev)


def sim_topk_raw(queries, candidates, n_valid, k: int):
    """Uncounted Top-K body, shared with :func:`route_topics` and the
    fused lookup (the device is the candidates')."""
    dev = _device_of(candidates, queries)
    c = _rows(candidates, dev)
    n_valid = c.shape[0] if n_valid is None else int(n_valid)
    return _sim_topk(_rows(queries, dev), c, n_valid, int(k))


def route_topics_raw(queries, reps_aug, n_valid, k: int):
    """Uncounted routing body: augment each query with its L2 norm and
    Top-K the (T, D+1) bound matrix ``[rep | spread]``, so the product is
    ``q . rep_t + |q| * spread_t`` (see :mod:`repro_torch.cache.pruned`).
    The augmented queries get the routing mirror's 16-byte row pitch."""
    qf = _as(queries, torch.float32, _device_of(reps_aug, queries))
    b, d = qf.shape
    qa = qf.new_zeros((b, -(-(d + 1) // 4) * 4))
    qa[:, :d] = qf
    qa[:, d] = torch.sqrt((qf * qf).sum(dim=1))
    return sim_topk_raw(qa[:, :d + 1], reps_aug, n_valid, k)


def sim_topk_q8_raw(q8, qscale, c8, cscale, n_valid, k: int):
    """Uncounted quantized Top-K body, shared with the fused lookup."""
    dev = _device_of(c8, q8)
    c = _as(c8, torch.int8, dev)
    n_valid = c.shape[0] if n_valid is None else int(n_valid)
    return _sim_topk_q8(_as(q8, torch.int8, dev),
                        _as(qscale, torch.float32, dev), c,
                        _as(cscale, torch.float32, dev), n_valid, int(k))


def _victim_value_raw(tsi, tid, occ, tp_last, t_last, t_now, alpha, dev):
    return _victim_value(_as(tsi, torch.float32, dev),
                         _as(tid, torch.int32, dev),
                         _as(occ, torch.int32, dev),
                         _as(tp_last, torch.float32, dev),
                         _as(t_last, torch.int32, dev), int(t_now),
                         float(alpha))


def _rac_value_raw(tsi, tid, tp_last, t_last, alpha, t_now, dev,
                   valid=None):
    # t_last goes in as f32, as the TPU kernel's caller casts it; an int32
    # tensor (the backend's shifted table) is cast by the kernel itself
    i32 = isinstance(t_last, torch.Tensor) and t_last.dtype == torch.int32
    return _rac_value(_as(tsi, torch.float32, dev),
                      _as(tid, torch.int32, dev),
                      _as(tp_last, torch.float32, dev),
                      _as(t_last, torch.int32 if i32 else torch.float32, dev),
                      float(alpha), int(t_now),
                      None if valid is None else _as(valid, torch.bool, dev))


@_counted
def sim_top1(queries, candidates, n_valid=None):
    """Top-1 cosine retrieval: (Q,D)x(N,D) -> (vals (Q,), idx (Q,)).

    ``n_valid`` (default: all of ``candidates``) is the runtime resident
    count: rows at or past it score -inf.  It may be a 1-element int32
    tensor on the candidates' device, read by the kernel itself."""
    return _sim_top1_raw(queries, candidates, n_valid,
                         _device_of(candidates, queries))


@_counted
def sim_topk(queries, candidates, k: int, n_valid=None):
    """Top-K cosine retrieval: (Q,D)x(N,D) -> (vals (Q,K), idx (Q,K)),
    sorted descending with ties toward the lower candidate index (any
    1 <= K <= N).  ``n_valid`` masks the free tail: rows at or past it come
    back as (-inf, any index) — callers map them to (-inf, -1)."""
    return sim_topk_raw(queries, candidates, n_valid, k)


@_counted
def route_topics(queries, reps_aug, probes: int, n_valid=None):
    """Stage-1 routing of the pruned lookup: (Q,D)x(T,D+1) ->
    (bounds (Q,K), tids (Q,K)), K = min(probes+1, T), sorted descending.

    ``reps_aug`` row ``t`` is ``[rep_t | spread_t]``, so scoring the
    norm-augmented query yields each topic's Cauchy–Schwarz score bound;
    the leading ``probes`` columns are the probe set and column ``probes``
    (when present) bounds every unprobed topic.  ``n_valid`` masks
    retired and unborn topic rows to (-inf, any index)."""
    if n_valid is None:
        n_valid = reps_aug.shape[0]
    k = int(min(probes + 1, reps_aug.shape[0]))
    return route_topics_raw(queries, reps_aug, n_valid, k)


@_counted
def sim_topk_q8(q8, qscale, c8, cscale, k: int, n_valid=None):
    """Quantized-slab Top-K candidate generation: (Q,D)i8 x (N,D)i8 ->
    (vals (Q,K), idx (Q,K)) of approximate fp32 similarities
    ``(acc * qscale) * cscale``, same order and tie rule as
    :func:`sim_topk`.  ``k`` is clamped to the candidate count."""
    return sim_topk_q8_raw(q8, qscale, c8, cscale, n_valid,
                           int(min(k, c8.shape[0])))


@_counted
def sim_top1_multi(queries, slabs, n_valid=None):
    """Policy-stacked Top-1 retrieval: (B,D)x(P,N,D) -> ((P,B), (P,B)).

    The batched-over-policy variant of :func:`sim_top1` behind the
    multi-policy arena: ONE dispatch (one kernel launch, the policy a grid
    axis) scores a query chunk against every policy's resident slab, with
    a per-policy count ``n_valid`` (P,) masking each slab's free tail
    (default: every slot).  Slice p is what :func:`sim_top1` gives for
    slab p."""
    dev = _device_of(slabs, queries)
    s = _as(slabs, torch.float32, dev)
    return _sim_top1_multi(_as(queries, torch.float32, dev), s,
                           _counts(n_valid, s.shape[0], s.shape[1], dev))


@_counted
def sim_topk_q8_multi(q8, qscale, slabs8, cscales, k: int, n_valid=None):
    """Policy-stacked quantized Top-K: (B,D)i8 x (P,N,D)i8 ->
    ((P,B,K), (P,B,K)) — the quantized arena's stacked scan on the
    4x-smaller slab, one dispatch.  ``k`` is clamped to the slot-axis
    width like :func:`sim_topk_q8`; ``n_valid`` (P,) as in
    :func:`sim_top1_multi`."""
    dev = _device_of(slabs8, q8)
    s8 = _as(slabs8, torch.int8, dev)
    n_pol, n_slots = s8.shape[0], s8.shape[1]
    return _sim_topk_q8_multi(
        _as(q8, torch.int8, dev), _as(qscale, torch.float32, dev), s8,
        _as(cscales, torch.float32, dev),
        _counts(n_valid, n_pol, n_slots, dev), int(min(k, n_slots)))


@_counted
def victim_value_multi(tsi, tid, occ, tp_last, t_last, t_now, *,
                       alpha: float):
    """Policy-stacked occupancy-masked Eq.1: ``tsi``/``tid``/``occ`` are
    (P, N) slot tables, ``tp_last``/``t_last`` (P, T) topic tables, and
    ``t_now`` the one shared clock; returns (P, N) victim values (free
    slots +inf) from one dispatch — the multi-policy analogue of
    :func:`victim_value`."""
    dev = _device_of(tsi, tid, occ, tp_last, t_last)
    return _victim_value_multi(_as(tsi, torch.float32, dev),
                               _as(tid, torch.int32, dev),
                               _as(occ, torch.int32, dev),
                               _as(tp_last, torch.float32, dev),
                               _as(t_last, torch.int32, dev), int(t_now),
                               float(alpha))


@_counted
def flash_attention(q, k, v, window: int = 0, causal: bool = True):
    """GQA flash attention: causal (T == S), banded to ``window`` keys when
    it is positive, or, with ``causal=False``, every query over all T keys
    (an encoder's self-attention, cross attention).  q (B,H,S,D); k
    (B,Hkv,T,D); v (B,Hkv,T,Dv) -> (B,H,S,Dv), any S and T (the kernel
    masks the ragged tails: no padding)."""
    return _flash_attention(q, k, v, window, causal)


@_counted
def decode_attention(q, k, v, pos, scale=None):
    """One-token GQA decode.  q (B,H,D); k (B,S,Hkv,D); v (B,S,Hkv,Dv),
    possibly a column-prefix view of k; pos (B,) int32 on the tensors'
    device (read there: no host sync) -> (B,H,Dv); ``scale`` defaults to
    1/sqrt(D)."""
    return _decode_attention(q, k, v, pos, scale)


@_counted
def rac_value(tsi, tid, tp_last, t_last, alpha: float, t_now: int):
    """RAC Eq.1 scoring over the resident table."""
    return _rac_value_raw(tsi, tid, tp_last, t_last, alpha, t_now,
                          _device_of(tsi, tid, tp_last, t_last))


@_counted
def rac_value_masked(tsi, tid, tp_last, t_last, valid, alpha: float,
                     t_now: int):
    """RAC Eq.1 over a block table with a structural-validity mask:
    invalid rows score ``+inf`` so a min-value victim scan never elects
    them.  One kernel launch: the mask is applied in the kernel."""
    dev = _device_of(tsi, tid, tp_last, t_last, valid)
    return _rac_value_raw(tsi, tid, tp_last, t_last, alpha, t_now, dev,
                          valid)


@_counted
def victim_value(tsi, tid, occ, tp_last, t_last, t_now, *, alpha: float):
    """Occupancy-masked RAC Eq.1 over the fixed-shape slot table with a
    runtime ``t_now`` (free slots score +inf)."""
    return _victim_value_raw(tsi, tid, occ, tp_last, t_last, t_now, alpha,
                             _device_of(tsi, tid, occ, tp_last, t_last))


@_counted
def fused_decide(queries, slab, n_valid, reps, n_topics, tsi, tid, occ,
                 tp_last, t_last, t_now, *, alpha: float):
    """One decision dispatch per replay chunk: ``sim_top1`` over the
    resident slab (hit determination, masked to ``n_valid``), ``sim_top1``
    over the dense topic-representative table (Alg. 4 routing, masked to
    ``n_topics``), and the occupancy-masked Eq. 1 victim values.  Three
    kernel launches on one stream; the caller pays one host sync."""
    dev = _device_of(slab, reps, queries)
    hit_vals, hit_idx = _sim_top1_raw(queries, slab, n_valid, dev)
    route_vals, route_idx = _sim_top1_raw(queries, reps, n_topics, dev)
    victim = _victim_value_raw(tsi, tid, occ, tp_last, t_last, t_now,
                               alpha, dev)
    return hit_vals, hit_idx, route_vals, route_idx, victim


@_counted
def decide_aux(queries, reps, n_topics, tsi, tid, occ, tp_last, t_last,
               t_now, *, alpha: float):
    """Routing Top-1 over the topic-representative table plus the
    occupancy-masked Eq.1 victim values in one dispatch (the decide legs
    that remain when the hit leg comes from another scan)."""
    dev = _device_of(reps, queries)
    route_vals, route_idx = _sim_top1_raw(queries, reps, n_topics, dev)
    victim = _victim_value_raw(tsi, tid, occ, tp_last, t_last, t_now,
                               alpha, dev)
    return route_vals, route_idx, victim
