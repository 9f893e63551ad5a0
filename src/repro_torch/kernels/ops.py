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
from .rac_value import rac_value as _rac_value
from .similarity_topk import sim_top1 as _sim_top1

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
    """``x`` as a contiguous tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


def _sim_top1_raw(queries, candidates, n_valid, dev):
    c = _as(candidates, torch.float32, dev)
    n_valid = c.shape[0] if n_valid is None else int(n_valid)
    return _sim_top1(_as(queries, torch.float32, dev), c, n_valid)


def _victim_value_raw(tsi, tid, occ, tp_last, t_last, t_now, alpha, dev):
    return _victim_value(_as(tsi, torch.float32, dev),
                         _as(tid, torch.int32, dev),
                         _as(occ, torch.int32, dev),
                         _as(tp_last, torch.float32, dev),
                         _as(t_last, torch.int32, dev), int(t_now),
                         float(alpha))


def _rac_value_raw(tsi, tid, tp_last, t_last, alpha, t_now, dev):
    # t_last goes in as f32, as the TPU kernel's caller casts it
    return _rac_value(_as(tsi, torch.float32, dev),
                      _as(tid, torch.int32, dev),
                      _as(tp_last, torch.float32, dev),
                      _as(t_last, torch.float32, dev), float(alpha),
                      int(t_now))


@_counted
def sim_top1(queries, candidates, n_valid=None):
    """Top-1 cosine retrieval: (Q,D)x(N,D) -> (vals (Q,), idx (Q,)).

    ``n_valid`` (default: all of ``candidates``) is the runtime resident
    count: rows at or past it score -inf."""
    return _sim_top1_raw(queries, candidates, n_valid,
                         _device_of(candidates, queries))


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
    them."""
    dev = _device_of(tsi, tid, tp_last, t_last, valid)
    vals = _rac_value_raw(tsi, tid, tp_last, t_last, alpha, t_now, dev)
    return torch.where(_as(valid, torch.bool, dev), vals, float("inf"))


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
