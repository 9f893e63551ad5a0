"""Device-resident fused lookup pipeline (the reference's B6 composition).

One call runs the whole approximate lookup on the card: topic routing
(the ``sim_topk`` kernel) → adaptive probe cap → CSR candidate gather →
int8 candidate scan → fp32 union rescore (the ``sim_top1`` kernel with a
count it reads on the card) → the ``resolve_pruned``/``resolve_topk``
safety predicates.  The pure-quantized body scans the full int8 slab with
the ``sim_topk_q8`` kernel instead of routing and gathering.  The glue
between the kernels is PyTorch tensor code on the same stream, as the
reference leaves it to XLA outside its Pallas kernels.  The host gets back
one compact tuple in ONE sync (winner slot, rescored sim, certification
mask, ledger counts) and exact-rescans only the uncertified rows.

Decision parity
---------------
The predicates move to the card but their arms do not change, and the
certified outputs equal the exact scan's by construction:

* Candidate *selection* is approximate (int8 scores — exact integer
  arithmetic, identical across batch shapes), but every *reported*
  similarity comes from the same per-pair fp32 kernel arithmetic as the
  exact path: the union of all shortlists is sorted by slot id and
  rescored with ``sim_top1``, so a certified winner carries exactly the
  fp32 bits the full-slab scan would have produced, with the same
  lowest-slot tie rule (the union is slot-sorted, and the kernel breaks
  ties toward the lower index).
* The exclusion threshold ``kth + eps`` and the routing bound are
  evaluated in fp32 on the card with an absolute + relative inflation
  (``x + |x|·1e-6 + 1e-6`` after the already-padded ``eps``), so fp32
  rounding can only *add* fallbacks, never certify something the float64
  host predicate would not have.
* ``tau`` comparisons use ``tau_lo`` — the largest float32 strictly below
  ``tau`` — so the device predicate ``v <= tau_lo`` is *exactly* the host
  predicate ``float64(v) < tau`` for any float32 ``v``: every float32 at
  or below ``tau_lo`` is below ``tau``, and the next float32 up is at or
  above it.

The batched int8 product of stage 4 (each query against its own gathered
candidate block) runs as a float64 ``bmm`` of the int8 values: every
partial sum is an integer below 2^53, so it is exact for any D and does
not depend on the TF32 setting; the float32 cast then rounds as an
int32 cast would.

Shape buckets
-------------
The batch is padded to the next power of two (floor 1 — every padded row
pays a full ``cap_c``-row gather, and the serving path is ``b=1``); the
candidate width to a geometric grid (powers of two plus the 1.5×
midpoints, floor 64) sized from the top-``P`` bucket counts and the probe
budget, so a steady-state loop sees few distinct shapes
(:func:`compile_counts` counts them: the counterpart of the reference's
executables, and the shapes a later CUDA graph would capture).  The
reference donates its query buffers to XLA; PyTorch has no counterpart,
and the buffers are freed when the call returns.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ops
from .quant import quantize_rows_int8
from .similarity_topk import sim_top1

#: Shortlist width when the pruned path runs without a composed
#: quantized config (the fused scan is always int8).
DEFAULT_K = 8

#: Driver-side ledger: calls into the fused pipeline, rows that fell back
#: to the exact scan, rows whose probe set was budget-capped.
fused_stats = {"calls": 0, "fallback_rows": 0, "capped_rows": 0}

# distinct static shape buckets served per entry point
_buckets: dict[str, set] = {"pruned": set(), "quant": set()}


def reset_stats() -> None:
    for k in fused_stats:
        fused_stats[k] = 0


def compile_counts() -> dict:
    """Distinct static shape buckets each fused entry point has served —
    the counterpart of the reference's executables per jitted body: a
    steady-state loop stays at one per bucket."""
    return {name: len(keys) for name, keys in _buckets.items()}


# ---------------------------------------------------------------------------
# static-bucket helpers (host side)

def pad_pow2(n: int, min_b: int = 8) -> int:
    """Smallest power of two ≥ ``n`` (floor ``min_b``)."""
    b = min_b
    while b < n:
        b *= 2
    return b


def pad_geo(n: int, min_b: int = 64) -> int:
    """Smallest bucket ≥ ``n`` from the geometric grid {64, 96, 128, 192,
    256, ...} — powers of two plus their 1.5× midpoints.  Roughly halves
    the worst-case overshoot of pure pow2 buckets for the candidate dim,
    which directly multiplies gather bytes."""
    b = min_b
    while True:
        if b >= n:
            return b
        mid = b + b // 2
        if mid >= n:
            return mid
        b *= 2


@functools.lru_cache(maxsize=64)
def tau_lo_f32(tau: float) -> np.float32:
    """Largest float32 strictly below ``tau`` (a float64 threshold).

    For float32 ``v``, ``v <= tau_lo_f32(tau)`` holds iff
    ``float64(v) < tau`` — the device-side form of the staged drivers'
    f64 certain-miss comparisons."""
    t = np.float32(tau)
    while float(t) >= float(tau):
        t = np.nextafter(t, np.float32(-np.inf))
    return t


def prep_queries(queries: np.ndarray, bq: int):
    """Pad a query chunk to the ``bq`` batch bucket and quantize it.

    Returns ``(qp, q8, qscale, ql1)`` — fp32 queries, their int8 mirror,
    per-row scales, and the f32-inflated L1 norms the device-side error
    bound consumes (cast rounding is swallowed by the 1e-6 relative pad,
    keeping the bound an upper bound)."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    b = q.shape[0]
    if bq > b:
        q = np.pad(q, ((0, bq - b), (0, 0)))
    q8, qs, ql1 = quantize_rows_int8(q)
    ql1_32 = (ql1 * (1.0 + 1e-6)).astype(np.float32)
    return q, q8, qs.astype(np.float32), ql1_32


def csr_device_arrays(indptr: np.ndarray, slot_ids: np.ndarray,
                      unassigned: np.ndarray, t_rows: int):
    """Pack the topic-bucket CSR plus the unassigned segment for upload:
    ``indptr_dev`` has ``t_rows + 2`` entries (segment ``t_rows`` is the
    always-scanned unassigned block) and ``slots_dev`` is padded to a pow2
    bucket so membership churn keeps its shape."""
    n_mem = int(indptr[-1]) if indptr.size else 0
    slots = np.concatenate([np.asarray(slot_ids, np.int64),
                            np.asarray(unassigned, np.int64)])
    npad = pad_pow2(max(int(slots.size), 1), 64)
    out = np.zeros(npad, np.int32)
    out[: slots.size] = slots
    ip = np.zeros(t_rows + 2, np.int32)
    ip[: t_rows + 1] = indptr
    ip[t_rows + 1] = n_mem + int(unassigned.size)
    return ip, out


def candidate_cap(counts: np.ndarray, n_una: int, probes: int,
                  budget: int) -> int:
    """Static candidate width for the gather: the unassigned block plus
    the smaller of the probe budget and the ``probes`` largest bucket
    counts — an upper bound on any query's candidate total, computed
    without a device sync."""
    p = int(min(probes, counts.size))
    if p <= 0:
        top = 0
    elif p >= counts.size:
        top = int(counts.sum())
    else:
        top = int(np.partition(counts, -p)[-p:].sum())
    return pad_geo(max(1, int(n_una) + min(int(budget), top)))


# ---------------------------------------------------------------------------
# fused bodies

_NEG_INF = float("-inf")


def _stable_topk(scores: torch.Tensor, k: int):
    """``lax.top_k``'s contract: descending, ties toward the lower
    position (a stable sort; ``torch.topk`` promises no order for ties)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def _union_rescore(qp, emb, u_slots, u_valid):
    """Rescore the (slot-sorted) union of all shortlists in fp32 with the
    exact scan's kernel, returning each query's max and the lowest winning
    slot.  Sorting by slot id makes the kernel's lowest-*index* tie rule
    the exact path's lowest-*slot* rule.  The union's live count ``n_u``
    stays on the card and the kernel reads it there."""
    n_slots = emb.shape[0]
    flat = torch.where(u_valid, u_slots, n_slots).reshape(-1)
    order = torch.sort(flat).values             # sentinels sort last
    n_u = u_valid.sum(dtype=torch.int32).reshape(1)
    blk = emb.index_select(0, order.clamp(max=n_slots - 1))
    rvals, ridx = sim_top1(qp, blk, n_u)
    win = order[ridx.long().clamp(0, order.shape[0] - 1)]
    win = torch.where(torch.isfinite(rvals), win, n_slots)
    return win, rvals, n_u


def _eps_f32(ql1, qsc, cl1_max, cs_max, dim: int):
    """Device-side int8 error bound, padded: the staged ``scan_margin``
    terms evaluated in f32 with 1.06×+1e-6 inflation (vs the host's
    1.05×+1e-7) so f32 rounding of the bound itself stays conservative."""
    eps = (0.5 * ql1 * cs_max + 0.5 * cl1_max * qsc
           + (0.25 * float(dim)) * qsc * cs_max)
    return eps * 1.06 + 1e-6


def _inflate(thresh):
    """Absolute + relative inflation of a finite f32 threshold so device
    f32 comparisons can only be *more* conservative than the staged f64
    predicate (−inf passes through untouched)."""
    guard = torch.where(torch.isfinite(thresh), thresh.abs() * 1e-6 + 1e-6,
                        0.0)
    return thresh + guard


def _fused_pruned_body(qp, q8q, qsc, ql1, emb, q8s, csc, cl1, aug, indptr,
                       slots, n_topics, budget, b_real, tau_lo, *, probes,
                       cap_c, k, armed):
    """route → cap → CSR gather → int8 scan → fp32 union rescore →
    safety predicates.  Shapes: ``qp (B,D)``, ``emb/q8s (N,D)``,
    ``aug (T,D+1)``, ``indptr (T+2,)``, ``slots (Npad,)``."""
    bsz, dim = qp.shape
    t_rows = aug.shape[0]
    dev = qp.device
    ip = indptr.long()

    # ---- stage 1: routing (same kernel + k contract as ops.route_topics)
    k_route = min(probes + 1, t_rows)
    vals, tids = ops.route_topics_raw(qp, aug, n_topics, k_route)
    n_pc = min(probes, k_route)
    if vals.shape[1] <= n_pc:      # no natural unprobed-bound column
        vals_e = torch.cat([vals, vals.new_full((bsz, 1), _NEG_INF)], dim=1)
    else:
        vals_e = vals
    pv = vals[:, :n_pc]
    pt = tids[:, :n_pc].long().clamp(0, max(t_rows - 1, 0))
    live = torch.isfinite(pv)

    # ---- stage 2: adaptive probe cap — the staged driver's greedy prefix
    # rule (cumulative bucket rows ≤ budget); dead columns sort last, so
    # the kept set is always a prefix
    cnt = torch.where(live, ip[pt + 1] - ip[pt], 0)
    allowed = torch.cumprod((cnt.cumsum(1) <= budget).long(), dim=1) > 0
    take = live & allowed
    p_i = take.sum(1)
    ub = vals_e.gather(1, p_i[:, None])[:, 0]
    capped = (live & ~allowed).any(1)
    if armed:
        skip = vals[:, 0] <= tau_lo        # certain-miss routing arm
        take = take & ~skip[:, None]
        ub = torch.where(skip, vals[:, 0], ub)
        capped = capped & ~skip

    # ---- stage 3: CSR candidate gather.  Per-query segments = kept
    # probes' buckets + the always-scanned unassigned block; position →
    # segment by counting the segment ends at or below it
    seg_cnt = torch.where(take, cnt, 0)
    n_una = (ip[t_rows + 1] - ip[t_rows]).expand(bsz, 1)
    ends = torch.cat([seg_cnt, n_una], dim=1).cumsum(1)
    total = ends[:, -1]
    pos = torch.arange(cap_c, device=dev)
    seg = (ends[:, :, None] <= pos[None, None, :]).sum(1).clamp(max=n_pc)
    starts = torch.cat([ends.new_zeros((bsz, 1)), ends[:, :-1]], dim=1)
    off = pos[None, :] - starts.gather(1, seg)
    topic = pt.gather(1, seg.clamp(max=n_pc - 1))
    base = torch.where(seg < n_pc, ip[topic], ip[t_rows])
    cvalid = pos[None, :] < total[:, None]
    cand = slots.long()[(base + off).clamp(0, slots.shape[0] - 1)]
    cand = torch.where(cvalid, cand, 0)

    # ---- stage 4: int8 candidate scan (exact integer accumulate; the
    # fixed (acc·qs)·cs order matches the q8 kernel bit for bit)
    c8 = q8s[cand]                                        # (B, cap_c, D)
    acc = torch.bmm(c8.to(torch.float64),
                    q8q.to(torch.float64)[:, :, None])[:, :, 0]
    cs_g = csc[cand]
    scores = torch.where(cvalid,
                         (acc.to(torch.float32) * qsc[:, None]) * cs_g,
                         _NEG_INF)
    cs_max = torch.where(cvalid, cs_g, 0.0).amax(1)
    cl1_max = torch.where(cvalid, cl1[cand], 0.0).amax(1)
    eps = _eps_f32(ql1, qsc, cl1_max, cs_max, dim)

    # ---- stage 5: shortlist + exclusion threshold
    k_eff = min(k, cap_c)
    svals, spos = _stable_topk(scores, k_eff)
    kth = svals[:, -1]
    covers = total <= k_eff
    thresh = _inflate(torch.where(torch.isfinite(kth) & ~covers, kth + eps,
                                  _NEG_INF))

    # ---- stage 6: fp32 union rescore (exact per-pair kernel arithmetic)
    row_ok = torch.arange(bsz, device=dev) < b_real
    u_slots = cand.gather(1, spos)
    u_valid = torch.isfinite(svals) & row_ok[:, None]
    win, rmax, n_u = _union_rescore(qp, emb, u_slots, u_valid)

    # ---- stage 7: safety predicates (resolve_topk + resolve_pruned arms)
    cert = rmax > torch.maximum(thresh, ub)
    if armed:
        cert = cert | ((rmax <= tau_lo) & (thresh <= tau_lo)
                       & (ub <= tau_lo))
    probed = (take & (cnt > 0)).sum(1)
    return (win, rmax, ub, cert, total, probed, capped.to(torch.int32),
            n_u)


def _fused_quant_body(qp, q8q, qsc, ql1, emb, q8s, csc, cl1, n_valid,
                      b_real, tau_lo, *, k, armed):
    """Pure-quantized fused lookup: full-slab int8 Top-K (the same
    ``sim_topk_q8`` kernel launch the staged path makes) + fp32 union
    rescore + the ``resolve_topk`` arms."""
    bsz, dim = qp.shape
    n_slots = q8s.shape[0]
    dev = qp.device
    vals, rows = ops.sim_topk_q8_raw(q8q, qsc, q8s, csc, n_valid, k)
    m = torch.arange(n_slots, device=dev) < n_valid
    cs_max = torch.where(m, csc, 0.0).amax()
    cl1_max = torch.where(m, cl1, 0.0).amax()
    eps = _eps_f32(ql1, qsc, cl1_max, cs_max, dim)
    kth = vals[:, -1]
    live = torch.isfinite(kth)
    if n_valid <= vals.shape[1]:          # the shortlist covers every row
        live = torch.zeros_like(live)
    thresh = _inflate(torch.where(live, kth + eps, _NEG_INF))
    row_ok = torch.arange(bsz, device=dev) < b_real
    u_valid = torch.isfinite(vals) & row_ok[:, None]
    win, rmax, n_u = _union_rescore(qp, emb, rows.long(), u_valid)
    cert = rmax > thresh
    if armed:
        cert = cert | ((rmax <= tau_lo) & (thresh <= tau_lo))
    return win, rmax, cert, n_u


def fused_pruned_lookup(qp, q8q, qsc, ql1, emb, q8s, csc, cl1, aug, indptr,
                        slots, n_topics, budget, b_real, tau, *, probes,
                        cap_c, k):
    """One-dispatch pruned (optionally quantize-composed) lookup.  ``tau``
    is the f64 hit threshold or None; the tensors are on the card (or all
    on the CPU, where every kernel runs its plain version).  Returns the
    raw device tuple ``(win, rmax, ub, cert, total, probed, capped, n_u)``
    — callers slice off padding rows."""
    armed = tau is not None
    t_lo = float(tau_lo_f32(tau)) if armed else 0.0
    fused_stats["calls"] += 1
    ops.count_launch()
    _buckets["pruned"].add((tuple(qp.shape), tuple(emb.shape),
                            tuple(aug.shape), tuple(slots.shape),
                            int(probes), int(cap_c), int(k), armed))
    return _fused_pruned_body(qp, q8q, qsc, ql1, emb, q8s, csc, cl1, aug,
                              indptr, slots, int(n_topics), int(budget),
                              int(b_real), t_lo, probes=int(probes),
                              cap_c=int(cap_c), k=int(k), armed=armed)


def fused_quant_lookup(qp, q8q, qsc, ql1, emb, q8s, csc, cl1, n_valid,
                       b_real, tau, *, k):
    """One-dispatch pure-quantized lookup (full-slab int8 Top-K + rescore
    + predicates); returns ``(win, rmax, cert, n_u)``.  Same conventions
    as :func:`fused_pruned_lookup`."""
    armed = tau is not None
    t_lo = float(tau_lo_f32(tau)) if armed else 0.0
    fused_stats["calls"] += 1
    ops.count_launch()
    _buckets["quant"].add((tuple(qp.shape), tuple(emb.shape), int(k),
                           armed))
    return _fused_quant_body(qp, q8q, qsc, ql1, emb, q8s, csc, cl1,
                             int(n_valid), int(b_real), t_lo, k=int(k),
                             armed=armed)
