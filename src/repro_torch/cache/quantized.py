"""Quantized int8 candidate generation for the lookup/decision stack.

The exact lookup path streams the fp32 embedding slab (O(S·D) bytes) for
every scan.  With ``CacheConfig.quantized_lookup`` the backends instead:

  1. keep a **per-row-scaled int8 mirror** of the slab fresh via the same
     journal dirty-row machinery as the device mirrors
     (:class:`QuantizedSlabMirror`);
  2. scan it with the quantized Top-K kernel (``ops.sim_topk_q8``, the
     ``csrc/sim_topk_q8.cu`` int8 tensor-core kernel on the card) — 4×
     fewer slab bytes moved;
  3. **rescore the ≤k survivors in fp32** against the exact rows (the
     backend's own ``top1_rows`` engine) and certify the result with
     :func:`resolve_topk`'s safety predicate;
  4. fall back to the exact full scan for any query the predicate cannot
     certify (counted — ``cache.rescore_fallbacks`` telemetry).

Decision-exactness argument:
``scan_margin`` bounds the per-row quantization error ``eps``, so every
row *not* in the survivor union has exact score ≤ ``kth + eps`` where
``kth`` is the smallest surviving approximate score.  If the rescored
union max beats that threshold, it is the true global Top-1 — and because
every tied true-maximum row is itself in the union, the lowest-slot tie
break matches the exact path's argmax bit-for-bit.  Otherwise, if both
the rescored max and the threshold sit strictly below ``tau_hit``, the
query is a certain miss (no row can reach the tau band) and the
approximate best is decision-equivalent.  Anything else takes the exact
fallback, so hit/miss/eviction sequences are identical to the exact path
by construction, not by luck.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = [
    "QuantizedLookupConfig", "as_quantized_config", "new_quant_stats",
    "QuantizedSlabMirror", "resolve_topk", "account_scan",
]


@dataclasses.dataclass(frozen=True)
class QuantizedLookupConfig:
    """Knobs for the quantized candidate-generation path.

    ``k``: survivor-shortlist width of the int8 scan (static per launch
    shape; wider k widens the certified margin and shrinks the fallback
    rate at the cost of rescore work).  ``tau_hit``: the facade's hit
    threshold, used by the certain-miss arm of the safety predicate; when
    ``None`` (content-mode stores, arenas without a tau band) only the
    top-1-margin arm certifies and everything else falls back.
    ``fused`` routes kernel backends through the device-resident fused
    pipeline (int8 scan + fp32 rescore + safety predicate on the card with
    one host sync; see :mod:`repro_torch.kernels.fused`); ``fused=False``
    keeps the staged multi-launch driver.  ``fused_max_batch`` bounds the chunk
    width the fused program serves — wider chunks fall through to the
    staged driver, whose per-stage launches amortize better there.
    """
    k: int = 8
    tau_hit: Optional[float] = None
    fused: bool = True
    fused_max_batch: int = 16


def as_quantized_config(spec) -> Optional[QuantizedLookupConfig]:
    """Normalize a ``CacheConfig.quantized_lookup`` spec: ``False``/``None``
    -> disabled, ``True`` -> defaults, dict -> field overrides, or a ready
    :class:`QuantizedLookupConfig`."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return QuantizedLookupConfig()
    if isinstance(spec, QuantizedLookupConfig):
        return spec
    if isinstance(spec, dict):
        return QuantizedLookupConfig(**spec)
    raise ValueError(f"bad quantized_lookup spec: {spec!r}")


def new_quant_stats() -> dict:
    """Counter surface for the quantized path (mirrors ``sync_stats``):
    scans/queries served, exact-scan fallbacks, fp32 rows rescored, and
    the byte ledger — ``bytes_scanned`` is what the quantized path
    actually read (int8 slab + scales + rescored rows + any fallback
    scans), ``bytes_exact`` what the fp32 path would have read."""
    return {"scans": 0, "queries": 0, "fallbacks": 0, "rescore_rows": 0,
            "bytes_scanned": 0, "bytes_exact": 0}


def account_scan(stats: dict, *, n_valid: int, dim: int, batch: int,
                 n_union: int, n_fallback: int) -> None:
    """Fold one quantized scan into the counter surface.  The int8 scan
    reads ``n_valid`` rows of D int8 + one fp32 scale each; the rescore
    gathers ``n_union`` exact fp32 rows; a fallback re-reads the fp32
    slab once for the whole unsafe sub-batch."""
    stats["scans"] += 1
    stats["queries"] += batch
    stats["fallbacks"] += n_fallback
    stats["rescore_rows"] += n_union
    stats["bytes_exact"] += n_valid * dim * 4
    stats["bytes_scanned"] += n_valid * (dim + 4) + n_union * dim * 4
    if n_fallback:
        stats["bytes_scanned"] += n_valid * dim * 4


class QuantizedSlabMirror:
    """Host-side per-row int8 mirror of a journaled fp32 row slab.

    Same contract as the device ``_DeviceMirror``: keyed on the journal
    ``version``, requantizing only the dirty rows when the journal can
    name them and the delta is small, else a full requantize.  Holds the
    int8 codes, the per-row fp32 scales, and the per-row L1 norms that
    ``scan_margin`` consumes.  Device backends upload ``q8``/``scale``
    from here; the numpy backend scans it directly.
    """

    def __init__(self) -> None:
        self.version = None
        self.q8: Optional[np.ndarray] = None
        self.scale: Optional[np.ndarray] = None
        self.l1: Optional[np.ndarray] = None
        self.stats = {"full": 0, "incremental": 0, "rows": 0}

    def sync(self, version, dirty_since: Callable, emb: np.ndarray
             ) -> "QuantizedSlabMirror":
        from repro_torch.kernels.quant import quantize_rows_int8

        from .backends import small_delta
        emb = np.asarray(emb)
        fresh = (self.q8 is not None and version == self.version
                 and self.q8.shape == emb.shape)
        if fresh:
            return self
        dirty = None
        if self.q8 is not None and self.q8.shape == emb.shape:
            dirty = dirty_since(self.version)
        if dirty is not None and small_delta(len(dirty), emb.shape[0]):
            if dirty:
                rows = np.fromiter(sorted(dirty), dtype=np.int64,
                                   count=len(dirty))
                q8, sc, l1 = quantize_rows_int8(emb[rows])
                self.q8[rows] = q8
                self.scale[rows] = sc
                self.l1[rows] = l1
                self.stats["incremental"] += 1
                self.stats["rows"] += len(rows)
        else:
            self.q8, self.scale, self.l1 = quantize_rows_int8(emb)
            self.stats["full"] += 1
        self.version = version
        return self


def resolve_topk(vals: np.ndarray, rows: np.ndarray, eps: np.ndarray,
                 covers_all: bool, tau_hit: Optional[float],
                 rescore_fn: Callable, exact_fn: Callable
                 ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Turn int8 survivor shortlists into certified exact decisions.

    ``vals`` (B, K) approximate scores sorted descending (``-inf`` pads),
    ``rows`` (B, K) their slot indices, ``eps`` (B,) the per-query error
    bound, ``covers_all`` whether the shortlist provably contains every
    valid row (k ≥ resident count — no discarded row exists).

    ``rescore_fn(rows_ascending) -> (cids (B,), sims (B,))`` rescores the
    survivor union in fp32 with the backend's own restricted-scan engine
    (for *all* B queries — the union is shared, and restricted scans cost
    O(|union|·D) independent of B).  ``exact_fn(query_indices) ->
    (cids, sims)`` runs the exact full scan for the unsafe sub-batch.

    Safety predicate per query (strict inequalities; see module doc):

    - rescored union max > ``kth + eps``  -> certified exact Top-1;
    - rescored max < tau and ``kth + eps`` < tau -> certified miss;
    - otherwise -> exact fallback.

    Returns ``(cids, sims, n_fallback, n_union)``; free-slot survivors
    (cid < 0) are mapped to ``-inf`` sims at the end, exactly like the
    exact path's post-scan mapping.
    """
    vals = np.asarray(vals, dtype=np.float64)
    b = vals.shape[0]
    finite = np.isfinite(vals)
    if covers_all:
        thresh = np.full(b, -np.inf)
    else:
        kth = vals[:, -1]
        thresh = np.where(np.isfinite(kth), kth + eps, -np.inf)
    uniq = np.unique(np.asarray(rows)[finite])
    r_cids, r_sims = rescore_fn(uniq)
    r_sims = np.asarray(r_sims, dtype=np.float64)
    safe = r_sims > thresh
    if tau_hit is not None:
        safe |= (r_sims < tau_hit) & (thresh < tau_hit)
    cids = np.asarray(r_cids, dtype=np.int64).copy()
    sims = r_sims.copy()
    n_fallback = int(b - np.count_nonzero(safe))
    if n_fallback:
        sel = np.flatnonzero(~safe)
        f_cids, f_sims = exact_fn(sel)
        cids[sel] = np.asarray(f_cids, dtype=np.int64)
        sims[sel] = np.asarray(f_sims, dtype=np.float64)
    sims = np.where(cids >= 0, sims, -np.inf)
    return cids, sims, n_fallback, int(uniq.size)
