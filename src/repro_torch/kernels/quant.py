"""int8 quantization: the per-tensor codec of the gradient compression
(torch) and the per-row one of the quantized lookup (numpy, host side).

  - **Per-tensor scale** (``quantize_int8`` / ``dequantize_int8``): one
    fp32 scale for the whole tensor, for the int8 gradient all-reduce with
    error feedback (:mod:`repro_torch.distributed.compression`).
  - **Per-row scale** (``quantize_rows_int8``): one symmetric scale per
    row, for the cache's embedding slab.

The host keeps a per-row-scaled int8 mirror of the embedding slab
(:class:`repro_torch.cache.quantized.QuantizedSlabMirror`); the card scans
it with the ``sim_topk_q8`` kernel.  Exactness plumbing for that scan:

  - ``int8_scores`` computes *exact* integer dot products of int8 rows on
    the host.  For ``D * 127**2 < 2**24`` every partial sum fits a fp32
    mantissa, so a BLAS fp32 gemm of the int8 values is bit-exact integer
    arithmetic; larger D takes an int32 gemm.
  - ``scan_margin`` bounds ``|approx_score - exact_score|`` per query so
    the rescore step can certify decisions.

Copied from the reference's numpy helpers; the per-tensor codec is its
``jnp`` one in torch.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_int8", "dequantize_int8", "quantize_rows_int8",
           "int8_scores", "scan_margin"]


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(q, scale)`` with ``scale
    = max|g| / 127 + 1e-30`` in fp32 and ``q = clip(round(g / scale),
    -127, 127)`` as int8 (``torch.round`` rounds half to even, as
    ``jnp.round`` does)."""
    scale = g.abs().max().to(torch.float32) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_rows_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization of a ``(N, D)`` fp32 slab.

    Returns ``(q8, scale, l1)`` where ``x[i] ≈ q8[i] * scale[i]`` with
    per-element error ≤ ``scale[i] / 2`` (round-half-even, clip inert
    because ``|x[i,j]| / scale[i] < 127``), and ``l1[i] = sum_j |x[i,j]|``
    in float64 — the row norms ``scan_margin`` needs.  All-zero rows get
    the epsilon scale, ``q8 = 0``, ``l1 = 0``.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    ax = np.abs(x)
    scale = (ax.max(axis=1) / 127.0 + 1e-30).astype(np.float32) \
        if x.size else np.zeros((x.shape[0],), np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8) \
        if x.size else np.zeros(x.shape, np.int8)
    l1 = ax.sum(axis=1, dtype=np.float64)
    return q, scale, l1


def int8_scores(q8: np.ndarray, c8: np.ndarray) -> np.ndarray:
    """Exact ``q8 @ c8.T`` integer dot products, returned as float32.

    Each product is ≤ ``127**2 = 16129``; when ``D * 16129 < 2**24`` every
    partial sum is exactly representable in fp32, so the fast BLAS path is
    bit-exact integer arithmetic.  Otherwise an int32 gemm (always exact:
    ``D * 16129 < 2**31`` for any realistic D) is converted — int32 scores
    below ``2**24`` convert to fp32 without rounding, and larger ones only
    occur when the fp32 path was already excluded.
    """
    d = q8.shape[1]
    if d * 16129 < (1 << 24):
        return q8.astype(np.float32) @ c8.astype(np.float32).T
    return (q8.astype(np.int32) @ c8.astype(np.int32).T).astype(np.float32)


def scan_margin(qscale: np.ndarray, q_l1: np.ndarray,
                cand_scale: np.ndarray, cand_l1: np.ndarray,
                dim: int) -> np.ndarray:
    """Per-query upper bound on ``|approx - exact|`` similarity error.

    With ``x = q8*qs + eq`` (``|eq| ≤ qs/2`` elementwise) and
    ``c = c8*cs + ec`` (``|ec| ≤ cs/2``)::

        |approx - exact| = |q·ec + c·eq - eq·ec|
                         ≤ ||q||_1 * cs/2 + ||c||_1 * qs/2 + D * qs*cs/4

    maximized over candidate rows by taking ``max(cand_scale)`` and
    ``max(cand_l1)``.  Rows that were never written are all-zero (epsilon
    scale, zero L1) so the maxima can safely run over the whole mirror.
    The 5% inflation + absolute floor swallows fp32 rounding of both the
    scaled int8 scores and the exact-path dot products (relative error
    ``O(D * 2^-24)``, < 1% of the leading terms for D ≤ 1024) — inflating
    the bound only ever costs extra exact-scan fallbacks, never wrong
    decisions.  Computed in float64; shape ``(B,)``.
    """
    qs = np.asarray(qscale, dtype=np.float64)
    ql1 = np.asarray(q_l1, dtype=np.float64)
    cs = float(np.max(cand_scale)) if np.size(cand_scale) else 0.0
    cl1 = float(np.max(cand_l1)) if np.size(cand_l1) else 0.0
    eps = 0.5 * ql1 * cs + 0.5 * cl1 * qs + 0.25 * float(dim) * qs * cs
    return eps * 1.05 + 1e-7
