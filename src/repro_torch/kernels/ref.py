"""Plain PyTorch versions of the CUDA kernels (the allclose ground truth).

Each wrapper takes these for a tensor on the CPU; ``chip_smoke.py`` holds
each kernel against them on the card.  They repeat the kernels'
arithmetic order, not their speed.
"""
from __future__ import annotations

import torch


def sim_top1_ref(queries: torch.Tensor, candidates: torch.Tensor,
                 n_valid: int):
    """queries (Q,D), candidates (N,D) -> (max sim (Q,), argmax (Q,)).
    Columns at or past ``n_valid`` score -inf; ties and all-masked rows go
    to the lowest index (``argmax`` returns the first maximum)."""
    q = queries.to(torch.float32)
    if candidates.shape[0] == 0:
        return (torch.full((q.shape[0],), float("-inf"), device=q.device),
                torch.zeros(q.shape[0], dtype=torch.int32, device=q.device))
    scores = q @ candidates.to(torch.float32).T
    col = torch.arange(candidates.shape[0], device=scores.device)
    scores = torch.where(col[None, :] < n_valid, scores, float("-inf"))
    idx = scores.argmax(dim=1)
    return (scores.gather(1, idx[:, None])[:, 0],
            idx.to(torch.int32))


def _topk_sorted(scores: torch.Tensor, k: int):
    """The K best columns per row, descending; a stable sort keeps equal
    scores in ascending column order (``torch.topk`` promises no order
    for ties)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def _mask_cols(scores: torch.Tensor, n_valid) -> torch.Tensor:
    col = torch.arange(scores.shape[1], device=scores.device)
    return torch.where(col[None, :] < n_valid, scores, float("-inf"))


def sim_topk_ref(queries: torch.Tensor, candidates: torch.Tensor,
                 n_valid: int, k: int):
    """queries (Q,D), candidates (N,D) -> (vals (Q,K), idx (Q,K)), sorted
    descending, ties toward the lower index; columns at or past
    ``n_valid`` score -inf."""
    scores = queries.to(torch.float32) @ candidates.to(torch.float32).T
    return _topk_sorted(_mask_cols(scores, n_valid), k)


def int8_dots(q8: torch.Tensor, c8: torch.Tensor) -> torch.Tensor:
    """Exact ``q8 @ c8.T`` integer dots of int8 rows, as float32.  The CPU
    takes an int64 product; the card has no integer matmul for this, so
    it takes a float64 one, exact for any D below 2^53 / 127^2.  Either
    way the float32 cast rounds to nearest, as an int32 -> float32 cast
    does (exact while D * 127^2 < 2^24)."""
    if q8.device.type == "cpu":
        acc = q8.to(torch.int64) @ c8.to(torch.int64).T
    else:
        acc = q8.to(torch.float64) @ c8.to(torch.float64).T
    return acc.to(torch.float32)


def sim_topk_q8_ref(q8: torch.Tensor, qscale: torch.Tensor,
                    c8: torch.Tensor, cscale: torch.Tensor,
                    n_valid: int, k: int):
    """Quantized-slab Top-K: exact integer dots rescaled per row as
    ``(acc * qscale) * cscale`` in that order (the kernel's, the reference
    kernel's and the host gemm's order, so all give the same bits), then
    the order and masking of :func:`sim_topk_ref`."""
    scores = (int8_dots(q8, c8) * qscale.to(torch.float32)[:, None]) \
        * cscale.to(torch.float32)[None, :]
    return _topk_sorted(_mask_cols(scores, n_valid), k)


def rac_value_ref(tsi: torch.Tensor, tid: torch.Tensor,
                  tp_last: torch.Tensor, t_last: torch.Tensor,
                  alpha: float, t_now):
    """Unmasked Eq. 1; the age is taken in ``t_last``'s own dtype."""
    tid = tid.long()
    age = (t_now - t_last[tid]).to(torch.float32)
    decay = torch.exp2(-alpha * age)
    return decay * tp_last[tid].to(torch.float32) * tsi


def victim_value_ref(tsi: torch.Tensor, tid: torch.Tensor, occ: torch.Tensor,
                     tp_last: torch.Tensor, t_last: torch.Tensor, t_now,
                     alpha: float):
    """Occupancy-masked Eq. 1 with a runtime t_now (free slots -> +inf)."""
    tid = tid.long().clamp(min=0)                # free slots carry tid -1
    age = (t_now - t_last[tid]).to(torch.float32)
    decay = torch.exp2(-alpha * age)
    val = decay * tp_last[tid].to(torch.float32) * tsi
    return torch.where(occ > 0, val, float("inf"))


# -- policy-stacked versions: a leading policy axis, a count per policy ----
# Each policy's slice is the single-slab plain version on that slice, so a
# stacked kernel is held to exactly what P single launches would give.
# ``n_valid`` is a (P,) tensor (or sequence); its entries stay tensors, so
# the plain versions run on the card without a host sync.  P >= 1.

def sim_top1_multi_ref(queries: torch.Tensor, slabs: torch.Tensor,
                       n_valid):
    """queries (B,D), slabs (P,S,D), n_valid (P,) -> (vals (P,B),
    idx (P,B)): :func:`sim_top1_ref` of every slab under its own count."""
    outs = [sim_top1_ref(queries, slabs[p], n_valid[p])
            for p in range(slabs.shape[0])]
    return (torch.stack([v for v, _ in outs]),
            torch.stack([i for _, i in outs]))


def sim_topk_q8_multi_ref(q8: torch.Tensor, qscale: torch.Tensor,
                          slabs8: torch.Tensor, cscales: torch.Tensor,
                          n_valid, k: int):
    """q8 (B,D) int8 with qscale (B,), slabs8 (P,S,D) int8 with cscales
    (P,S), n_valid (P,) -> (vals (P,B,K), idx (P,B,K)):
    :func:`sim_topk_q8_ref` of every slab under its own count."""
    outs = [sim_topk_q8_ref(q8, qscale, slabs8[p], cscales[p], n_valid[p], k)
            for p in range(slabs8.shape[0])]
    return (torch.stack([v for v, _ in outs]),
            torch.stack([i for _, i in outs]))


def victim_value_multi_ref(tsi: torch.Tensor, tid: torch.Tensor,
                           occ: torch.Tensor, tp_last: torch.Tensor,
                           t_last: torch.Tensor, t_now, alpha: float):
    """Slot tables (P,N), topic tables (P,T), one shared ``t_now`` ->
    (P,N): :func:`victim_value_ref` of every policy's tables."""
    return torch.stack([
        victim_value_ref(tsi[p], tid[p], occ[p], tp_last[p], t_last[p],
                         t_now, alpha)
        for p in range(tsi.shape[0])])


# -- attention: fp32 softmax, the reference's layouts ----------------------

def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  q_start: int = 0) -> torch.Tensor:
    """q (B,H,S,D); k (B,Hkv,T,D); v (B,Hkv,T,Dv) -> (B,H,S,Dv) in q's
    dtype.  Query head ``h`` reads kv head ``h // (H/Hkv)``; scores,
    softmax and the weighted sum are fp32.  ``causal`` keeps key ``j`` for
    query ``i`` only where ``j <= i``, ``window > 0`` only where ``j > i -
    window`` (the reference's band, query and key indices from 0 as in
    its ``sdpa``); with neither every query attends to all T keys.  The
    queries sit at positions ``q_start + i`` (a chunk of a longer query
    sequence, as the rematerialised backward passes them).  Any
    strides."""
    b, h, s, d = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, s, d) / d ** 0.5
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, k.to(torch.float32))
    if causal or window > 0:
        qi = q_start + torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(t, device=q.device)[None, :]
        keep = torch.ones((s, t), dtype=torch.bool, device=q.device)
        if causal:
            keep &= ki <= qi
        if window > 0:
            keep &= ki > qi - window
        scores = scores.masked_fill(~keep, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.to(torch.float32))
    return out.reshape(b, h, s, dv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """One query token per batch row over a KV cache: q (B,H,D); k
    (B,S,Hkv,D); v (B,S,Hkv,Dv) (it may be a view of k's first Dv
    columns); pos (B,) the newest valid cache index (keys ``[0, pos]``
    are attended; ``pos`` stays on its device, nothing reads it on the
    host) -> (B,H,Dv) in q's dtype, fp32 softmax; ``scale`` defaults to
    1/sqrt(D)."""
    b, h, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, d)
    qf = qf / d ** 0.5 if scale is None else qf * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32))
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return out.reshape(b, h, dv).to(q.dtype)
