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
