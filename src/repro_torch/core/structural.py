"""Structural-importance ranking on the intra-topic dependency DAG.

Implements the paper's Appendix 7.2: a PageRank/TextRank-style random walk
with uniform restart on the *reversed* prerequisite edges, so importance
propagates from dependents back to their context anchors.  The stationary
distribution is computed by power iteration (Proposition 2).

``pagerank_reversed`` is the pure-numpy oracle used by tests;
``pagerank_power`` is an equivalent torch power iteration on the device
of its input, and ``pagerank_scores`` selects between the two — RAC's
``structural_mode="pagerank"`` drives its refreshes through it.
"""
from __future__ import annotations

import numpy as np
import torch


def pagerank_reversed(edges: list[tuple[int, int]], n: int,
                      beta: float = 0.85, tol: float = 1e-10,
                      max_iter: int = 200) -> np.ndarray:
    """Stationary scores r(u) of the uniform-restart walk (Eq. 3/4).

    ``edges`` are prerequisite links (u -> v): u is an anchor required by v.
    The walk runs on reversed edges (v -> u): dependents push importance to
    their anchors.  Dangling nodes jump uniformly.
    """
    if n == 0:
        return np.zeros(0)
    # build reversed adjacency: from v to u for each (u, v)
    out_deg = np.zeros(n, dtype=np.int64)         # out-degree in reversed graph
    for (u, v) in edges:
        out_deg[v] += 1
    r = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        contrib = np.zeros(n)
        # mass from dangling nodes (out_deg == 0 in reversed graph)
        dangling = r[out_deg == 0].sum() / n
        for (u, v) in edges:
            contrib[u] += r[v] / out_deg[v]
        r_new = (1.0 - beta) / n + beta * (contrib + dangling)
        if np.abs(r_new - r).sum() < tol:
            return r_new
        r = r_new
    return r


def pagerank_power(adj: torch.Tensor, beta: float = 0.85,
                   iters: int = 64) -> torch.Tensor:
    """Torch power iteration on a dense reversed-transition matrix, on
    ``adj``'s device.

    ``adj[u, v] = 1`` iff prerequisite edge u -> v exists.  Returns r over n
    nodes.
    """
    n = adj.shape[0]
    out_deg = adj.sum(dim=0)                        # reversed out-degree of v
    # column-stochastic transition P[u, v] = adj[u,v] / out_deg[v]
    p = torch.where(out_deg[None, :] > 0,
                    adj / torch.clamp(out_deg[None, :], min=1),
                    torch.zeros((), dtype=adj.dtype, device=adj.device))
    dang = (out_deg == 0).to(adj.dtype)
    r = torch.full((n,), 1.0 / n, dtype=adj.dtype, device=adj.device)
    for _ in range(iters):
        spread = p @ r + (dang @ r) / n
        r = (1.0 - beta) / n + beta * spread
    return r


def pagerank_scores(edges: list[tuple[int, int]], n: int,
                    beta: float = 0.85, device: bool | str = False,
                    iters: int = 128) -> np.ndarray:
    """Stationary scores through a selectable engine.

    ``device=False`` runs the numpy oracle (tolerance-converged);
    ``device=True`` (the card) or a torch device name builds the dense
    reversed-transition adjacency and runs :func:`pagerank_power` there
    (``iters=128`` puts the iteration error at ``beta^128 ≈ 1e-9``, below
    float32 resolution — edges are assumed unique, which DetectParent's
    one-parent rule guarantees)."""
    if device is False:
        return pagerank_reversed(edges, n, beta=beta)
    if n == 0:
        return np.zeros(0)
    adj = np.zeros((n, n), dtype=np.float32)
    for (u, v) in edges:
        adj[u, v] = 1.0
    dev = torch.device("cuda" if device is True else device)
    r = pagerank_power(torch.as_tensor(adj, device=dev), beta=beta,
                       iters=iters)
    return r.cpu().numpy().astype(np.float64)
