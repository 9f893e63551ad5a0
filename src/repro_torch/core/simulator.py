"""Trace-driven cache simulator with shared hit semantics (paper §2, §4.2).

All policies see the *same* request sequence under *identical* hit
semantics, enforced by driving every run through the unified
:class:`repro_torch.cache.SemanticCache` facade.  Two equivalent hit modes:

  - ``content``:  hit iff the request's content id is resident (query-level
    content equivalence).  O(1), used for large sweeps.
  - ``semantic``: hit iff the Top-1 resident by cosine similarity clears
    tau_hit (embedding-based semantic equivalence; the mode the paper's
    semantic cache uses).  The synthetic embedding geometry makes the two
    agree (paraphrase sim ≈ 0.93 > tau_hit > in-topic distinct ≈ 0.72);
    ``tests/test_simulator.py`` asserts the agreement.

Admission is always-admit (paper Alg. 1 line 4: insert, then evict while
over capacity) — policies express admission control by electing the fresh
entry as the victim (e.g. TinyLFU).

``run_policy`` replays one request at a time (bit-for-bit the historical
loop, one backend Top-1 per request).  ``run_policy_batched`` is the
large-sweep fast path and is *exact*: each chunk is scored by ONE fused
``decide_batch`` launch against the chunk-start snapshot, and the replay
closes the snapshot gap incrementally — every intra-chunk admission
rescores only the chunk's remaining queries against the one new row (a
rank-1 host update), and a query whose running best was evicted mid-chunk
falls back to a fresh backend Top-1 exactly as ``run_policy`` would have
computed it.  Hit/miss/eviction decisions are therefore bit-identical to
``run_policy`` for every chunk size (``tests/test_simulator.py`` asserts
this across content/semantic modes, chunk sizes, and backends;
exactness is modulo float-exact similarity ties between distinct
embeddings, which the synthetic geometry excludes).  Content mode needs no
similarity work and simply delegates.

Both drivers default to the ``"kernel"`` backend on the card
(``device="cuda"``); pass ``device="cpu"`` to run the kernels' plain
versions, or ``backend="numpy"`` for the host oracle.
"""
from __future__ import annotations

import inspect
import time
from typing import TYPE_CHECKING, Callable

import numpy as np

from .store import ResidentStore
from .types import Stats, Trace

if TYPE_CHECKING:         # deferred at runtime: repro_torch.cache imports
    from repro_torch.cache import SemanticCache   # core.{store,types}

PolicyFactory = Callable[[int, ResidentStore], "Policy"]

# host-vs-backend float slack: an incremental rescore whose outcome sits
# within this band of the running best (or of tau_hit) falls back to the
# reference backend scan, so scoring-engine accumulation order can never
# flip a decision (see run_policy_batched)
_EPS = 1e-4


def with_seed(factory: PolicyFactory, seed: int | None) -> PolicyFactory:
    """Bind a deterministic ``seed`` into a policy factory.

    Factories that expose a ``seed`` parameter get it bound; plain
    ``(capacity, store)`` factories pass through untouched."""
    if seed is None:
        return factory
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):          # builtins/partials without sig
        return factory
    if "seed" not in params:
        return factory

    def seeded(capacity, store):
        return factory(capacity, store, seed=seed)

    seeded.__name__ = getattr(factory, "__name__", "policy")
    return seeded


def hr_full(trace: Trace) -> float:
    """Infinite-cache hit ratio: every non-first occurrence hits."""
    seen: set[int] = set()
    hits = 0
    for r in trace.requests:
        if r.cid in seen:
            hits += 1
        seen.add(r.cid)
    return hits / max(1, len(trace.requests))


def _make_cache(trace: Trace, capacity: int, factory: PolicyFactory,
                hit_mode: str, tau_hit: float, backend: str,
                device: str) -> "SemanticCache":
    # deferred: repro_torch.cache depends on repro_torch.core.{store,types},
    # and this module is imported during repro_torch.core package init
    from repro_torch.cache import CacheConfig, SemanticCache
    dim = trace.requests[0].emb.shape[0]
    cfg = CacheConfig(capacity=capacity, dim=dim, tau_hit=tau_hit,
                      hit_mode=hit_mode, backend=backend,
                      device=device)
    return SemanticCache(cfg, policy_factory=factory)


def _finish(stats: Stats, cache: "SemanticCache", trace: Trace,
            t0: float) -> Stats:
    m = cache.metrics
    stats.hits, stats.misses, stats.evictions = m.hits, m.misses, m.evictions
    stats.wall_s = time.perf_counter() - t0
    stats.hr_full = hr_full(trace)
    return stats


def run_policy(trace: Trace, capacity: int, factory: PolicyFactory,
               hit_mode: str = "content", tau_hit: float = 0.85,
               name: str | None = None, backend: str = "kernel",
               device: str = "cuda", seed: int | None = None) -> Stats:
    """Replay ``trace`` through a :class:`SemanticCache` one request at a
    time — the reference protocol every policy is compared under."""
    cache = _make_cache(trace, capacity, with_seed(factory, seed), hit_mode,
                        tau_hit, backend, device)
    stats = Stats(policy=name or getattr(cache.policy, "name",
                                         factory.__name__),
                  capacity=capacity, requests=len(trace.requests))
    t0 = time.perf_counter()
    for req in trace.requests:
        r = cache.lookup(req.emb, cid=req.cid, t=req.t, req=req)
        if not r.hit:
            cache.admit(req.cid, req.emb, t=req.t, req=req)
    return _finish(stats, cache, trace, t0)


def run_policy_batched(trace: Trace, capacity: int, factory: PolicyFactory,
                       hit_mode: str = "semantic", tau_hit: float = 0.85,
                       name: str | None = None, backend: str = "kernel",
                       chunk: int = 512, device: str = "cuda",
                       seed: int | None = None) -> Stats:
    """Exact incremental batched replay (one fused launch per chunk).

    The chunk-start ``decide_batch`` snapshot supplies every query's
    running-best Top-1; the replay then applies requests in order and
    keeps the snapshot exact:

      - an admission that inserts a new row rescores the chunk's remaining
        queries against that one embedding (an entry of the chunk's Gram
        matrix — no extra kernel launch) and promotes strictly-better
        candidates.  Because these rescores are host dot products while
        the snapshot came from the backend's own scoring engine, any new
        row landing within a small epsilon of a query's running best also
        *flags* that query: at its turn the snapshot is discarded and
        ``lookup`` recomputes a fresh backend Top-1 — the identical call
        ``run_policy`` makes — so borderline decisions near ``tau_hit``
        (or near-tied argmaxes) are always made by the same engine;
      - a query whose running best was evicted at any point in the chunk
        (even if the same cid was later re-admitted under a fresh
        embedding) is flagged the same way;
      - hits never mutate residency, so their snapshots stay valid.

    Decisions (hit cids, admissions, eviction victims) are bit-identical
    to :func:`run_policy`: every query's best is taken over exactly the
    entries resident at its own turn, and every decision that could hinge
    on sub-epsilon float differences between scoring engines falls back to
    the reference scan.  ``chunk=1`` degenerates to the per-request loop.
    Content mode needs no similarity work and simply delegates.
    """
    if hit_mode == "content":
        return run_policy(trace, capacity, factory, hit_mode=hit_mode,
                          tau_hit=tau_hit, name=name, backend=backend,
                          device=device, seed=seed)
    cache = _make_cache(trace, capacity, with_seed(factory, seed), hit_mode,
                        tau_hit, backend, device)
    stats = Stats(policy=name or getattr(cache.policy, "name",
                                         factory.__name__),
                  capacity=capacity, requests=len(trace.requests))
    t0 = time.perf_counter()
    reqs = trace.requests
    step = max(1, chunk)
    for lo in range(0, len(reqs), step):
        block = reqs[lo:lo + step]
        b = len(block)
        embs = np.stack([r.emb for r in block]).astype(np.float32,
                                                       copy=False)
        dec = cache.decide_batch(embs)
        best_cid = np.asarray(dec.hit_cid, dtype=np.int64).copy()
        best_sim = np.asarray(dec.hit_sim, dtype=np.float64).copy()
        # an intra-chunk admission's row IS that request's own embedding,
        # so every possible incremental-rescore similarity is an entry of
        # the chunk's Gram matrix: one gemm replaces per-admission matvecs
        # (skipped for huge chunks where the B x B buffer would dominate)
        gram = embs @ embs.T if 1 < b <= 8192 else None
        # flagged[j]: query j's decision could hinge on a host-vs-backend
        # float difference (an intra-chunk row within _EPS of its running
        # best) — force the reference backend scan at its turn
        flagged = np.zeros(b, dtype=bool)
        promoted = np.zeros(b, dtype=bool)   # best came from a host rescore
        gone: set[int] = set()         # cids evicted at any point this chunk
        for i, req in enumerate(block):
            c = int(best_cid[i])
            # a running best that was ever evicted this chunk is stale even
            # if re-admitted (the re-admission carries a fresh embedding);
            # a host-promoted best within _EPS of the hit threshold could
            # flip under the backend's own accumulation order — both cases
            # drop the snapshot so lookup() recomputes the full Top-1
            stale = (flagged[i] or c in gone
                     or (promoted[i]
                         and abs(best_sim[i] - tau_hit) <= _EPS))
            top1 = None if stale else (c, float(best_sim[i]))
            r = cache.lookup(req.emb, cid=req.cid, t=req.t, req=req,
                             top1=top1)
            if r.hit:
                continue
            was_resident = req.cid in cache
            gone.update(cache.admit(req.cid, req.emb, t=req.t, req=req))
            if not was_resident and req.cid in cache and i + 1 < b:
                # exact incremental rescore: the one dirtied row is scored
                # against the remaining queries (strictly-better wins; a
                # near-tie flags the query for the reference scan instead)
                sims = (gram[i + 1:, i] if gram is not None else
                        embs[i + 1:] @ np.asarray(req.emb,
                                                  dtype=np.float32))
                tail = best_sim[i + 1:]
                # a near-tie only matters when it can change a decision:
                # below the hit gate the argmax identity is irrelevant
                # (the lookup is a miss either way, and evicted bests are
                # handled by `gone`), so only gate-adjacent ties flag
                flagged[i + 1:] |= ((np.abs(sims - tail) <= _EPS)
                                    & (np.maximum(sims, tail)
                                       >= tau_hit - _EPS))
                upd = sims > tail
                if upd.any():
                    tail[upd] = sims[upd]
                    best_cid[i + 1:][upd] = req.cid
                    promoted[i + 1:][upd] = True
    return _finish(stats, cache, trace, t0)
