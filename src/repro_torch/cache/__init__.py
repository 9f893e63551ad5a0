"""Unified semantic-cache API of the port: lookup / admit / evict behind one
facade, on the hand-written CUDA kernels.

Quick start::

    from repro_torch.cache import SemanticCache, CacheConfig

    cache = SemanticCache(CacheConfig(capacity=1024, dim=768, tau_hit=0.85))
    res = cache.lookup(query_emb, cid=content_id)      # never admits
    if not res.hit:
        cache.admit(content_id, query_emb, payload=response)

    results = cache.lookup_batch(embs, cids=cids)      # one kernel launch
    state = cache.checkpoint()             # deep snapshot...
    cache.restore(state)                   # ...restored exactly

``CacheConfig`` defaults to ``policy="RAC"`` on the ``"kernel"`` backend
with ``device="cuda"``: the slab, the RAC policy table and the topic
representatives live on the card, and every lookup, fused decision pass
and eviction scoring runs through the CUDA kernels in
:mod:`repro_torch.kernels`.  ``device="cpu"`` runs the same backend on the
kernels' plain PyTorch versions; ``backend="numpy"`` is the host oracle.
Both backends make identical hit/admit/evict decisions.

Two approximate lookups cut the bytes a lookup scans while keeping the
exact scan's decisions: ``CacheConfig(quantized_lookup=True)`` scans an
int8 mirror of the slab and rescores the survivors in fp32, and
``CacheConfig(pruned_lookup=True)`` routes each query to a few topic
buckets of the RAC policy and scans only those.  Both take a dict or a
:class:`QuantizedLookupConfig` / :class:`PrunedLookupConfig` too, and they
compose; lookups of at most ``fused_max_batch`` queries run the fused
pipeline (one host sync), wider ones the staged driver.

``CacheConfig(async_admit=True)`` (a worker thread) or ``"sync"`` (drained
only by ``flush()``) takes admission off the request path, and
``CacheConfig(tiers=TierConfig(host_capacity=..., ghost_capacity=...))``
demotes device evictions to a host-DRAM tier that serves device misses,
over ARC-style ghost lists.  ``policy="RadixRAC"`` is the KV prefix-block
policy that :class:`repro_torch.serving.KVBlockManager` runs on.

``load_reference_state`` fills a RAC cache from plain arrays, so a cache
warmed elsewhere can be continued here.
"""
from .async_admit import AsyncAdmitter
from .backends import KernelBackend, LookupBackend, NumpyBackend, get_backend
from .facade import SemanticCache, load_reference_state
from .pruned import PrunedLookupConfig
from .quantized import QuantizedLookupConfig
from .tiers import GhostTier, HostTier, TierManager, TierStats
from .types import (CacheConfig, CacheEvent, CacheHit, CacheMetrics,
                    CacheMiss, CacheResult, DecisionBatch, TierConfig)

__all__ = [
    "SemanticCache", "CacheConfig", "CacheHit", "CacheMiss", "CacheResult",
    "CacheEvent", "CacheMetrics", "DecisionBatch", "LookupBackend",
    "NumpyBackend", "KernelBackend", "get_backend", "load_reference_state",
    "AsyncAdmitter", "TierConfig", "TierManager", "TierStats", "HostTier",
    "GhostTier", "QuantizedLookupConfig", "PrunedLookupConfig",
]
