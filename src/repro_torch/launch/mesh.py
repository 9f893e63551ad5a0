"""The cache mesh: which cards hold the shards of the sharded semantic cache.

A function, not a module-level constant, so importing this module never
touches the CUDA runtime.  Training runs on one card (``launch/train.py``);
the reference's production and dry-run meshes (``make_production_mesh``,
``make_local_mesh``, ``abstract_mesh``) wait for ``ROADMAP.md`` queue A
item 12.
"""
from __future__ import annotations

import torch


def make_cache_mesh(n_shards: int, device="cuda"):
    """One card per shard of the row-partitioned resident slab: the list
    ``[cuda:0, ..., cuda:n_shards-1]``.

    Returns ``None`` when ``device`` is not CUDA, when ``n_shards <= 1``,
    or when fewer cards exist: callers then run the identical per-shard
    math and merge as a loop on one device, so decisions never depend on
    the machine."""
    if torch.device(device).type != "cuda" or n_shards <= 1 \
            or torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", s) for s in range(n_shards)]
