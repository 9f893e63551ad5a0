"""The bounded ghost-metadata map shared by RAC's lifetime counters and its
ghost topic memory.

Only :class:`GhostTier` is ported so far; the host-DRAM tier and the tier
manager behind the facade are queued in ``ROADMAP.md``.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["GhostTier"]


class GhostTier:
    """Capacity-bounded insertion-ordered metadata map (FIFO eviction).

    ``put`` inserts (or updates in place, keeping the original insertion
    position — plain dict semantics) and then enforces the bound: when the
    size exceeds ``capacity`` it drops the oldest entries and returns their
    keys so the caller can release any side state.  ``batch_div`` selects
    the drop batch ``max(1, capacity // batch_div, overshoot)`` —
    ``batch_div=16`` amortizes dict churn for the policy's large ghost
    table, ``batch_div=None`` drops exactly the overshoot (the topic-memory
    behavior).  Both keep the bound hard even for tiny capacities.
    """

    def __init__(self, capacity: int, batch_div: Optional[int] = None):
        self.capacity = int(capacity)
        self.batch_div = batch_div
        self._data: dict[Any, Any] = {}

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        return self._data[key]

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key, default=None):
        return self._data.get(key, default)

    def pop(self, key, *default):
        return self._data.pop(key, *default)

    def put(self, key, value) -> list:
        """Insert/update ``key`` and enforce the capacity bound; returns
        the keys dropped (oldest first), empty when nothing fell out."""
        self._data[key] = value
        dropped: list = []
        if len(self._data) > self.capacity:
            batch = self.capacity // self.batch_div if self.batch_div else 0
            drop = max(1, batch, len(self._data) - self.capacity)
            it = iter(self._data)
            dropped = [next(it) for _ in range(min(drop, len(self._data)))]
            for old in dropped:
                del self._data[old]
        return dropped
