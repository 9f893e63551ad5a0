"""The eviction-policy protocol driven by the simulator and the facade.

  - ``on_hit(cid, req, t)``   — the store served ``req`` from entry ``cid``
  - ``on_admit(cid, req, t)`` — a miss; entry ``cid`` was just inserted
  - ``victim(t) -> cid``      — called while the store is over capacity;
                                must return a resident cid

Only the base class is ported so far; the 16 array-state baselines are
queued in ``ROADMAP.md``.
"""
from __future__ import annotations


class Policy:
    name = "base"
    requires_future = False

    def __init__(self, capacity: int, store=None, **kw):
        self.capacity = capacity
        self.store = store

    def on_hit(self, cid: int, req, t: int):  # pragma: no cover - interface
        raise NotImplementedError

    def on_admit(self, cid: int, req, t: int):
        raise NotImplementedError

    def victim(self, t: int) -> int:
        raise NotImplementedError

    # -- batched surface (default: the scalar loop, always correct) --------
    def on_hit_batch(self, cids, reqs, ts):
        for i, cid in enumerate(cids):
            self.on_hit(cid, reqs[i], ts[i])

    def on_admit_batch(self, cids, reqs, ts):
        for i, cid in enumerate(cids):
            self.on_admit(cid, reqs[i], ts[i])
