"""Core datatypes for the RAC cache-replacement framework.

A *trace* is a time-ordered sequence of :class:`Request`.  Each request
carries a content id (``cid``) identifying the unique underlying query
content, and an embedding.  Paraphrases of the same content share a ``cid``
but have (slightly) different embeddings; the embedding geometry is built so
that ``sim(paraphrase, original) >= tau_hit`` while distinct contents stay
below ``tau_hit`` (see :mod:`repro_torch.core.embeddings`).

``topic`` / ``session`` / ``parent_idx`` are *generator-side ground truth*
used for analysis and for the offline-optimal policy; online policies only
see ``cid`` lazily through hit determination plus the embedding.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One arrival in the trace."""

    t: int                      # time step (position in trace)
    cid: int                    # unique content id (ground truth equivalence)
    emb: np.ndarray             # unit-norm embedding, shape (dim,)
    topic: int = -1             # ground-truth topic label  Z_t
    session: int = -1           # ground-truth session/episode id
    parent_cid: int = -1        # ground-truth dependency parent (-1: root)
    next_use: int = -1          # next position with same cid (-1: never); filled by simulator
    timestamp: float = 0.0      # wall-clock style timestamp (OASST-style traces)


@dataclasses.dataclass
class Trace:
    """A full request sequence plus generator metadata."""

    requests: list[Request]
    n_topics: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    def cids(self) -> np.ndarray:
        return np.array([r.cid for r in self.requests], dtype=np.int64)

    def with_next_use(self) -> "Trace":
        """Fill ``next_use`` pointers (needed by Belady-MIN)."""
        last_seen: dict[int, int] = {}
        for i in range(len(self.requests) - 1, -1, -1):
            r = self.requests[i]
            r.next_use = last_seen.get(r.cid, -1)
            last_seen[r.cid] = i
        return self


@dataclasses.dataclass
class Stats:
    """Outcome of one simulation run."""

    policy: str = ""
    capacity: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    requests: int = 0
    hr_full: float = float("nan")   # infinite-cache hit ratio on same trace
    wall_s: float = 0.0

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(1, self.requests)

    @property
    def hr_norm(self) -> float:
        """Normalized hit ratio  HR_algo(C) / HR_full  (paper §4.2)."""
        if not np.isfinite(self.hr_full) or self.hr_full <= 0:
            return float("nan")
        return self.hit_ratio / self.hr_full

    def row(self) -> str:
        return (f"{self.policy},{self.capacity},{self.hits},{self.misses},"
                f"{self.hit_ratio:.4f},{self.hr_norm:.4f},{self.wall_s:.3f}")


ROW_HEADER = "policy,capacity,hits,misses,hit_ratio,hr_norm,wall_s"


def summarize(stats: Sequence[Stats]) -> str:
    return "\n".join([ROW_HEADER] + [s.row() for s in stats])
