"""Slot-based resident-entry store shared by the simulator and policies.

Keeps a dense numpy slab of resident embeddings for vectorized semantic hit
determination (the ``sim_top1`` CUDA kernel scans the same layout on the
card), plus per-slot metadata arrays that relation-aware policies (RAC)
score over in O(m) vectorized time.

Entries are keyed by content id (``cid``): re-admitting content that was
evicted earlier re-uses the same key, which matches query-level caching in
the paper (one entry per unique query content).

Slot *placement* is a policy of the store subclass: the base class packs a
single free-list (LIFO reuse, so occupied slots stay below a high-water
mark ``hwm`` that device backends pass as the kernel's runtime ``n_valid``);
a row-partitioned subclass can override ``_alloc``/``_release`` to route
new entries onto its least-loaded shard.

Mutation tracking lives in :class:`MutationJournal`, shared with
:class:`repro_torch.core.policy_table.PolicyTable` (the RAC scoring slabs ride
the same dirty-row sync protocol as the embedding slab).  ``version`` is a
globally-unique mutation stamp: two journaled objects carry the same
version only if their arrays are identical (deep copies that have not
diverged), which lets device backends cache an uploaded copy keyed by
version alone.  The bounded journal records which row each stamp touched,
so a device backend holding arrays uploaded at an older version of *this*
lineage can ask :meth:`MutationJournal.dirty_since` for the exact row set
to DMA instead of re-uploading everything.
"""
from __future__ import annotations

import itertools
from collections import deque

import numpy as np

_STAMP = itertools.count(1)     # global mutation stamps (see class docstring)

_JOURNAL_LEN = 4096             # mutations remembered for dirty-row sync


class MutationJournal:
    """Bounded (version, row) mutation log with globally-unique stamps.

    One journal tracks one row-indexed axis of one array family (the
    store's slot axis, the policy table's slot axis, its topic axis, ...).
    Deep copies keep their history: stamps are globally unique, so a
    diverged copy's version can never be mistaken for this lineage's.
    """

    def __init__(self, maxlen: int = _JOURNAL_LEN):
        self.maxlen = maxlen
        self.version = next(_STAMP)
        # (version, row) pairs, version-ascending.  _base is the version
        # held just before the oldest journal entry — the earliest version
        # dirty_since can answer for.
        self._journal: deque[tuple[int, int]] = deque()
        self._base = self.version

    def stamp(self, row: int):
        """Record a mutation of ``row`` under a fresh global version."""
        self.version = next(_STAMP)
        self._journal.append((self.version, row))
        while len(self._journal) > self.maxlen:
            self._base = self._journal.popleft()[0]

    def bump(self):
        """Advance the version WITHOUT recording the row — the cheap path
        for owners whose mirrors never scatter (e.g. the arena's per-view
        journals, where a flagged fallback re-upload is fine).  Staleness
        detection stays exact: the base moves with the version, so
        ``dirty_since`` answers the conservative ``None`` (full upload)
        for every version that predates the bump."""
        self.version = next(_STAMP)
        self._base = self.version

    def dirty_since(self, version: int) -> set[int] | None:
        """Rows mutated after ``version``, or None if unanswerable.

        ``version`` must be a stamp this exact lineage has held and that
        is still covered by the journal; anything else returns None (aged
        out, or a foreign/diverged lineage's stamp).
        """
        if version == self.version:
            return set()
        if version < self._base:
            return None                    # aged out (or foreign lineage)
        known = version == self._base
        dirty: set[int] = set()
        for v, row in self._journal:
            if v <= version:
                known = known or v == version
                continue
            if not known:
                return None   # ``version`` was never a stamp of this lineage
            dirty.add(row)
        return dirty if known else None


class ResidentStore:
    def __init__(self, capacity: int, dim: int, n_slots: int | None = None):
        # one spare slot: Alg.1 inserts first, then evicts while |C| > C
        self.capacity = capacity
        n = capacity + 1 if n_slots is None else n_slots
        assert n >= capacity + 1
        self.emb = np.zeros((n, dim), dtype=np.float32)
        self.occ = np.zeros(n, dtype=bool)
        self.cid = np.full(n, -1, dtype=np.int64)
        self.slot_of: dict[int, int] = {}      # cid -> slot
        self._free: list[int] = list(range(n - 1, -1, -1))
        self.hwm = 0                           # all occupied slots < hwm
        # deepcopied with the store, so a restored checkpoint keeps its own
        # lineage's history
        self._log = MutationJournal()

    @property
    def version(self) -> int:
        return self._log.version

    def _stamp(self, slot: int):
        self._log.stamp(slot)

    def dirty_since(self, version: int) -> set[int] | None:
        """Slots mutated after ``version`` (see
        :meth:`MutationJournal.dirty_since`)."""
        return self._log.dirty_since(version)

    def __len__(self) -> int:
        return len(self.slot_of)

    def __contains__(self, cid: int) -> bool:
        return cid in self.slot_of

    def keys(self):
        return self.slot_of.keys()

    # -- slot placement (overridden by sharded stores) ----------------------
    def _alloc(self) -> int:
        return self._free.pop()

    def _release(self, slot: int):
        self._free.append(slot)

    def insert(self, cid: int, emb: np.ndarray) -> int:
        assert cid not in self.slot_of
        slot = self._alloc()
        self.emb[slot] = emb
        self.occ[slot] = True
        self.cid[slot] = cid
        self.slot_of[cid] = slot
        self.hwm = max(self.hwm, slot + 1)
        self._stamp(slot)
        return slot

    def remove(self, cid: int) -> int:
        slot = self.slot_of.pop(cid)
        self.occ[slot] = False
        self.cid[slot] = -1
        # zero the freed row: device backends score the full fixed-shape
        # slab, and a zero embedding can never clear tau_hit > 0
        self.emb[slot] = 0.0
        self._release(slot)
        self._stamp(slot)
        return slot

    # -- semantic hit determination (identical for every policy) -----------
    def nearest(self, q: np.ndarray) -> tuple[int, float]:
        """Top-1 resident by cosine similarity. Returns (cid, sim) or (-1, -inf)."""
        if not self.slot_of:
            return -1, float("-inf")
        sims = self.emb @ q
        sims[~self.occ] = -np.inf
        s = int(np.argmax(sims))
        return int(self.cid[s]), float(sims[s])
