"""PolicyTable — the RAC scoring state as a device-syncable structure.

:class:`repro_torch.core.rac.RACPolicy` historically kept its per-slot counters
(freq/dep/tsi/topic_of/last_t/arrive_t), the per-topic TP tables
(tp_last/t_last), and the topic representatives as loose numpy arrays and
per-``TopicState`` embeddings.  That layout was host-only: every fused
device decision (Top-1 lookup + Alg. 4 routing + Eq. 1 victim scoring)
would have had to re-upload everything per call.

The PolicyTable packs the same state into two journaled array families:

  - **slot axis** (aligned with :class:`~repro_torch.core.store.ResidentStore`
    slots): ``freq``, ``dep``, ``tsi``, ``topic_of``, ``last_t``,
    ``arrive_t``.  Mutations stamp ``slot_log``.
  - **topic axis** (indexed by tid, grown by doubling): ``tp_last``,
    ``t_last``, the dense representative table ``rep`` (T, D) with a
    ``rep_valid`` mask, and ``topic_hwm`` (all live tids < hwm, the
    runtime ``n_valid`` for the routing kernel).  Mutations stamp
    ``topic_log``.

Both journals are :class:`~repro_torch.core.store.MutationJournal` instances —
the exact protocol device backends already use to sync the resident slab —
so a backend caches an uploaded copy keyed by ``(slot_version,
topic_version)`` and scatters only the dirty rows on the next
``decide_batch`` (see ``repro_torch.cache.backends.KernelBackend``).

Deleted topics zero their ``rep`` row (mirroring the store's zeroed free
slots): a zero representative can only win routing Top-1 when every real
similarity is negative, far below any sensible ``tau_route`` gate, so the
host-masked and device-zeroed paths make identical routing *decisions*.

The policy remains the single writer; it mutates the arrays in place and
stamps the touched row through :meth:`touch_slot` / :meth:`touch_topic`
(or the ``set_rep`` / ``clear_slot`` / ``clear_topic`` helpers that stamp
for it).  Checkpointing needs no cooperation: a ``deepcopy`` of the table
carries its journals, and globally-unique stamps keep a restored
snapshot's versions honest.
"""
from __future__ import annotations

import numpy as np

from .store import MutationJournal


class SlabTable:
    """Journaled named per-slot arrays — the generic array-state slab.

    The generalization of the :class:`PolicyTable` slot axis that the
    array-state baseline policies (:mod:`repro_torch.core.policies`) build on:
    each field is a fixed-size 1-D array aligned with the resident store's
    slots, and every mutation can be stamped into one shared
    :class:`~repro_torch.core.store.MutationJournal` — the exact dirty-row sync
    protocol device backends already speak for the embedding slab and the
    RAC scoring tables, so a backend can mirror any policy's metadata
    without knowing which policy owns it.

    ``specs`` maps field name -> ``(dtype, fill)``; fields are exposed as
    attributes (``slabs.seq``, ``slabs.freq``, ...).  The owning policy is
    the single writer: it mutates rows in place and stamps them through
    :meth:`touch` / :meth:`touch_rows`.  Freed slots are *not* cleared on
    eviction — selection masks on store occupancy, and the next admission
    into the slot overwrites every field it reads — so the hot path stays
    O(touched rows); :meth:`clear` exists for policies that do want the
    reset.

    ``journal=False`` (the array-state baselines' default) skips the
    per-row log entirely: nothing mirrors their slabs to a device yet, and
    on the replay hot path a million no-op stamps are real wall time.
    Pass ``journal=True`` (the default) to turn the dirty-row protocol on
    for slabs a device backend will scatter-sync.
    """

    def __init__(self, n_slots: int, journal: bool = True, **specs):
        self.n_slots = n_slots
        self._specs = dict(specs)
        for name, (dtype, fill) in specs.items():
            setattr(self, name, np.full(n_slots, fill, dtype=dtype))
        self.log = MutationJournal() if journal else None

    @property
    def version(self) -> int | None:
        return None if self.log is None else self.log.version

    def dirty_since(self, version: int) -> set[int] | None:
        return None if self.log is None else self.log.dirty_since(version)

    def touch(self, slot: int):
        """Record that row ``slot`` was mutated."""
        if self.log is not None:
            self.log.stamp(int(slot))

    def touch_rows(self, slots):
        """Stamp a batch of mutated rows (vectorized hooks)."""
        if self.log is not None:
            for s in slots:
                self.log.stamp(int(s))

    def clear(self, slot: int):
        """Reset every field of ``slot`` to its fill value."""
        for name, (_, fill) in self._specs.items():
            getattr(self, name)[slot] = fill
        self.touch(slot)


class PolicyTable:
    """Journaled slot/topic scoring slabs (see module docstring)."""

    def __init__(self, n_slots: int, dim: int, n_topics: int = 256):
        self.dim = dim
        # -- slot axis (aligned with store slots) --------------------------
        self.freq = np.zeros(n_slots, dtype=np.float64)
        self.dep = np.zeros(n_slots, dtype=np.float64)
        self.tsi = np.zeros(n_slots, dtype=np.float64)
        self.topic_of = np.full(n_slots, -1, dtype=np.int64)
        self.last_t = np.full(n_slots, -1, dtype=np.int64)
        self.arrive_t = np.full(n_slots, -1, dtype=np.int64)
        # -- topic axis (indexed by tid, doubled on demand) ----------------
        self.tp_last = np.zeros(n_topics, dtype=np.float64)
        self.t_last = np.zeros(n_topics, dtype=np.int64)
        self.rep = np.zeros((n_topics, dim), dtype=np.float32)
        self.rep_valid = np.zeros(n_topics, dtype=bool)
        self.topic_hwm = 0                     # all live tids < topic_hwm
        # -- dirty-row sync ------------------------------------------------
        self.slot_log = MutationJournal()
        self.topic_log = MutationJournal()

    # ------------------------------------------------------------ versions
    @property
    def slot_version(self) -> int:
        return self.slot_log.version

    @property
    def topic_version(self) -> int:
        return self.topic_log.version

    def dirty_slots_since(self, version: int) -> set[int] | None:
        return self.slot_log.dirty_since(version)

    def dirty_topics_since(self, version: int) -> set[int] | None:
        return self.topic_log.dirty_since(version)

    # ------------------------------------------------------------ stamping
    def touch_slot(self, slot: int):
        """Record that the slot-axis row ``slot`` was mutated."""
        self.slot_log.stamp(int(slot))

    def touch_topic(self, tid: int):
        """Record that the topic-axis row ``tid`` was mutated."""
        tid = int(tid)
        if tid + 1 > self.topic_hwm:
            self.topic_hwm = tid + 1
        self.topic_log.stamp(tid)

    # ------------------------------------------------------------- helpers
    @property
    def n_topic_rows(self) -> int:
        return len(self.tp_last)

    def grow_topics(self, tid: int):
        """Double every topic-axis array until ``tid`` is addressable.

        Growth reallocates the arrays, so device mirrors detect the shape
        change and fall back to a full upload (shape mismatch, not the
        journal, is the signal — the journal stays small)."""
        while tid >= len(self.tp_last):
            self.tp_last = np.concatenate([self.tp_last,
                                           np.zeros_like(self.tp_last)])
            self.t_last = np.concatenate([self.t_last,
                                          np.zeros_like(self.t_last)])
            self.rep = np.concatenate([self.rep, np.zeros_like(self.rep)])
            self.rep_valid = np.concatenate([self.rep_valid,
                                             np.zeros_like(self.rep_valid)])

    def set_rep(self, tid: int, emb: np.ndarray, valid: bool = True):
        """Install ``emb`` as topic ``tid``'s representative."""
        self.grow_topics(tid)
        self.rep[tid] = emb
        self.rep_valid[tid] = valid
        self.touch_topic(tid)

    def clear_topic(self, tid: int):
        """Retire a deleted topic: zero its representative row so it can
        never win a routing Top-1 (the TP cells keep their last value —
        ghost revival overwrites them before the tid goes live again)."""
        self.rep[tid] = 0.0
        self.rep_valid[tid] = False
        self.touch_topic(tid)

    def clear_slot(self, slot: int):
        """Reset a freed slot's scoring row (eviction path)."""
        self.freq[slot] = 0.0
        self.dep[slot] = 0.0
        self.tsi[slot] = 0.0
        self.topic_of[slot] = -1
        self.touch_slot(slot)
