"""Tiered cache hierarchy behind :class:`repro_torch.cache.SemanticCache`.

Three tiers, coldest evidence surviving longest (production LLM caches are
inherently multi-tier — HBM holds a fraction of the working set, so an
eviction from the device slab should *demote*, not drop):

  - **Device tier** — the existing journaled
    :class:`~repro_torch.core.store.ResidentStore` slab the backends score
    (unchanged by this module; the facade owns it).
  - **Host tier** (:class:`HostTier`) — a much larger host-DRAM slab that
    catches device evictions (payload + embedding + policy metadata ride
    along) and serves device-tier misses.  It reuses ``ResidentStore``, so
    every tier move is a journal entry on the same
    :class:`~repro_torch.core.store.MutationJournal` protocol the device mirrors
    and checkpoint/restore already speak.  Scoring is host-side
    (:class:`~repro_torch.cache.backends.NumpyBackend`-style ``topk_rows`` over
    the occupied rows) — the host tier is DRAM-resident by definition, and
    its promotion scan is a shortlist, not the hot path.
  - **Ghost tier** (:class:`GhostTier`) — metadata only (id, topic, TP/TSI
    counters), ARC B1/B2-style: one capacity-bounded list for entries
    demoted and never promoted, one for entries that were promoted and
    later fell all the way out again.  A ghost hit at re-admission feeds
    the preserved relation evidence back into the policy (RAC's lifetime
    ``freq``/``dep`` counters and the dead topic's TP state), so
    demoted-then-requested topics re-enter hot instead of cold-starting.

Flow (all under the facade's lock):

  - **demote** — ``_admit_now``'s eviction loop hands the victim's
    embedding, payload, and ``RACPolicy.ghost_meta`` snapshot to
    :meth:`TierManager.demote`; the host tier inserts (insert-then-evict,
    LRU on demote/serve time) and anything it drops falls through to the
    ghost lists.
  - **promote** — a device miss falls through to :meth:`TierManager.serve`
    (Top-K scan via the backend ``topk_rows`` op); the served entry is
    removed here and re-admitted through the facade's normal admission
    path — the :class:`~repro_torch.cache.async_admit.AsyncAdmitter` queue when
    configured, so the request path never blocks on eviction scoring.
  - **revive** — ``_admit_now`` asks :meth:`TierManager.on_admit` whether
    the cid is a known ghost; if so the metadata is pushed back into the
    policy (``revive_ghost``) *before* ``policy.on_admit`` runs, so the
    normal arrival path restores the counters.

The manager holds no reference to the facade or the policy (it is handed
the policy per call), so the facade's ``checkpoint()`` deep copy captures
the whole hierarchy with zero cooperation.  With ``host_capacity=0`` and
``ghost_capacity=0`` the facade never constructs a manager and the single-
tier decision sequence is bit-identical to the pre-tiering code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.store import ResidentStore

from .types import TierConfig

__all__ = ["GhostTier", "HostTier", "TierManager", "TierStats", "TierConfig"]


class GhostTier:
    """Capacity-bounded insertion-ordered metadata map (FIFO eviction).

    The one bounded-ghost structure shared by the tier manager's ARC-style
    B1/B2 lists *and* :class:`~repro_torch.core.rac.RACPolicy`'s lifetime ghost
    counters / ghost topic memory (which it unifies — the policy used to
    hand-roll the same FIFO drop loop twice).

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


@dataclasses.dataclass
class TierStats:
    """Per-tier observability counters (the facade's ``tier_stats``)."""

    host_lookups: int = 0        # device misses that scanned the host tier
    host_hits: int = 0           # ...that the host tier served
    demotions: int = 0           # device evictions caught by the host tier
    promotions: int = 0          # host entries re-admitted toward device
    host_evictions: int = 0      # entries the host tier dropped (LRU)
    host_invalidations: int = 0  # stale host copies dropped at re-admit
    ghost_inserts: int = 0       # metadata records entering B1/B2
    ghost_drops: int = 0         # metadata records aged out of B1/B2
    ghost_revivals: int = 0      # re-admissions that found ghost metadata

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class HostTier:
    """Host-DRAM second tier: a journaled ``ResidentStore`` slab plus the
    demoted entries' payloads and policy metadata, evicted LRU by
    demote/serve time (deterministic ``(last_t, cid)`` tie-break).

    Insert-then-evict like the device tier (the store carries the +1 spare
    slot), so a demote burst never loses the newest entry.  All mutations
    go through ``store.insert``/``store.remove`` — i.e. every tier move is
    a stamped :class:`~repro_torch.core.store.MutationJournal` entry.
    """

    def __init__(self, capacity: int, dim: int):
        self.capacity = int(capacity)
        self.store = ResidentStore(capacity, dim)
        self.payloads: dict[int, Any] = {}
        self.meta: dict[int, Optional[dict]] = {}
        self.last_t: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.store)

    def __contains__(self, cid: int) -> bool:
        return cid in self.store

    def put(self, cid: int, emb: np.ndarray, payload: Any, t: int,
            meta: Optional[dict]) -> list[tuple[int, Optional[dict]]]:
        """Demote one entry in; returns ``(cid, meta)`` for everything the
        LRU bound pushed out (→ ghost tier)."""
        if cid in self.store:
            self.store.remove(cid)          # refresh = journaled re-insert
        self.store.insert(cid, np.asarray(emb, dtype=np.float32))
        self.payloads[cid] = payload
        self.meta[cid] = meta
        self.last_t[cid] = t
        dropped: list[tuple[int, Optional[dict]]] = []
        while len(self.store) > self.capacity:
            old = min(self.store.slot_of,
                      key=lambda c: (self.last_t.get(c, -1), c))
            self.store.remove(old)
            self.payloads.pop(old, None)
            self.last_t.pop(old, None)
            dropped.append((old, self.meta.pop(old, None)))
        return dropped

    def take(self, cid: int, t: int) -> tuple[np.ndarray, Any,
                                              Optional[dict]]:
        """Remove-at-serve: pop the entry for promotion (the admission
        path owns it from here)."""
        slot = self.store.slot_of[cid]
        emb = self.store.emb[slot].copy()
        self.store.remove(cid)
        payload = self.payloads.pop(cid, None)
        meta = self.meta.pop(cid, None)
        self.last_t.pop(cid, None)
        return emb, payload, meta

    def drop(self, cid: int) -> bool:
        """Invalidate a (stale) host copy without serving it."""
        if cid not in self.store:
            return False
        self.store.remove(cid)
        self.payloads.pop(cid, None)
        self.meta.pop(cid, None)
        self.last_t.pop(cid, None)
        return True

    def occupied_rows(self) -> np.ndarray:
        return np.fromiter(self.store.slot_of.values(), dtype=np.int64,
                           count=len(self.store.slot_of))

    def top1_batch(self, queries: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Host Top-1 per query — the ``decide_batch`` fall-through
        columns (host_cid/host_sim)."""
        from .backends import NumpyBackend
        queries = np.asarray(queries, dtype=np.float32)
        rows = self.occupied_rows()
        if rows.size == 0:
            b = queries.shape[0]
            return (np.full(b, -1, dtype=np.int64),
                    np.full(b, -np.inf, dtype=np.float64))
        return NumpyBackend().top1_rows(self.store, queries, rows)

    def topk(self, emb: np.ndarray, k: int, backend=None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Promotion scan: Top-K over the occupied rows through a backend's
        ``topk_rows`` op (host-side numpy scoring by default)."""
        if backend is None:
            from .backends import NumpyBackend
            backend = NumpyBackend()
        rows = self.occupied_rows()
        if rows.size == 0:
            return (np.full((1, k), -1, dtype=np.int64),
                    np.full((1, k), -np.inf, dtype=np.float64))
        return backend.topk_rows(
            self.store, np.asarray(emb, dtype=np.float32)[None, :], rows, k)


class TierManager:
    """Owns the host tier and the ARC-style ghost lists; the facade calls
    it at three points (all under the facade's lock): device eviction
    (:meth:`demote`), device miss (:meth:`serve`), and admission
    (:meth:`on_admit`).  It never calls back into the facade, so the
    checkpoint deep copy needs no cooperation.

    ``tracker`` (a scoped :class:`repro_torch.telemetry.Tracker` child, or
    None) receives the same flow counters :class:`TierStats` accumulates
    — demotions, promotions, host hits/evictions, ghost churn — plus a
    windowed promotion-rate series, so the per-tier flow shows up in the
    unified metric registry alongside the cache-level series.  Trackers
    deep-copy as shared references, so checkpointing a tiered cache never
    clones the sink."""

    def __init__(self, cfg: TierConfig, dim: int, tracker=None):
        self.cfg = cfg
        self.dim = dim
        self._trk = tracker
        self.host = (HostTier(cfg.host_capacity, dim)
                     if cfg.host_capacity > 0 else None)
        # ARC-style split: b1 = demoted, never promoted; b2 = promoted at
        # least once, then lost again (each bounded at ghost_capacity)
        cap = max(0, int(cfg.ghost_capacity))
        self.ghost_b1 = GhostTier(cap)
        self.ghost_b2 = GhostTier(cap)
        # promotion memory for the B1/B2 routing: the policy rebuilds an
        # eviction's metadata from scratch, so the "was promoted" bit has
        # to live here (bounded like the ghost lists themselves)
        self.promoted = GhostTier(cap)
        self.stats = TierStats()

    def _count(self, name: str, n: int = 1):
        # tolerate pre-telemetry snapshots restored into this process
        trk = getattr(self, "_trk", None)
        if trk is not None and n:
            trk.count(name, n)

    # ------------------------------------------------------------- ghosts
    def _ghost_insert(self, cid: int, meta: Optional[dict]):
        if self.cfg.ghost_capacity <= 0:
            return
        meta = dict(meta) if meta is not None else {}
        if meta.get("promoted") or cid in self.promoted:
            meta["promoted"] = True
        lst = self.ghost_b2 if meta.get("promoted") else self.ghost_b1
        dropped = lst.put(cid, meta)
        self.stats.ghost_inserts += 1
        self.stats.ghost_drops += len(dropped)
        self._count("ghost_inserts")
        self._count("ghost_drops", len(dropped))

    def ghost_get(self, cid: int) -> Optional[dict]:
        """Peek (no removal) at a cid's ghost record, B2 before B1."""
        hit = self.ghost_b2.get(cid)
        return hit if hit is not None else self.ghost_b1.get(cid)

    # ------------------------------------------------------------- demote
    def demote(self, cid: int, emb: np.ndarray, payload: Any, t: int,
               meta: Optional[dict]) -> bool:
        """Catch a device eviction.  Returns True when the entry landed in
        the host tier (payload retained), False when it fell straight to
        ghost metadata (or nowhere)."""
        if self.host is None:
            self._ghost_insert(cid, meta)
            return False
        self.stats.demotions += 1
        self._count("demotions")
        for old, old_meta in self.host.put(cid, emb, payload, t, meta):
            self.stats.host_evictions += 1
            self._count("host_evictions")
            self._ghost_insert(old, old_meta)
        return True

    # -------------------------------------------------------------- serve
    def serve(self, emb: np.ndarray, *, cid: int = -1,
              hit_mode: str = "semantic", tau_hit: float = 0.85,
              t: int = 0) -> list[tuple[int, float, np.ndarray, Any,
                                        Optional[dict]]]:
        """Host-tier fall-through for a device miss.

        Returns the served entries, best first — ``(cid, sim, emb,
        payload, meta)`` — already *removed* from the host tier (the
        caller re-admits them; remove-at-serve keeps exactly one
        authoritative copy).  Ranks past the first are ``promote_k``
        co-promotion candidates that also cleared ``tau_hit``.  Empty
        list = genuine miss."""
        if self.host is None or len(self.host) == 0:
            return []
        self.stats.host_lookups += 1
        self._count("host_lookups")
        if hit_mode == "content":
            if cid not in self.host:
                return []
            hemb, payload, meta = self.host.take(cid, t)
            if meta is not None:
                meta["promoted"] = True
            if self.cfg.ghost_capacity > 0:
                self.promoted.put(cid, True)
            self.stats.host_hits += 1
            self.stats.promotions += 1
            self._record_promotions(1, t)
            return [(cid, float("nan"), hemb, payload, meta)]
        k = max(1, int(self.cfg.promote_k))
        cids, sims = self.host.topk(emb, k)
        out = []
        for hcid, sim in zip(cids[0], sims[0]):
            if hcid < 0 or sim < tau_hit:
                break                    # sorted descending: nothing below
            hemb, payload, meta = self.host.take(int(hcid), t)
            if meta is not None:
                meta["promoted"] = True
            if self.cfg.ghost_capacity > 0:
                self.promoted.put(int(hcid), True)
            out.append((int(hcid), float(sim), hemb, payload, meta))
        if out:
            self.stats.host_hits += 1
            self.stats.promotions += len(out)
            self._record_promotions(len(out), t)
        return out

    def _record_promotions(self, n: int, t: int):
        trk = getattr(self, "_trk", None)
        if trk is None:
            return
        trk.count("host_hits")
        trk.count("promotions", n)
        # windowed promotion rate over logical time
        trk.observe("promotion", float(n), t)

    # ------------------------------------------------------------ admission
    def on_admit(self, cid: int, policy, emb: np.ndarray):
        """Admission-side bookkeeping, called between the device-store
        insert and ``policy.on_admit``: drop any stale host copy (the
        device entry is authoritative now) and, if the cid is a known
        ghost, feed the preserved metadata back into the policy
        (``revive_ghost``) so the normal arrival path restores the
        counters — and the demoted topic re-enters hot."""
        if self.host is not None and self.host.drop(cid):
            self.stats.host_invalidations += 1
            self._count("host_invalidations")
        meta = self.ghost_b2.pop(cid, None)
        if meta is None:
            meta = self.ghost_b1.pop(cid, None)
        if meta is None:
            return
        self.stats.ghost_revivals += 1
        self._count("ghost_revivals")
        revive = getattr(policy, "revive_ghost", None)
        if revive is not None:
            revive(cid, meta, rep=emb)
