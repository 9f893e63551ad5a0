"""`SemanticCache` — the single owner of lookup, admission, and eviction.

Every consumer in the repo (trace simulator, serving engine, examples,
benchmarks) drives the cache through this facade instead of wiring
``ResidentStore`` + ``Policy`` by hand.  The protocol is the paper's
Alg. 1 exactly:

  - ``lookup`` determines a hit under identical semantics for every policy
    (Top-1 cosine >= tau_hit in semantic mode; content-id residency in
    content mode) and notifies the policy of hits.  Lookups never admit.
  - ``admit`` is always-admit (Alg. 1 line 4): insert, then evict while
    over capacity.  Policies express admission control by electing the
    fresh entry as the victim (e.g. TinyLFU).
  - payloads (cached responses) live here too: eviction drops the payload
    and fires the ``"evict"`` event — no consumer hand-rolls payload
    bookkeeping anymore.

Batching: ``lookup_batch`` drains whole query blocks in one backend call
(one ``sim_top1`` kernel launch under the kernel backend), and
``decide_batch`` scores a block's hit, routing and victim legs in one
fused dispatch.  A batched lookup scores every query against the store
*snapshot* at call time; hits are revalidated against residency when
results are applied, so interleaved evictions can never produce a stale
hit.  All mutable state is guarded by one reentrant lock.

Telemetry: ``cfg.tracker`` attaches a :class:`repro_torch.telemetry.
Tracker` the facade emits through — lookup/admit latency histograms,
windowed hit-ratio and occupancy series, eviction counters, and a span
around ``decide_batch``.  The device backend gets a scoped child
(``backend.*`` names).  Emission is strictly observation-only,
``metrics_snapshot()`` consolidates every counter surface into one dict,
and event-subscriber failures are contained (counted as ``hook_errors``;
``cfg.debug_hooks`` re-raises).

Not ported yet (each raises ``NotImplementedError``, see ``ROADMAP.md``):
asynchronous admission, the host/ghost tiers behind the facade, the
quantized and pruned lookups, the baseline policies and ``"RadixRAC"``.

:func:`load_reference_state` fills a cache from the plain-array state of
another implementation's cache (the reference's, in the tests), so a
warmed cache can be continued here.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.store import ResidentStore
from repro_torch.core.types import Request
from repro_torch.telemetry.tracker import make_tracker

from .backends import LookupBackend, _not_ported, get_backend
from .types import (CacheConfig, CacheEvent, CacheHit, CacheMetrics,
                    CacheMiss, CacheResult, DecisionBatch)

PolicyFactory = Callable[[int, ResidentStore], Any]

_NULL_CM = contextlib.nullcontext()      # reusable no-op span

_MUTABLE_STATE = ("store", "policy", "payloads", "clock", "metrics")

# policy hook attribute -> backend method wired into it (device-side
# eviction scoring: RAC consumes Eq. 1 values; the masked variant is the
# radix policy's, kept so the hook table matches the reference)
_VALUE_HOOKS = (("value_backend", "rac_value"),
                ("masked_value_backend", "rac_value_masked"))


def _make_policy(cfg: CacheConfig, store: ResidentStore):
    if cfg.policy == "RAC":
        from repro_torch.core.rac import RACPolicy
        return RACPolicy(cfg.capacity, store, **cfg.policy_kwargs)
    if cfg.policy == "RadixRAC":
        raise _not_ported("policy 'RadixRAC'", "9")
    raise _not_ported(f"policy {cfg.policy!r}", "2")


class SemanticCache:
    """Batched, backend-pluggable semantic cache (see module docstring).

    ``policy_factory`` overrides ``cfg.policy`` with the simulator's
    ``(capacity, store) -> Policy`` calling convention, so sweep drivers
    can inject pre-built factories unchanged.
    """

    def __init__(self, cfg: CacheConfig,
                 policy_factory: Optional[PolicyFactory] = None,
                 backend: Optional[LookupBackend] = None):
        self.cfg = cfg
        if cfg.async_admit:
            raise _not_ported("async_admit", "3")
        if cfg.tiers is not None and (cfg.tiers.host_capacity > 0
                                      or cfg.tiers.ghost_capacity > 0):
            raise _not_ported("tiers", "4")
        if cfg.quantized_lookup:
            raise _not_ported("quantized_lookup", "5")
        if cfg.pruned_lookup:
            raise _not_ported("pruned_lookup", "6")
        if backend is not None:
            if cfg.backend_kwargs:
                raise ValueError(
                    "backend_kwargs "
                    f"{sorted(cfg.backend_kwargs)} cannot apply to an "
                    "already-built backend instance")
            self.backend = backend
        else:
            kw = dict(cfg.backend_kwargs)
            if cfg.backend == "kernel":
                kw.setdefault("device", cfg.device)
            self.backend = get_backend(cfg.backend, **kw)
        self.store = ResidentStore(cfg.capacity, cfg.dim)
        self.policy = (policy_factory(cfg.capacity, self.store)
                       if policy_factory is not None
                       else _make_policy(cfg, self.store))
        self.payloads: dict[int, Any] = {}
        self.metrics = CacheMetrics()
        self.clock = 0                     # internal logical time
        self._hooks: dict[str, list[Callable[[CacheEvent], None]]] = {}
        self._lock = threading.RLock()     # guards all mutable state
        self._wire_value_backend()
        # telemetry: strictly observation-only — None skips emission
        # entirely, and decisions are identical with any tracker
        self._trk = make_tracker(cfg.tracker)
        if self._trk is not None and hasattr(self.backend, "set_tracker"):
            self.backend.set_tracker(self._trk.child("backend"))

    def _wire_value_backend(self):
        for attr, method in _VALUE_HOOKS:
            if hasattr(self.policy, attr):
                setattr(self.policy, attr, getattr(self.backend, method))

    # ----------------------------------------------------------- events
    def subscribe(self, kind: str, fn: Callable[[CacheEvent], None]):
        """Register ``fn`` for ``"hit" | "miss" | "admit" | "evict"``."""
        self._hooks.setdefault(kind, []).append(fn)
        return fn

    def _emit(self, kind: str, cid: int, t: int, sim: float = float("nan"),
              payload: Any = None, tier: str = "device"):
        hooks = self._hooks.get(kind)
        if not hooks:
            return
        ev = CacheEvent(kind=kind, cid=cid, t=t, sim=sim,
                        payload=payload, tier=tier)
        for fn in hooks:
            try:
                fn(ev)
            except Exception:
                # a subscriber must never corrupt the cache operation it
                # observes: count the failure and keep going (the
                # development mode re-raises at the call site)
                self.metrics.hook_errors += 1
                if self._trk is not None:
                    self._trk.count("cache.hook_errors",
                                    tags={"kind": kind})
                if self.cfg.debug_hooks:
                    raise

    # ------------------------------------------------------------ basics
    def __len__(self) -> int:
        return len(self.store)

    def __contains__(self, cid: int) -> bool:
        return cid in self.store

    @property
    def tracker(self):
        """The attached :class:`repro_torch.telemetry.Tracker` (or None)."""
        return self._trk

    def metrics_snapshot(self) -> dict:
        """The consolidated observability surface: ONE dict merging the
        :class:`CacheMetrics` counters, the device backend's mirror-sync
        stats (``sync``, when the backend keeps device mirrors), and the
        launch/transfer ledger (``dispatch``, zeros for host backends)."""
        with self._lock:
            snap = self.metrics.snapshot()
            snap["pending_admits"] = 0
            snap["admit_stall_s"] = self.metrics.admit_s
            sync = getattr(self.backend, "sync_stats", None)
            if sync:
                snap["sync"] = dict(sync)
            dispatch = getattr(self.backend, "dispatch_stats", None)
            if dispatch is None:
                dispatch = {"launches": 0, "host_syncs": 0, "kernel_s": 0.0}
            snap["dispatch"] = dict(dispatch)
            return snap

    def _tick(self, t: Optional[int]) -> int:
        if t is None:
            self.clock += 1
            return self.clock
        self.clock = max(self.clock, t)
        return t

    def _request(self, cid: int, emb: np.ndarray, t: int,
                 req: Optional[Request]) -> Request:
        return req if req is not None else Request(t=t, cid=cid, emb=emb)

    # ------------------------------------------------------------ lookup
    def lookup(self, emb: np.ndarray, *, cid: int = -1,
               t: Optional[int] = None, req: Optional[Request] = None,
               top1: Optional[tuple[int, float]] = None) -> CacheResult:
        """Hit determination for one query.  Never admits.

        ``cid`` is the query's content id (required for content mode and
        for consumers that track per-content payloads).  ``top1`` is an
        optional precomputed ``(cid, sim)`` from a snapshot ``peek_batch``;
        it is revalidated against residency and recomputed on staleness.
        """
        t0 = time.perf_counter()
        with self._lock:
            t = self._tick(t)
            if self.cfg.hit_mode == "content":
                best_cid, best_sim = cid, float("nan")
                hit_cid = cid if cid in self.store else -1
            else:
                if top1 is not None and (top1[0] < 0 or top1[0] in self.store):
                    best_cid, best_sim = top1
                else:
                    best_cid, best_sim = self.backend.top1(self.store, emb)
                hit_cid = best_cid if best_sim >= self.cfg.tau_hit else -1
            self.metrics.lookups += 1
            if hit_cid >= 0:
                self.metrics.hits += 1
                self.policy.on_hit(hit_cid,
                                   self._request(hit_cid, emb, t, req), t)
                self._emit("hit", hit_cid, t, best_sim,
                           self.payloads.get(hit_cid))
                result: CacheResult = CacheHit(
                    cid=hit_cid, sim=best_sim,
                    payload=self.payloads.get(hit_cid), t=t)
            else:
                self.metrics.misses += 1
                self._emit("miss", cid, t, best_sim)
                result = CacheMiss(
                    best_cid=best_cid if np.isfinite(best_sim) else -1,
                    best_sim=best_sim, t=t)
            dt = time.perf_counter() - t0
            self.metrics.lookup_s += dt
            trk = self._trk
            if trk is not None:
                trk.observe("cache.lookup_s", dt)
                # windowed hit indicator over logical time -> the
                # hit-ratio-over-time series every workload study wants
                trk.observe("cache.hit", 1.0 if result.hit else 0.0, t)
        return result

    def peek_batch(self, embs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw snapshot Top-1 over a (B, D) query block — one backend call,
        no policy/metrics side effects.  Sims are against the store as of
        this call; pair with ``lookup(..., top1=...)`` to apply results."""
        with self._lock:
            return self.backend.top1_batch(self.store, np.asarray(embs))

    def decide_batch(self, embs: np.ndarray, *,
                     t: Optional[int] = None) -> "DecisionBatch":
        """Fused snapshot decision scoring over a (B, D) query block — ONE
        backend dispatch computes the Top-1 hit candidates, the Alg. 4
        topic-routing candidates, and the masked Eq. 1 victim values over
        the policy's :class:`~repro_torch.core.policy_table.PolicyTable`
        (the device backend mirrors the table by dirty-row copies, so
        steady-state chunks move O(mutations), not O(capacity)).  Like
        ``peek_batch`` this has no policy/metrics side effects; the hit
        columns are exactly ``peek_batch``'s answer.  With a table-less
        policy the routing and victim columns degrade to sentinels."""
        embs = np.asarray(embs, dtype=np.float32)
        with (self._trk.span("cache.decide_batch",
                             tags={"b": int(embs.shape[0])})
              if self._trk is not None else _NULL_CM), self._lock:
            t_now = self.clock if t is None else t
            table = getattr(self.policy, "table", None)
            alpha = float(getattr(self.policy, "alpha", 0.0))
            return self.backend.decide_batch(self.store, table, embs,
                                             alpha=alpha, t_now=t_now)

    def peek_rows(self, embs: np.ndarray, cids: Sequence[int]
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Snapshot Top-1 restricted to the given resident ``cids``.

        The incremental-rescan primitive: after a full ``peek_batch``, a
        waiting queue only needs rescoring against entries admitted since
        — and it must use the backend's own cosine scoring so the peeked
        sims can never disagree with ``lookup`` near ``tau_hit``.
        Non-resident cids are skipped; with none resident every query
        reports ``(-1, -inf)``."""
        embs = np.asarray(embs, dtype=np.float32)
        with self._lock:
            rows = [self.store.slot_of[c] for c in dict.fromkeys(cids)
                    if c in self.store]
            if not rows:
                b = embs.shape[0]
                return (np.full(b, -1, dtype=np.int64),
                        np.full(b, -np.inf, dtype=np.float64))
            return self.backend.top1_rows(self.store, embs,
                                          np.asarray(rows, dtype=np.int64))

    def lookup_batch(self, embs: Sequence[np.ndarray] | np.ndarray, *,
                     cids: Optional[Sequence[int]] = None,
                     ts: Optional[Sequence[int]] = None,
                     reqs: Optional[Sequence[Request]] = None
                     ) -> list[CacheResult]:
        """Hit determination for a whole query block in ONE backend call.

        Snapshot semantics: similarities are computed against the store at
        call time (lookups never admit, so residency can only change via
        subscriber-driven mutation — hits are revalidated regardless).
        """
        embs = np.asarray(embs, dtype=np.float32)
        b = embs.shape[0]
        cids = list(cids) if cids is not None else [-1] * b
        if self.cfg.hit_mode == "content":
            return [self.lookup(embs[i], cid=cids[i],
                                t=None if ts is None else ts[i],
                                req=None if reqs is None else reqs[i])
                    for i in range(b)]
        t0 = time.perf_counter()
        top_cids, top_sims = self.peek_batch(embs)
        self.metrics.lookup_s += time.perf_counter() - t0
        return [self.lookup(embs[i], cid=cids[i],
                            t=None if ts is None else ts[i],
                            req=None if reqs is None else reqs[i],
                            top1=(int(top_cids[i]), float(top_sims[i])))
                for i in range(b)]

    # ------------------------------------------------------------- admit
    def admit(self, cid: int, emb: np.ndarray, payload: Any = None, *,
              t: Optional[int] = None,
              req: Optional[Request] = None) -> list[int]:
        """Admit ``cid`` (insert-then-evict, Alg. 1).  Returns evicted cids.

        Already-resident cids only refresh their payload (the historical
        semantic-mode behavior: a miss whose content is resident — a
        paraphrase below tau_hit — does not reinsert)."""
        trk = self._trk
        t0 = time.perf_counter() if trk is not None else 0.0
        out = self._admit_now(cid, emb, payload, t, req)
        if trk is not None:
            trk.observe("cache.admit_stall_s", time.perf_counter() - t0)
        return out

    def _admit_now(self, cid: int, emb: np.ndarray, payload: Any,
                   t: Optional[int], req: Optional[Request]) -> list[int]:
        """The insert-then-evict body."""
        t0 = time.perf_counter()
        evicted: list[int] = []
        with self._lock:
            t = self._tick(t)
            if self.cfg.capacity <= 0:
                # nothing can ever be inserted: storing the payload would
                # leak it forever (eviction is the only payload-drop path)
                self.metrics.admit_s += time.perf_counter() - t0
                return evicted
            if payload is not None:
                self.payloads[cid] = payload
            if cid in self.store:
                self.metrics.admit_s += time.perf_counter() - t0
                return evicted
            self.store.insert(cid, emb)
            self.policy.on_admit(cid, self._request(cid, emb, t, req), t)
            self.metrics.admissions += 1
            self._emit("admit", cid, t, payload=payload)
            trk = self._trk
            while len(self.store) > self.cfg.capacity:
                victim = self.policy.victim(t)
                self.store.remove(victim)
                vp = self.payloads.pop(victim, None)
                self.metrics.evictions += 1
                evicted.append(victim)
                self._emit("evict", victim, t, payload=vp)
                if trk is not None:
                    trk.count("cache.evictions", tags={"tier": "device"})
            dt = time.perf_counter() - t0
            self.metrics.admit_s += dt
            if trk is not None:
                trk.observe("cache.admit_s", dt)
                trk.observe("cache.occupancy", float(len(self.store)), t)
        return evicted

    def admit_batch(self, cids: Sequence[int],
                    embs: Sequence[np.ndarray] | np.ndarray,
                    payloads: Optional[Sequence[Any]] = None, *,
                    ts: Optional[Sequence[int]] = None,
                    reqs: Optional[Sequence[Request]] = None) -> list[int]:
        """Admit a block of entries; returns all evicted cids in order."""
        evicted: list[int] = []
        for i, cid in enumerate(cids):
            evicted += self.admit(
                int(cid), np.asarray(embs[i]),
                None if payloads is None else payloads[i],
                t=None if ts is None else ts[i],
                req=None if reqs is None else reqs[i])
        return evicted

    # ------------------------------------------------- checkpoint/restore
    def checkpoint(self) -> dict:
        """Deep snapshot of all mutable state (store, policy, payloads,
        clock, metrics).  Store/policy are copied together so the policy's
        internal store reference stays shared inside the snapshot (the
        backends copy as themselves: their device mirrors are keyed by
        journal versions, never by object identity)."""
        with self._lock:
            state = copy.deepcopy({k: getattr(self, k)
                                   for k in _MUTABLE_STATE})
        state["_version"] = 1
        return state

    def restore(self, state: dict):
        """Restore a :meth:`checkpoint` snapshot (the snapshot itself is
        copied, so one checkpoint can be restored multiple times)."""
        keys = [k for k in _MUTABLE_STATE if k in state]   # tolerate older
        restored = copy.deepcopy({k: state[k] for k in keys})  # snapshots
        with self._lock:
            for k in keys:
                setattr(self, k, restored[k])
            self._wire_value_backend()


# ---------------------------------------------------- reference state
_STORE_FIELDS = ("emb", "occ", "cid", "slot_of", "_free", "hwm")
_TABLE_FIELDS = ("freq", "dep", "tsi", "topic_of", "last_t", "arrive_t",
                 "tp_last", "t_last", "rep", "rep_valid", "topic_hwm")
_RAC_FIELDS = ("par", "children", "_next_tid", "_evictions")


def load_reference_state(cache: SemanticCache, state: dict) -> None:
    """Fill ``cache`` (a RAC cache) from plain state: numpy arrays and
    Python containers, no objects of another package.

    ``state`` holds ``store`` (``emb``, ``occ``, ``cid``, ``slot_of``,
    ``_free``, ``hwm``), ``table`` (every :class:`PolicyTable` array plus
    ``topic_hwm``), ``rac`` (``topics`` as ``{tid: {"members", "src",
    "dirty"}}``, ``par``, ``children``, ``ghosts`` and ``ghost_topics`` as
    insertion-ordered ``{key: value}`` dicts, ``_next_tid``,
    ``_evictions``), ``clock`` and ``metrics`` (the :class:`CacheMetrics`
    fields).  Every array is copied and every journal restarts, so the
    device mirrors take one full upload at the next launch."""
    from repro_torch.core.rac import RACPolicy, TopicState
    from repro_torch.core.store import MutationJournal
    pol = cache.policy
    if not isinstance(pol, RACPolicy):
        raise TypeError("load_reference_state fills a RAC cache")
    with cache._lock:
        store = cache.store
        src = state["store"]
        if np.shape(src["emb"]) != store.emb.shape:
            raise ValueError(f"slab shape {np.shape(src['emb'])} does not "
                             f"match this cache's {store.emb.shape}")
        store.emb = np.array(src["emb"], dtype=np.float32)
        store.occ = np.array(src["occ"], dtype=bool)
        store.cid = np.array(src["cid"], dtype=np.int64)
        store.slot_of = {int(c): int(s) for c, s in src["slot_of"].items()}
        store._free = [int(s) for s in src["_free"]]
        store.hwm = int(src["hwm"])
        store._log = MutationJournal()

        table = pol.table
        for name in _TABLE_FIELDS[:-1]:
            ref = getattr(table, name)
            setattr(table, name,
                    np.array(state["table"][name], dtype=ref.dtype))
        table.topic_hwm = int(state["table"]["topic_hwm"])
        table.slot_log = MutationJournal()
        table.topic_log = MutationJournal()

        rac = state["rac"]
        pol.topics = {}
        for tid, ts in rac["topics"].items():
            # bypass TopicState.__init__: the rep row is already in the table
            obj = TopicState.__new__(TopicState)
            obj.tid, obj.table = int(tid), table
            obj.src = int(ts["src"])
            obj.members = {int(c) for c in ts["members"]}
            obj.dirty = bool(ts["dirty"])
            pol.topics[int(tid)] = obj
        pol.par = {int(c): int(p) for c, p in rac["par"].items()}
        pol.children = {int(c): {int(x) for x in ch}
                        for c, ch in rac["children"].items()}
        pol.ghosts._data = dict(rac["ghosts"])
        pol.ghost_topics._data = {
            int(tid): (np.array(rep, dtype=np.float32), float(tp), int(tl))
            for tid, (rep, tp, tl) in rac["ghost_topics"].items()}
        pol._next_tid = int(rac["_next_tid"])
        pol._evictions = int(rac["_evictions"])
        pol._pr_scores.clear()

        cache.clock = int(state["clock"])
        cache.metrics = CacheMetrics(**state["metrics"])
