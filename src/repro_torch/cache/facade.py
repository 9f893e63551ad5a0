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
hit.

Event-driven admission: with ``cfg.async_admit`` set, ``admit`` enqueues
onto an :class:`~repro_torch.cache.async_admit.AsyncAdmitter` and returns
immediately — a background worker (``True``) or a deterministic
``flush()`` drain (``"sync"``) applies insert + eviction scoring off the
request path, firing the same hooks and metrics as the synchronous path.
All mutable state is guarded by one reentrant lock so concurrent lookups
never observe a half-applied admission.

Tiers: ``cfg.tiers`` puts a host-DRAM tier and ARC-style ghost lists
behind the device slab (:mod:`repro_torch.cache.tiers`): device evictions
demote instead of dropping, a device miss falls through to the host tier
(a ``tier="host"`` hit, promoted back through the admission path), and a
re-admitted ghost feeds its preserved relation evidence back into the
policy.

Telemetry: ``cfg.tracker`` attaches a :class:`repro_torch.telemetry.
Tracker` the facade emits through — lookup/admit latency histograms,
windowed hit-ratio and occupancy series, tier-tagged eviction counters,
and spans around ``decide_batch`` and the host-tier fall-through.  The
device backend, the admitter and the tier manager get scoped children
(``backend.*`` / ``tier.*`` names).  Emission is strictly observation-only,
``metrics_snapshot()`` consolidates every counter surface into one dict,
and event-subscriber failures are contained (counted as ``hook_errors``;
``cfg.debug_hooks`` re-raises).

Approximate lookups: ``cfg.quantized_lookup`` (an int8 candidate scan
with an fp32 rescore) and ``cfg.pruned_lookup`` (topic routing, then a
scan of the probed topic buckets only), alone or together, make the
backend's lookups cheaper with the same hit/miss/admit/evict decisions;
their exact-scan fallbacks reach the tracker as the
``cache.rescore_fallbacks`` and ``cache.prune_fallbacks`` counters, and
``metrics_snapshot()`` always carries their ``quant`` and ``prune``
ledgers (zeroed when the paths are off).

Policies: ``cfg.policy`` is ``"RAC"``, ``"RadixRAC"`` (the KV
prefix-block policy of :mod:`repro_torch.core.radix`, scored through the
backend's ``rac_value_masked``) or any of the 16 baselines of
:data:`repro_torch.core.policies.BASELINES`.

:func:`load_reference_state` fills a cache from the plain-array state of
another implementation's cache (the reference's, in the tests), so a
warmed cache can be continued here.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.store import ResidentStore
from repro_torch.core.types import Request
from repro_torch.telemetry.tracker import make_tracker

from .backends import LookupBackend, get_backend
from .pruned import as_pruned_config, new_prune_stats
from .quantized import as_quantized_config, new_quant_stats
from .types import (CacheConfig, CacheEvent, CacheHit, CacheMetrics,
                    CacheMiss, CacheResult, DecisionBatch)

PolicyFactory = Callable[[int, ResidentStore], Any]

_NULL_CM = contextlib.nullcontext()      # reusable no-op span

_MUTABLE_STATE = ("store", "policy", "payloads", "clock", "metrics",
                  "tiers")

# policy hook attribute -> backend method wired into it (device-side
# eviction scoring: RAC consumes Eq. 1 values, RadixRAC the masked variant)
_VALUE_HOOKS = (("value_backend", "rac_value"),
                ("masked_value_backend", "rac_value_masked"))


def _make_policy(cfg: CacheConfig, store: ResidentStore):
    if cfg.policy == "RAC":
        from repro_torch.core.rac import RACPolicy
        return RACPolicy(cfg.capacity, store, **cfg.policy_kwargs)
    if cfg.policy == "RadixRAC":
        from repro_torch.core.radix import RadixRACPolicy
        return RadixRACPolicy(cfg.capacity, store, **cfg.policy_kwargs)
    from repro_torch.core.policies import BASELINES
    return BASELINES[cfg.policy](cfg.capacity, store, **cfg.policy_kwargs)


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
        if backend is not None:
            if cfg.backend_kwargs:
                raise ValueError(
                    "backend_kwargs "
                    f"{sorted(cfg.backend_kwargs)} cannot apply to an "
                    "already-built backend instance")
            for field, kwarg in (("quantized_lookup", "quantized"),
                                 ("pruned_lookup", "pruned")):
                if getattr(cfg, field):
                    raise ValueError(
                        f"{field} cannot apply to an already-built backend "
                        f"instance — pass {kwarg}= to its constructor "
                        "instead")
            self.backend = backend
        else:
            kw = dict(cfg.backend_kwargs)
            if cfg.backend in ("kernel", "sharded"):
                kw.setdefault("device", cfg.device)
            # the approximate lookups' certain-miss arm needs the hit
            # threshold: semantic mode fills it in from the facade's own
            # (content mode never gates on sims, so only the margin arms
            # certify there)
            for field, kwarg, norm in (
                    ("quantized_lookup", "quantized", as_quantized_config),
                    ("pruned_lookup", "pruned", as_pruned_config)):
                sub = norm(getattr(cfg, field))
                if sub is None:
                    continue
                if sub.tau_hit is None and cfg.hit_mode == "semantic":
                    sub = dataclasses.replace(sub, tau_hit=cfg.tau_hit)
                kw.setdefault(kwarg, sub)
            self.backend = get_backend(cfg.backend, **kw)
        self._fb_seen = {"quant": 0, "prune": 0}   # fallback delta bases
        # backends that own their store geometry (the sharded slab) build
        # it; everyone else gets the plain dense slab
        self.store = (self.backend.make_store(cfg.capacity, cfg.dim)
                      if hasattr(self.backend, "make_store")
                      else ResidentStore(cfg.capacity, cfg.dim))
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
        # tiered hierarchy (host DRAM tier + ghost metadata) behind the
        # facade; None = single-tier, identical to the untiered path
        self.tiers = None
        if cfg.tiers is not None and (cfg.tiers.host_capacity > 0
                                      or cfg.tiers.ghost_capacity > 0):
            from .tiers import TierManager
            self.tiers = TierManager(
                cfg.tiers, cfg.dim,
                tracker=None if self._trk is None
                else self._trk.child("tier"))
        # event-driven admission: enqueue + background/deterministic drain
        self.admitter = None
        if cfg.async_admit:
            from .async_admit import AsyncAdmitter
            self.admitter = AsyncAdmitter(
                self, background=cfg.async_admit != "sync",
                tracker=self._trk)

    def _wire_value_backend(self):
        for attr, method in _VALUE_HOOKS:
            if hasattr(self.policy, attr):
                setattr(self.policy, attr, getattr(self.backend, method))
        if getattr(self.backend, "pruned", None) is not None:
            # topic routing reads the policy's journaled PolicyTable (rep
            # matrix + topic memberships) against this facade's store;
            # restore() re-runs this, so store swaps stay wired.  A
            # table-less policy leaves route_table None and the backend
            # falls back to the exact scan (still decision-identical).
            self.backend.route_table = getattr(self.policy, "table", None)
            self.backend.route_store = self.store

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

    def in_host(self, cid: int) -> bool:
        """Whether ``cid`` currently lives in the host DRAM tier."""
        return (self.tiers is not None and self.tiers.host is not None
                and cid in self.tiers.host)

    @property
    def tier_stats(self) -> dict:
        """Per-tier counters (empty when running single-tier)."""
        return {} if self.tiers is None else self.tiers.stats.snapshot()

    @property
    def tracker(self):
        """The attached :class:`repro_torch.telemetry.Tracker` (or None)."""
        return self._trk

    def metrics_snapshot(self) -> dict:
        """The consolidated observability surface: ONE dict merging the
        :class:`CacheMetrics` counters, the per-tier flow counters
        (``tiers``, when tiered), the admission-queue state
        (``pending_admits`` and the producer-visible ``admit_stall_s``,
        split into ``enqueue_s``/``flush_s`` under async admission), the
        device backend's mirror-sync stats (``sync``, when the backend
        keeps device mirrors), the always-present approximate-lookup
        ledgers (``quant``/``prune``, zeroed when the paths are off) and
        the launch/transfer ledger (``dispatch``, zeros for host
        backends)."""
        with self._lock:
            snap = self.metrics.snapshot()
            snap["pending_admits"] = self.pending_admits
            snap["admit_stall_s"] = self.admit_stall_s
            if self.admitter is not None:
                snap["enqueue_s"] = self.admitter.enqueue_s
                snap["flush_s"] = self.admitter.flush_s
            tiers = self.tier_stats
            if tiers:
                snap["tiers"] = tiers
            sync = getattr(self.backend, "sync_stats", None)
            if sync:
                snap["sync"] = dict(sync)
            snap["quant"] = dict(getattr(self.backend, "quant_stats", None)
                                 or new_quant_stats())
            snap["prune"] = dict(getattr(self.backend, "prune_stats", None)
                                 or new_prune_stats())
            dispatch = getattr(self.backend, "dispatch_stats", None)
            if dispatch is None:
                dispatch = {"launches": 0, "host_syncs": 0, "kernel_s": 0.0}
            snap["dispatch"] = dict(dispatch)
            return snap

    def _flush_fallbacks(self):
        """Emit the since-last-flush deltas of the approximate lookups'
        exact-scan fallbacks as the ``cache.rescore_fallbacks`` (quantized)
        and ``cache.prune_fallbacks`` (pruned) counters (strictly
        observation-only; call sites hold the lock)."""
        trk = self._trk
        if trk is None:
            return
        for key, cfg_attr, stats_attr, name in (
                ("quant", "quantized", "quant_stats",
                 "cache.rescore_fallbacks"),
                ("prune", "pruned", "prune_stats", "cache.prune_fallbacks")):
            if getattr(self.backend, cfg_attr, None) is None:
                continue
            fb = getattr(self.backend, stats_attr)["fallbacks"]
            d = fb - self._fb_seen[key]
            if d:
                trk.count(name, d)
                self._fb_seen[key] = fb

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
                # tier fall-through: a device miss may still be served from
                # the host DRAM tier (and promoted back toward the device)
                result = (self._tier_lookup(emb, cid, t)
                          if self.tiers is not None else None)
                if result is None:
                    self.metrics.misses += 1
                    self._emit("miss", cid, t, best_sim)
                    result = CacheMiss(
                        best_cid=best_cid if np.isfinite(best_sim)
                        else -1, best_sim=best_sim, t=t)
            dt = time.perf_counter() - t0
            self.metrics.lookup_s += dt
            trk = self._trk
            if trk is not None:
                trk.observe("cache.lookup_s", dt)
                # windowed hit indicator over logical time -> the
                # hit-ratio-over-time series every workload study wants
                trk.observe("cache.hit", 1.0 if result.hit else 0.0, t)
                self._flush_fallbacks()
        return result

    def _tier_lookup(self, emb: np.ndarray, cid: int,
                     t: int) -> Optional[CacheHit]:
        """Host-tier fall-through on a device miss (under the lock).

        Serves the payload straight from host DRAM and promotes the served
        entry (plus any ``promote_k`` co-promotion candidates that also
        cleared ``tau_hit``) back through the normal admission path — the
        :class:`~repro_torch.cache.async_admit.AsyncAdmitter` queue when
        configured, so the request path never blocks on device eviction
        scoring.  Ghost metadata rides along via ``revive_ghost`` so the
        policy's arrival path restores the preserved relation evidence."""
        with (self._trk.span("cache.tier_serve")
              if self._trk is not None else _NULL_CM):
            served = self.tiers.serve(np.asarray(emb, dtype=np.float32),
                                      cid=cid, hit_mode=self.cfg.hit_mode,
                                      tau_hit=self.cfg.tau_hit, t=t)
        if not served:
            return None
        revive = getattr(self.policy, "revive_ghost", None)
        for pcid, _psim, pemb, ppayload, pmeta in served:
            if pmeta is not None and revive is not None:
                revive(pcid, pmeta, rep=pemb)
            self.admit(pcid, pemb, payload=ppayload, t=t)
        hcid, sim, _hemb, payload, _meta = served[0]
        self.metrics.hits += 1
        self._emit("hit", hcid, t, sim, payload, tier="host")
        return CacheHit(cid=hcid, sim=sim, payload=payload, t=t)

    def peek_batch(self, embs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw snapshot Top-1 over a (B, D) query block — one backend call,
        no policy/metrics side effects.  Sims are against the store as of
        this call; pair with ``lookup(..., top1=...)`` to apply results."""
        with self._lock:
            out = self.backend.top1_batch(self.store, np.asarray(embs))
            self._flush_fallbacks()
            return out

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
            dec = self.backend.decide_batch(self.store, table, embs,
                                            alpha=alpha, t_now=t_now)
            if self.tiers is not None and self.tiers.host is not None:
                # tier-aware fall-through columns: the host tier's Top-1
                # per query (scored on the host: the host slab is DRAM-
                # resident by definition)
                dec.host_cid, dec.host_sim = \
                    self.tiers.host.top1_batch(embs)
            self._flush_fallbacks()
            return dec

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
        paraphrase below tau_hit — does not reinsert).

        With ``cfg.async_admit`` the admission is queued (logical time is
        assigned now, so ordering is deterministic) and the returned list
        is empty — evictions surface through the ``"evict"`` hook and
        :meth:`flush`."""
        trk = self._trk
        t0 = time.perf_counter() if trk is not None else 0.0
        if self.admitter is not None:
            # tick + enqueue under one lock: concurrent producers must not
            # queue out of timestamp order, or the FIFO drain would apply
            # decreasing times and diverge from the synchronous path
            with self._lock:
                t = self._tick(t)
                self.admitter.submit(cid, emb, payload, t, req)
            if trk is not None:
                trk.observe("cache.admit_stall_s",
                            time.perf_counter() - t0)
            return []
        out = self._admit_now(cid, emb, payload, t, req)
        if trk is not None:
            # producer-visible stall: in synchronous mode the full
            # insert+evict cost, in async mode just the enqueue above
            trk.observe("cache.admit_stall_s", time.perf_counter() - t0)
        return out

    def _admit_now(self, cid: int, emb: np.ndarray, payload: Any,
                   t: Optional[int], req: Optional[Request]) -> list[int]:
        """The synchronous insert-then-evict body (also the admitter's
        drain target)."""
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
            if self.tiers is not None:
                # drop any stale host copy + feed ghost metadata back into
                # the policy BEFORE on_admit, so the normal arrival path
                # restores the preserved counters
                self.tiers.on_admit(cid, self.policy, emb)
            self.policy.on_admit(cid, self._request(cid, emb, t, req), t)
            self.metrics.admissions += 1
            self._emit("admit", cid, t, payload=payload)
            trk = self._trk
            while len(self.store) > self.cfg.capacity:
                victim = self.policy.victim(t)
                vemb = (self.store.emb[self.store.slot_of[victim]].copy()
                        if self.tiers is not None else None)
                self.store.remove(victim)
                vp = self.payloads.pop(victim, None)
                self.metrics.evictions += 1
                evicted.append(victim)
                etier = "device"
                if self.tiers is not None:
                    # demote instead of dropping: the host tier keeps the
                    # payload (and the ghost tier the relation metadata)
                    meta_fn = getattr(self.policy, "ghost_meta", None)
                    meta = meta_fn(victim) if meta_fn is not None else None
                    if self.tiers.demote(victim, vemb, vp, t, meta):
                        etier = "host"
                self._emit("evict", victim, t, payload=vp, tier=etier)
                if trk is not None:
                    trk.count("cache.evictions", tags={"tier": etier})
            dt = time.perf_counter() - t0
            self.metrics.admit_s += dt
            if trk is not None:
                trk.observe("cache.admit_s", dt)
                trk.observe("cache.occupancy", float(len(self.store)), t)
        return evicted

    # ------------------------------------------------- async admission
    @property
    def pending_admits(self) -> int:
        """Queued-but-unapplied admissions (0 in synchronous mode)."""
        return 0 if self.admitter is None else len(self.admitter)

    @property
    def admit_stall_s(self) -> float:
        """Producer-visible admission stall: in synchronous mode the full
        insert+evict cost; in async mode just enqueue + flush waits."""
        if self.admitter is None:
            return self.metrics.admit_s
        return self.admitter.stall_s

    def flush(self) -> list[int]:
        """Apply all queued admissions (no-op when synchronous); returns
        the cids evicted by the drain since the last flush."""
        if self.admitter is None:
            return []
        return self.admitter.flush()

    drain = flush

    def close(self):
        """Stop the background admission worker (flushes first) and
        revert to inline admission — the cache stays fully usable, later
        ``admit`` calls just pay the insert+evict cost synchronously."""
        if self.admitter is not None:
            self.admitter.close()
            self.admitter = None

    def admit_batch(self, cids: Sequence[int],
                    embs: Sequence[np.ndarray] | np.ndarray,
                    payloads: Optional[Sequence[Any]] = None, *,
                    ts: Optional[Sequence[int]] = None,
                    reqs: Optional[Sequence[Request]] = None) -> list[int]:
        """Admit a block of entries; returns all evicted cids in order.

        With ``cfg.async_admit`` the block is queued and the returned list
        is empty — collect victims from :meth:`flush` or the ``"evict"``
        hook instead."""
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
        clock, metrics, tiers).  Queued async admissions are flushed first
        so the snapshot is a settled state.  Store/policy are copied
        together so the policy's internal store reference stays shared
        inside the snapshot (the backends copy as themselves: their device
        mirrors are keyed by journal versions, never by object identity)."""
        self.flush()
        with self._lock:
            state = copy.deepcopy({k: getattr(self, k)
                                   for k in _MUTABLE_STATE})
        state["_version"] = 1
        return state

    def restore(self, state: dict):
        """Restore a :meth:`checkpoint` snapshot (the snapshot itself is
        copied, so one checkpoint can be restored multiple times).  Queued
        async admissions are applied to the *old* state first, then
        discarded with it."""
        self.flush()
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
    device mirrors take one full upload at the next launch, and the
    approximate lookups rebuild their int8 mirror and topic-bucket index
    from the journals at their first use."""
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
