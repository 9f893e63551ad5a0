"""RAC — Relation-Aware Cache replacement (the paper's contribution).

Implements, faithfully:

  - Alg. 1  main workflow: on every arrival refresh TP, update TSI, insert,
            and evict ``argmin TP(Z_i)·TSI(q_i)`` under capacity pressure.
  - Alg. 2  cache-side topic routing + O(1) lazy TP refresh
            (Def. 1:  TP_t(s) = Σ_{i∈H_t(s)} (1/2)^{α(t-i)}, maintained via
            the closed form (1/2)^{α(t-t_last)} · TP_last).
  - Alg. 3  constant-time TSI update cascade
            (Def. 2:  TSI(q) = freq(q) + λ·dep(q)), with the one-parent
            DetectParent rule  score(k,t) = sim(q_k,q_t)/(t-k)  over cached
            same-topic candidates inside a look-back window T, gated by
            τ_edge.
  - Alg. 4  representative-index shortlist routing (top-K + similarity gate).
  - Alg. 5  TSI-max anchor representative with lazy refresh on eviction and
            empty-topic deletion.
  - App.7.2 optional PageRank structural refinement
            (``structural_mode="pagerank"``, refreshed through
            ``structural.pagerank_scores`` — the torch power iteration on
            the card by default, on another torch device when
            ``structural_device`` names one, the numpy oracle with
            ``structural_device=False``).

Ablations (§4.4): ``use_tp=False`` → RAC w/o TP; ``use_tsi=False`` → RAC
w/o TSI.  Ties are broken by (value, last-access, cid) for determinism.

State layout — the PolicyTable split
------------------------------------
The per-request *semantics* (routing, DetectParent, the TSI cascade,
anchor maintenance, ghost metadata) live here as plain Python driving
dense arrays; the arrays themselves — the slot-aligned freq/dep/tsi/
topic_of/last_t/arrive_t slabs, the per-topic tp_last/t_last tables, and
the dense topic-representative matrix — are owned by a
:class:`repro_torch.core.policy_table.PolicyTable`.  Every mutation stamps the
table's slot/topic :class:`~repro_torch.core.store.MutationJournal`, so device
backends mirror the scoring state with dirty-row scatters and serve the
whole decision surface (Top-1 lookup + Alg. 4 routing + Eq. 1 victim
scoring) from one fused launch (``decide_batch``).  A full host eviction
scan stays one vectorized O(m) pass over the same slabs; the facade wires
``value_backend`` so Eq. 1 scoring can also run through
``kernels/ops.rac_value`` on device.
"""
from __future__ import annotations

import numpy as np

from . import structural
from .policies import Policy
from .policy_table import PolicyTable

_NEG = -1.0


class TopicState:
    """Host bookkeeping for one live topic (Alg. 2/5).

    The representative embedding itself lives in the PolicyTable's dense
    ``rep`` matrix so device routing can score every topic in one kernel;
    ``rep`` here is a journaled read/write view of that row."""

    __slots__ = ("tid", "table", "src", "members", "dirty")

    def __init__(self, tid: int, table: PolicyTable, rep: np.ndarray,
                 src: int):
        self.tid = tid
        self.table = table
        self.src = src                 # anchor cid realizing rep (Alg. 5)
        self.members: set[int] = set()
        self.dirty = False             # anchor invalidated by eviction
        table.set_rep(tid, rep)

    @property
    def rep(self) -> np.ndarray:
        return self.table.rep[self.tid]

    @rep.setter
    def rep(self, emb: np.ndarray):
        self.table.set_rep(self.tid, emb)


class RACPolicy(Policy):
    name = "RAC"

    def __init__(self, capacity, store=None, *,
                 tau_route: float = 0.65,      # topic routing gate (Alg. 2/4)
                 tau_edge: float = 0.60,       # dependency-link gate (§3.3)
                 alpha: float = 0.001,         # TP decay coefficient (Def. 1)
                 lam: float = 2.0,             # structural weight λ (Def. 2)
                 lookback: int = 64,           # DetectParent window T
                 shortlist_k: int = 8,         # ANN shortlist size (Alg. 4)
                 use_tp: bool = True,
                 use_tsi: bool = True,
                 structural_mode: str = "onehop",   # "onehop" | "pagerank"
                 structural_device: bool | str = True,
                                               # pagerank engine: torch power
                                               # iteration (True = the card,
                                               # or a device name) vs numpy
                                               # oracle (False)
                 pagerank_beta: float = 0.85,
                 pagerank_every: int = 64,     # evictions between PR refreshes
                 topic_memory: bool = True,    # Alg.2 Data: TP state persists
                                               # "for each appeared topic";
                                               # False = Alg.5-literal (delete
                                               # state with the empty topic)
                 value_mode: str = "normalized",
                                               # "normalized": TP·TSI/Σ_topic TSI
                                               #   — the §3.1 derivation reading
                                               #   (Value ≈ π_Z·p(q|Z); p(q|Z) is
                                               #   a normalized conditional)
                                               # "paper": literal Eq.1 TP·TSI
                                               #   product of raw counters
                 probation: int = 0,           # beyond-paper: entries younger
                                               # than this are eviction-exempt
                 ghost_limit: int = 1 << 18,   # FIFO bound on evicted-entry
                                               # lifetime metadata (g_freq/g_dep)
                 ghost_topic_limit: int = 4096,
                                               # FIFO bound on the ghost topic
                                               # memory (dead topics' TP state)
                 **kw):
        super().__init__(capacity, store)
        assert store is not None, "RAC scores over the resident store"
        self.tau_route = tau_route
        self.tau_edge = tau_edge
        self.alpha = alpha
        self.lam = lam
        self.lookback = lookback
        self.shortlist_k = shortlist_k
        self.use_tp = use_tp
        self.use_tsi = use_tsi
        self.structural_mode = structural_mode
        self.structural_device = structural_device
        self.pr_beta = pagerank_beta
        self.pr_every = max(1, pagerank_every)
        self.topic_memory = topic_memory
        self.value_mode = value_mode
        self.probation = probation

        # all scoring slabs (slot axis) and topic tables (topic axis) live
        # in the journaled PolicyTable so device backends can mirror them
        self.table = PolicyTable(store.emb.shape[0], store.emb.shape[1])

        # lifetime relation metadata (Def. 2: freq(q) counts hits "so far in
        # topic s" — a lifetime counter that survives eviction; par(q_t) "is
        # cached for future accesses").  Bounded FIFO ghosts, kept in the
        # shared GhostTier structure (deferred import: repro_torch.cache imports
        # this module through the core package, so a module-level import
        # here would close the cycle mid-initialization).
        from repro_torch.cache.tiers import GhostTier
        # cid -> (freq, dep, tid); batch_div=16 reproduces the historical
        # amortized drop loop bit-for-bit
        self.ghosts = GhostTier(ghost_limit, batch_div=16)
        self.ghost_limit = ghost_limit
        self.ghost_topic_limit = ghost_topic_limit
        self.par: dict[int, int] = {}          # cid -> parent cid (or -1)
        self.children: dict[int, set[int]] = {}  # resident DAG (for pagerank)

        self.topics: dict[int, TopicState] = {}
        self._next_tid = 0
        # ghost topic memory (beyond-paper option): tid -> (rep, tp, t_last)
        self.ghost_topics = GhostTier(ghost_topic_limit)
        self._evictions = 0
        self._pr_scores: dict[int, float] = {}   # cid -> pagerank structural term
        # optional device-side Eq.1 scorer (repro_torch.cache wires the lookup
        # backend's rac_value here); signature
        # (tsi, tids, tp_last, t_last, alpha, t_now) -> values
        self.value_backend = None

    # -- ghost views (the authoritative records live in self.ghosts) -------
    @property
    def g_freq(self) -> dict[int, float]:
        """Lifetime hit counters of evicted entries (read-only view)."""
        return {c: e[0] for c, e in self.ghosts.items()}

    @property
    def g_dep(self) -> dict[int, float]:
        """Lifetime dependency counters of evicted entries (read-only)."""
        return {c: e[1] for c, e in self.ghosts.items()}

    # -- table views (the authoritative arrays live in self.table) ---------
    freq = property(lambda self: self.table.freq)
    dep = property(lambda self: self.table.dep)
    tsi = property(lambda self: self.table.tsi)
    topic_of = property(lambda self: self.table.topic_of)
    last_t = property(lambda self: self.table.last_t)
    arrive_t = property(lambda self: self.table.arrive_t)
    tp_last = property(lambda self: self.table.tp_last)
    t_last = property(lambda self: self.table.t_last)

    # ------------------------------------------------------------------ TP
    def _grow_tp(self, tid: int):
        self.table.grow_topics(tid)

    def tp_now(self, tid: int, t: int) -> float:
        """Lazy closed-form evaluation (Def. 1)."""
        return float(0.5 ** (self.alpha * (t - self.t_last[tid])) * self.tp_last[tid])

    def _refresh_tp(self, tid: int, t: int):
        """Decay-and-increment on a topic hit (Alg. 2 lines 6-7)."""
        self.tp_last[tid] = 0.5 ** (self.alpha * (t - self.t_last[tid])) * self.tp_last[tid] + 1.0
        self.t_last[tid] = t
        self.table.touch_topic(tid)

    # -------------------------------------------------------------- routing
    def _refresh_anchor(self, ts: TopicState):
        """Lazy TSI-max anchor refresh (Alg. 5 Refresh)."""
        if not ts.dirty:
            return
        best, best_v = -1, -np.inf
        for cid in ts.members:
            s = self.store.slot_of[cid]
            v = (self.tsi[s], -self.last_t[s], -cid)   # deterministic ties
            if best < 0 or v > best_v:
                best, best_v = cid, v
        if best >= 0:
            ts.src = best
            ts.rep = self.store.emb[self.store.slot_of[best]]
        ts.dirty = False

    def _route(self, emb: np.ndarray, t: int) -> int:
        """Alg. 4: shortlist over representatives + similarity gate."""
        if self.topics:
            tids = list(self.topics.keys())
            for tid in tids:
                self._refresh_anchor(self.topics[tid])
            # the dense table IS the stacked representative matrix: one
            # fancy-index gather replaces per-topic stacking
            reps = self.table.rep[np.fromiter(tids, dtype=np.int64,
                                              count=len(tids))]
            sims = reps @ emb
            k = min(self.shortlist_k, len(tids))
            short = np.argpartition(-sims, k - 1)[:k]
            best = max(short, key=lambda i: (sims[i], -tids[i]))
            if sims[best] >= self.tau_route:
                return tids[best]
        # beyond-paper: try ghost topic memory before creating a new topic
        if self.topic_memory and self.ghost_topics:
            gids = list(self.ghost_topics.keys())
            reps = np.stack([self.ghost_topics[g][0] for g in gids])
            sims = reps @ emb
            gi = int(np.argmax(sims))
            if sims[gi] >= self.tau_route:
                tid = gids[gi]
                rep, tp_last, t_last = self.ghost_topics.pop(tid)
                ts = TopicState(tid, self.table, rep, -1)
                ts.dirty = False
                self.topics[tid] = ts
                self.tp_last[tid] = tp_last
                self.t_last[tid] = t_last
                self.table.touch_topic(tid)
                return tid
        return -1

    def _new_topic(self, emb: np.ndarray, src: int, t: int) -> int:
        tid = self._next_tid
        self._next_tid += 1
        self._grow_tp(tid)
        ts = TopicState(tid, self.table, emb, src)
        self.topics[tid] = ts
        self.tp_last[tid] = 0.0
        self.t_last[tid] = t
        self.table.touch_topic(tid)
        return tid

    # ------------------------------------------------------------- parents
    def _detect_parent(self, cid: int, emb: np.ndarray, tid: int, t: int) -> int:
        """DetectParent (§3.3): Top-1 cached same-topic predecessor within
        the look-back window under score = sim/(t-k), gated by τ_edge."""
        ts = self.topics[tid]
        cands, slots = [], []
        for other in ts.members:
            if other == cid:
                continue
            s = self.store.slot_of[other]
            dt = t - int(self.last_t[s])
            if 0 < dt <= self.lookback:
                cands.append((other, dt))
                slots.append(s)
        if not cands:
            return -1
        sims = self.store.emb[slots] @ emb
        best, best_score = -1, -np.inf
        for (other, dt), sim in zip(cands, sims):
            if sim < self.tau_edge:
                continue
            sc = sim / dt
            if sc > best_score or (sc == best_score and other < best):
                best, best_score = other, sc
        return best

    # ------------------------------------------------------------ TSI (Alg.3)
    def _update_tsi(self, cid: int, emb: np.ndarray, tid: int, t: int):
        s = self.store.slot_of[cid]
        self.freq[s] += 1.0
        self.tsi[s] = self.freq[s] + self.lam * self.dep[s]
        self.table.touch_slot(s)
        if cid in self.par:
            qp, new = self.par[cid], False
        else:
            qp = self._detect_parent(cid, emb, tid, t)
            self.par[cid] = qp
            new = True
            if qp >= 0:
                self.children.setdefault(qp, set()).add(cid)
        if qp >= 0 and qp in self.store.slot_of:
            self.children.setdefault(qp, set()).add(cid)
            sp = self.store.slot_of[qp]
            self.dep[sp] += self.freq[s] if new else 1.0
            self.tsi[sp] = self.freq[sp] + self.lam * self.dep[sp]
            self.table.touch_slot(sp)
            pt = int(self.topic_of[sp])
            if pt in self.topics and self.topics[pt].src == qp:
                pass                                   # anchor strengthened
            elif pt in self.topics and self.tsi[sp] > self._anchor_tsi(pt):
                self._set_anchor(pt, qp, sp)

    def _anchor_tsi(self, tid: int) -> float:
        ts = self.topics[tid]
        if ts.src < 0 or ts.src not in self.store.slot_of:
            return -np.inf
        return float(self.tsi[self.store.slot_of[ts.src]])

    def _set_anchor(self, tid: int, cid: int, slot: int):
        ts = self.topics[tid]
        ts.src = cid
        ts.rep = self.store.emb[slot]
        ts.dirty = False

    # ------------------------------------------------------------- protocol
    def _arrive(self, cid: int, req, t: int, is_admit: bool):
        s = self.store.slot_of[cid]
        if is_admit:
            # restore lifetime counters (ghost metadata) or start fresh
            ghost = self.ghosts.pop(cid, None)
            self.freq[s] = ghost[0] if ghost is not None else 0.0
            self.dep[s] = ghost[1] if ghost is not None else 0.0
            self.tsi[s] = self.freq[s] + self.lam * self.dep[s]
            self.arrive_t[s] = t
            tid = self._route(req.emb, t)
            if tid < 0:
                tid = self._new_topic(req.emb, cid, t)
            self.topic_of[s] = tid
            self.table.touch_slot(s)
            self.topics[tid].members.add(cid)
        else:
            tid = int(self.topic_of[s])
            if tid not in self.topics:          # defensive; should not happen
                tid = self._new_topic(self.store.emb[s], cid, t)
                self.topic_of[s] = tid
                self.table.touch_slot(s)
                self.topics[tid].members.add(cid)
        self._refresh_tp(tid, t)                # Alg. 2: topic hit
        self._update_tsi(cid, req.emb, tid, t)  # Alg. 3
        self.last_t[s] = t
        self.table.touch_slot(s)
        # Alg. 5 OnInsert: promote anchor if newcomer has max TSI
        ts = self.topics[tid]
        if is_admit:
            self._refresh_anchor(ts)
            if ts.src < 0 or self.tsi[s] > self._anchor_tsi(tid):
                self._set_anchor(tid, cid, s)

    def on_hit(self, cid, req, t):
        self._arrive(cid, req, t, is_admit=False)

    def on_admit(self, cid, req, t):
        self._arrive(cid, req, t, is_admit=True)

    # ------------------------------------------------------------- eviction
    def _structural_refresh(self):
        """Optional App. 7.2: PageRank over resident intra-topic DAGs
        (the torch power iteration by default; ``structural_device=False``
        selects the numpy oracle)."""
        self._pr_scores.clear()
        for tid, ts in self.topics.items():
            members = [c for c in ts.members if c in self.store.slot_of]
            if len(members) < 2:
                continue
            idx = {c: i for i, c in enumerate(members)}
            edges = []
            for c in members:
                p = self.par.get(c, -1)
                if p >= 0 and p in idx:
                    edges.append((idx[p], idx[c]))
            if not edges:
                continue
            r = structural.pagerank_scores(edges, len(members),
                                           beta=self.pr_beta,
                                           device=self.structural_device)
            scale = len(members)                 # r ~ 1/n → scale to O(1)
            for c, i in idx.items():
                self._pr_scores[c] = scale * float(r[i])

    def _residents(self) -> tuple[np.ndarray, np.ndarray]:
        """(cids, slots) of every resident, in insertion order."""
        n = len(self.store.slot_of)
        return (np.fromiter(self.store.slot_of.keys(), dtype=np.int64,
                            count=n),
                np.fromiter(self.store.slot_of.values(), dtype=np.int64,
                            count=n))

    def value_scores(self, t: int,
                     residents: tuple[np.ndarray, np.ndarray] | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized Value(q) = TP(Z_q)·TSI(q) over all residents."""
        cids, slots = residents if residents is not None else \
            self._residents()
        tids = self.topic_of[slots]
        if self.use_tsi:
            if self.structural_mode == "pagerank" and self._pr_scores:
                pr = np.array([self._pr_scores.get(int(c), 0.0) for c in cids])
                tsi = self.freq[slots] + self.lam * pr
            else:
                tsi = self.tsi[slots]
        else:
            tsi = np.ones(len(slots))
        if self.value_mode == "normalized" and self.use_tsi:
            # p(q|s) reading of §3.1: normalize TSI by resident topic mass
            mass = np.zeros(int(tids.max()) + 1)
            np.add.at(mass, tids, tsi)
            tsi = tsi / np.maximum(mass[tids], 1e-9)
        if not self.use_tp:
            return cids, tsi
        if self.value_backend is not None:
            return cids, self.value_backend(tsi, tids, self.tp_last,
                                            self.t_last, self.alpha, t)
        tp = 0.5 ** (self.alpha * (t - self.t_last[tids])) * self.tp_last[tids]
        return cids, tp * tsi

    def victim(self, t):
        if self.structural_mode == "pagerank" and self._evictions % self.pr_every == 0:
            self._structural_refresh()
        self._evictions += 1
        cids, slots = self._residents()
        cids, values = self.value_scores(t, (cids, slots))
        if self.probation > 0:
            # beyond-paper recency guard: fresh entries are exempt unless
            # everything resident is fresh
            guarded = (t - self.arrive_t[slots]) < self.probation
            if not guarded.all():
                values = np.where(guarded, np.inf, values)
        # deterministic: min value, then least-recently-used, then smallest cid
        order = np.lexsort((cids, self.last_t[slots], values))
        victim = int(cids[order[0]])
        self._forget(victim)
        return victim

    def _forget(self, cid: int):
        s = self.store.slot_of[cid]
        tid = int(self.topic_of[s])
        ts = self.topics.get(tid)
        if ts is not None:
            ts.members.discard(cid)
            if not ts.members:
                # Alg. 5: delete empty topic (optionally remember TP state)
                if self.topic_memory:
                    # bounded by ghost_topic_limit (FIFO drop of the oldest)
                    self.ghost_topics.put(tid, (ts.rep.copy(),
                                                float(self.tp_last[tid]),
                                                int(self.t_last[tid])))
                del self.topics[tid]
                self.table.clear_topic(tid)
            elif ts.src == cid:
                ts.src = -1
                ts.dirty = True                 # lazy refresh (Alg. 5 OnEvict)
        # persist lifetime counters as ghost metadata (Def. 2 semantics);
        # par(cid) stays cached (§3.3).  Resident-DAG edges are pruned.
        # The GhostTier enforces the FIFO bound (limit//16 drop batches
        # amortize the dict churn; the bound stays hard for tiny limits).
        for old in self.ghosts.put(cid, (float(self.freq[s]),
                                         float(self.dep[s]), tid)):
            self.par.pop(old, None)
        p = self.par.get(cid)
        if p is not None and p >= 0 and p in self.children:
            self.children[p].discard(cid)
        self.children.pop(cid, None)            # children keep their cached par
        self.table.clear_slot(s)
        self._pr_scores.pop(cid, None)

    # ------------------------------------------------- tiering integration
    def ghost_meta(self, cid: int) -> dict | None:
        """Snapshot the just-forgotten entry's relation evidence for the
        tier manager (called by the facade right after an eviction, while
        the ghost record is guaranteed fresh).  Carries the lifetime
        counters plus the topic's TP state so a ghost revival can rebuild
        both — even after this policy's own bounded ghosts age it out."""
        e = self.ghosts.get(cid)
        if e is None:
            return None
        freq, dep, tid = e
        if tid in self.topics:
            tp, tl = float(self.tp_last[tid]), int(self.t_last[tid])
        elif tid in self.ghost_topics:
            _, tp, tl = self.ghost_topics[tid]
        else:
            tp, tl = 0.0, 0
        return {"freq": freq, "dep": dep, "tid": int(tid),
                "tp": float(tp), "tl": int(tl)}

    def revive_ghost(self, cid: int, meta: dict, rep=None):
        """Feed tier-preserved relation evidence back in at re-admission
        (called by the facade *before* ``on_admit``, so the normal arrival
        path restores the counters).  The policy's own records win when
        still present; the tier metadata only fills what aged out."""
        tid = int(meta.get("tid", -1))
        if cid not in self.ghosts:
            for old in self.ghosts.put(cid, (float(meta.get("freq", 0.0)),
                                             float(meta.get("dep", 0.0)),
                                             tid)):
                self.par.pop(old, None)
        if (self.topic_memory and rep is not None and 0 <= tid
                and tid < self._next_tid and tid not in self.topics
                and tid not in self.ghost_topics):
            # the demoted topic re-enters hot through _route's ghost-topic
            # revival, carrying its preserved TP state
            self.ghost_topics.put(
                tid, (np.asarray(rep, dtype=np.float32).copy(),
                      float(meta.get("tp", 0.0)), int(meta.get("tl", 0))))


def make_rac(**kwargs):
    """Factory matching the simulator's (capacity, store) calling convention."""
    def f(capacity, store):
        return RACPolicy(capacity, store, **kwargs)
    f.__name__ = kwargs.get("name", "RAC")
    return f


RAC_VARIANTS = {
    "RAC": dict(),
    "RAC w/o TP": dict(use_tp=False),
    "RAC w/o TSI": dict(use_tsi=False),
    "RAC (Eq.1 literal)": dict(value_mode="paper", topic_memory=False),
    "RAC (pagerank)": dict(structural_mode="pagerank"),
    "RAC (probation)": dict(probation=32),
}
