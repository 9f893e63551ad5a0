"""Multi-policy arena: one-pass evaluation of P policies over one trace.

``run_many`` replays the trace once per policy — P full passes, P
per-request scoring calls, P Gram matrices.  The arena replays it ONCE:
the P policies' resident slabs live in one stacked ``(P, S, D)``
:class:`ArenaStore`, every chunk of B requests is scored against all P
slabs by a single policy-stacked Top-1 launch
(``LookupBackend.top1_multi``: on the kernel backend the ``sim_top1``
CUDA kernel's policy grid axis, ``kernels/ops.sim_top1_multi``), and the
per-policy replay that closes each chunk's snapshot gap reuses the
exact-incremental machinery of ``run_policy_batched`` — with the chunk's
embedding stack and Gram matrix computed once and shared by all P
policies.

Decisions are those of the sequential per-policy replays
(``run_policy``); the same guarantees and the same fallbacks apply:

  - every query's running best is maintained against the entries resident
    at its own turn (rank-1 Gram-row rescores per intra-chunk admission,
    per policy);
  - a query whose running best was evicted mid-chunk, or whose decision
    could hinge on sub-epsilon float differences between scoring engines
    (a promoted or snapshot best within ``_EPS`` of ``tau_hit``), discards
    the snapshot and recomputes a fresh single-store backend Top-1 — the
    identical call ``run_policy`` makes.  The snapshot-near-``tau_hit``
    flag is a superset of ``run_policy_batched``'s protections (exactness
    stays modulo float-exact similarity ties between distinct embeddings,
    which the synthetic geometry excludes);
  - content mode needs no similarity work: the one-pass win is the shared
    trace walk plus the policies' vectorized batch hooks — runs of
    consecutive hits flush through ``on_hit_batch`` in one slab write.

Policy hooks run host-side exactly as the facade would drive them
(hit -> ``on_hit``, miss -> insert + ``on_admit`` + evict-while-over, a
below-threshold miss on resident content does not reinsert), and policies
exposing device eviction scoring hooks (RAC's ``value_backend``) are wired
to the backend the same way :class:`repro_torch.cache.SemanticCache` wires
them, so RAC variants ride the arena unchanged and score their evictions
with the ``rac_value`` kernel on the card.

``backend`` is ``"kernel"`` (the default, on ``device="cuda"``; pass
``device="cpu"`` for the kernels' plain versions), ``"sharded"`` (the
slot axis cut into shards, one B1-multi a shard and a merge; its flagged
rescans and eviction scoring run on a dense kernel backend on the same
device) or ``"numpy"`` (the host oracle).
"""
from __future__ import annotations

import time

import numpy as np

from .simulator import _EPS, PolicyFactory, hr_full, with_seed
from .store import MutationJournal, ResidentStore
from .types import Stats, Trace


class _ArenaView(ResidentStore):
    """One policy's resident store: views into the arena's stacked arrays.

    Behaves exactly like a dense :class:`ResidentStore` (same slot
    allocation, same zero-freed-rows contract), but its ``emb``/``occ``/
    ``cid`` rows alias the arena's ``(P, S, D)`` buffers, so mutating
    through the view keeps the stacked launch's input current for free.
    Mutations *bump* the view's own journal (single-store backend calls
    key their mirrors on its version; a flagged-fallback full upload is
    fine, so no per-row log is kept) and stamp the arena's flat journal at
    row ``p * S + slot`` when a device backend is attached (the stacked
    mirror's dirty-row sync); host-only runs bump it instead.
    """

    def __init__(self, arena: "ArenaStore", p: int):
        self.capacity = arena.capacity
        self.emb = arena.emb[p]
        self.occ = arena.occ[p]
        self.cid = arena.cid[p]
        self.slot_of = {}
        self._free = list(range(arena.n_slots - 1, -1, -1))
        self.hwm = 0
        self._log = MutationJournal()
        self._arena = arena
        self._p = p

    def _stamp(self, slot: int):
        # journaling exists for device mirrors only: host-only arenas
        # (track_rows=False) skip it entirely — nothing keys on these
        # versions — while device arenas stamp the flat journal AND the
        # view's own row journal: the per-view consumers (quantized host
        # mirrors, the fused pipeline's topic-bucket indices) key on the
        # view version and use dirty_since for incremental refresh, so a
        # bare bump would force a full rebuild per mutation
        arena = self._arena
        if arena.track_rows:
            self._log.stamp(slot)
            arena._log.stamp(self._p * arena.n_slots + slot)

    # lean clones of ResidentStore.insert/remove: identical state changes,
    # no assert / placement-hook / stamp-method indirection — this pair
    # runs once per miss per policy and is a measurable slice of the sweep
    def insert(self, cid: int, emb) -> int:
        slot = self._free.pop()
        self.emb[slot] = emb
        self.occ[slot] = True
        self.cid[slot] = cid
        self.slot_of[cid] = slot
        if slot >= self.hwm:
            self.hwm = slot + 1
        self._stamp(slot)
        return slot

    def remove(self, cid: int) -> int:
        slot = self.slot_of.pop(cid)
        self.occ[slot] = False
        self.cid[slot] = -1
        # zero the freed row: device backends score the full fixed-shape
        # slab, and a zero embedding can never clear tau_hit > 0
        self.emb[slot] = 0.0
        self._free.append(slot)
        self._stamp(slot)
        return slot


class ArenaStore:
    """P stacked resident slabs sharing one ``(P, S, D)`` buffer.

    ``views[p]`` is policy p's :class:`ResidentStore`-compatible store;
    the stacked arrays are what ``top1_multi`` scores (device backends
    mirror the flat ``(P*S, D)`` slab against :attr:`dirty_since`)."""

    def __init__(self, n_policies: int, capacity: int, dim: int,
                 track_rows: bool = False):
        self.n_policies = n_policies
        self.capacity = capacity
        self.dim = dim
        self.n_slots = capacity + 1        # Alg. 1 insert-then-evict spare
        # per-row journaling feeds device dirty-row scatter; host-only
        # backends skip the log and pay only a version bump per mutation
        self.track_rows = track_rows
        self.emb = np.zeros((n_policies, self.n_slots, dim), np.float32)
        self.occ = np.zeros((n_policies, self.n_slots), bool)
        self.cid = np.full((n_policies, self.n_slots), -1, np.int64)
        self._log = MutationJournal()
        self.views = [_ArenaView(self, p) for p in range(n_policies)]

    @property
    def version(self) -> int:
        return self._log.version

    def dirty_since(self, version: int) -> set[int] | None:
        """Flat (p * S + slot) rows mutated after ``version``."""
        return self._log.dirty_since(version)

    def hwms(self) -> np.ndarray:
        """Per-policy high-water marks (the stacked launch's n_valid)."""
        return np.fromiter((v.hwm for v in self.views), dtype=np.int64,
                           count=self.n_policies)

    def __len__(self) -> int:
        return sum(len(v) for v in self.views)


def _flush_hits(pol, cids: list, reqs: list, ts: list):
    if cids:
        pol.on_hit_batch(cids, reqs, ts)
        cids.clear()
        reqs.clear()
        ts.clear()


def run_arena(trace: Trace, capacity: int,
              factories: dict[str, PolicyFactory],
              hit_mode: str = "content", tau_hit: float = 0.85,
              backend: str = "kernel", chunk: int = 512,
              device: str = "cuda",
              seed: int | None = None,
              quantized: bool | dict = False,
              pruned: bool | dict = False) -> list[Stats]:
    """One-pass arena replay of every factory (see module docstring).

    Returns one :class:`Stats` per factory, in dict order, with hit /
    miss / eviction counts equal to ``run_policy``'s per policy.
    ``wall_s`` reports each policy's amortized share (total arena wall
    time / P) so throughput comparisons against sequential runs stay
    apples-to-apples.  ``quantized`` routes the stacked Top-1 scan onto
    the int8 mirror path (:mod:`repro_torch.cache.quantized`; one stacked
    ``sim_topk_q8`` launch per chunk) — decisions are unchanged; the
    semantic-mode hit threshold is filled into the quantized config's
    certain-miss arm automatically.  ``pruned`` routes it through the
    topic-pruned two-stage scan (:mod:`repro_torch.cache.pruned`) instead
    — each table-backed policy's probe runs over its own per-policy bucket
    index; table-less policies fall back to the exact per-view scan.  The
    two compose (``pruned`` + ``quantized``)."""
    import dataclasses

    from repro_torch.cache.backends import KernelBackend, get_backend
    from repro_torch.cache.facade import _VALUE_HOOKS

    names = list(factories)
    n_pol = len(names)
    if not n_pol:
        return []
    # resolve the backend FIRST and classify by the resolved instance, so
    # an already-built backend object (the contract get_backend documents)
    # selects the same arena wiring as its config-name spelling
    kw = {"device": device} if backend in ("kernel", "sharded") else {}
    if quantized:
        from repro_torch.cache.quantized import as_quantized_config
        qcfg = as_quantized_config(quantized)
        if qcfg.tau_hit is None and hit_mode == "semantic":
            qcfg = dataclasses.replace(qcfg, tau_hit=tau_hit)
        kw["quantized"] = qcfg
    if pruned:
        from repro_torch.cache.pruned import as_pruned_config
        pcfg = as_pruned_config(pruned)
        if pcfg.tau_hit is None and hit_mode == "semantic":
            pcfg = dataclasses.replace(pcfg, tau_hit=tau_hit)
        kw["pruned"] = pcfg
    be = get_backend(backend, **kw)
    on_device = be.name in ("kernel", "sharded")
    dim = trace.requests[0].emb.shape[0]
    # the quantized mirror and the pruned bucket indices key on the
    # arena's flat journal, so either path needs row tracking even on
    # the numpy backend
    arena = ArenaStore(n_pol, capacity, dim,
                       track_rows=on_device or bool(quantized)
                       or bool(pruned))
    policies = [with_seed(factories[n], seed)(capacity, arena.views[i])
                for i, n in enumerate(names)]
    if pruned:
        # per-policy routing tables: each table-backed policy probes its
        # own topic structure; None entries take the exact per-view scan
        be.route_tables = [getattr(pol, "table", None) for pol in policies]
    # flagged single-query rescans (``top1``) and eviction scoring run on
    # the backend itself, except under "sharded", where a dense kernel
    # backend on the same device computes the same per-row scores without
    # fanning one query out over the shards
    ref_be = KernelBackend(be.device) if be.name == "sharded" else be
    for pol in policies:
        for attr, method in _VALUE_HOOKS:
            if hasattr(pol, attr):
                setattr(pol, attr, getattr(ref_be, method))

    stats = [Stats(policy=n, capacity=capacity, requests=len(trace.requests))
             for n in names]
    semantic = hit_mode == "semantic"
    reqs = trace.requests
    step = max(1, chunk)
    t0 = time.perf_counter()
    if semantic:
        for lo in range(0, len(reqs), step):
            block = reqs[lo:lo + step]
            b = len(block)
            embs = np.stack([r.emb for r in block]).astype(np.float32,
                                                          copy=False)
            snap_cid, snap_sim = be.top1_multi(arena, embs)
            gram = embs @ embs.T if 1 < b <= 8192 else None
            for p in range(n_pol):
                _replay_semantic(policies[p], arena.views[p], stats[p],
                                 block, embs, gram,
                                 np.asarray(snap_cid[p], np.int64).copy(),
                                 np.asarray(snap_sim[p], np.float64).copy(),
                                 capacity, tau_hit, ref_be)
    else:
        for lo in range(0, len(reqs), step):
            block = reqs[lo:lo + step]
            # extracted once, shared by every policy's replay
            cids = [r.cid for r in block]
            ts = [r.t for r in block]
            for p in range(n_pol):
                _replay_content(policies[p], arena.views[p], stats[p],
                                block, cids, ts, capacity)
    wall = time.perf_counter() - t0
    hrf = hr_full(trace)
    for s in stats:
        s.wall_s = wall / n_pol
        s.hr_full = hrf
    return stats


def _replay_content(pol, store, st: Stats, block, cids, ts, capacity: int):
    """Content-mode chunk replay: O(1) residency hits, batched hit runs.
    ``cids``/``ts`` are the chunk's request fields, extracted once by the
    caller and shared across all P policies; bound methods are hoisted —
    this body runs once per (request, policy) and its own overhead is a
    measurable slice of the sweep."""
    slot_of = store.slot_of
    insert, remove = store.insert, store.remove
    on_admit, victim = pol.on_admit, pol.victim
    on_hit_batch = pol.on_hit_batch
    hits = misses = evictions = 0
    pc: list = []
    pr: list = []
    pt: list = []
    for i, cid in enumerate(cids):
        if cid in slot_of:
            hits += 1
            pc.append(cid)
            pr.append(block[i])
            pt.append(ts[i])
            continue
        if pc:
            on_hit_batch(pc, pr, pt)
            pc, pr, pt = [], [], []
        misses += 1
        req = block[i]
        t = ts[i]
        insert(cid, req.emb)
        on_admit(cid, req, t)
        while len(slot_of) > capacity:
            remove(victim(t))
            evictions += 1
    if pc:
        on_hit_batch(pc, pr, pt)
    st.hits += hits
    st.misses += misses
    st.evictions += evictions


def _replay_semantic(pol, store, st: Stats, block, embs, gram,
                     best_cid, best_sim, capacity: int, tau_hit: float,
                     ref_be):
    """Semantic-mode chunk replay for one policy — the exact-incremental
    body of ``run_policy_batched`` against this policy's snapshot row,
    restructured so clean-hit runs are consumed without a per-request
    Python step.

    ``ok[j]`` marks queries whose snapshot decides a hit with no
    engine-drift risk: best over the hit gate, not epsilon-flagged, and
    not a host-promoted best sitting on the gate.  Hits never mutate
    residency, so a maximal ``ok`` run is one ``on_hit_batch`` flush; the
    first non-``ok`` query is handled individually (reference rescan when
    flagged, the admit/evict machinery on a miss).  An eviction flags
    every remaining query currently holding the victim as its best — a
    sticky superset of ``run_policy_batched``'s use-time ``gone`` check
    (strictly more reference rescans, identical decisions)."""
    b = len(block)
    # flagged[j]: query j's decision could hinge on a host-vs-backend (or
    # stacked-vs-single launch) float difference — force the reference
    # backend scan at its turn.  Snapshot bests already gate-adjacent are
    # flagged up front (see module docstring).
    flagged = np.abs(best_sim - tau_hit) <= _EPS
    promoted = np.zeros(b, dtype=bool)   # best came from a host rescore
    ok = (best_sim >= tau_hit) & ~flagged
    slot_of = store.slot_of
    i = 0
    while i < b:
        if ok[i]:
            rest = ok[i:]
            stop = int(np.argmin(rest))          # first False, 0 if none
            j = i + (stop if not rest[stop] else rest.size)
            st.hits += j - i
            # the facade notifies the HIT cid for each served query
            pol.on_hit_batch(best_cid[i:j].tolist(), block[i:j],
                             [r.t for r in block[i:j]])
            i = j
            continue
        req = block[i]
        c = int(best_cid[i])
        sim = float(best_sim[i])
        if flagged[i] or (promoted[i] and abs(sim - tau_hit) <= _EPS):
            c, sim = ref_be.top1(store, req.emb)
            c = int(c)
        if sim >= tau_hit:
            st.hits += 1
            pol.on_hit(c, req, req.t)
            i += 1
            continue
        st.misses += 1
        if req.cid in slot_of:
            i += 1
            continue   # paraphrase below tau_hit: resident, no reinsert
        store.insert(req.cid, req.emb)
        pol.on_admit(req.cid, req, req.t)
        evicted = []
        while len(slot_of) > capacity:
            v = pol.victim(req.t)
            store.remove(v)
            st.evictions += 1
            evicted.append(v)
        if i + 1 < b:
            tail_cid = best_cid[i + 1:]
            tail = best_sim[i + 1:]
            tail_flag = flagged[i + 1:]
            for v in evicted:
                tail_flag |= tail_cid == v
            if req.cid in slot_of:
                # exact incremental rescore: the one dirtied row is scored
                # against the remaining queries (strictly-better wins; a
                # near-tie flags the query for the reference scan instead)
                sims = (gram[i + 1:, i] if gram is not None else
                        embs[i + 1:] @ np.asarray(req.emb,
                                                  dtype=np.float32))
                tail_flag |= ((np.abs(sims - tail) <= _EPS)
                              & (np.maximum(sims, tail) >= tau_hit - _EPS))
                upd = sims > tail
                if upd.any():
                    tail[upd] = sims[upd]
                    tail_cid[upd] = req.cid
                    promoted[i + 1:][upd] = True
            ok[i + 1:] = ((tail >= tau_hit) & ~tail_flag
                          & ~(promoted[i + 1:]
                              & (np.abs(tail - tau_hit) <= _EPS)))
        i += 1
