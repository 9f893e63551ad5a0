"""Topic-pruned two-stage lookup: IVF-style candidate scan over RAC's
own topic structure (``CacheConfig.pruned_lookup``).

Every exact lookup touches all S resident rows — O(S·D) traffic per
query no matter how few rows could plausibly win.  But RAC already
maintains a pruning index for free: the journaled dense topic-
representative matrix (``PolicyTable.rep``).  The pruned path scores
the query against the (T, D) representatives first (T ≪ S), probes the
top-P topics, and scans only their member rows.

Decisions stay **identical** to the exact path by construction — this
module never trusts the routing heuristic.  Each per-query decision is
certified by a safety predicate built on a per-topic *spread* bound
(Cauchy–Schwarz: for any member ``x`` of topic ``t`` with
representative ``r_t`` and spread ``σ_t = max_x ‖x − r_t‖``,

    q·x  ≤  q·r_t + ‖q‖·‖x − r_t‖  ≤  q·r_t + ‖q‖·σ_t  =:  bound(q, t)

so the best row of an *unprobed* topic cannot beat that topic's bound).
Routing scores the augmented matrix ``[r_t | σ_t]`` against ``[q |
‖q‖]`` — one (T, D+1) matmul yields the bounds directly, and the top-P
*bounds* are the probe set (greedily minimising the strongest unprobed
bound).  Uncertifiable queries take an exact full-scan fallback,
counted in ``prune_stats["fallbacks"]`` and surfaced as the
``cache.prune_fallbacks`` tracker counter.

The topic→slots bucket index here (:class:`TopicBucketIndex`) is
CSR-style packed arrays rebuilt *incrementally* from the same mutation
journals the device mirrors sync against (store row journal +
``PolicyTable``'s ``dirty_slots_since`` / ``dirty_topics_since``), so
steady-state maintenance is O(mutated slots), not O(capacity).

Safety predicates (:func:`resolve_pruned`, per query, strict
inequalities): with ``ub`` the strongest bound of any unprobed topic
(column ``probes`` of the routing result, or the first probe dropped by
the scan budget), a candidate-scan result is

1. a certified Top-1 when ``sim > ub`` — no row outside the candidate set
   can beat or tie it, and the candidates were scanned in ascending slot
   order, so cid and sim are the exact path's;
2. a certified miss when ``sim < tau`` and ``ub < tau`` — no row anywhere
   reaches the hit band (the reported best-effort sim may differ from the
   exact scan's, the decision does not);
3. otherwise an exact full-scan fallback.

When ``tau`` is armed and a query's *strongest* bound is already below
it, stage 2 probes nothing and scans only the unassigned bucket (which no
representative bounds).  The scan cost is ``T·(D+1)`` for routing plus
the gathered candidate rows, against ``S·D`` for the exact scan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.store import MutationJournal

# Finite "cannot win, cannot bound-block" sentinel for the spread column
# of memberless topics.  Finite (not -inf) so the routing matmul never
# produces inf·0 NaNs; -1e30 keeps the topic's bound astronomically
# negative, so it neither attracts probes nor blocks certification.
NEG = np.float32(-1e30)

# Spread inflation absorbing fp32 kernel evaluation error: the routing
# matmul and the candidate scan both run in fp32 (~1e-5 relative at
# D=128 unit rows); the bound is computed in float64 and padded before
# the fp32 cast so it stays an upper bound of every computed score.
_SPREAD_PAD_REL = 1.05
_SPREAD_PAD_ABS = 1e-4


@dataclasses.dataclass(frozen=True)
class PrunedLookupConfig:
    """Configuration for the topic-pruned candidate scan.

    ``probes`` is the number of topic buckets stage 2 scans per query
    (P).  ``tau_hit`` arms the certain-miss arm of the safety predicate
    (every topic bound and every scanned candidate below tau ⇒ certain
    miss); the facade copies its own ``tau_hit`` in for semantic-mode
    stores when left ``None``.

    ``max_scan_frac`` caps each query's gathered candidate rows at that
    fraction of the resident count (floored at ``min_scan_rows`` so
    small stores stay uncapped): probes are kept greedily in
    descending-bound order while the cumulative bucket rows fit the
    budget, and the first dropped probe's bound becomes the query's
    certification bound — wide-P queries landing in fat buckets degrade
    to fewer probes (at worst the tau short-circuit) instead of
    gathering more bytes than the exact scan would stream.  Capped
    queries are counted in ``prune_stats["capped"]``.  ``None`` disables
    the cap.  ``fused`` routes kernel backends through the
    device-resident fused pipeline (one launch from routing to certified
    decision; see :mod:`repro_torch.kernels.fused`) — the staged multi-launch
    driver remains available with ``fused=False``.  ``fused_max_batch``
    is the chunk-size dispatch policy: the fused program gathers a full
    ``cap_c``-row candidate block per query, so past this batch width
    the staged driver's signature-grouped shared gathers win and wide
    chunks fall through to it.
    """
    probes: int = 2
    tau_hit: Optional[float] = None
    max_scan_frac: Optional[float] = 0.02
    min_scan_rows: int = 256
    fused: bool = True
    fused_max_batch: int = 16


def as_pruned_config(spec) -> Optional[PrunedLookupConfig]:
    """Normalize ``CacheConfig.pruned_lookup`` specs: ``None``/``False``
    → off, ``True`` → defaults, a dict → kwargs, or a ready config."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return PrunedLookupConfig()
    if isinstance(spec, PrunedLookupConfig):
        return spec
    if isinstance(spec, dict):
        return PrunedLookupConfig(**spec)
    raise ValueError(f"bad pruned_lookup spec: {spec!r}")


def new_prune_stats() -> dict:
    """Zeroed pruned-scan ledger (always present in
    ``metrics_snapshot()["prune"]``, even with the path off)."""
    return {"scans": 0, "queries": 0, "fallbacks": 0, "probed_topics": 0,
            "scanned_rows": 0, "rows_exact": 0,
            "bytes_scanned": 0, "bytes_exact": 0, "capped": 0}


def account_prune(stats: dict, *, n_valid: int, dim: int, n_topics: int,
                  batch: int, probes: int, scanned_rows: int,
                  slab_bytes: int, n_fallback: int,
                  n_capped: int = 0) -> None:
    """Ledger one pruned batch scan.

    ``bytes_exact`` is what the exact path would have streamed (the fp32
    slab once per scan); ``bytes_scanned`` is the routing matrix plus the
    gathered candidate slabs actually read (``slab_bytes``, quantized
    gathers included by the caller), plus a whole exact slab per scan
    containing fallbacks.  ``scanned_rows`` / ``rows_exact`` are the
    per-query row-scoring counts (Σ_q |candidates(q)| vs batch·S) — the
    compute-side reduction.
    """
    stats["scans"] += 1
    stats["queries"] += batch
    stats["fallbacks"] += n_fallback
    stats["capped"] += n_capped
    stats["probed_topics"] += probes
    stats["scanned_rows"] += scanned_rows
    stats["rows_exact"] += n_valid * batch
    stats["bytes_exact"] += n_valid * dim * 4
    stats["bytes_scanned"] += n_topics * (dim + 1) * 4 + slab_bytes
    if n_fallback:
        stats["bytes_scanned"] += n_valid * dim * 4


class TopicBucketIndex:
    """Incremental topic→slots bucket index with per-topic spread.

    Maintains, against the store/table mutation journals:

    - a slot-state vector (−2 = free slot, −1 = occupied but unassigned
      to any topic, t ≥ 0 = member of topic ``t``);
    - per-topic member sets packed into CSR arrays (``indptr`` /
      ``slot_ids``, members ascending) plus the ``unassigned`` bucket —
      occupied rows with no topic are in **every** candidate set, since
      no representative bounds them;
    - the augmented routing matrix ``aug`` of shape (T, D+1): row ``t``
      is ``[rep_t | σ_t_eff]`` with the inflated spread in the last
      column (memberless topics get ``[0…0, NEG]``).

    ``aug`` rows carry their own :class:`MutationJournal` (``log``) so
    device backends can mirror the routing matrix with the standard
    dirty-row scatter; a full rebuild swaps in a fresh journal, which
    foreign-lineage mirrors answer with a full upload.
    """

    def __init__(self):
        self.log = MutationJournal()
        self.aug: Optional[np.ndarray] = None          # (T, D+1) float32
        self.indptr = np.zeros(1, dtype=np.int64)
        self.slot_ids = np.zeros(0, dtype=np.int64)
        self.unassigned = np.zeros(0, dtype=np.int64)
        self.stats = {"full": 0, "incremental": 0, "slots": 0, "topics": 0}
        self._key = None              # (store.version, slot_ver, topic_ver)
        self._shape = None            # (n_slots, n_topic_rows, dim)
        self._state: Optional[np.ndarray] = None
        self._members: dict[int, set] = {}
        self._unassigned: set = set()
        self._csr_fresh = False
        self._cand_cache: dict[tuple, np.ndarray] = {}

    # ------------------------------------------------------------ mirror API
    @property
    def version(self) -> int:
        return self.log.version

    @property
    def key(self):
        """Identity of the last-synced (store, table) journal state.

        Device CSR mirrors must key on this triple, **not** on
        ``version``: membership churn confined to the unassigned bucket
        (e.g. evicting a topicless row) touches no aug row, so the aug
        journal doesn't move even though the CSR arrays changed."""
        return self._key

    def dirty_since(self, version: int):
        return self.log.dirty_since(version)

    # ---------------------------------------------------------------- sync
    def sync(self, store, table) -> "TopicBucketIndex":
        """Freshen the index against ``(store, table)``; no-op when the
        journal versions match the last sync."""
        key = (store.version, table.slot_version, table.topic_version)
        shape = (store.emb.shape[0], table.rep.shape[0], store.emb.shape[1])
        if key == self._key and shape == self._shape:
            return self
        incremental = self._key is not None and shape == self._shape
        if incremental:
            d_emb = store.dirty_since(self._key[0])
            d_slot = table.dirty_slots_since(self._key[1])
            d_topic = table.dirty_topics_since(self._key[2])
            incremental = (d_emb is not None and d_slot is not None
                           and d_topic is not None)
        if incremental:
            self._apply(store, table, d_emb, d_slot, d_topic)
        else:
            self._rebuild(store, table)
        self._key = key
        self._shape = shape
        return self

    def _rebuild(self, store, table) -> None:
        n_slots, dim = store.emb.shape
        n_top = table.rep.shape[0]
        state = np.full(n_slots, -2, dtype=np.int64)
        occ = np.flatnonzero(store.occ)
        state[occ] = np.where(table.topic_of[occ] >= 0,
                              table.topic_of[occ], -1)
        self._state = state
        self._unassigned = set(np.flatnonzero(state == -1).tolist())
        self._members = {int(t): set(np.flatnonzero(state == t).tolist())
                         for t in np.unique(state[state >= 0])}
        self.aug = np.zeros((n_top, dim + 1), dtype=np.float32)
        self.aug[:, -1] = NEG
        # fresh journal lineage: mirrors that synced the old aug see a
        # foreign journal and fall back to a full upload
        self.log = MutationJournal()
        for t in self._members:
            self._refresh_topic(t, store, table)
        self.log.bump()
        self.stats["full"] += 1
        self._csr_fresh = False
        self._cand_cache = {}

    def _apply(self, store, table, d_emb: set, d_slot: set,
               d_topic: set) -> None:
        state = self._state
        n_slots = state.shape[0]
        n_top = self.aug.shape[0]
        touched: set[int] = set()
        for slot in (d_emb | d_slot):
            if slot >= n_slots:
                continue
            old = int(state[slot])
            if store.occ[slot]:
                t = int(table.topic_of[slot])
                new = t if t >= 0 else -1
            else:
                new = -2
            if new != old:
                if old >= 0:
                    m = self._members.get(old)
                    if m:
                        m.discard(slot)
                    touched.add(old)
                elif old == -1:
                    self._unassigned.discard(slot)
                if new >= 0:
                    self._members.setdefault(new, set()).add(slot)
                    touched.add(new)
                elif new == -1:
                    self._unassigned.add(slot)
                state[slot] = new
                self._csr_fresh = False
            elif new >= 0 and slot in d_emb:
                # embedding rewritten in place within its bucket: the
                # spread may have grown
                touched.add(new)
        for t in d_topic:
            # representative moved (or topic retired/revived): every
            # member distance is stale
            if 0 <= t < n_top:
                touched.add(t)
        for t in touched:
            self._refresh_topic(t, store, table)
        self.stats["incremental"] += 1
        self.stats["slots"] += len(d_emb | d_slot)
        if touched:
            self._cand_cache = {}

    def _refresh_topic(self, t: int, store, table) -> None:
        """Recompute topic ``t``'s aug row ([rep | inflated spread], or
        the inert memberless row) and journal the mutation."""
        row = self.aug[t]
        members = self._members.get(t)
        if not members:
            row[:-1] = 0.0
            row[-1] = NEG
        else:
            slots = np.fromiter(members, dtype=np.int64, count=len(members))
            rep = table.rep[t].astype(np.float64)
            d = store.emb[slots].astype(np.float64) - rep
            spread = float(np.sqrt(np.max(np.sum(d * d, axis=1))))
            row[:-1] = table.rep[t]
            row[-1] = np.float32(spread * _SPREAD_PAD_REL + _SPREAD_PAD_ABS)
        self.log.stamp(t)
        self.stats["topics"] += 1

    # ------------------------------------------------------------ candidates
    def _pack_csr(self) -> None:
        n_top = self.aug.shape[0]
        counts = np.zeros(n_top + 1, dtype=np.int64)
        for t, members in self._members.items():
            counts[t + 1] = len(members)
        self.indptr = np.cumsum(counts)
        self.slot_ids = np.empty(int(self.indptr[-1]), dtype=np.int64)
        for t, members in self._members.items():
            self.slot_ids[self.indptr[t]:self.indptr[t + 1]] = \
                sorted(members)
        self.unassigned = np.fromiter(sorted(self._unassigned),
                                      dtype=np.int64,
                                      count=len(self._unassigned))
        self._csr_fresh = True
        self._cand_cache = {}

    def csr(self) -> tuple:
        """Fresh packed CSR view: ``(indptr, slot_ids, unassigned)``.
        Packs lazily if membership churned since the last pack."""
        if not self._csr_fresh:
            self._pack_csr()
        return self.indptr, self.slot_ids, self.unassigned

    def group_key(self, tids) -> tuple:
        """Canonical probe signature: sorted topic ids with non-empty
        buckets (empty buckets contribute no candidates and are dropped
        so batches group better)."""
        if not self._csr_fresh:
            self._pack_csr()
        return tuple(sorted(int(t) for t in np.unique(np.asarray(tids))
                            if self.indptr[t] < self.indptr[t + 1]))

    def candidate_rows(self, sig: tuple) -> np.ndarray:
        """Ascending slot ids of every candidate for probe signature
        ``sig``: the probed buckets' members plus the unassigned bucket.
        Buckets are disjoint, so concatenate + sort needs no dedup; the
        ascending order preserves the exact path's lower-slot tie rule."""
        if not self._csr_fresh:
            self._pack_csr()
        rows = self._cand_cache.get(sig)
        if rows is None:
            parts = [self.slot_ids[self.indptr[t]:self.indptr[t + 1]]
                     for t in sig]
            parts.append(self.unassigned)
            rows = np.sort(np.concatenate(parts))
            self._cand_cache[sig] = rows
        return rows


def route_topics_host(queries: np.ndarray, aug: np.ndarray, n_topics: int,
                      probes: int) -> tuple[np.ndarray, np.ndarray]:
    """Host (numpy) routing oracle: fp32 bound matmul + stable descending
    argsort over the live topics.  Routing need not be bit-identical
    across backends — it only picks *which* buckets to probe; the safety
    predicate certifies decisions regardless."""
    qn = np.linalg.norm(queries.astype(np.float32),
                        axis=1, keepdims=True).astype(np.float32)
    qa = np.concatenate([queries.astype(np.float32), qn], axis=1)
    scores = qa @ aug[:n_topics].T                       # (B, T) fp32
    k = min(probes + 1, n_topics)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, order, axis=1).astype(np.float64)
    return vals, order.astype(np.int64)


def resolve_pruned(cand_cids, cand_sims, bound, tau_hit,
                   exact_fn: Callable) -> tuple:
    """Certify each candidate-scan result against the unprobed bound.

    ``bound[i]`` is an upper bound on the true score of every row *not*
    in query ``i``'s candidate set.  Two arms:

    1. **Top-1 certified**: ``cand_sim > bound`` (strict) — no
       non-candidate can beat or tie it, and candidates were scanned
       ascending, so ``(cid, sim)`` is bit-equal to the exact path.
    2. **Miss certified**: ``cand_sim < tau`` and ``bound < tau`` — no
       row anywhere reaches the tau band; decision-equal (the reported
       best-effort sim may differ from the exact scan's).

    Anything else falls back to ``exact_fn`` (exact full scan) for those
    queries; the fallback count is returned for the ledger.
    """
    cids = np.asarray(cand_cids, dtype=np.int64).copy()
    sims = np.asarray(cand_sims, dtype=np.float64).copy()
    bound = np.asarray(bound, dtype=np.float64)
    safe = sims > bound
    if tau_hit is not None:
        safe |= (sims < tau_hit) & (bound < tau_hit)
    n_fb = int(sims.shape[0] - np.count_nonzero(safe))
    if n_fb:
        sel = np.flatnonzero(~safe)
        f_cids, f_sims = exact_fn(sel)
        cids[sel] = np.asarray(f_cids, dtype=np.int64)
        sims[sel] = np.asarray(f_sims, dtype=np.float64)
    sims = np.where(cids >= 0, sims, -np.inf)
    return cids, sims, n_fb


def pruned_top1_batch(store, table, queries: np.ndarray,
                      cfg: PrunedLookupConfig, idx: TopicBucketIndex,
                      stats: dict, *, route_fn: Callable,
                      scan_fn: Callable, exact_fn: Callable) -> tuple:
    """The backend-agnostic two-stage driver.

    ``route_fn(queries, aug, n_topics) -> (vals, tids)`` scores the
    (B, P+1) strongest topic *bounds* (vals descending; entries past the
    live-topic count are −inf).  ``scan_fn(sel, rows) -> (cids, sims,
    nbytes)`` scans queries ``queries[sel]`` against the gathered
    ascending candidate ``rows`` and reports the slab bytes it read.
    ``exact_fn(sel) -> (cids, sims)`` is the exact full scan used for
    uncertifiable queries.

    Queries sharing a probe signature are scanned as one group (one
    gather + one kernel launch).  When ``tau_hit`` is armed, a query
    whose *strongest* topic bound is already below tau short-circuits
    stage 2 entirely (no assigned row can reach tau — only the unbounded
    unassigned bucket still needs scanning).
    """
    idx.sync(store, table)
    b, dim = queries.shape
    n_top = int(table.topic_hwm)
    probes = int(cfg.probes)
    if n_top > 0:
        vals, tids = route_fn(queries, idx.aug, n_top)
        vals = np.asarray(vals, dtype=np.float64)
        tids = np.asarray(tids, dtype=np.int64)
        ub = (vals[:, probes].copy() if vals.shape[1] > probes
              else np.full(b, -np.inf))
        probe_vals = vals[:, :probes]
        probe_tids = tids[:, :probes]
    else:
        ub = np.full(b, -np.inf)
        probe_vals = np.zeros((b, 0))
        probe_tids = np.zeros((b, 0), dtype=np.int64)
    # certain-miss routing short-circuit: strongest bound < tau means no
    # assigned row can reach the band — probe nothing, scan unassigned
    skip = np.zeros(b, dtype=bool)
    if cfg.tau_hit is not None and probe_vals.shape[1] > 0:
        skip = probe_vals[:, 0] < cfg.tau_hit
        ub[skip] = probe_vals[skip, 0]
    budget = None
    if cfg.max_scan_frac is not None:
        budget = max(int(cfg.min_scan_rows),
                     int(cfg.max_scan_frac * store.hwm))
    groups: dict[tuple, list[int]] = {}
    n_probed = 0
    n_capped = 0
    empty_sig = ()
    for i in range(b):
        if skip[i]:
            sig = empty_sig
        else:
            live = probe_tids[i][np.isfinite(probe_vals[i])]
            if budget is not None and live.size:
                # adaptive probe cap: keep the longest descending-bound
                # prefix whose cumulative bucket rows fit the budget; the
                # first dropped probe's bound (≥ every later bound and ≥
                # the unprobed bound) becomes the certification bound
                indptr, _, _ = idx.csr()
                cnts = indptr[live + 1] - indptr[live]
                keep = int(np.searchsorted(np.cumsum(cnts), budget,
                                           side="right"))
                if keep < live.size:
                    n_capped += 1
                    ub[i] = probe_vals[i, keep]
                    live = live[:keep]
            sig = idx.group_key(live)
            n_probed += len(sig)
        groups.setdefault(sig, []).append(i)
    cids = np.full(b, -1, dtype=np.int64)
    sims = np.full(b, -np.inf)
    scanned = 0
    slab_bytes = 0
    for sig, members in groups.items():
        rows = idx.candidate_rows(sig)
        if rows.size == 0:
            continue
        sel = np.asarray(members, dtype=np.int64)
        scanned += rows.size * sel.size
        g_cids, g_sims, nbytes = scan_fn(sel, rows)
        cids[sel] = np.asarray(g_cids, dtype=np.int64)
        sims[sel] = np.asarray(g_sims, dtype=np.float64)
        slab_bytes += int(nbytes)
    out_cids, out_sims, n_fb = resolve_pruned(cids, sims, ub, cfg.tau_hit,
                                              exact_fn)
    account_prune(stats, n_valid=store.hwm, dim=dim, n_topics=n_top,
                  batch=b, probes=n_probed, scanned_rows=scanned,
                  slab_bytes=slab_bytes, n_fallback=n_fb,
                  n_capped=n_capped)
    return out_cids, out_sims
