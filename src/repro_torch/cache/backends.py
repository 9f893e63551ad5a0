"""Pluggable lookup/scoring backends behind :class:`repro_torch.cache.
SemanticCache`.

A backend answers three questions over the resident slab
(:class:`repro_torch.core.store.ResidentStore`) and the RAC scoring state
(:class:`repro_torch.core.policy_table.PolicyTable`):

  - Top-1 retrieval: for a (batch of) query embedding(s), which resident
    entry is most similar, and how similar?  (hit determination)
  - RAC value scoring: Eq. 1 ``TP(Z_q)·TSI(q)`` over the resident table.
    (eviction scoring)
  - Fused decision scoring (``decide_batch``): hit Top-1 + Alg. 4 topic
    routing against the representative table + occupancy-masked Eq. 1
    victim values, all from ONE dispatch per query chunk — the replay
    loop's snapshot scoring surface.

Two implementations with identical hit decisions:

  - :class:`NumpyBackend` — the host path: masked matmul over the dense
    slab (exactly ``ResidentStore.nearest`` for single queries).  It is
    the host oracle the device path is held against.
  - :class:`KernelBackend` — the device path: the CUDA ``sim_top1`` kernel
    scores the whole query batch against the slab up to the store's
    high-water mark (a runtime count), the ``victim_value`` kernel scores
    the slot table, and the ``rac_value`` kernel scores evictions.  Free
    slots hold zero embeddings: a zero row can only win Top-1 when every
    real similarity is negative, in which case the query is far below any
    sensible ``tau_hit`` and is reported as a miss ``(-1, -inf)`` — the
    same *decision* the numpy path makes.

Backends are stateless with respect to the host store: they read the store
that is passed in, so one backend instance can serve many caches and
``checkpoint()/restore()`` needs no backend cooperation.  The kernel
backend keeps *mirrors* — device copies of the host arrays keyed by the
owners' globally-unique mutation versions, kept fresh by copying only the
rows the :class:`~repro_torch.core.store.MutationJournal` reports dirty (a
full re-upload only on a journal miss, a shape change, or bulk churn).

Both backends take the two approximate lookups of the reference:
``quantized`` (an int8 candidate scan, then an fp32 rescore of the
survivors, :mod:`repro_torch.cache.quantized`) and ``pruned`` (topic
routing, then a scan of the probed buckets only,
:mod:`repro_torch.cache.pruned`), alone or composed.  The numpy backend is
their host oracle; the kernel backend runs them on the ``sim_topk`` /
``sim_topk_q8`` / ``sim_top1`` kernels, staged (several launches and syncs)
for wide batches and fused (:mod:`repro_torch.kernels.fused`, one sync)
for lookups of at most ``fused_max_batch`` queries.  Decisions are those
of the exact scan by construction: every approximate result is certified
or rescanned exactly.

Both also serve the multi-policy arena (:mod:`repro_torch.core.arena`):
``top1_multi`` scores a query chunk against every policy's slab of an
``ArenaStore`` — on the kernel backend with ONE policy-stacked kernel
launch (``sim_top1_multi``; ``sim_topk_q8_multi`` when quantized), and on
the numpy backend with one host gemm.

The third backend, :class:`~repro_torch.cache.sharded.ShardedKernelBackend`
(``"sharded"``), partitions the slab by rows over the cards of the cache
mesh, or loops the same per-shard launches on one device, with the same
decisions (:mod:`repro_torch.cache.sharded`).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.policy_table import PolicyTable
from repro_torch.core.store import ResidentStore
from repro_torch.kernels import fused, ops
from repro_torch.kernels.quant import (int8_scores, quantize_rows_int8,
                                       scan_margin)
from repro_torch.telemetry.tracing import annotate

from .pruned import (TopicBucketIndex, account_prune, as_pruned_config,
                     new_prune_stats, pruned_top1_batch, route_topics_host)
from .quantized import (QuantizedSlabMirror, account_scan,
                        as_quantized_config, new_quant_stats, resolve_topk)
from .types import DecisionBatch


@runtime_checkable
class LookupBackend(Protocol):
    """Protocol every lookup/scoring backend implements."""

    name: str

    def top1(self, store: ResidentStore,
             query: np.ndarray) -> tuple[int, float]:
        """Top-1 resident for one query -> (cid, sim) or (-1, -inf)."""
        ...

    def top1_batch(self, store: ResidentStore,
                   queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Top-1 residents for (B, D) queries -> (cids (B,), sims (B,))."""
        ...

    def top1_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Top-1 restricted to the given store ``rows`` (slot indices) —
        the same cosine scoring as :meth:`top1_batch`, so an incremental
        rescan over recently-admitted rows can never disagree with a full
        peek near ``tau_hit``."""
        ...

    def rac_value(self, tsi: np.ndarray, tids: np.ndarray,
                  tp_last: np.ndarray, t_last: np.ndarray,
                  alpha: float, t_now: int) -> np.ndarray:
        """RAC Eq. 1 ``2^(-alpha·(t_now - t_last[tid])) · TP_last[tid] · tsi``."""
        ...

    def rac_value_masked(self, tsi: np.ndarray, tids: np.ndarray,
                         tp_last: np.ndarray, t_last: np.ndarray,
                         alpha: float, t_now: int,
                         valid: np.ndarray) -> np.ndarray:
        """Eq. 1 with a validity mask: invalid entries score ``+inf``."""
        ...

    def topk_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray, k: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Top-K restricted to the given store ``rows`` (slot indices):
        ((B, K) cids, (B, K) sims) sorted descending per query, ties
        toward the lower row position; ranks past the restriction size are
        ``(-1, -inf)``."""
        ...

    def decide_batch(self, store: ResidentStore,
                     table: Optional[PolicyTable], queries: np.ndarray, *,
                     alpha: float = 0.0, t_now: int = 0) -> DecisionBatch:
        """Fused snapshot decision scoring for a (B, D) query block: hit
        Top-1 + routing Top-1 + masked Eq. 1 victim values in one launch.
        ``table=None`` (table-less policies) degrades to hit Top-1 only."""
        ...

    def top1_multi(self, arena, queries: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Policy-stacked Top-1 over an :class:`~repro_torch.core.arena.
        ArenaStore`'s (P, S, D) slab — the multi-policy arena's snapshot
        scoring surface.  Returns ((P, B) cids, (P, B) sims); each row is
        the answer :meth:`top1_batch` would give for that policy's store
        view."""
        ...


def _miss(b: int) -> tuple[np.ndarray, np.ndarray]:
    return (np.full(b, -1, dtype=np.int64),
            np.full(b, -np.inf, dtype=np.float64))


def _sorted_topk(scores: np.ndarray, k: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Host Top-K: a stable descending sort keeps equal scores in
    ascending column order, the kernels' lower-index tie rule."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(scores, order, axis=1).astype(np.float64),
            order)


def small_delta(n_dirty: int, n_rows: int) -> bool:
    """The dirty-row sync policy: a delta this small is worth a device
    row copy; anything bigger re-uploads in full."""
    return n_dirty <= max(64, n_rows // 4)


class _DeviceMirror:
    """Device copy of equally-row-indexed host arrays, kept fresh by
    dirty-row copies against a :class:`MutationJournal`'s answers.

    ``sync(version, dirty_since, host_fn)`` returns tensors on ``device``
    of the ``dtypes`` declared at construction.  Same version → cached
    as-is with ZERO host work (``host_fn`` is only called on staleness,
    and the incremental branch casts only the dirty rows); journal-
    answerable small delta → ``index_copy_`` of those rows into the
    resident tensors (in place, on the launch stream, so later kernels see
    it); anything else (foreign lineage, aged-out journal, array growth,
    bulk churn) → full upload.

    ``row_align``: a 2-D array's device rows start a multiple of this many
    elements apart; the mirror keeps it in a zero-padded tensor and hands
    out the view of its first columns (the fp32 Top-K copies 16-byte row
    pieces, so the (T, D+1) routing matrix takes ``row_align=4``)."""

    def __init__(self, dtypes: dict, device: torch.device,
                 row_align: int = 1):
        self.dtypes = dtypes
        self.device = device
        self.row_align = row_align
        self.version = None
        self.arrays: Optional[dict] = None
        # "bytes" = host->device traffic this mirror moved (copied rows
        # for incremental syncs, whole arrays for full uploads)
        self.stats = {"full": 0, "incremental": 0, "rows": 0, "bytes": 0}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        # a copy on every device: on the CPU ``from_numpy`` would alias the
        # host array, which the owner keeps writing (a restored checkpoint
        # then finds the mirror at its version with another lineage's rows)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            copy=True)

    def _upload_rows(self, a: np.ndarray) -> torch.Tensor:
        t = self._upload(a)
        cols = t.shape[1] if t.dim() == 2 else 0
        if cols % self.row_align == 0:
            return t
        padded = t.new_zeros((t.shape[0], -(-cols // self.row_align)
                              * self.row_align))
        padded[:, :cols] = t
        return padded[:, :cols]

    def sync(self, version: int, dirty_since, host_fn) -> dict:
        if self.arrays is not None and version == self.version:
            return self.arrays
        host = host_fn()                       # raw host arrays, no casts
        dirty = None
        if self.arrays is not None and all(
                tuple(self.arrays[k].shape) == v.shape
                for k, v in host.items()):
            dirty = dirty_since(self.version)
        n_rows = next(iter(host.values())).shape[0]
        if dirty is not None and small_delta(len(dirty), n_rows):
            if dirty:
                rows = np.fromiter(sorted(dirty), dtype=np.int64,
                                   count=len(dirty))
                rows_t = self._upload(rows)
                for k, v in host.items():
                    block = np.asarray(v[rows], dtype=self.dtypes[k])
                    self.arrays[k].index_copy_(0, rows_t, self._upload(block))
                    self.stats["bytes"] += block.nbytes
                self.stats["incremental"] += 1
                self.stats["rows"] += len(dirty)
        else:
            self.arrays = {k: self._upload_rows(np.asarray(v,
                                                           self.dtypes[k]))
                           for k, v in host.items()}
            self.stats["full"] += 1
            self.stats["bytes"] += sum(
                v.size * np.dtype(self.dtypes[k]).itemsize
                for k, v in host.items())
        self.version = version
        return self.arrays


class NumpyBackend:
    """Host-side slab scan (the historical ``ResidentStore.nearest`` path)
    — the oracle every device path is held against.

    With ``quantized`` set (a :class:`~repro_torch.cache.quantized.
    QuantizedLookupConfig`, or ``True``/a dict spec) this is the quantized
    path's host oracle: the same per-row int8 mirror, an exact int8 gemm
    (``kernels.quant.int8_scores``) instead of the kernel scan, and the
    shared rescore/certify driver — survivor scores bit-equal to the
    kernel's.  With ``pruned`` set it routes on the host and scans the
    gathered candidate rows (int8 when ``quantized`` is also set)."""

    name = "numpy"

    def __init__(self, quantized=None, pruned=None):
        self.quantized = as_quantized_config(quantized)
        self.quant_stats = new_quant_stats()
        self._qhost = QuantizedSlabMirror()
        self._qhost_arena = QuantizedSlabMirror()
        # topic-pruned two-stage scan: the facade wires route_table and
        # route_store when the acting policy exposes a PolicyTable;
        # run_arena wires route_tables (one per policy)
        self.pruned = as_pruned_config(pruned)
        self.prune_stats = new_prune_stats()
        self._pidx = TopicBucketIndex()
        self._pidx_arena: dict[int, TopicBucketIndex] = {}
        self.route_table = None
        self.route_store = None

    def __deepcopy__(self, memo):
        # checkpoints share the backend: its mirrors and index are keyed
        # by journal versions, never by object identity
        return self

    def top1(self, store: ResidentStore, query: np.ndarray) -> tuple[int, float]:
        if self.quantized is not None or self.pruned is not None:
            cids, sims = self.top1_batch(store, np.asarray(query)[None, :])
            return int(cids[0]), float(sims[0])
        return store.nearest(query)

    def top1_batch(self, store: ResidentStore,
                   queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        if not store.slot_of:
            return _miss(queries.shape[0])
        if self.pruned is not None:
            out = self._top1_batch_pruned(store, queries)
            if out is not None:
                return out
        if self.quantized is not None:
            return self._top1_batch_quantized(store, queries)
        return self._top1_batch_exact(store, queries)

    def _top1_batch_exact(self, store: ResidentStore,
                          queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        b = queries.shape[0]
        if not store.slot_of:
            return _miss(b)
        sims = queries @ store.emb.T                      # (B, n_slots)
        sims[:, ~store.occ] = -np.inf
        idx = np.argmax(sims, axis=1)
        return (store.cid[idx].copy(),
                sims[np.arange(b), idx].astype(np.float64))

    def _top1_batch_quantized(self, store: ResidentStore, queries: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """int8-gemm candidate scan over the host mirror + fp32 rescore.
        Scans slots up to the high-water mark (free rows are zeros — a
        certified free-row winner means every real score was negative,
        the same miss decision the masked exact scan makes)."""
        b = queries.shape[0]
        hwm, dim = store.hwm, store.emb.shape[1]
        qm = self._qhost.sync(store.version, store.dirty_since, store.emb)
        q8, qs, ql1 = quantize_rows_int8(queries)
        scores = (int8_scores(q8, qm.q8[:hwm])
                  * qs[:, None]) * qm.scale[None, :hwm]
        vals, order = _sorted_topk(scores, min(self.quantized.k, hwm))
        eps = scan_margin(qs, ql1, qm.scale, qm.l1, dim)
        cids, sims, n_fb, n_union = resolve_topk(
            vals, order, eps, self.quantized.k >= hwm,
            self.quantized.tau_hit,
            lambda rows: self.top1_rows(store, queries, rows),
            lambda sel: self._top1_batch_exact(store, queries[sel]))
        account_scan(self.quant_stats, n_valid=hwm, dim=dim, batch=b,
                     n_union=n_union, n_fallback=n_fb)
        return cids, sims

    def _top1_batch_pruned(self, store: ResidentStore, queries: np.ndarray
                           ) -> Optional[tuple]:
        """Topic-pruned two-stage scan, host oracle: host routing matmul,
        gathered-rows candidate scans (int8 when ``quantized`` is also
        set), and the shared certify-or-fallback driver.  Returns ``None``
        when the routing surface isn't wired for this store (table-less
        policies, foreign stores) so the caller falls through to the
        quantized/exact paths."""
        table = self.route_table
        if table is None or store is not self.route_store:
            return None
        dim = store.emb.shape[1]
        probes = self.pruned.probes

        if self.quantized is not None:
            scan = self._make_pruned_q8_scan_host(store, queries)
        else:
            def scan(sel, rows):
                c, s = self.top1_rows(store, queries[sel], rows)
                return c, s, rows.size * dim * 4

        return pruned_top1_batch(
            store, table, queries, self.pruned, self._pidx,
            self.prune_stats,
            route_fn=lambda qs, aug, nt: route_topics_host(qs, aug, nt,
                                                           probes),
            scan_fn=scan,
            exact_fn=lambda sel: self._top1_batch_exact(store, queries[sel]))

    def _make_pruned_q8_scan_host(self, store: ResidentStore,
                                  queries: np.ndarray):
        """Stage-2 scan composing ``quantized_lookup``: the gathered
        candidate block is scanned over the int8 host mirror and certified
        by the inner ``resolve_topk`` predicate *within the candidate
        set* (its fallback leg re-scans only the candidates — outer
        certification against unprobed topics still happens in the pruned
        driver).  Gathered int8 + rescore bytes land in the prune ledger;
        the quant ledger is untouched on this path."""
        dim = store.emb.shape[1]
        qm = self._qhost.sync(store.version, store.dirty_since, store.emb)
        k_cfg = self.quantized.k
        tau = self.quantized.tau_hit

        def scan(sel, rows):
            qs_q = queries[sel]
            q8, qsc, ql1 = quantize_rows_int8(qs_q)
            scores = (int8_scores(q8, qm.q8[rows])
                      * qsc[:, None]) * qm.scale[rows][None, :]
            vals, order = _sorted_topk(scores, min(k_cfg, rows.size))
            eps = scan_margin(qsc, ql1, qm.scale[rows], qm.l1[rows], dim)
            # local shortlist indices are ascending positions into the
            # ascending ``rows``, so the rescore keeps the lower-slot tie
            # contract within the candidate set
            cids, sims, n_fb, n_union = resolve_topk(
                vals, order, eps, k_cfg >= rows.size, tau,
                lambda lr: self.top1_rows(store, qs_q, rows[lr]),
                lambda ss: self.top1_rows(store, qs_q[ss], rows))
            nbytes = (rows.size * (dim + 4) + n_union * dim * 4
                      + (rows.size * dim * 4 if n_fb else 0))
            return cids, sims, nbytes

        return scan

    def top1_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        sims = queries @ store.emb[rows].T                # (B, len(rows))
        best = np.argmax(sims, axis=1)
        b = np.arange(queries.shape[0])
        return (store.cid[rows[best]].copy(),
                sims[b, best].astype(np.float64))

    def topk_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray, k: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        b = queries.shape[0]
        cids = np.full((b, k), -1, dtype=np.int64)
        sims = np.full((b, k), -np.inf, dtype=np.float64)
        if rows.size == 0:
            return cids, sims
        vals, order = _sorted_topk(queries @ store.emb[rows].T, k)
        kk = order.shape[1]
        cids[:, :kk] = store.cid[rows[order]]
        sims[:, :kk] = vals
        return cids, sims

    def top1_multi(self, arena, queries: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Host stacked pass: ONE (B, P*S) gemm scores the chunk against
        every policy's slab.  Free slots hold zero embeddings, so instead
        of masking, a zero row that wins maps to cid -1 → ``-inf`` — the
        same *decision* the masked per-view scan makes (a zero can only
        win when every real similarity is negative, far below any sensible
        ``tau_hit``); gate-adjacent outcomes are re-scored by the
        reference engine via the arena's epsilon flags."""
        queries = np.asarray(queries, dtype=np.float32)
        if self.pruned is not None:
            out = self._top1_multi_pruned(arena, queries)
            if out is not None:
                return out
        if self.quantized is not None:
            return self._top1_multi_quantized(arena, queries)
        b = queries.shape[0]
        n_pol, n_slots = arena.occ.shape
        flat = arena.emb.reshape(n_pol * n_slots, -1)
        sims3 = (queries @ flat.T).reshape(b, n_pol, n_slots)
        idx = sims3.argmax(axis=2)                        # (B, P)
        vals = np.take_along_axis(sims3, idx[:, :, None],
                                  axis=2)[:, :, 0]        # (B, P)
        cids = arena.cid[np.arange(n_pol)[None, :], idx].T.copy()
        sims = np.where(cids >= 0, vals.T.astype(np.float64), -np.inf)
        return cids, sims

    def _top1_multi_quantized(self, arena, queries: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Stacked host oracle of the quantized arena scan: one int8 gemm
        over the flat (P*S, D) mirror, then the shared per-policy
        rescore/certify driver against each policy's store view."""
        if not arena.track_rows:
            raise ValueError("quantized top1_multi needs an ArenaStore "
                             "built with track_rows=True")
        b = queries.shape[0]
        n_pol, n_slots = arena.occ.shape
        dim = arena.emb.shape[-1]
        qm = self._qhost_arena.sync(
            arena.version, arena.dirty_since,
            arena.emb.reshape(n_pol * n_slots, dim))
        q8, qs, ql1 = quantize_rows_int8(queries)
        scores3 = ((int8_scores(q8, qm.q8)
                    * qs[:, None]) * qm.scale[None, :]
                   ).reshape(b, n_pol, n_slots)
        scale2 = qm.scale.reshape(n_pol, n_slots)
        l12 = qm.l1.reshape(n_pol, n_slots)
        hwms = arena.hwms()
        k_cfg = self.quantized.k
        out_c = np.full((n_pol, b), -1, dtype=np.int64)
        out_s = np.full((n_pol, b), -np.inf)
        for p in range(n_pol):
            hw = int(hwms[p])
            if hw == 0:
                continue
            vals, order = _sorted_topk(scores3[:, p, :hw], min(k_cfg, hw))
            eps = scan_margin(qs, ql1, scale2[p], l12[p], dim)
            view = arena.views[p]
            cids, sims, n_fb, n_union = resolve_topk(
                vals, order, eps, k_cfg >= hw, self.quantized.tau_hit,
                lambda rows, v=view: self.top1_rows(v, queries, rows),
                lambda sel, v=view: self._top1_batch_exact(v, queries[sel]))
            account_scan(self.quant_stats, n_valid=hw, dim=dim, batch=b,
                         n_union=n_union, n_fallback=n_fb)
            out_c[p], out_s[p] = cids, sims
        return out_c, out_s

    def _top1_multi_pruned(self, arena, queries: np.ndarray
                           ) -> Optional[tuple]:
        """Per-policy pruned pass over the arena's store views: each
        table-backed policy runs the two-stage driver against its own
        :class:`TopicBucketIndex`; table-less policies take a per-view
        exact scan (same per-row dots as the stacked gemm).  Returns
        ``None`` when ``run_arena`` didn't wire ``route_tables``."""
        tables = getattr(self, "route_tables", None)
        if tables is None:
            return None
        if not arena.track_rows:
            raise ValueError("pruned top1_multi needs an ArenaStore "
                             "built with track_rows=True")
        b = queries.shape[0]
        n_pol = arena.occ.shape[0]
        dim = arena.emb.shape[-1]
        probes = self.pruned.probes
        out_c = np.full((n_pol, b), -1, dtype=np.int64)
        out_s = np.full((n_pol, b), -np.inf)
        for p in range(n_pol):
            view = arena.views[p]
            if not view.slot_of:
                continue
            table = tables[p] if p < len(tables) else None
            if table is None:
                cids, sims = self._top1_batch_exact(view, queries)
            else:
                idx = self._pidx_arena.setdefault(p, TopicBucketIndex())
                cids, sims = pruned_top1_batch(
                    view, table, queries, self.pruned, idx,
                    self.prune_stats,
                    route_fn=lambda qs, aug, nt: route_topics_host(
                        qs, aug, nt, probes),
                    scan_fn=lambda sel, rows, v=view: (
                        *self.top1_rows(v, queries[sel], rows),
                        rows.size * dim * 4),
                    exact_fn=lambda sel, v=view: self._top1_batch_exact(
                        v, queries[sel]))
            out_c[p], out_s[p] = cids, sims
        return out_c, out_s

    def rac_value(self, tsi, tids, tp_last, t_last, alpha, t_now):
        decay = 0.5 ** (alpha * (t_now - t_last[tids]))
        return decay * tp_last[tids] * tsi

    def rac_value_masked(self, tsi, tids, tp_last, t_last, alpha, t_now,
                         valid):
        vals = self.rac_value(tsi, tids, tp_last, t_last, alpha, t_now)
        return np.where(np.asarray(valid, dtype=bool), vals, np.inf)

    def decide_batch(self, store, table, queries, *, alpha=0.0, t_now=0):
        """Host oracle of the fused decision pass (see the protocol)."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        hit_cid, hit_sim = self.top1_batch(store, queries)
        route_tid = np.full(b, -1, dtype=np.int64)
        route_sim = np.full(b, -np.inf, dtype=np.float64)
        victim = None
        if table is not None:
            k = table.topic_hwm
            live_tids = np.flatnonzero(table.rep_valid[:k])
            if live_tids.size:
                # score live topics only: tids are never recycled, so the
                # dense table is mostly retired rows — the gather keeps the
                # host oracle O(live topics), with identical decisions (a
                # retired row could never win a gated route anyway)
                sims = queries @ table.rep[live_tids].T      # (B, live)
                best = np.argmax(sims, axis=1)
                route_sim = sims[np.arange(b), best].astype(np.float64)
                route_tid = live_tids[best].astype(np.int64)
            victim = self.rac_value_masked(
                table.tsi, np.maximum(table.topic_of, 0), table.tp_last,
                table.t_last, alpha, t_now, store.occ)
        return DecisionBatch(hit_cid, hit_sim, route_tid, route_sim, victim)


class KernelBackend:
    """Device path: batched Top-1 via the ``sim_top1`` CUDA kernel, the
    fused decision pass via ``ops.fused_decide``, eviction scoring via the
    ``rac_value`` kernel, and the approximate lookups on the ``sim_topk`` /
    ``sim_topk_q8`` kernels.

    ``device="cuda"`` (the default) needs a card and raises without one;
    ``device="cpu"`` runs every kernel wrapper's plain PyTorch version.

    The whole scoring state is device-resident: :class:`_DeviceMirror`\\ s
    hold the embedding slab + occupancy (synced against the store's
    mutation journal), the policy table's slot slabs (tsi/topic, its slot
    journal), its topic tables (TP state + representatives, its topic
    journal), and for the approximate lookups the int8 slab mirror, the
    (T, D+1) routing matrix and the topic-bucket CSR.  Steady-state replay
    therefore moves O(mutated rows) per chunk, not O(capacity), and every
    scan — full slab, gathered candidates, rescored union — reads its rows
    from a mirror instead of uploading them.

    The multi-policy arena mirrors its stacked slab as one flat (P*S, D)
    tensor (fp32, and int8 for the quantized arena) against the arena's
    flat journal; ``top1_multi`` scores a chunk against all P slabs with
    one policy-stacked kernel launch, and single-store calls on an arena
    view (the flagged rescans, the rescore legs) read the view's rows of
    that same mirror.
    """

    name = "kernel"

    def __init__(self, device: str = "cuda", quantized=None, pruned=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"KernelBackend(device={device!r}): no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self.quantized = as_quantized_config(quantized)
        self.quant_stats = new_quant_stats()
        # topic-pruned two-stage scan: the facade wires route_table and
        # route_store when the acting policy exposes a PolicyTable
        self.pruned = as_pruned_config(pruned)
        self.prune_stats = new_prune_stats()
        self._pidx = TopicBucketIndex()
        # run_arena wires route_tables (one per policy) and each policy
        # gets its own bucket index
        self._pidx_arena: dict[int, TopicBucketIndex] = {}
        self.route_table = None
        self.route_store = None
        dev = self.device
        self._store_mirror = _DeviceMirror({"emb": np.float32,
                                            "occ": np.int32}, dev)
        self._slot_mirror = _DeviceMirror({"tsi": np.float32,
                                           "tid": np.int32}, dev)
        self._topic_mirror = _DeviceMirror({"rep": np.float32,
                                            "tp": np.float32,
                                            "tl": np.int32}, dev)
        # the (T, D+1) augmented routing matrix [rep | spread], mirrored
        # against the bucket index's own journal
        self._route_mirror = _DeviceMirror({"aug": np.float32}, dev,
                                           row_align=4)
        # host int8 requantizer + its device mirror, keyed on the store's
        # journal like the fp32 slab
        self._qhost = QuantizedSlabMirror()
        self._q8_mirror = _DeviceMirror({"q8": np.int8, "scale": np.float32,
                                         "l1": np.float32}, dev)
        # fused pipeline: device CSR copy of the topic-bucket index, keyed
        # on the index's (store, table) journal triple — NOT its aug
        # version (unassigned-only churn doesn't move the aug journal)
        self._csr_mirror = _DeviceMirror({"indptr": np.int32,
                                          "slots": np.int32}, dev)
        # the arena's stacked slab, flat (P*S, D), synced against its flat
        # journal; its int8 twin for the quantized arena; per-policy CSR
        # and routing-matrix mirrors for the pruned arena
        self._arena_mirror = _DeviceMirror({"emb": np.float32}, dev)
        self._qhost_arena = QuantizedSlabMirror()
        self._q8_arena_mirror = _DeviceMirror({"q8": np.int8,
                                               "scale": np.float32,
                                               "l1": np.float32}, dev)
        self._csr_arena: dict[int, _DeviceMirror] = {}
        self._route_arena: dict[int, _DeviceMirror] = {}
        self._tracker = None                # telemetry sink (observation-only)
        self._sync_seen: dict[str, int] = {}   # last sync_stats flushed to it

    def __deepcopy__(self, memo):
        # a checkpoint must not copy the device mirrors: they are keyed by
        # journal versions, so sharing them with a restored store is safe
        return self

    def set_tracker(self, tracker) -> None:
        """Attach a :class:`repro_torch.telemetry.Tracker` child; the
        backend emits ``sync.*`` counter deltas after each fused decision
        pass.  Strictly observation-only — decisions are unaffected."""
        self._tracker = tracker

    def _flush_sync(self) -> None:
        """Emit the since-last-flush delta of ``sync_stats`` as counters."""
        trk = self._tracker
        if trk is None:
            return
        stats = self.sync_stats
        for k, v in stats.items():
            d = v - self._sync_seen.get(k, 0)
            if d:
                trk.count(f"sync.{k}", d)
        self._sync_seen = stats

    @property
    def sync_stats(self) -> dict:
        """Aggregate mirror observability: full uploads vs dirty-row
        copies, total rows copied, and host→device bytes moved."""
        mirrors = (self._store_mirror, self._slot_mirror, self._topic_mirror,
                   self._route_mirror, self._q8_mirror, self._csr_mirror,
                   self._arena_mirror, self._q8_arena_mirror,
                   *self._csr_arena.values(), *self._route_arena.values())
        return {k: sum(m.stats[k] for m in mirrors)
                for k in ("full", "incremental", "rows", "bytes")}

    @property
    def dispatch_stats(self) -> dict:
        """Launch/transfer observability: dispatches issued, blocking
        device→host syncs, and seconds spent inside timed kernel intervals.
        Process-global — consumers read deltas."""
        return dict(ops.dispatch_stats)

    @staticmethod
    def _arena_rows(store):
        """``(arena, rows)`` when ``store`` is a view of a row-tracked
        arena — its rows are then read from the arena's mirrors, so the
        P views never fight over the single-store mirror — else None."""
        arena = getattr(store, "_arena", None)
        if arena is None or not arena.track_rows:
            return None
        n = arena.n_slots
        return arena, slice(store._p * n, (store._p + 1) * n)

    def _arena_flat(self, arena) -> torch.Tensor:
        """The arena's flat (P*S, D) slab on the device, freshened by
        dirty-row copies against the arena's flat journal."""
        n_pol, n_slots, dim = arena.emb.shape
        return self._arena_mirror.sync(
            arena.version, arena.dirty_since,
            lambda: {"emb": arena.emb.reshape(n_pol * n_slots, dim)})["emb"]

    def _arena_q8(self, arena):
        """The arena's flat host int8 mirror and its device copy."""
        n_pol, n_slots, dim = arena.emb.shape
        qm = self._qhost_arena.sync(arena.version, arena.dirty_since,
                                    arena.emb.reshape(n_pol * n_slots, dim))
        dev = self._q8_arena_mirror.sync(
            arena.version, arena.dirty_since,
            lambda: {"q8": qm.q8, "scale": qm.scale, "l1": qm.l1})
        return qm, dev

    def _slab(self, store: ResidentStore) -> dict:
        view = self._arena_rows(store)
        if view is not None:
            arena, rows = view
            return {"emb": self._arena_flat(arena)[rows]}
        return self._store_mirror.sync(
            store.version, store.dirty_since,
            lambda: {"emb": store.emb, "occ": store.occ})

    def _q8(self, store: ResidentStore):
        """The host int8 mirror and its device copy, both freshened."""
        view = self._arena_rows(store)
        if view is not None:
            arena, rows = view
            qm, dev = self._arena_q8(arena)
            return (SimpleNamespace(q8=qm.q8[rows], scale=qm.scale[rows],
                                    l1=qm.l1[rows]),
                    {k: v[rows] for k, v in dev.items()})
        qm = self._qhost.sync(store.version, store.dirty_since, store.emb)
        dev = self._q8_mirror.sync(
            store.version, store.dirty_since,
            lambda: {"q8": qm.q8, "scale": qm.scale, "l1": qm.l1})
        return qm, dev

    def _tensor(self, x, dtype) -> torch.Tensor:
        """Host array ``x`` as a contiguous ``dtype`` tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
            self.device)

    def top1(self, store: ResidentStore, query: np.ndarray) -> tuple[int, float]:
        cids, sims = self.top1_batch(store, np.asarray(query)[None, :])
        return int(cids[0]), float(sims[0])

    def top1_batch(self, store: ResidentStore,
                   queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        if not store.slot_of:
            return _miss(queries.shape[0])
        if self.pruned is not None:
            out = self._top1_batch_pruned(store, queries)
            if out is not None:
                return out
        if self.quantized is not None:
            return self._top1_batch_quantized(store, queries)
        return self._top1_batch_exact(store, queries)

    def _top1_batch_exact(self, store: ResidentStore,
                          queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if not store.slot_of:
            return _miss(queries.shape[0])
        slab = self._slab(store)
        qd = self._tensor(queries, np.float32)
        # runtime n_valid = the store's high-water mark: slots past it have
        # never been occupied, so the kernel skips scoring the free tail
        with annotate("rac/sim_top1"):
            vals, idx = ops.run_timed(
                lambda: ops.sim_top1(qd, slab["emb"], n_valid=store.hwm),
                self._tracker, "sim_top1")
        vals, idx = ops.to_host_tuple((vals, idx))
        cids = store.cid[idx].copy()
        # a free (zeroed) slot can only win when all real sims < 0 → miss
        sims = np.where(cids >= 0, vals.astype(np.float64), -np.inf)
        self._flush_sync()
        return cids, sims

    def _top1_batch_quantized(self, store: ResidentStore,
                              queries: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Quantized candidate scan: the card streams the int8 mirror (4×
        fewer slab bytes) through ``sim_topk_q8``, then the ≤k survivors
        are rescored in fp32 by :meth:`top1_rows` — the same
        restricted-scan engine the admission rescans trust — and certified
        by the shared safety predicate (exact full scan on failure)."""
        b, dim = queries.shape
        qm, dev = self._q8(store)
        if self.quantized.fused and b <= self.quantized.fused_max_batch:
            return self._top1_batch_quantized_fused(store, queries, dev)
        q8, qs, ql1 = quantize_rows_int8(queries)
        k = self.quantized.k
        with annotate("rac/sim_topk_q8"):
            vals, idx = ops.run_timed(
                lambda: ops.sim_topk_q8(
                    self._tensor(q8, np.int8), self._tensor(qs, np.float32),
                    dev["q8"], dev["scale"], k, n_valid=store.hwm),
                self._tracker, "sim_topk_q8")
        vals, rows = ops.to_host_tuple((vals, idx))
        eps = scan_margin(qs, ql1, qm.scale, qm.l1, dim)
        cids, sims, n_fb, n_union = resolve_topk(
            vals.astype(np.float64), rows, eps, k >= store.hwm,
            self.quantized.tau_hit,
            lambda r: self.top1_rows(store, queries, r),
            lambda sel: self._top1_batch_exact(store, queries[sel]))
        account_scan(self.quant_stats, n_valid=store.hwm, dim=dim, batch=b,
                     n_union=n_union, n_fallback=n_fb)
        self._flush_sync()
        return cids, sims

    def _top1_batch_pruned(self, store: ResidentStore, queries: np.ndarray
                           ) -> Optional[tuple]:
        """Topic-pruned two-stage scan: stage 1 routes over the mirrored
        (T, D+1) augmented representative matrix (``ops.route_topics``,
        T ≪ S), stage 2 scans only the probed buckets' rows, gathered on
        the card (int8 when ``quantized`` is also set), and the shared
        driver certifies each decision against the unprobed-topic bound —
        uncertifiable queries take an exact full-scan fallback.  Returns
        ``None`` when the routing surface isn't wired for this store
        (table-less policies, foreign stores) so the caller falls through
        to the quantized/exact paths."""
        table = self.route_table
        if table is None or store is not self.route_store:
            return None
        cfg = self.pruned
        idx = self._pidx
        dim = store.emb.shape[1]

        if cfg.fused and queries.shape[0] <= cfg.fused_max_batch \
                and cfg.probes >= 1 and table.rep.shape[0] >= 1 \
                and store.hwm > 0:
            idx.sync(store, table)
            out = self._fused_pruned_batch(store, table, queries, cfg, idx)
            self._flush_sync()
            return out

        def route(qs, aug, n_top):
            # the driver synced ``idx`` already; freshen the device copy
            # of the aug matrix against the index's own journal
            dev = self._route_mirror.sync(idx.version, idx.dirty_since,
                                          lambda: {"aug": idx.aug})
            with annotate("rac/route_topics"):
                vals, tids = ops.run_timed(
                    lambda: ops.route_topics(
                        self._tensor(qs, np.float32), dev["aug"],
                        cfg.probes, n_valid=n_top),
                    self._tracker, "route_topics")
            return ops.to_host_tuple((vals, tids))

        if self.quantized is not None:
            scan = self._make_pruned_q8_scan(store, queries)
        else:
            def scan(sel, rows):
                c, s = self.top1_rows(store, queries[sel], rows)
                return c, s, rows.size * dim * 4

        out = pruned_top1_batch(
            store, table, queries, cfg, idx, self.prune_stats,
            route_fn=route, scan_fn=scan,
            exact_fn=lambda sel: self._top1_batch_exact(store, queries[sel]))
        self._flush_sync()
        return out

    def _top1_batch_quantized_fused(self, store: ResidentStore,
                                    queries: np.ndarray, dev
                                    ) -> tuple[np.ndarray, np.ndarray]:
        """Fused quantized lookup (:mod:`repro_torch.kernels.fused`): the
        int8 Top-K, the fp32 union rescore and the ``resolve_topk`` safety
        arms run on the card with one host sync; the host maps winner
        slots to cids and exact-rescans only the uncertified rows."""
        b, dim = queries.shape
        cfg = self.quantized
        slab = self._slab(store)
        # pow2 bucket, floor 1 (serving is b=1)
        qp, q8q, qsc, ql1 = (
            self._tensor(x, x.dtype)
            for x in fused.prep_queries(queries, fused.pad_pow2(b, 1)))
        n_slots = store.emb.shape[0]
        with annotate("rac/fused_quant"):
            out = ops.run_timed(
                lambda: fused.fused_quant_lookup(
                    qp, q8q, qsc, ql1, slab["emb"], dev["q8"], dev["scale"],
                    dev["l1"], store.hwm, b, cfg.tau_hit,
                    k=min(int(cfg.k), n_slots)),
                self._tracker, "fused_quant")
        win, rmax, cert, n_u = ops.to_host_tuple(out)
        cids, sims, n_fb = self._fused_results(
            win[:b], rmax[:b], cert[:b], store.cid, n_slots,
            lambda sel: self._top1_batch_exact(store, queries[sel]))
        account_scan(self.quant_stats, n_valid=store.hwm, dim=dim, batch=b,
                     n_union=int(n_u.reshape(-1)[0]), n_fallback=n_fb)
        self._flush_sync()
        return cids, sims

    @staticmethod
    def _fused_results(win, rmax, cert, cid_arr, n_slots: int, exact_fn,
                       slot_off: int = 0):
        """Map a fused call's winner rows to cids and exact-rescan the
        uncertified rows; returns ``(cids, sims, n_fallback)``.  A winner
        is row ``slot_off + slot`` of the scanned slab (``slot_off`` > 0
        for an arena view inside the flat (P*S, D) slab); anything outside
        the view's ``n_slots`` — the sentinel past the slab's last row —
        had no finite score."""
        local = win.astype(np.int64) - slot_off
        ok = (local >= 0) & (local < n_slots)
        cids = np.where(ok, cid_arr[np.clip(local, 0, n_slots - 1)], -1)
        sims = np.where(cids >= 0, rmax.astype(np.float64), -np.inf)
        certm = cert.astype(bool)
        n_fb = int(certm.size - np.count_nonzero(certm))
        if n_fb:
            sel = np.flatnonzero(~certm)
            f_c, f_s = exact_fn(sel)
            cids[sel] = np.asarray(f_c, dtype=np.int64)
            sims[sel] = np.asarray(f_s, dtype=np.float64)
        fused.fused_stats["fallback_rows"] += n_fb
        return cids, sims, n_fb

    def _fused_pruned_batch(self, store: ResidentStore, table: PolicyTable,
                            queries: np.ndarray, cfg, idx):
        """Mirror-freshening wrapper of :meth:`_fused_pruned_call` (``idx``
        must already be synced).  The int8 mirror is maintained even
        without a composed quantized config — the fused candidate scan is
        always int8."""
        _, q8d = self._q8(store)
        augd = self._route_mirror.sync(idx.version, idx.dirty_since,
                                       lambda: {"aug": idx.aug})
        return self._fused_pruned_call(
            store, table, queries, cfg, idx, emb_dev=self._slab(store)["emb"],
            q8_dev=q8d, aug_dev=augd["aug"], csr_mirror=self._csr_mirror,
            slot_off=0, n_slots=store.emb.shape[0], cid_arr=store.cid,
            exact_fn=lambda sel: self._top1_batch_exact(store,
                                                        queries[sel]),
            stats=self.prune_stats)

    def _fused_pruned_call(self, store, table, queries: np.ndarray, cfg,
                           idx, *, emb_dev, q8_dev, aug_dev, csr_mirror,
                           slot_off: int, n_slots: int, cid_arr, exact_fn,
                           stats: dict):
        """Shared fused-pruned driver (single stores and arena views):
        prep the static shape buckets, make ONE fused call covering
        routing → probe cap → CSR gather → int8 scan → fp32 union rescore
        → safety predicates with one host sync, then map winners/fallbacks
        and ledger on the host.  ``slot_off`` shifts the CSR slot ids into
        the flat (P*S, D) arena slab that ``emb_dev``/``q8_dev`` hold;
        ``n_slots`` is the per-view slot count winners map back into (the
        sentinel row lands outside it)."""
        b, dim = queries.shape
        probes = int(cfg.probes)
        indptr_h, slot_ids, unassigned = idx.csr()
        t_rows = idx.aug.shape[0]
        budget = 1 << 30                           # uncapped
        if cfg.max_scan_frac is not None:
            budget = max(int(cfg.min_scan_rows),
                         int(cfg.max_scan_frac * store.hwm))
        cap_c = fused.candidate_cap(np.diff(indptr_h), unassigned.size,
                                    probes, budget)
        csr = csr_mirror.sync(
            (idx.key, t_rows, slot_off), lambda v: None,
            lambda: dict(zip(("indptr", "slots"), fused.csr_device_arrays(
                indptr_h, slot_ids + slot_off, unassigned + slot_off,
                t_rows))))
        # pow2 bucket, floor 1: every padded row pays a full cap_c-row
        # gather, and the serving path is b=1
        qp, q8q, qsc, ql1 = (
            self._tensor(x, x.dtype)
            for x in fused.prep_queries(queries, fused.pad_pow2(b, 1)))
        k = (int(self.quantized.k) if self.quantized is not None
             else fused.DEFAULT_K)
        with annotate("rac/fused_pruned"):
            out = ops.run_timed(
                lambda: fused.fused_pruned_lookup(
                    qp, q8q, qsc, ql1, emb_dev, q8_dev["q8"],
                    q8_dev["scale"], q8_dev["l1"], aug_dev, csr["indptr"],
                    csr["slots"], int(table.topic_hwm), budget, b,
                    cfg.tau_hit, probes=probes, cap_c=cap_c, k=k),
                self._tracker, "fused_pruned")
        win, rmax, ub, cert, total, probed, capped, n_u = \
            ops.to_host_tuple(out)
        cids, sims, n_fb = self._fused_results(
            win[:b], rmax[:b], cert[:b], cid_arr, n_slots, exact_fn,
            slot_off)
        tot = int(total[:b].sum())
        ncap = int(capped[:b].sum())
        # gathered int8 candidate bytes (codes + scale + l1) + the fp32
        # union-rescore gather
        slab_bytes = tot * (dim + 8) + int(n_u.reshape(-1)[0]) * dim * 4
        account_prune(stats, n_valid=int(store.hwm), dim=dim,
                      n_topics=int(table.topic_hwm), batch=b,
                      probes=int(probed[:b].sum()), scanned_rows=tot,
                      slab_bytes=slab_bytes, n_fallback=n_fb,
                      n_capped=ncap)
        fused.fused_stats["capped_rows"] += ncap
        return cids, sims

    def _make_pruned_q8_scan(self, store: ResidentStore,
                             queries: np.ndarray):
        """Stage-2 scan composing ``quantized_lookup``: the gathered
        candidate block (int8 rows and scales gathered on the card from the
        mirror) is scanned through ``sim_topk_q8`` and certified by the
        inner ``resolve_topk`` predicate *within the candidate set* (its
        fallback leg re-scans only the candidates — outer certification
        against unprobed topics still happens in the pruned driver).
        Gathered int8 + rescore bytes land in the prune ledger; the quant
        ledger is untouched on this path."""
        dim = store.emb.shape[1]
        qm, dev = self._q8(store)
        k_cfg = self.quantized.k
        tau = self.quantized.tau_hit

        def scan(sel, rows):
            qs_q = queries[sel]
            q8, qsc, ql1 = quantize_rows_int8(qs_q)
            n = rows.size
            rows_d = self._tensor(rows, np.int64)
            with annotate("rac/sim_topk_q8_pruned"):
                vals, idx = ops.run_timed(
                    lambda: ops.sim_topk_q8(
                        self._tensor(q8, np.int8),
                        self._tensor(qsc, np.float32),
                        dev["q8"].index_select(0, rows_d),
                        dev["scale"].index_select(0, rows_d),
                        min(k_cfg, n), n_valid=n),
                    self._tracker, "sim_topk_q8")
            vals, lrows = ops.to_host_tuple((vals, idx))
            eps = scan_margin(qsc, ql1, qm.scale[rows], qm.l1[rows], dim)
            # local shortlist indices are ascending positions into the
            # ascending ``rows``, so the rescore keeps the lower-slot tie
            # contract within the candidate set
            cids, sims, n_fb, n_union = resolve_topk(
                vals.astype(np.float64), lrows, eps, k_cfg >= n, tau,
                lambda lr: self.top1_rows(store, qs_q, rows[lr]),
                lambda ss: self.top1_rows(store, qs_q[ss], rows))
            nbytes = (n * (dim + 4) + n_union * dim * 4
                      + (n * dim * 4 if n_fb else 0))
            return cids, sims, nbytes

        return scan

    def _gathered(self, store: ResidentStore, rows: np.ndarray):
        """The slab rows ``rows``, gathered on the card from the mirror."""
        return self._slab(store)["emb"].index_select(
            0, self._tensor(rows, np.int64))

    def top1_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        vals, idx = ops.sim_top1(self._tensor(queries, np.float32),
                                 self._gathered(store, rows),
                                 n_valid=rows.shape[0])
        vals, idx = ops.to_host_tuple((vals, idx))
        return store.cid[rows[idx]].copy(), vals.astype(np.float64)

    def topk_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray, k: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        b, n = queries.shape[0], rows.shape[0]
        out_c = np.full((b, k), -1, dtype=np.int64)
        out_s = np.full((b, k), -np.inf, dtype=np.float64)
        if n == 0:
            return out_c, out_s
        # ranks past the restriction size stay (-1, -inf)
        kk = min(k, n)
        vals, idx = ops.sim_topk(self._tensor(queries, np.float32),
                                 self._gathered(store, rows), kk, n_valid=n)
        vals, idx = ops.to_host_tuple((vals, idx))
        finite = np.isfinite(vals)
        out_c[:, :kk] = np.where(
            finite, store.cid[rows[np.minimum(idx, n - 1)]], -1)
        out_s[:, :kk] = np.where(finite, vals, -np.inf)
        return out_c, out_s

    def top1_multi(self, arena, queries: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Stacked device pass: ONE ``sim_top1_multi`` launch scores the
        query chunk against all P policy slabs, each masked to its own
        high-water mark (a (P,) count the kernel reads on the card).  The
        flat (P*S, D) slab is mirrored against the arena's flat journal
        (dirty-row copies), so steady-state chunks move O(mutations) rows
        for the whole arena."""
        if not arena.track_rows:
            # host-only arenas skip journaling entirely; a version-keyed
            # mirror would silently serve stale rows
            raise ValueError("KernelBackend.top1_multi needs an ArenaStore "
                             "built with track_rows=True")
        queries = np.asarray(queries, dtype=np.float32)
        n_pol, n_slots, dim = arena.emb.shape
        # an empty arena launches too (every count is 0, so each row comes
        # back as a miss): one stacked launch per chunk, always
        if self.pruned is not None:
            out = self._top1_multi_pruned(arena, queries)
            if out is not None:
                return out
        if self.quantized is not None:
            return self._top1_multi_quantized(arena, queries)
        flat = self._arena_flat(arena)
        qd = self._tensor(queries, np.float32)
        with annotate("rac/sim_top1_multi"):
            vals, idx = ops.run_timed(
                lambda: ops.sim_top1_multi(
                    qd, flat.view(n_pol, n_slots, dim),
                    n_valid=self._tensor(arena.hwms(), np.int32)),
                self._tracker, "sim_top1_multi")
        vals, idx = ops.to_host_tuple((vals, idx))
        cids = arena.cid[np.arange(n_pol)[:, None], idx].copy()
        # a free (zeroed) slot can only win when all real sims < 0 → miss
        sims = np.where(cids >= 0, vals.astype(np.float64), -np.inf)
        self._flush_sync()
        return cids, sims

    def _top1_multi_quantized(self, arena, queries: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Stacked quantized arena scan: ONE ``sim_topk_q8_multi`` launch
        streams every policy's int8 slab (the 4x byte saving multiplied
        by P), then each policy's survivors are rescored and certified
        against its own store view — per-row kernel-score independence
        makes each policy's shortlist the one its single-slab launch would
        have produced."""
        b = queries.shape[0]
        n_pol, n_slots, dim = arena.emb.shape
        qm, dev = self._arena_q8(arena)
        q8, qs, ql1 = quantize_rows_int8(queries)
        k = self.quantized.k
        hwms = arena.hwms()
        with annotate("rac/sim_topk_q8_multi"):
            vals, idx = ops.run_timed(
                lambda: ops.sim_topk_q8_multi(
                    self._tensor(q8, np.int8), self._tensor(qs, np.float32),
                    dev["q8"].view(n_pol, n_slots, dim),
                    dev["scale"].view(n_pol, n_slots), k,
                    n_valid=self._tensor(hwms, np.int32)),
                self._tracker, "sim_topk_q8_multi")
        vals, rows = ops.to_host_tuple((vals, idx))
        vals = vals.astype(np.float64)
        scale2 = qm.scale.reshape(n_pol, n_slots)
        l12 = qm.l1.reshape(n_pol, n_slots)
        out_c = np.full((n_pol, b), -1, dtype=np.int64)
        out_s = np.full((n_pol, b), -np.inf)
        for p in range(n_pol):
            hw = int(hwms[p])
            if hw == 0:
                continue
            eps = scan_margin(qs, ql1, scale2[p], l12[p], dim)
            view = arena.views[p]
            cids, sims, n_fb, n_union = resolve_topk(
                vals[p], rows[p], eps, k >= hw, self.quantized.tau_hit,
                lambda r, v=view: self.top1_rows(v, queries, r),
                lambda sel, v=view: self._top1_batch_exact(v, queries[sel]))
            account_scan(self.quant_stats, n_valid=hw, dim=dim, batch=b,
                         n_union=n_union, n_fallback=n_fb)
            out_c[p], out_s[p] = cids, sims
        self._flush_sync()
        return out_c, out_s

    def _top1_multi_pruned(self, arena, queries: np.ndarray
                           ) -> Optional[tuple]:
        """Per-policy pruned pass over the arena's store views: each
        table-backed policy runs the two-stage driver against its own
        :class:`TopicBucketIndex` — fused (one call per policy over the
        flat arena mirrors, its CSR slot ids shifted by ``p*S``) or staged
        — and table-less policies take a per-view exact kernel scan (the
        same per-row dots as the stacked launch).  Returns ``None`` when
        ``run_arena`` didn't wire ``route_tables``."""
        tables = getattr(self, "route_tables", None)
        if tables is None:
            return None
        b = queries.shape[0]
        n_pol, n_slots, dim = arena.emb.shape
        cfg = self.pruned
        fused_on = cfg.fused and cfg.probes >= 1
        if fused_on:
            # one flat (P*S, D) fp32 + int8 mirror pair serves every
            # policy's fused call
            flat = self._arena_flat(arena)
            _, q8d = self._arena_q8(arena)
        out_c = np.full((n_pol, b), -1, dtype=np.int64)
        out_s = np.full((n_pol, b), -np.inf)
        for p in range(n_pol):
            view = arena.views[p]
            if not view.slot_of:
                continue
            table = tables[p] if p < len(tables) else None
            if table is None:
                out_c[p], out_s[p] = self._top1_batch_exact(view, queries)
                continue

            def exact(sel, v=view):
                return self._top1_batch_exact(v, queries[sel])

            idx = self._pidx_arena.setdefault(p, TopicBucketIndex())
            route_m = self._route_arena.setdefault(
                p, _DeviceMirror({"aug": np.float32}, self.device,
                                 row_align=4))

            def aug_dev(idx=idx, route_m=route_m):
                return route_m.sync(idx.version, idx.dirty_since,
                                    lambda: {"aug": idx.aug})["aug"]

            if fused_on and table.rep.shape[0] >= 1 and view.hwm > 0:
                idx.sync(view, table)
                csr_m = self._csr_arena.setdefault(
                    p, _DeviceMirror({"indptr": np.int32,
                                      "slots": np.int32}, self.device))
                cids, sims = self._fused_pruned_call(
                    view, table, queries, cfg, idx, emb_dev=flat,
                    q8_dev=q8d, aug_dev=aug_dev(), csr_mirror=csr_m,
                    slot_off=p * n_slots, n_slots=n_slots, cid_arr=view.cid,
                    exact_fn=exact, stats=self.prune_stats)
            else:
                def route(qs, aug, n_top, aug_dev=aug_dev):
                    with annotate("rac/route_topics"):
                        vals, tids = ops.run_timed(
                            lambda: ops.route_topics(
                                self._tensor(qs, np.float32), aug_dev(),
                                cfg.probes, n_valid=n_top),
                            self._tracker, "route_topics")
                    return ops.to_host_tuple((vals, tids))

                cids, sims = pruned_top1_batch(
                    view, table, queries, cfg, idx, self.prune_stats,
                    route_fn=route,
                    scan_fn=lambda sel, rows, v=view: (
                        *self.top1_rows(v, queries[sel], rows),
                        rows.size * dim * 4),
                    exact_fn=exact)
            out_c[p], out_s[p] = cids, sims
        self._flush_sync()
        return out_c, out_s

    def _value_args(self, tsi, tids, tp_last, t_last, t_now):
        # shift timestamps so t_now is 0: the kernel sees
        # 0 - (t_last - t_now) = t_now - t_last, and the f32 subtraction
        # it inherits from the TPU kernel is exact for ages below 2^24
        return (self._tensor(tsi, np.float32), self._tensor(tids, np.int32),
                self._tensor(tp_last, np.float32),
                self._tensor(t_last - t_now, np.int32))

    def rac_value_masked(self, tsi, tids, tp_last, t_last, alpha, t_now,
                         valid):
        out = ops.rac_value_masked(
            *self._value_args(tsi, tids, tp_last, t_last, t_now),
            self._tensor(valid, bool), float(alpha), 0)
        return np.asarray(ops.to_host(out), dtype=np.float64)

    def rac_value(self, tsi, tids, tp_last, t_last, alpha, t_now):
        out = ops.rac_value(
            *self._value_args(tsi, tids, tp_last, t_last, t_now),
            float(alpha), 0)
        return np.asarray(ops.to_host(out), dtype=np.float64)

    def _table_state(self, table: PolicyTable) -> dict:
        """The mirrored policy-table state, freshened by dirty-row copies."""
        slot = self._slot_mirror.sync(
            table.slot_version, table.dirty_slots_since,
            lambda: {"tsi": table.tsi, "tid": table.topic_of})
        topic = self._topic_mirror.sync(
            table.topic_version, table.dirty_topics_since,
            lambda: {"rep": table.rep, "tp": table.tp_last,
                     "tl": table.t_last})
        return {**slot, **topic}

    def decide_batch(self, store, table, queries, *, alpha=0.0, t_now=0):
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        if table is None:
            hit_cid, hit_sim = self.top1_batch(store, queries)
            return DecisionBatch(hit_cid, hit_sim,
                                 np.full(b, -1, dtype=np.int64),
                                 np.full(b, -np.inf, dtype=np.float64), None)
        if self.quantized is not None or self.pruned is not None:
            return self._decide_batch_split(store, table, queries,
                                            alpha=alpha, t_now=t_now)
        dev = {**self._slab(store), **self._table_state(table)}
        qd = self._tensor(queries, np.float32)
        # ONE fused dispatch: hit Top-1 (runtime n_valid = store hwm) +
        # routing Top-1 (runtime n_topics = topic hwm) + masked Eq.1 victim
        # values with a runtime t_now, then one host sync for all five
        with annotate("rac/fused_decide"):
            out = ops.run_timed(
                lambda: ops.fused_decide(
                    qd, dev["emb"], store.hwm, dev["rep"], table.topic_hwm,
                    dev["tsi"], dev["tid"], dev["occ"], dev["tp"],
                    dev["tl"], t_now, alpha=float(alpha)),
                self._tracker, "fused_decide")
        hv, hi, rv, ri, vv = ops.to_host_tuple(out)
        cids = store.cid[hi].copy()
        # a free (zeroed) slot can only win when all real sims < 0 → miss
        sims = np.where(cids >= 0, hv.astype(np.float64), -np.inf)
        rv = rv.astype(np.float64)
        ri = np.where(np.isfinite(rv), ri.astype(np.int64), -1)
        self._flush_sync()
        return DecisionBatch(cids, sims, ri, rv, vv.astype(np.float64))

    def _decide_batch_split(self, store, table, queries, *, alpha, t_now):
        """Decision pass with the hit leg split off: the hit Top-1 rides
        ``top1_batch`` — the topic-pruned and/or int8 scan, whichever is
        configured, or the sharded backend's per-shard loop — while routing and victim scoring run the same
        ``sim_top1``/``victim_value`` kernels as the exact path's fused
        dispatch (per-leg score independence keeps the decisions
        identical), on the mirrored occupancy."""
        hit_cid, hit_sim = self.top1_batch(store, queries)
        dev = {**self._slab(store), **self._table_state(table)}
        qd = self._tensor(queries, np.float32)
        # ONE auxiliary dispatch (routing Top-1 + victim values together)
        with annotate("rac/decide_aux"):
            out = ops.run_timed(
                lambda: ops.decide_aux(
                    qd, dev["rep"], table.topic_hwm, dev["tsi"], dev["tid"],
                    dev["occ"], dev["tp"], dev["tl"], t_now,
                    alpha=float(alpha)),
                self._tracker, "decide_aux")
        rv, ri, vv = ops.to_host_tuple(out)
        rv = rv.astype(np.float64)
        ri = np.where(np.isfinite(rv), ri.astype(np.int64), -1)
        self._flush_sync()
        return DecisionBatch(hit_cid, hit_sim, ri, rv, vv.astype(np.float64))


def _backends() -> dict:
    from .sharded import ShardedKernelBackend
    return {"numpy": NumpyBackend, "kernel": KernelBackend,
            "sharded": ShardedKernelBackend}


def get_backend(name: str, **kwargs) -> LookupBackend:
    """Instantiate a backend by config name
    (``"numpy"`` | ``"kernel"`` | ``"sharded"``).

    ``kwargs`` are forwarded to the backend constructor *uniformly*;
    unexpected ones raise (a ``TypeError`` from the constructor), they are
    never silently dropped.  An already-built backend instance passes
    through unchanged — constructor kwargs cannot apply to it, so passing
    any alongside an instance raises ``ValueError``."""
    if not isinstance(name, str):
        if not isinstance(name, LookupBackend):
            raise ValueError(f"expected a backend name or LookupBackend "
                             f"instance, got {name!r}")
        if kwargs:
            raise ValueError(f"backend instance {name!r} cannot take "
                             f"constructor kwargs {sorted(kwargs)}")
        return name
    registry = _backends()
    try:
        cls = registry[name]
    except KeyError:
        raise ValueError(f"unknown cache backend {name!r}; "
                         f"expected one of {sorted(registry)}") from None
    return cls(**kwargs)
