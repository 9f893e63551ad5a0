"""Sharded resident store: the semantic cache's slab partitioned by rows.

The counterpart of ``repro/cache/sharded.py``: one controller process holds
the cache; the slab is split row-wise over the cards of the cache mesh
(:func:`repro_torch.launch.mesh.make_cache_mesh`):

  - **Layout** — :class:`ShardedStore` keeps one contiguous ``(S·R, D)``
    slab: shard ``s`` owns rows ``[s·R, (s+1)·R)``.  A new entry goes to
    the least-loaded shard (ties to the lowest), and each shard keeps a
    local high-water mark, the ``n_valid`` its lookups score up to.
  - **Lookup** — :class:`ShardedKernelBackend` launches one B1
    (``ops.sim_top1``) per shard, on that shard's card and its current
    stream, copies each shard's ``(value, local row)`` to the lead card and
    merges them by one max over the shard axis.  Equal maxima go to the
    lowest shard, then (inside B1) to the lowest row: the global slot
    order.  Only the host read of the merged result waits for the cards.
  - **Eviction** — ``rac_value`` cuts the resident table's entry axis into
    one chunk a shard, one B3 each, and hands the stitched values back to
    the policy, whose ``(value, last access, cid)`` lexsort takes the min.
  - **Fallback** — with fewer cards than shards (one card, or the CPU) the
    same per-shard launches and the same merge run as a loop on one
    device, over views of one mirrored slab, so decisions never depend on
    the machine.
  - **Checkpoint/restore** — every sharded field (slab, per-shard free
    lists, loads, high-water marks) lives in the store, so the facade's
    deep copy needs nothing of the backend.  The device slabs are mirrors
    keyed on the store's mutation version (dirty rows copied, a full
    upload past :func:`~repro_torch.cache.backends.small_delta`).

The approximate lookups keep their dense parts on the lead card, as the
reference does: the pruned driver, the row rescans (``top1_rows``,
``topk_rows``) and the fused pipeline are :class:`KernelBackend`'s, with
this backend's sharded scan as their exact fallback; the quantized scan
runs one B5 per shard and merges the shortlists by a stable sort.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.store import ResidentStore
from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_rows_int8, scan_margin
from repro_torch.telemetry.tracing import annotate

from .backends import KernelBackend, _DeviceMirror, _miss, small_delta
from .quantized import account_scan, resolve_topk
from .types import DecisionBatch


class ShardedStore(ResidentStore):
    """Row-partitioned resident slab with least-loaded shard placement.

    ``n_shards`` shards of ``rows_per_shard = ceil((capacity+1)/n_shards)``
    rows each (the +1 is Alg. 1's insert-then-evict spare slot).  The numpy
    arrays are the plain :class:`ResidentStore` layout, so every host-side
    consumer (policies, the numpy backend, metrics) works unchanged — only
    slot *placement* differs.
    """

    def __init__(self, capacity: int, dim: int, n_shards: int = 1):
        n_shards = max(1, int(n_shards))
        rows = -(-(capacity + 1) // n_shards)          # ceil division
        super().__init__(capacity, dim, n_slots=rows * n_shards)
        self.n_shards = n_shards
        self.rows_per_shard = rows
        # per-shard LIFO free lists keep each shard's occupied slots below
        # its local high-water mark; the parent's single free list is
        # cleared so no stale copy rides along in checkpoints
        self._free.clear()
        self._free_by_shard = [list(range((s + 1) * rows - 1, s * rows - 1, -1))
                               for s in range(n_shards)]
        self.load = np.zeros(n_shards, dtype=np.int64)
        self.local_hwm = np.zeros(n_shards, dtype=np.int64)

    def shard_of(self, slot: int) -> int:
        return slot // self.rows_per_shard

    def shard_view(self) -> np.ndarray:
        """The slab as ``(n_shards, rows_per_shard, D)`` (a zero-copy view)."""
        return self.emb.reshape(self.n_shards, self.rows_per_shard, -1)

    def _alloc(self) -> int:
        shard = int(np.argmin(self.load))              # ties → lowest shard
        slot = self._free_by_shard[shard].pop()
        self.load[shard] += 1
        local = slot - shard * self.rows_per_shard
        if local + 1 > self.local_hwm[shard]:
            self.local_hwm[shard] = local + 1
        return slot

    def _release(self, slot: int):
        shard = self.shard_of(slot)
        self._free_by_shard[shard].append(slot)
        self.load[shard] -= 1


class _ShardMirror:
    """Device pieces of journaled host arrays, piece ``s`` on
    ``devices[s]``: the multi-card layout of a sharded slab.  Kept fresh as
    :class:`~repro_torch.cache.backends._DeviceMirror` keeps its one copy:
    the journal's dirty rows are copied into the pieces that hold them
    (``index_copy_`` on each card's stream), and a version the journal
    cannot answer, a delta past :func:`small_delta` of all rows, or a new
    layout uploads every piece again."""

    def __init__(self, dtypes: dict, devices):
        self.dtypes = dtypes
        self.devices = list(devices)
        self.version = self.layout = self.parts = None
        self.stats = {"full": 0, "incremental": 0, "rows": 0, "bytes": 0}

    def sync(self, version, dirty_since, host: dict, layout, piece,
             place) -> list:
        """``host`` holds the arrays whose rows the journal names,
        ``piece(a, s)`` is piece ``s`` of host array ``a`` (2-D pieces are
        copied by rows), ``place(rows)`` gives journal rows' ``(piece, row
        in piece)``, and ``layout`` keys the pieces' shapes."""
        if self.parts is not None and version == self.version \
                and layout == self.layout:
            return self.parts
        n_rows = next(iter(host.values())).shape[0]
        dirty = (dirty_since(self.version)
                 if self.parts is not None and layout == self.layout
                 else None)
        if dirty is not None and small_delta(len(dirty), n_rows):
            if dirty:
                rows = np.fromiter(sorted(dirty), dtype=np.int64,
                                   count=len(dirty))
                shard, local = place(rows)
                for s in np.unique(shard):
                    sel = shard == s
                    dev = self.devices[s]
                    at = torch.from_numpy(local[sel]).to(dev)
                    for k, a in host.items():
                        block = np.ascontiguousarray(a[rows[sel]],
                                                     dtype=self.dtypes[k])
                        self.parts[s][k].index_copy_(
                            0, at, torch.from_numpy(block).to(dev))
                        self.stats["bytes"] += block.nbytes
                self.stats["incremental"] += 1
                self.stats["rows"] += len(dirty)
        else:
            # copies on every device (a CPU piece must not alias the host
            # array, as in _DeviceMirror)
            self.parts = [
                {k: torch.from_numpy(np.ascontiguousarray(
                    piece(a, s), dtype=self.dtypes[k])).to(dev, copy=True)
                 for k, a in host.items()}
                for s, dev in enumerate(self.devices)]
            self.stats["full"] += 1
            self.stats["bytes"] += sum(t.numel() * t.element_size()
                                       for p in self.parts
                                       for t in p.values())
        self.version, self.layout = version, layout
        return self.parts


def _on(dev: torch.device):
    """Make ``dev`` the current card while a shard's work is issued."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _merge_top1(vals: list, idx: list, lead: torch.device):
    """The shards' Top-1 candidates, merged on ``lead`` by one max over the
    shard axis: ``(value, winning shard, its local row)``.  Among equal
    maxima the lowest shard wins (``np.argmax``'s first-maximum rule, which
    ``torch.argmax`` does not promise), i.e. the lowest global slot."""
    gv = torch.stack([v.to(lead, non_blocking=True) for v in vals])
    gi = torch.stack([i.to(lead, non_blocking=True) for i in idx])
    best = gv.amax(dim=0, keepdim=True)
    shard = torch.arange(gv.shape[0], dtype=torch.int32, device=lead).view(
        -1, *(1,) * (gv.dim() - 1))
    win = torch.where(gv == best, shard, gv.shape[0]).amin(dim=0,
                                                           keepdim=True)
    return best[0], win[0], gi.gather(0, win.long())[0]


def _store_place(rows_per: int):
    return lambda rows: (rows // rows_per, rows % rows_per)


def _store_piece(rows_per: int):
    return lambda a, s: a[s * rows_per:(s + 1) * rows_per]


class ShardedKernelBackend(KernelBackend):
    """Lookup and scoring over a :class:`ShardedStore`, shard by shard.

    ``n_shards=None`` means one shard per card (``torch.cuda.device_count
    ()``), or one on the CPU.  ``device`` is :class:`KernelBackend`'s: the
    card by default (it raises without one), ``"cpu"`` for the kernels'
    plain versions.  With at least ``n_shards`` cards
    (:meth:`mesh`) shard ``s`` lives on ``cuda:s``; otherwise every shard
    is a view of one mirrored slab on ``device`` and the per-shard launches
    run as a loop there (see the module docstring).

    The dense legs come from :class:`KernelBackend`: the pruned two-stage
    driver and the fused pipeline, ``top1_rows``/``topk_rows``, the
    quantized and pruned arena passes, and the dense scan of any store
    that is not a :class:`ShardedStore` (an arena view).
    """

    name = "sharded"

    def __init__(self, n_shards: int | None = None, device: str = "cuda",
                 quantized=None, pruned=None):
        super().__init__(device, quantized=quantized, pruned=pruned)
        self._n_shards = n_shards
        self._mesh = None
        self._mesh_built = False
        # the multi-card mirrors (built on the first call that needs them):
        # the fp32 slab + occupancy, its int8 twin, the policy table's slot
        # slices, the topic tables once a card, and the arena's slot-axis
        # slices of every policy (also on the one-card loop)
        self._shard_store = None
        self._shard_q8 = None
        self._shard_slots = None
        self._shard_topics: dict = {}
        self._shard_arena = None

    @property
    def sync_stats(self) -> dict:
        """:class:`KernelBackend`'s mirrors plus the sharded ones."""
        stats = super().sync_stats
        mirrors = [m for m in (self._shard_store, self._shard_q8,
                               self._shard_slots, self._shard_arena)
                   if m is not None] + list(self._shard_topics.values())
        return {k: v + sum(m.stats[k] for m in mirrors)
                for k, v in stats.items()}

    # ------------------------------------------------------------- topology
    @property
    def n_shards(self) -> int:
        if self._n_shards is None:
            self._n_shards = (torch.cuda.device_count()
                              if self.device.type == "cuda" else 1)
        return max(1, int(self._n_shards))

    def make_store(self, capacity: int, dim: int) -> ShardedStore:
        """Facade hook: the sharded backend owns its store geometry."""
        return ShardedStore(capacity, dim, n_shards=self.n_shards)

    def mesh(self):
        """The shards' cards, or None when there are too few."""
        if not self._mesh_built:
            from repro_torch.launch import mesh
            self._mesh = mesh.make_cache_mesh(self.n_shards, self.device)
            self._mesh_built = True
        return self._mesh

    def _on_each(self, x: np.ndarray, dtype, devices) -> dict:
        """Host array ``x`` uploaded once to every distinct card of
        ``devices``."""
        out: dict = {}
        for dev in devices:
            if dev not in out:
                out[dev] = torch.from_numpy(
                    np.ascontiguousarray(x, dtype=dtype)).to(dev)
        return out

    # ---------------------------------------------------------- device slab
    def _shard_slabs(self, store: ShardedStore):
        """Each shard's ``{"emb": (R, D), "occ": (R,)}`` on its card, and
        the cards.  On the mesh one mirror piece a card; otherwise row
        views of the one mirrored slab (:meth:`KernelBackend._slab`)."""
        devs, rows = self.mesh(), store.rows_per_shard
        if devs is None:
            dense = self._slab(store)
            parts = [{k: dense[k][s * rows:(s + 1) * rows]
                      for k in ("emb", "occ")}
                     for s in range(store.n_shards)]
            return parts, [dense["emb"].device] * store.n_shards
        if self._shard_store is None:
            self._shard_store = _ShardMirror({"emb": np.float32,
                                              "occ": np.int32}, devs)
        parts = self._shard_store.sync(
            store.version, store.dirty_since,
            {"emb": store.emb, "occ": store.occ}, store.emb.shape,
            _store_piece(rows), _store_place(rows))
        return parts, devs

    def _shard_int8(self, store: ShardedStore):
        """The host int8 mirror, each shard's ``{"q8", "scale"}`` on its
        card, and the cards."""
        devs, rows = self.mesh(), store.rows_per_shard
        if devs is None:
            qm, dense = self._q8(store)
            parts = [{k: dense[k][s * rows:(s + 1) * rows]
                      for k in ("q8", "scale")}
                     for s in range(store.n_shards)]
            return qm, parts, [dense["q8"].device] * store.n_shards
        qm = self._qhost.sync(store.version, store.dirty_since, store.emb)
        if self._shard_q8 is None:
            self._shard_q8 = _ShardMirror({"q8": np.int8,
                                           "scale": np.float32}, devs)
        parts = self._shard_q8.sync(
            store.version, store.dirty_since,
            {"q8": qm.q8, "scale": qm.scale}, store.emb.shape,
            _store_piece(rows), _store_place(rows))
        return qm, parts, devs

    # -------------------------------------------------------------- lookup
    def _top1_batch_exact(self, store, queries: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
        if not isinstance(store, ShardedStore):
            return super()._top1_batch_exact(store, queries)
        queries = np.asarray(queries, dtype=np.float32)
        if not store.slot_of:
            return _miss(queries.shape[0])
        parts, devs = self._shard_slabs(store)
        qd = self._on_each(queries, np.float32, devs)

        def scan():
            per = []
            for s, dev in enumerate(devs):
                with _on(dev):
                    # runtime n_valid = this shard's high-water mark
                    per.append(ops.sim_top1(
                        qd[dev], parts[s]["emb"],
                        n_valid=int(store.local_hwm[s])))
            return _merge_top1([v for v, _ in per], [i for _, i in per],
                               devs[0])

        with annotate("rac/sharded_top1"):
            out = ops.run_timed(scan, self._tracker, "sharded_top1")
        vals, win, local = ops.to_host_tuple(out)
        gslot = (win.astype(np.int64) * store.rows_per_shard
                 + local.astype(np.int64))
        cids = store.cid[gslot].copy()
        # a free (zeroed) slot can only win when all real sims < 0 → miss
        sims = np.where(cids >= 0, vals.astype(np.float64), -np.inf)
        self._flush_sync()
        return cids, sims

    def _quantized_candidates(self, store: ShardedStore, queries: np.ndarray):
        """The merged int8 shortlist before certification: one B5 a shard
        (Top-``ks``, ``ks = min(k, R)``), the ``S·ks`` candidates
        concatenated shard-major and cut to Top-``km`` (``km = min(k,
        S·ks)``) by a stable descending sort, so equal scores go to the
        lower slot.  Either ``ks = R`` (no shard hides a row) or ``km =
        ks`` (a hidden row sits below its shard's ``ks`` survivors, hence
        below the merged ``km``-th), so the single-slab error bound holds.
        Returns ``(vals (B, km), rows (B, km), qs, ql1, host int8
        mirror)``."""
        qm, parts, devs = self._shard_int8(store)
        q8, qs, ql1 = quantize_rows_int8(queries)
        rows_per = store.rows_per_shard
        ks = min(self.quantized.k, rows_per)
        km = min(self.quantized.k, store.n_shards * ks)
        q8d = self._on_each(q8, np.int8, devs)
        qsd = self._on_each(qs, np.float32, devs)
        lead = devs[0]

        def scan():
            vals, rows = [], []
            for s, dev in enumerate(devs):
                with _on(dev):
                    v, i = ops.sim_topk_q8(
                        q8d[dev], qsd[dev], parts[s]["q8"],
                        parts[s]["scale"], ks,
                        n_valid=int(store.local_hwm[s]))
                vals.append(v.to(lead, non_blocking=True))
                rows.append(i.to(lead, non_blocking=True).long()
                            + s * rows_per)
            allv, alli = torch.cat(vals, dim=1), torch.cat(rows, dim=1)
            order = torch.sort(allv, dim=1, descending=True,
                               stable=True).indices[:, :km]
            return allv.gather(1, order), alli.gather(1, order)

        with annotate("rac/sharded_topk_q8"):
            out = ops.run_timed(scan, self._tracker, "sharded_topk_q8")
        vals, rows = ops.to_host_tuple(out)
        return vals.astype(np.float64), rows, qs, ql1, qm

    def _top1_batch_quantized(self, store, queries: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Quantized candidate scan over the sharded int8 slab
        (:meth:`_quantized_candidates`), the union rescored in fp32 by
        :meth:`top1_rows` and certified by the shared safety predicate,
        with this backend's sharded scan as the exact fallback."""
        if not isinstance(store, ShardedStore):
            return super()._top1_batch_quantized(store, queries)
        b, dim = queries.shape
        vals, rows, qs, ql1, qm = self._quantized_candidates(store, queries)
        hwm_total = int(store.local_hwm.sum())
        k = self.quantized.k
        eps = scan_margin(qs, ql1, qm.scale, qm.l1, dim)
        cids, sims, n_fb, n_union = resolve_topk(
            vals, rows, eps, k >= hwm_total, self.quantized.tau_hit,
            lambda r: self.top1_rows(store, queries, r),
            lambda sel: self._top1_batch_exact(store, queries[sel]))
        account_scan(self.quant_stats, n_valid=hwm_total, dim=dim, batch=b,
                     n_union=n_union, n_fallback=n_fb)
        self._flush_sync()
        return cids, sims

    # ------------------------------------------------- multi-policy arena
    def top1_multi(self, arena, queries: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Policy-stacked Top-1 with the shard merge.  The arena's slot
        axis is cut into ``R = ceil(n_slots/S)`` rows a shard: every card
        holds each policy's slice as one ``(P, R, D)`` mirror piece (on the
        one-card loop, S pieces on that card) and runs one B1-multi with
        per-(shard, policy) counts from the policies' high-water marks;
        the ``(S, P, B)`` candidates merge as :meth:`top1_batch`'s do.  The
        quantized and pruned passes are :class:`KernelBackend`'s dense
        ones."""
        if not arena.track_rows:
            # the version-keyed mirrors sync against the arena's flat
            # journal; a host-only arena never stamps it
            raise ValueError("ShardedKernelBackend.top1_multi needs an "
                             "ArenaStore built with track_rows=True")
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        n_pol, n_slots, dim = arena.emb.shape
        if not any(v.slot_of for v in arena.views):
            return (np.full((n_pol, b), -1, dtype=np.int64),
                    np.full((n_pol, b), -np.inf, dtype=np.float64))
        if self.pruned is not None:
            out = self._top1_multi_pruned(arena, queries)
            if out is not None:
                return out
        if self.quantized is not None:
            return self._top1_multi_quantized(arena, queries)
        s = self.n_shards
        rows = -(-n_slots // s)                        # ceil division
        # per-(shard, policy) valid prefix of each policy's hwm
        lnv = np.clip(arena.hwms()[None, :] - (np.arange(s) * rows)[:, None],
                      0, rows).astype(np.int32)        # (S, P)
        devs = self.mesh() or [self.device] * s
        if self._shard_arena is None:
            self._shard_arena = _ShardMirror({"emb": np.float32}, devs)

        def piece(a, si):
            part = a.reshape(n_pol, n_slots, dim)[:, si * rows:(si + 1) * rows]
            if part.shape[1] < rows:        # the last shard's padded tail
                part = np.concatenate([part, np.zeros(
                    (n_pol, rows - part.shape[1], dim), np.float32)], axis=1)
            return part.reshape(n_pol * rows, dim)

        def place(flat):
            p, slot = flat // n_slots, flat % n_slots
            return slot // rows, p * rows + slot % rows

        parts = self._shard_arena.sync(
            arena.version, arena.dirty_since,
            {"emb": arena.emb.reshape(n_pol * n_slots, dim)},
            (n_pol, n_slots, rows, dim), piece, place)
        qd = self._on_each(queries, np.float32, devs)

        def scan():
            per = []
            for si, dev in enumerate(devs):
                with _on(dev):
                    per.append(ops.sim_top1_multi(
                        qd[dev], parts[si]["emb"].view(n_pol, rows, dim),
                        n_valid=torch.from_numpy(lnv[si]).to(dev)))
            return _merge_top1([v for v, _ in per], [i for _, i in per],
                               devs[0])

        with annotate("rac/sharded_top1_multi"):
            out = ops.run_timed(scan, self._tracker, "sharded_top1_multi")
        vals, win, local = ops.to_host_tuple(out)
        gslot = win.astype(np.int64) * rows + local.astype(np.int64)
        # padded tail rows are never scored (each count stops at its hwm);
        # an all-masked policy's row 0 maps to a miss like a free slot
        safe = np.minimum(gslot, n_slots - 1)
        cids = np.where(gslot < n_slots,
                        arena.cid[np.arange(n_pol)[:, None], safe], -1)
        sims = np.where(cids >= 0, vals.astype(np.float64), -np.inf)
        self._flush_sync()
        return cids, sims

    # ------------------------------------------------------------- eviction
    def _values(self, tsi, tids, tp_last, t_last, alpha, t_now, valid):
        """Eq. 1 over the resident table's entry axis, cut into
        ``ceil(n/S)``-entry chunks, one B3 a chunk on its shard's card (its
        mask in the kernel when ``valid`` is given); one B3 over the whole
        table when ``n < S`` or there is no mesh.  Ages are shifted so that
        ``t_now`` is 0, in int32.  The stitched values go back to the
        policy, whose lexsort takes the min with its tie-breaks."""
        n, s = len(tsi), self.n_shards
        devs = self.mesh()
        if devs is None or n < s:
            if valid is None:
                return super().rac_value(tsi, tids, tp_last, t_last, alpha,
                                         t_now)
            return super().rac_value_masked(tsi, tids, tp_last, t_last,
                                            alpha, t_now, valid)
        tsi = np.asarray(tsi, dtype=np.float32)
        tids = np.asarray(tids, dtype=np.int32)
        tpd = self._on_each(tp_last, np.float32, devs)
        tld = self._on_each(np.asarray(t_last) - t_now, np.int32, devs)
        lead = devs[0]
        chunk = -(-n // s)
        outs = []
        for c, lo in enumerate(range(0, n, chunk)):
            dev, hi = devs[c], lo + chunk
            args = (torch.from_numpy(tsi[lo:hi]).to(dev),
                    torch.from_numpy(tids[lo:hi]).to(dev), tpd[dev],
                    tld[dev])
            with _on(dev):
                if valid is None:
                    out = ops.rac_value(*args, float(alpha), 0)
                else:
                    mask = torch.from_numpy(np.ascontiguousarray(
                        valid[lo:hi], dtype=bool)).to(dev)
                    out = ops.rac_value_masked(*args, mask, float(alpha), 0)
            outs.append(out.to(lead, non_blocking=True))
        return np.asarray(ops.to_host(torch.cat(outs)), dtype=np.float64)

    def rac_value(self, tsi, tids, tp_last, t_last, alpha, t_now):
        return self._values(tsi, tids, tp_last, t_last, alpha, t_now, None)

    def rac_value_masked(self, tsi, tids, tp_last, t_last, alpha, t_now,
                         valid):
        return self._values(tsi, tids, tp_last, t_last, alpha, t_now,
                            np.asarray(valid, dtype=bool))

    # ------------------------------------------------------ fused decisions
    def _topics_on(self, dev: torch.device, table) -> dict:
        """The topic tables (representatives, TP state) mirrored on
        ``dev``: every card holds them whole."""
        m = self._shard_topics.get(dev)
        if m is None:
            m = self._shard_topics[dev] = _DeviceMirror(
                {"rep": np.float32, "tp": np.float32, "tl": np.int32}, dev)
        return m.sync(table.topic_version, table.dirty_topics_since,
                      lambda: {"rep": table.rep, "tp": table.tp_last,
                               "tl": table.t_last})

    def decide_batch(self, store, table, queries, *, alpha=0.0, t_now=0):
        """Fused per-shard decision pass.  On the mesh every card runs
        ``ops.fused_decide`` over its slab and its ``(R,)`` slices of the
        slot table, with the whole topic tables: the hit candidates merge
        as :meth:`top1_batch`'s, the routing Top-1 is the lead card's, and
        the victim slices are stitched back into one slot-indexed vector.
        On one device, and with an approximate lookup, the hit leg is
        :meth:`top1_batch` and routing plus victims one ``decide_aux``
        dispatch (B1 + B2), as the reference's fallback does."""
        if table is None or not isinstance(store, ShardedStore):
            return super().decide_batch(store, table, queries, alpha=alpha,
                                        t_now=t_now)
        queries = np.asarray(queries, dtype=np.float32)
        devs = self.mesh()
        if devs is None or self.quantized is not None \
                or self.pruned is not None:
            return self._decide_batch_split(store, table, queries,
                                            alpha=alpha, t_now=t_now)
        rows = store.rows_per_shard
        parts, _ = self._shard_slabs(store)
        if self._shard_slots is None:
            self._shard_slots = _ShardMirror({"tsi": np.float32,
                                              "tid": np.int32}, devs)
        slots = self._shard_slots.sync(
            table.slot_version, table.dirty_slots_since,
            {"tsi": table.tsi, "tid": table.topic_of}, table.tsi.shape,
            _store_piece(rows), _store_place(rows))
        qd = self._on_each(queries, np.float32, devs)
        lead = devs[0]

        def decide():
            per = []
            for s, dev in enumerate(devs):
                top = self._topics_on(dev, table)
                with _on(dev):
                    per.append(ops.fused_decide(
                        qd[dev], parts[s]["emb"], int(store.local_hwm[s]),
                        top["rep"], table.topic_hwm, slots[s]["tsi"],
                        slots[s]["tid"], parts[s]["occ"], top["tp"],
                        top["tl"], t_now, alpha=float(alpha)))
            hv, win, local = _merge_top1([o[0] for o in per],
                                         [o[1] for o in per], lead)
            victim = torch.cat([o[4].to(lead, non_blocking=True)
                                for o in per])
            return hv, win, local, per[0][2], per[0][3], victim

        with annotate("rac/sharded_fused_decide"):
            out = ops.run_timed(decide, self._tracker,
                                "sharded_fused_decide")
        hv, win, local, rv, ri, vv = ops.to_host_tuple(out)
        gslot = win.astype(np.int64) * rows + local.astype(np.int64)
        cids = store.cid[gslot].copy()
        # a free (zeroed) slot can only win when all real sims < 0 → miss
        sims = np.where(cids >= 0, hv.astype(np.float64), -np.inf)
        rv = rv.astype(np.float64)
        ri = np.where(np.isfinite(rv), ri.astype(np.int64), -1)
        self._flush_sync()
        return DecisionBatch(cids, sims, ri, rv, vv.astype(np.float64))
