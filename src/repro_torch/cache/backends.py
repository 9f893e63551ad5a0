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

The quantized and topic-pruned lookups, the policy-stacked arena surface,
Top-K row scans and the sharded backend are not ported yet; asking for
them raises ``NotImplementedError`` (see ``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.policy_table import PolicyTable
from repro_torch.core.store import ResidentStore
from repro_torch.kernels import ops
from repro_torch.telemetry.tracing import annotate

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

    def decide_batch(self, store: ResidentStore,
                     table: Optional[PolicyTable], queries: np.ndarray, *,
                     alpha: float = 0.0, t_now: int = 0) -> DecisionBatch:
        """Fused snapshot decision scoring for a (B, D) query block: hit
        Top-1 + routing Top-1 + masked Eq. 1 victim values in one launch.
        ``table=None`` (table-less policies) degrades to hit Top-1 only."""
        ...


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP.md, queue A item {item})")


def _reject_approximate(quantized, pruned) -> None:
    if quantized:
        raise _not_ported("quantized lookup", "5")
    if pruned:
        raise _not_ported("pruned lookup", "6")


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
    bulk churn) → full upload."""

    def __init__(self, dtypes: dict, device: torch.device):
        self.dtypes = dtypes
        self.device = device
        self.version = None
        self.arrays: Optional[dict] = None
        # "bytes" = host->device traffic this mirror moved (copied rows
        # for incremental syncs, whole arrays for full uploads)
        self.stats = {"full": 0, "incremental": 0, "rows": 0, "bytes": 0}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
            self.arrays = {k: self._upload(np.asarray(v, self.dtypes[k]))
                           for k, v in host.items()}
            self.stats["full"] += 1
            self.stats["bytes"] += sum(
                v.size * np.dtype(self.dtypes[k]).itemsize
                for k, v in host.items())
        self.version = version
        return self.arrays


class NumpyBackend:
    """Host-side slab scan (the historical ``ResidentStore.nearest`` path)
    — the oracle every device path is held against."""

    name = "numpy"

    def __init__(self, quantized=None, pruned=None):
        _reject_approximate(quantized, pruned)

    def __deepcopy__(self, memo):
        return self                   # stateless: checkpoints share it

    def top1(self, store: ResidentStore, query: np.ndarray) -> tuple[int, float]:
        return store.nearest(query)

    def top1_batch(self, store: ResidentStore,
                   queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        if not store.slot_of:
            return (np.full(b, -1, dtype=np.int64),
                    np.full(b, -np.inf, dtype=np.float64))
        sims = queries @ store.emb.T                      # (B, n_slots)
        sims[:, ~store.occ] = -np.inf
        idx = np.argmax(sims, axis=1)
        return (store.cid[idx].copy(),
                sims[np.arange(b), idx].astype(np.float64))

    def top1_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        sims = queries @ store.emb[rows].T                # (B, len(rows))
        best = np.argmax(sims, axis=1)
        b = np.arange(queries.shape[0])
        return (store.cid[rows[best]].copy(),
                sims[b, best].astype(np.float64))

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
    fused decision pass via ``ops.fused_decide`` and eviction scoring via
    the ``rac_value`` kernel.

    ``device="cuda"`` (the default) needs a card and raises without one;
    ``device="cpu"`` runs every kernel wrapper's plain PyTorch version.

    The whole scoring state is device-resident: three
    :class:`_DeviceMirror`\\ s hold the embedding slab + occupancy (synced
    against the store's mutation journal), the policy table's slot slabs
    (tsi/topic, its slot journal), and its topic tables (TP state +
    representatives, its topic journal).  Steady-state replay therefore
    moves O(mutated rows) per chunk, not O(capacity), and lookups read the
    slab from its mirror instead of uploading it.
    """

    name = "kernel"

    def __init__(self, device: str = "cuda", quantized=None, pruned=None):
        _reject_approximate(quantized, pruned)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"KernelBackend(device={device!r}): no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self._store_mirror = _DeviceMirror({"emb": np.float32,
                                            "occ": np.int32}, self.device)
        self._slot_mirror = _DeviceMirror({"tsi": np.float32,
                                           "tid": np.int32}, self.device)
        self._topic_mirror = _DeviceMirror({"rep": np.float32,
                                            "tp": np.float32,
                                            "tl": np.int32}, self.device)
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
        mirrors = (self._store_mirror, self._slot_mirror, self._topic_mirror)
        return {k: sum(m.stats[k] for m in mirrors)
                for k in ("full", "incremental", "rows", "bytes")}

    @property
    def dispatch_stats(self) -> dict:
        """Launch/transfer observability: dispatches issued, blocking
        device→host syncs, and seconds spent inside timed kernel intervals.
        Process-global — consumers read deltas."""
        return dict(ops.dispatch_stats)

    def _slab(self, store: ResidentStore) -> dict:
        return self._store_mirror.sync(
            store.version, store.dirty_since,
            lambda: {"emb": store.emb, "occ": store.occ})

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
        b = queries.shape[0]
        if not store.slot_of:
            return (np.full(b, -1, dtype=np.int64),
                    np.full(b, -np.inf, dtype=np.float64))
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

    def top1_rows(self, store: ResidentStore, queries: np.ndarray,
                  rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        # the restricted candidate block is gathered on the host and
        # uploaded (it is a handful of recently admitted rows)
        vals, idx = ops.sim_top1(self._tensor(queries, np.float32),
                                 self._tensor(store.emb[rows], np.float32),
                                 n_valid=rows.shape[0])
        vals, idx = ops.to_host_tuple((vals, idx))
        return store.cid[rows[idx]].copy(), vals.astype(np.float64)

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

    def _device_state(self, store: ResidentStore, table: PolicyTable) -> dict:
        """The mirrored decision state, freshened by dirty-row copies."""
        slot = self._slot_mirror.sync(
            table.slot_version, table.dirty_slots_since,
            lambda: {"tsi": table.tsi, "tid": table.topic_of})
        topic = self._topic_mirror.sync(
            table.topic_version, table.dirty_topics_since,
            lambda: {"rep": table.rep, "tp": table.tp_last,
                     "tl": table.t_last})
        return {**self._slab(store), **slot, **topic}

    def decide_batch(self, store, table, queries, *, alpha=0.0, t_now=0):
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        if table is None:
            hit_cid, hit_sim = self.top1_batch(store, queries)
            return DecisionBatch(hit_cid, hit_sim,
                                 np.full(b, -1, dtype=np.int64),
                                 np.full(b, -np.inf, dtype=np.float64), None)
        dev = self._device_state(store, table)
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


def _backends() -> dict:
    return {"numpy": NumpyBackend, "kernel": KernelBackend}


def get_backend(name: str, **kwargs) -> LookupBackend:
    """Instantiate a backend by config name (``"kernel"`` | ``"numpy"``).

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
    if name == "sharded":
        raise _not_ported("the sharded backend", "10")
    registry = _backends()
    try:
        cls = registry[name]
    except KeyError:
        raise ValueError(f"unknown cache backend {name!r}; "
                         f"expected one of {sorted(registry)}") from None
    return cls(**kwargs)
