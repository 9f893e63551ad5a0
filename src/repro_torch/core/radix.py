"""RadixRAC — RAC eviction for radix-structured KV prefix blocks.

The paper's second instantiation (§2, Alg. 3) caches fixed-size KV prefix
blocks in a radix tree: the parent edge IS the dependency link, and
eviction under block pressure ranks blocks by Value = TP(topic)·TSI(block)
with SGLang's children-first structural constraint.  This policy carries
exactly that scoring under the generic :mod:`repro_torch.core.policies`
protocol, so :class:`repro_torch.serving.kv_manager.KVBlockManager` runs
on a content-mode :class:`repro_torch.cache.SemanticCache` and shares the
facade's metrics, hooks, checkpoint and device scoring surface with the
query-level cache:

  - the *manager* owns the tree (token keys, prefix matching) and tells
    the policy about structure through :meth:`stage` (topic + parent of
    the next admission) and :meth:`touch_topic` (one TP refresh per
    request, Alg. 2);
  - the *policy* owns per-slot scoring slabs (freq/dep/last_t/topic),
    maintains the Alg. 3 TSI cascade on hits and new links, and elects
    victims by ``argmin TP·TSI`` over blocks with no live children;
  - victim scoring is one batched call — the facade wires
    ``masked_value_backend`` to the backend's ``rac_value_masked``, so the
    host oracle scores in float64 and the kernel backend runs one B3
    launch over the block slab with free and structurally protected slots
    masked to +inf in the kernel.

Self-eviction: when every block is structurally protected (all have live
children, or are the chain currently being extended), the freshly
admitted block itself is elected — the facade's always-admit protocol
turns that into "allocation failed", matching the legacy manager's
``victim < 0`` path, and the staged parent link is rolled back.

Every eviction reads slot-indexed arrays only: the scan covers the slab
up to the store's high-water mark (contiguous slices, no gather), free
slots and the (at most two) protected blocks are masked by slot like the
blocks with live children, and the victim is the minimum value, ties
broken on last access and then on cid.  Cids are unique, so this is the
same victim as a three-key lexsort over (value, last access, cid) of the
resident blocks, without a per-block Python loop at a pool of tens of
thousands of blocks.
"""
from __future__ import annotations

import numpy as np

from .policies import Policy


class RadixRACPolicy(Policy):
    name = "RadixRAC"

    def __init__(self, capacity, store=None, *,
                 alpha: float = 0.001,         # TP decay coefficient (Def. 1)
                 lam: float = 2.0,             # structural weight λ (Def. 2)
                 **kw):
        super().__init__(capacity, store)
        assert store is not None, "RadixRAC scores over the resident store"
        self.alpha = alpha
        self.lam = lam
        n = store.emb.shape[0]
        # per-slot scoring slabs (aligned with store slots)
        self.freq = np.zeros(n, dtype=np.float64)
        self.dep = np.zeros(n, dtype=np.float64)
        self.last_t = np.full(n, -1, dtype=np.int64)
        self.topic_of = np.full(n, -1, dtype=np.int64)
        self.parent = np.full(n, -1, dtype=np.int64)     # parent cid (-1 root)
        self.n_children = np.zeros(n, dtype=np.int64)    # live children count
        # topic TP tables (grown by doubling), indexed by tid
        self.tp_last = np.zeros(256, dtype=np.float64)
        self.t_last = np.zeros(256, dtype=np.int64)
        self._next_tid = 0
        # admission staging (set by the manager before each cache.admit)
        self._staged: tuple[int, int] | None = None      # (topic, parent)
        self._fresh = -1                  # last admitted cid (self-evict target)
        self.protect: set[int] = set()    # chain tip being extended
        # facade-wired scorers (see repro_torch.cache.facade._VALUE_HOOKS)
        self.value_backend = None
        self.masked_value_backend = None

    # ------------------------------------------------------------------ TP
    def _grow_tp(self, tid: int):
        while tid >= len(self.tp_last):
            self.tp_last = np.concatenate([self.tp_last,
                                           np.zeros_like(self.tp_last)])
            self.t_last = np.concatenate([self.t_last,
                                          np.zeros_like(self.t_last)])

    def touch_topic(self, tid: int | None, t: int) -> int:
        """Alg. 2 decay-and-increment; ``tid=None`` opens a fresh topic.
        Called once per request by the block manager (a conversation is a
        topic episode — every request touches exactly one topic)."""
        if tid is None:
            tid = self._next_tid
        self._grow_tp(tid)
        self._next_tid = max(self._next_tid, tid + 1)
        self.tp_last[tid] = (0.5 ** (self.alpha * (t - self.t_last[tid]))
                             * self.tp_last[tid] + 1.0)
        self.t_last[tid] = t
        return tid

    def tp_now(self, tid: int, t: int) -> float:
        return float(0.5 ** (self.alpha * (t - self.t_last[tid]))
                     * self.tp_last[tid])

    # ------------------------------------------------------------ protocol
    def stage(self, topic: int, parent: int):
        """Declare the structure of the next admission: its topic and its
        radix parent (-1 for a root).  The parent is also the chain tip
        currently being extended, so it joins the protected set."""
        self._staged = (topic, parent)
        self.protect = {parent} if parent >= 0 else set()

    def on_hit(self, cid, req, t):
        """Alg. 3 hit path: freq bump + one-hop dep cascade to the radix
        parent (the radix edge is the dependency link, no DetectParent)."""
        s = self.store.slot_of[cid]
        self.freq[s] += 1.0
        self.last_t[s] = t
        p = int(self.parent[s])
        if p >= 0 and p in self.store.slot_of:
            self.dep[self.store.slot_of[p]] += 1.0

    def on_admit(self, cid, req, t):
        assert self._staged is not None, \
            "RadixRAC admissions must be staged (topic, parent) first"
        topic, parent = self._staged
        self._staged = None
        self._fresh = cid
        s = self.store.slot_of[cid]
        self.freq[s] = 1.0
        self.dep[s] = 0.0
        self.last_t[s] = t
        self.topic_of[s] = topic
        self.parent[s] = parent
        if parent >= 0 and parent in self.store.slot_of:
            sp = self.store.slot_of[parent]
            self.n_children[sp] += 1
            self.dep[sp] += 1.0           # new link (Alg. 3 new=1 path)

    # ------------------------------------------------------------- eviction
    def _scores(self, t: int):
        """(values, valid) over the slots below the store's high-water
        mark; free and structurally protected slots score +inf."""
        store = self.store
        h = store.hwm
        tids = np.maximum(self.topic_of[:h], 0)     # free slots hold -1
        tsi = self.freq[:h] + self.lam * self.dep[:h]
        valid = store.occ[:h] & (self.n_children[:h] == 0)
        for c in self.protect | {self._fresh}:
            s = store.slot_of.get(c)
            if s is not None:
                valid[s] = False
        if self.masked_value_backend is not None:
            values = self.masked_value_backend(tsi, tids, self.tp_last,
                                               self.t_last, self.alpha, t,
                                               valid)
        else:
            tp = (0.5 ** (self.alpha * (t - self.t_last[tids]))
                  * self.tp_last[tids])
            values = np.where(valid, tp * tsi, np.inf)
        return values, valid

    def value_scores(self, t: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched masked Value(q) over all resident blocks: (cids, values,
        valid).  Invalid (structurally protected) blocks score +inf."""
        values, valid = self._scores(t)
        slots = np.flatnonzero(self.store.occ[:len(values)])
        return self.store.cid[slots], values[slots], valid[slots]

    def victim(self, t):
        values, valid = self._scores(t)
        if not valid.any():
            # everything is structurally protected: elect the fresh block
            # itself (always-admit admission control — the manager reads
            # this as "allocation failed", like the legacy victim<0 path)
            victim = self._fresh
            self._unlink_fresh()
        else:
            # (value, last access, cid) order over the valid slots; cids
            # are unique, so the third key always leaves one candidate
            cand = np.flatnonzero(values == values.min())
            if cand.size > 1:
                lt = self.last_t[cand]
                cand = cand[lt == lt.min()]
            victim = int(self.store.cid[cand].min())
        self._forget(victim)
        return victim

    def _unlink_fresh(self):
        """Roll back the staged parent link of a failed admission so the
        parent's dep/children match the legacy never-inserted state."""
        s = self.store.slot_of[self._fresh]
        p = int(self.parent[s])
        if p >= 0 and p in self.store.slot_of:
            sp = self.store.slot_of[p]
            self.n_children[sp] -= 1
            self.dep[sp] -= 1.0

    def _forget(self, cid: int):
        s = self.store.slot_of[cid]
        p = int(self.parent[s])
        if p >= 0 and cid != self._fresh and p in self.store.slot_of:
            self.n_children[self.store.slot_of[p]] -= 1
        self.freq[s] = 0.0
        self.dep[s] = 0.0                 # dep(parent) survives (Def. 2)
        self.last_t[s] = -1
        self.topic_of[s] = -1
        self.parent[s] = -1
        if cid == self._fresh:
            self._fresh = -1
