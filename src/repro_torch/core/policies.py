"""Eviction policies: the protocol and the 16 baselines as vectorized
array-state over per-slot slabs.

The protocol driven by :mod:`repro_torch.core.simulator`,
:mod:`repro_torch.core.arena` and :class:`repro_torch.cache.SemanticCache`:

  - ``on_hit(cid, req, t)``   — the store served ``req`` from entry ``cid``
  - ``on_admit(cid, req, t)`` — a miss; entry ``cid`` was just inserted
  - ``victim(t) -> cid``      — called while the store is over capacity;
                                must return a resident cid

plus the vectorized surface the multi-policy arena drives:

  - ``on_hit_batch(cids, reqs, ts)`` / ``on_admit_batch(...)`` — apply a
    run of consecutive events in one call.  The base implementations loop;
    policies whose update is expressible as slab writes override them with
    numpy ops that produce the *identical* final state (last-write-wins
    sequences, ``np.add.at`` counters).
  - ``victim_scores(t) -> (mask, keys)`` — the lexicographic eviction
    keys over the slot axis for score-ordered policies; ``victim`` is then
    a masked argmin (smallest key tuple wins).  Sweep/adaptive policies
    (CLOCK, SIEVE, ARC, S3-FIFO, ...) override ``victim`` wholesale with a
    vectorized transcription of their historical walk.

Every baseline (paper §4.2) keeps its metadata in a
:class:`repro_torch.core.policy_table.SlabTable` indexed by the resident
store's slot ids.  These are host state machines: they run on numpy
whatever the backend, and make the same decisions as the reference
package's baselines (``tests/test_torch_policies.py``).

Hit determination is owned by the simulator/facade and identical for every
policy; policies only order residents.  Victim selection runs under the
**sentinel-forget invariant**: a policy's ordering slab holds the dtype's
max sentinel (``_SEQ0`` / ``+inf``) at every non-resident slot — the fill
value initially, re-written by ``victim`` when it elects a slot — so the
common eviction is one unmasked C ``argmin`` over the slab, with no
occupancy mask or temporary.  Slabs that are not ordering keys are left
stale at freed slots (masked selections exclude them; the next admission
overwrites them).

RNG-bearing policies (TinyLFU's sketch salt, LHD, LeCaR, RANDOM) take a
``seed`` kwarg, threaded from ``run_many``/``default_factories`` for
reproducible reruns; they draw from ``random.Random`` and numpy exactly as
the reference package's do, so the same seed gives the same evictions.

Implemented baselines: FIFO, LRU, CLOCK, TTL, LFU, TinyLFU, ARC, S3-FIFO,
SIEVE, 2Q, LRU-2, GDSF, LHD, LeCaR, Belady-MIN (offline optimal), RANDOM.
"""
from __future__ import annotations

import random
from collections import OrderedDict, deque

import numpy as np

from .policy_table import SlabTable

INF = float("inf")

_SEQ0 = np.int64(1) << 62          # fill for never-written sequence slabs


class Policy:
    name = "base"
    requires_future = False

    def __init__(self, capacity: int, store=None, **kw):
        self.capacity = capacity
        self.store = store

    def on_hit(self, cid: int, req, t: int):  # pragma: no cover - interface
        raise NotImplementedError

    def on_admit(self, cid: int, req, t: int):
        raise NotImplementedError

    def victim(self, t: int) -> int:
        raise NotImplementedError

    # -- batched surface (default: the scalar loop, always correct) --------
    def on_hit_batch(self, cids, reqs, ts):
        for i, cid in enumerate(cids):
            self.on_hit(cid, reqs[i], ts[i])

    def on_admit_batch(self, cids, reqs, ts):
        for i, cid in enumerate(cids):
            self.on_admit(cid, reqs[i], ts[i])


_SENTINELS: dict = {}


def _sentinel(dtype):
    s = _SENTINELS.get(dtype.char)
    if s is None:
        s = np.inf if dtype.kind == "f" else np.iinfo(dtype).max
        _SENTINELS[dtype.char] = s
    return s


def _lex_argmin(mask: np.ndarray, *keys: np.ndarray) -> int:
    """Slot of the lexicographically smallest key tuple among ``mask``.

    Masked-out rows take the dtype's max sentinel (every live key is
    strictly below it), so the common single-key case is one ``where`` +
    one C ``argmin``; ties refine through successive keys.  The caller
    guarantees a non-empty mask and that the final key is unique (or that
    full ties are observationally equivalent)."""
    k = keys[0]
    masked = np.where(mask, k, _sentinel(k.dtype))
    i = int(masked.argmin())
    for nxt in keys[1:]:
        tie = masked == masked[i]
        if np.count_nonzero(tie) == 1:
            return i
        masked = np.where(tie, nxt, _sentinel(nxt.dtype))
        i = int(masked.argmin())
    return i


def _lex_argmin_nomask(*keys: np.ndarray) -> int:
    """Lexicographic argmin over the whole slot axis, relying on the
    sentinel-forget invariant: every non-resident slot holds its key
    dtype's sentinel (the slab fill, re-written by ``victim``), so no
    occupancy mask — and no masked temporary — is needed."""
    k = keys[0]
    i = int(k.argmin())
    for nxt in keys[1:]:
        tie = k == k[i]
        if np.count_nonzero(tie) == 1:
            return i
        k = np.where(tie, nxt, _sentinel(nxt.dtype))
        i = int(k.argmin())
    return i


def _assign_last(arr: np.ndarray, slots: np.ndarray, vals: np.ndarray):
    """``arr[slots] = vals`` with deterministic last-write-wins on
    duplicate slots (what the scalar loop would leave behind)."""
    u, ridx = np.unique(slots[::-1], return_index=True)
    arr[u] = vals[len(slots) - 1 - ridx]
    return u


class ArrayPolicy(Policy):
    """Base for slab-backed baselines (see module docstring).

    ``slab_spec`` declares the per-slot fields; ``self.slabs`` is the
    journaled :class:`SlabTable` sized to the store's slot count.  ``_seq``
    is the monotone touch counter every recency/insertion ordering is
    expressed in.
    """

    slab_spec: dict = {}
    #: per-row slab journaling (device dirty-row sync) — off by default:
    #: nothing mirrors baseline slabs yet and the stamps are hot-path cost
    journal_slabs: bool = False

    def __init__(self, capacity: int, store=None, **kw):
        super().__init__(capacity, store)
        if store is None:
            raise ValueError(f"{self.name}: array-state policies order "
                             "residents by store slot and need the store")
        self.n_slots = store.emb.shape[0]
        self.slabs = SlabTable(self.n_slots, journal=self.journal_slabs,
                               **self.slab_spec)
        self._ctr = 0

    def _slot(self, cid: int) -> int:
        return self.store.slot_of[cid]

    def _slots(self, cids) -> np.ndarray:
        so = self.store.slot_of
        return np.array([so[c] for c in cids], dtype=np.int64)

    def _tick(self) -> int:
        self._ctr += 1
        return self._ctr

    def _tick_n(self, n: int) -> np.ndarray:
        """``n`` fresh ascending sequence values."""
        base = self._ctr
        self._ctr += n
        return np.arange(base + 1, base + n + 1, dtype=np.int64)

    # -- score-ordered eviction (overridden by sweep/adaptive policies) ----
    def victim_scores(self, t: int):
        """(mask, lexicographic key arrays) over the slot axis; the victim
        is the masked lexicographic argmin.  ``None`` when the policy's
        eviction is not a pure score order (it overrides ``victim``)."""
        return None

    def _on_evict(self, slot: int, cid: int, t: int):
        """Post-selection bookkeeping hook for score-ordered policies."""

    def victim(self, t: int) -> int:
        mask, keys = self.victim_scores(t)
        slot = _lex_argmin(mask, *keys)
        cid = int(self.store.cid[slot])
        self._on_evict(slot, cid, t)
        return cid


# ---------------------------------------------------------------------------
class FIFOPolicy(ArrayPolicy):
    name = "FIFO"
    slab_spec = {"seq": (np.int64, _SEQ0)}

    def on_hit(self, cid, req, t):
        pass

    def on_hit_batch(self, cids, reqs, ts):
        pass

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def victim_scores(self, t):
        return self.store.occ, (self.slabs.seq,)

    def victim(self, t):
        seq = self.slabs.seq
        s = int(seq.argmin())          # sentinel-forget: free slots = _SEQ0
        seq[s] = _SEQ0
        self.slabs.touch(s)
        return int(self.store.cid[s])


class LRUPolicy(ArrayPolicy):
    name = "LRU"
    slab_spec = {"seq": (np.int64, _SEQ0)}

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        u = _assign_last(self.slabs.seq, slots, self._tick_n(len(slots)))
        self.slabs.touch_rows(u)

    on_admit = on_hit

    def victim_scores(self, t):
        return self.store.occ, (self.slabs.seq,)

    def victim(self, t):
        seq = self.slabs.seq
        s = int(seq.argmin())          # sentinel-forget: free slots = _SEQ0
        seq[s] = _SEQ0
        self.slabs.touch(s)
        return int(self.store.cid[s])


class CLOCKPolicy(ArrayPolicy):
    name = "CLOCK"
    slab_spec = {"seq": (np.int64, _SEQ0), "ref": (bool, False)}

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.ref[s] = True
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        self.slabs.ref[slots] = True
        self.slabs.touch_rows(slots)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.ref[s] = False
        self.slabs.touch(s)

    def victim(self, t):
        # the historical sweep in one pass: the hand starts at the ring
        # head (min seq); every referenced entry it passes is cleared and
        # moved to the tail in ring order; the first unreferenced entry is
        # evicted.  All-referenced rings clear everyone and evict the head.
        seq, ref = self.slabs.seq, self.slabs.ref
        masked = np.where(ref, _SEQ0, seq)   # sentinel-forget free slots
        vslot = int(masked.argmin())
        if masked[vslot] >= _SEQ0:
            # every resident referenced: clear all refs, evict the head
            # (relative ring order is unchanged)
            resident = seq < _SEQ0
            ref[resident] = False
            if self.slabs.log is not None:
                self.slabs.touch_rows(np.flatnonzero(resident))
            vslot = int(seq.argmin())
        else:
            pred = np.flatnonzero(ref & (seq < seq[vslot]))
            if pred.size:
                pred = pred[np.argsort(seq[pred], kind="stable")]
                ref[pred] = False
                seq[pred] = self._tick_n(pred.size)
                self.slabs.touch_rows(pred)
        seq[vslot] = _SEQ0
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])


class TTLPolicy(ArrayPolicy):
    """Expire-first (admit time + ttl), LRU among the unexpired."""
    name = "TTL"
    slab_spec = {"seq": (np.int64, _SEQ0), "deadline": (np.int64, _SEQ0)}

    def __init__(self, capacity, store=None, ttl: int = 2000, **kw):
        super().__init__(capacity, store)
        self.ttl = ttl

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        u = _assign_last(self.slabs.seq, slots, self._tick_n(len(slots)))
        self.slabs.touch_rows(u)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.deadline[s] = t + self.ttl
        self.slabs.touch(s)

    def victim(self, t):
        seq, dl = self.slabs.seq, self.slabs.deadline
        expired = dl <= t              # sentinel-forget: free slots = _SEQ0
        if expired.any():
            # min deadline; ties fall back to LRU position, matching the
            # historical min() over the recency-ordered dict
            vslot = _lex_argmin(expired, dl, seq)
        else:
            vslot = int(seq.argmin())
        seq[vslot] = _SEQ0
        dl[vslot] = _SEQ0
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])


class LFUPolicy(ArrayPolicy):
    """LFU with LRU tie-break."""
    name = "LFU"
    slab_spec = {"freq": (np.int64, _SEQ0), "stamp": (np.int64, _SEQ0)}

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.freq[s] += 1
        self.slabs.stamp[s] = self._tick()
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        np.add.at(self.slabs.freq, slots, 1)
        u = _assign_last(self.slabs.stamp, slots, self._tick_n(len(slots)))
        self.slabs.touch_rows(u)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.freq[s] = 1
        self.slabs.stamp[s] = self._tick()
        self.slabs.touch(s)

    def victim_scores(self, t):
        return self.store.occ, (self.slabs.freq, self.slabs.stamp)

    def victim(self, t):
        freq, stamp = self.slabs.freq, self.slabs.stamp
        vslot = _lex_argmin_nomask(freq, stamp)
        freq[vslot] = _SEQ0            # sentinel-forget
        stamp[vslot] = _SEQ0
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])


class _CountMinSketch:
    def __init__(self, width: int, depth: int = 4, seed: int = 7):
        self.w = max(16, width)
        self.d = depth
        self.tab = np.zeros((depth, self.w), dtype=np.uint8)  # 8-bit counters
        rng = random.Random(seed)
        self.salts = [rng.getrandbits(32) for _ in range(depth)]
        self.ops = 0

    def _idx(self, key: int, row: int) -> int:
        h = (key * 0x9E3779B97F4A7C15 + self.salts[row]) & 0xFFFFFFFFFFFFFFFF
        return (h >> 17) % self.w

    def add(self, key: int):
        self.ops += 1
        for r in range(self.d):
            i = self._idx(key, r)
            if self.tab[r, i] < 255:
                self.tab[r, i] += 1
        if self.ops >= 8 * self.w:       # periodic aging (halve)
            self.tab >>= 1
            self.ops = 0

    def estimate(self, key: int) -> int:
        return int(min(self.tab[r, self._idx(key, r)] for r in range(self.d)))


class TinyLFUPolicy(ArrayPolicy):
    """TinyLFU admission over an LRU main cache (simplified W-TinyLFU).

    Admission control is expressed through victim selection: the newly
    inserted entry itself is evicted when its sketch frequency does not
    beat the main cache's LRU victim.  The sketch is already array state
    (a fixed (depth, width) counter table); recency rides the seq slab.
    """
    name = "TinyLFU"
    slab_spec = {"seq": (np.int64, _SEQ0)}

    def __init__(self, capacity, store=None, seed: int = 0, **kw):
        super().__init__(capacity, store)
        self.sketch = _CountMinSketch(width=capacity * 8, seed=7 + seed)
        self.window: deque[int] = deque()         # recent admissions (window)
        self.window_size = max(1, capacity // 100)
        self._mru_slot = -1            # slot of the latest touch (hit/admit)

    def on_hit(self, cid, req, t):
        self.sketch.add(cid)
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self._mru_slot = s
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        sketch_add = self.sketch.add
        slot_of = self.store.slot_of
        seq = self.slabs.seq
        s = -1
        for cid in cids:
            sketch_add(cid)
            s = slot_of[cid]
            seq[s] = self._tick()
        self._mru_slot = s
        if self.slabs.log is not None:
            self.slabs.touch_rows([slot_of[c] for c in cids])

    def on_admit(self, cid, req, t):
        self.sketch.add(cid)
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self._mru_slot = s
        self.slabs.touch(s)
        self.window.append(cid)
        while len(self.window) > self.window_size:
            self.window.popleft()

    def victim(self, t):
        seq = self.slabs.seq
        oldest = int(seq.argmin())     # sentinel-forget: free slots = _SEQ0
        # victim always follows an admission (Alg. 1 insert-then-evict),
        # so the MRU touch IS the newest entry — no slab scan needed
        newest = self._mru_slot
        new_cid = int(self.store.cid[newest])
        old_cid = int(self.store.cid[oldest])
        if new_cid in self.window and new_cid != old_cid:
            # admission duel: candidate vs main LRU victim
            vslot, cid = ((oldest, old_cid)
                          if self.sketch.estimate(new_cid)
                          > self.sketch.estimate(old_cid)
                          else (newest, new_cid))
        else:
            vslot, cid = oldest, old_cid
        seq[vslot] = _SEQ0
        self.slabs.touch(vslot)
        return cid


class ARCPolicy(ArrayPolicy):
    """Adaptive Replacement Cache (Megiddo & Modha, FAST'03).

    Resident membership (T1 recency list vs T2 frequency list) and order
    live in slabs; the bounded ghost lists B1/B2 are cid-keyed host dicts
    exactly as in the historical implementation.
    """
    name = "ARC"
    slab_spec = {"which": (np.int8, 0), "seq": (np.int64, _SEQ0)}

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.p = 0.0
        self.b1: OrderedDict[int, None] = OrderedDict()
        self.b2: OrderedDict[int, None] = OrderedDict()
        self.n_t1 = 0
        self.n_t2 = 0

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        if self.slabs.which[s] == 1:
            self.slabs.which[s] = 2
            self.n_t1 -= 1
            self.n_t2 += 1
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def on_admit(self, cid, req, t):
        c = self.capacity
        s = self._slot(cid)
        if cid in self.b1:
            self.p = min(c, self.p + max(1.0, len(self.b2) / max(1, len(self.b1))))
            del self.b1[cid]
            self.slabs.which[s] = 2
            self.n_t2 += 1
        elif cid in self.b2:
            self.p = max(0.0, self.p - max(1.0, len(self.b1) / max(1, len(self.b2))))
            del self.b2[cid]
            self.slabs.which[s] = 2
            self.n_t2 += 1
        else:
            l1 = self.n_t1 + len(self.b1)
            if l1 >= c:
                if self.b1:
                    self.b1.popitem(last=False)
            elif l1 + self.n_t2 + len(self.b2) >= 2 * c:
                if self.b2:
                    self.b2.popitem(last=False)
            self.slabs.which[s] = 1
            self.n_t1 += 1
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def victim(self, t):
        which, seq = self.slabs.which, self.slabs.seq
        if self.n_t1 and (self.n_t1 > self.p or not self.n_t2):
            vslot = int(np.where(which == 1, seq, _SEQ0).argmin())
            cid = int(self.store.cid[vslot])
            self.b1[cid] = None
            self.n_t1 -= 1
        else:
            vslot = int(np.where(which == 2, seq, _SEQ0).argmin())
            cid = int(self.store.cid[vslot])
            self.b2[cid] = None
            self.n_t2 -= 1
        which[vslot] = 0
        self.slabs.touch(vslot)
        # bound ghost lists
        while len(self.b1) > self.capacity:
            self.b1.popitem(last=False)
        while len(self.b2) > self.capacity:
            self.b2.popitem(last=False)
        return cid


class S3FIFOPolicy(ArrayPolicy):
    """S3-FIFO (Yang et al., SOSP'23 / NSDI'23): small + main + ghost FIFOs.

    Queue membership/order/frequency are slabs; the historical pop-and-
    reappend walks collapse to one vectorized pass each — an entry at
    queue position ``pos`` with frequency ``f`` is evicted from MAIN after
    ``f`` full demotion cycles plus ``pos`` steps, so the victim is the
    lexicographic min of ``(freq, seq)`` and every entry processed before
    it is decremented and re-sequenced exactly as the walk would have.
    """
    name = "S3-FIFO"
    slab_spec = {"queue": (np.int8, 0),        # 0 none / 1 small / 2 main
                 "seq": (np.int64, _SEQ0),
                 "freq": (np.int64, 0)}

    def __init__(self, capacity, store=None, small_frac: float = 0.1, **kw):
        super().__init__(capacity, store)
        self.small_cap = max(1, int(capacity * small_frac))
        self.ghost: OrderedDict[int, None] = OrderedDict()
        self.n_small = 0
        self.n_main = 0

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.freq[s] = min(3, self.slabs.freq[s] + 1)
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        np.add.at(self.slabs.freq, slots, 1)
        np.minimum(self.slabs.freq, 3, out=self.slabs.freq)
        self.slabs.touch_rows(slots)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.freq[s] = 0
        if cid in self.ghost:
            del self.ghost[cid]
            self.slabs.queue[s] = 2
            self.n_main += 1
        else:
            self.slabs.queue[s] = 1
            self.n_small += 1
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def _evict_main(self) -> int:
        queue, seq, freq = self.slabs.queue, self.slabs.seq, self.slabs.freq
        mask = self.store.occ & (queue == 2)
        vslot = _lex_argmin(mask, freq, seq)
        fmin = int(freq[vslot])
        before = np.flatnonzero(mask & (seq < seq[vslot]))
        after = np.flatnonzero(mask & (seq > seq[vslot]))
        freq[before] -= fmin + 1       # processed fmin+1 times before evict
        freq[after] -= fmin            # processed fmin full cycles
        if fmin > 0:
            # every survivor was re-appended: tail-of-final-pass entries
            # (after) precede the re-processed head entries (before)
            walk = np.concatenate([after[np.argsort(seq[after],
                                                    kind="stable")],
                                   before[np.argsort(seq[before],
                                                     kind="stable")]])
            seq[walk] = self._tick_n(walk.size)
            self.slabs.touch_rows(walk)
        elif before.size:
            order = before[np.argsort(seq[before], kind="stable")]
            seq[order] = self._tick_n(order.size)
            self.slabs.touch_rows(order)
        queue[vslot] = 0
        self.n_main -= 1
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])

    def victim(self, t):
        queue, seq, freq = self.slabs.queue, self.slabs.seq, self.slabs.freq
        if self.n_small > self.small_cap or not self.n_main:
            small = np.flatnonzero(self.store.occ & (queue == 1))
            small = small[np.argsort(seq[small], kind="stable")]
            keep = freq[small] > 1                 # promoted on the walk
            first = np.flatnonzero(~keep)
            k = int(first[0]) if first.size else small.size
            promo = small[:k]
            if promo.size:
                queue[promo] = 2
                freq[promo] = 0
                seq[promo] = self._tick_n(promo.size)
                self.slabs.touch_rows(promo)
                self.n_small -= promo.size
                self.n_main += promo.size
            if first.size:
                vslot = int(small[k])
                cid = int(self.store.cid[vslot])
                self.ghost[cid] = None
                while len(self.ghost) > self.capacity:
                    self.ghost.popitem(last=False)
                queue[vslot] = 0
                self.n_small -= 1
                self.slabs.touch(vslot)
                return cid
        return self._evict_main()


class SIEVEPolicy(ArrayPolicy):
    """SIEVE (Zhang et al., NSDI'24): FIFO order + moving hand + visited bits."""
    name = "SIEVE"
    slab_spec = {"seq": (np.int64, _SEQ0), "visited": (bool, False)}

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.hand: int | None = None               # cid at hand

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.visited[s] = True
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        self.slabs.visited[slots] = True
        self.slabs.touch_rows(slots)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()           # insert at tail (newest)
        self.slabs.visited[s] = False
        self.slabs.touch(s)

    def victim(self, t):
        # the historical hand walk without sorting: order residents by the
        # CYCLIC key (insertion seq rotated so the hand is first); the
        # victim is the min-cyclic-key unvisited entry, everything walked
        # past loses its visited bit, and the hand moves to the victim's
        # ring successor.  SIEVE never reorders entries, so seqs are
        # untouched.  Free slots hold the seq sentinel (sentinel-forget).
        seq, visited = self.slabs.seq, self.slabs.visited
        big = _sentinel(seq.dtype)
        hslot = (self.store.slot_of.get(self.hand, -1)
                 if self.hand is not None else -1)
        if hslot >= 0:
            hseq = seq[hslot]
            ckey = np.where(seq >= hseq, seq - hseq, seq - hseq + _SEQ0)
            ckey[seq >= _SEQ0] = big               # exclude free slots
        else:
            ckey = np.where(seq < _SEQ0, seq, big)
        cand = np.where(visited, big, ckey)
        vslot = int(cand.argmin())
        if cand[vslot] >= big:
            # all residents visited: one full pass clears everyone, the
            # second evicts the walk head
            vslot = int(ckey.argmin())
            passed = ckey < big
        else:
            passed = visited & (ckey < ckey[vslot])
        visited[passed] = False
        if self.slabs.log is not None:
            self.slabs.touch_rows(np.flatnonzero(passed))
        cid = int(self.store.cid[vslot])
        # ring successor in the pre-eviction snapshot (wraps to the head)
        nkey = np.where(ckey > ckey[vslot], ckey, big)
        nslot = int(nkey.argmin())
        if nkey[nslot] >= big:
            nslot = int(ckey.argmin())             # victim was cyclic-last
        nxt = int(self.store.cid[nslot])
        self.hand = nxt if nxt != cid else None
        seq[vslot] = _SEQ0             # sentinel-forget
        self.slabs.touch(vslot)
        return cid


class TwoQPolicy(ArrayPolicy):
    """2Q (Johnson & Shasha, VLDB'94): A1in FIFO + A1out ghost + Am LRU."""
    name = "2Q"
    slab_spec = {"queue": (np.int8, 0),            # 1 A1in / 2 Am
                 "seq": (np.int64, _SEQ0)}

    def __init__(self, capacity, store=None, kin_frac=0.25, kout_frac=0.5, **kw):
        super().__init__(capacity, store)
        self.kin = max(1, int(capacity * kin_frac))
        self.kout = max(1, int(capacity * kout_frac))
        self.a1out: OrderedDict[int, None] = OrderedDict()
        self.n_in = 0
        self.n_am = 0

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        if self.slabs.queue[s] == 2:
            self.slabs.seq[s] = self._tick()
            self.slabs.touch(s)
        # hits in A1in leave position unchanged (2Q semantics)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        vals = self._tick_n(len(slots))
        am = self.slabs.queue[slots] == 2
        if am.any():
            u = _assign_last(self.slabs.seq, slots[am], vals[am])
            self.slabs.touch_rows(u)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        if cid in self.a1out:
            del self.a1out[cid]
            self.slabs.queue[s] = 2
            self.n_am += 1
        else:
            self.slabs.queue[s] = 1
            self.n_in += 1
        self.slabs.seq[s] = self._tick()
        self.slabs.touch(s)

    def victim(self, t):
        queue, seq = self.slabs.queue, self.slabs.seq
        if (self.n_in > self.kin or not self.n_am) and self.n_in:
            vslot = int(np.where(queue == 1, seq, _SEQ0).argmin())
            cid = int(self.store.cid[vslot])
            self.a1out[cid] = None
            while len(self.a1out) > self.kout:
                self.a1out.popitem(last=False)
            self.n_in -= 1
        else:
            vslot = int(np.where(queue == 2, seq, _SEQ0).argmin())
            cid = int(self.store.cid[vslot])
            self.n_am -= 1
        queue[vslot] = 0
        self.slabs.touch(vslot)
        return cid


class LRU2Policy(ArrayPolicy):
    """LRU-2 (O'Neil et al.): evict max backward-2nd-access distance."""
    name = "LRU-2"
    slab_spec = {"k2": (np.int64, _SEQ0), "last": (np.int64, 0)}

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.k2[s] = self.slabs.last[s]
        self.slabs.last[s] = t
        self.slabs.touch(s)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.k2[s] = -10**9                  # no 2nd-to-last yet
        self.slabs.last[s] = t
        self.slabs.touch(s)

    def victim_scores(self, t):
        return self.store.occ, (self.slabs.k2, self.slabs.last,
                                self.store.cid)

    def victim(self, t):
        k2 = self.slabs.k2
        vslot = _lex_argmin_nomask(k2, self.slabs.last, self.store.cid)
        k2[vslot] = _SEQ0              # sentinel-forget
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])


class GDSFPolicy(ArrayPolicy):
    """GreedyDual-Size-Frequency with unit size/cost: H = L + freq."""
    name = "GDSF"
    slab_spec = {"freq": (np.int64, 0), "h": (np.float64, INF),
                 "stamp": (np.int64, _SEQ0)}

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.L = 0.0

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.freq[s] += 1
        self.slabs.h[s] = self.L + self.slabs.freq[s]
        self.slabs.stamp[s] = self._tick()
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        np.add.at(self.slabs.freq, slots, 1)
        u = _assign_last(self.slabs.stamp, slots, self._tick_n(len(slots)))
        self.slabs.h[u] = self.L + self.slabs.freq[u]
        self.slabs.touch_rows(u)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.freq[s] = 1
        self.slabs.h[s] = self.L + 1.0
        self.slabs.stamp[s] = self._tick()
        self.slabs.touch(s)

    def victim_scores(self, t):
        return self.store.occ, (self.slabs.h, self.slabs.stamp)

    def victim(self, t):
        h = self.slabs.h
        vslot = _lex_argmin_nomask(h, self.slabs.stamp)   # free slots: +inf
        self.L = float(h[vslot])
        h[vslot] = INF                 # sentinel-forget
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])


class LHDPolicy(ArrayPolicy):
    """LHD (Beckmann et al., NSDI'18), simplified with sampling.

    Hit density per log2-age class is estimated online from observed hit /
    eviction ages; eviction samples ``n_sample`` residents and removes the
    minimum-density one.  The sampling order (and hence the rng stream)
    replicates the historical swap-remove key list exactly.
    """
    name = "LHD"
    N_CLASSES = 32
    slab_spec = {"last": (np.int64, 0)}

    def __init__(self, capacity, store=None, n_sample: int = 64, seed: int = 0,
                 **kw):
        super().__init__(capacity, store)
        self.n_sample = n_sample
        self.rng = random.Random(seed)
        self.keys: list[int] = []
        self.pos: dict[int, int] = {}
        self.hit_age = np.ones(self.N_CLASSES)
        self.ev_age = np.ones(self.N_CLASSES)

    @staticmethod
    def _cls(age: int) -> int:
        return min(LHDPolicy.N_CLASSES - 1, max(0, int(np.log2(age + 1))))

    def _cls_vec(self, ages: np.ndarray) -> np.ndarray:
        return np.minimum(self.N_CLASSES - 1,
                          np.maximum(0, np.log2(ages + 1).astype(np.int64)))

    def _add(self, cid):
        self.pos[cid] = len(self.keys)
        self.keys.append(cid)

    def _del(self, cid):
        i = self.pos.pop(cid)
        last = self.keys.pop()
        if last != cid:
            self.keys[i] = last
            self.pos[last] = i

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.hit_age[self._cls(t - self.slabs.last[s])] += 1
        self.slabs.last[s] = t
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        if np.unique(slots).size != slots.size:
            # an age depends on the previous touch of the same slot —
            # duplicate slots need the sequential order
            return Policy.on_hit_batch(self, cids, reqs, ts)
        ages = np.asarray(ts, dtype=np.int64) - self.slabs.last[slots]
        np.add.at(self.hit_age, self._cls_vec(ages), 1)
        self.slabs.last[slots] = ts
        self.slabs.touch_rows(slots)

    def on_admit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.last[s] = t
        self.slabs.touch(s)
        self._add(cid)

    def _sample(self, n: int) -> list[int]:
        """``n_sample`` draws of ``rng.randrange(n)``, consuming the exact
        bit stream ``random.Random._randbelow_with_getrandbits`` would —
        bit-identical samples to ``rng.randrange``, minus two Python frames
        per draw."""
        getrandbits = self.rng.getrandbits
        k = n.bit_length()
        keys = self.keys
        out = []
        for _ in range(self.n_sample):
            r = getrandbits(k)
            while r >= n:
                r = getrandbits(k)
            out.append(keys[r])
        return out

    def victim(self, t):
        n = len(self.keys)
        sample = self.keys if n <= self.n_sample else self._sample(n)
        cids = np.fromiter(sample, dtype=np.int64, count=len(sample))
        slots = self._slots(sample)
        last = self.slabs.last[slots]
        ages = t - last
        c = self._cls_vec(ages)
        p_hit = self.hit_age[c] / (self.hit_age[c] + self.ev_age[c])
        dens = p_hit / (ages + 1.0)
        # historical min(sample, key=(density, -last, cid)) — full ties
        # only occur between duplicate samples of one cid
        i = _lex_argmin(np.ones(len(sample), dtype=bool), dens, -last, cids)
        cid = int(cids[i])
        self.ev_age[self._cls(t - int(last[i]))] += 1
        self._del(cid)
        return cid


class LeCaRPolicy(ArrayPolicy):
    """LeCaR (Vietri et al., HotStorage'18): regret-weighted LRU/LFU experts."""
    name = "LeCaR"
    slab_spec = {"seq": (np.int64, _SEQ0), "freq": (np.int64, _SEQ0)}

    def __init__(self, capacity, store=None, learning_rate=0.45,
                 discount=None, seed=0, **kw):
        super().__init__(capacity, store)
        self.lr = learning_rate
        self.d = discount if discount is not None else 0.005 ** (1.0 / capacity)
        self.w = np.array([0.5, 0.5])            # [LRU, LFU]
        self.rng = random.Random(seed)
        self.h_lru: OrderedDict[int, int] = OrderedDict()   # ghost: cid -> evict t
        self.h_lfu: OrderedDict[int, int] = OrderedDict()

    def _reward(self, ghost: OrderedDict, idx: int, cid: int, t: int):
        if cid in ghost:
            dt = t - ghost.pop(cid)
            r = self.d ** dt
            upd = np.ones(2)
            upd[idx] = np.exp(-self.lr * r)      # penalize the expert at fault
            self.w = self.w * upd
            self.w = self.w / self.w.sum()

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.freq[s] += 1
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        np.add.at(self.slabs.freq, slots, 1)
        u = _assign_last(self.slabs.seq, slots, self._tick_n(len(slots)))
        self.slabs.touch_rows(u)

    def on_admit(self, cid, req, t):
        self._reward(self.h_lru, 0, cid, t)
        self._reward(self.h_lfu, 1, cid, t)
        s = self._slot(cid)
        self.slabs.seq[s] = self._tick()
        self.slabs.freq[s] = 1
        self.slabs.touch(s)

    def victim(self, t):
        seq, freq = self.slabs.seq, self.slabs.freq
        use_lru = self.rng.random() < self.w[0]
        if use_lru:
            vslot = int(seq.argmin())  # sentinel-forget: free slots = _SEQ0
            cid = int(self.store.cid[vslot])
            self.h_lru[cid] = t
            while len(self.h_lru) > self.capacity:
                self.h_lru.popitem(last=False)
        else:
            vslot = _lex_argmin_nomask(freq, self.store.cid)
            cid = int(self.store.cid[vslot])
            self.h_lfu[cid] = t
            while len(self.h_lfu) > self.capacity:
                self.h_lfu.popitem(last=False)
        seq[vslot] = _SEQ0
        freq[vslot] = _SEQ0
        self.slabs.touch(vslot)
        return cid


class BeladyPolicy(ArrayPolicy):
    """Belady's MIN — offline optimal; uses precomputed next-use indices.

    The slab stores the NEGATED farthest-next-use key, so the max-distance
    victim is a plain lexicographic argmin under the sentinel-forget
    invariant (free slots hold ``_SEQ0``, above every real ``-key``)."""
    name = "Belady"
    requires_future = True
    slab_spec = {"negkey": (np.int64, _SEQ0)}

    _NEVER = 10 ** 12                            # never-used-again = farthest

    @classmethod
    def _key(cls, nu: int) -> int:
        return cls._NEVER if nu < 0 else nu

    def on_hit(self, cid, req, t):
        s = self._slot(cid)
        self.slabs.negkey[s] = -self._key(req.next_use)
        self.slabs.touch(s)

    def on_hit_batch(self, cids, reqs, ts):
        slots = self._slots(cids)
        nus = np.fromiter((r.next_use for r in reqs), dtype=np.int64,
                          count=len(reqs))
        vals = np.where(nus < 0, -self._NEVER, -nus)
        u = _assign_last(self.slabs.negkey, slots, vals)
        self.slabs.touch_rows(u)

    on_admit = on_hit

    def victim_scores(self, t):
        return self.store.occ, (self.slabs.negkey, self.store.cid)

    def victim(self, t):
        negkey = self.slabs.negkey
        vslot = _lex_argmin_nomask(negkey, self.store.cid)
        negkey[vslot] = _SEQ0          # sentinel-forget
        self.slabs.touch(vslot)
        return int(self.store.cid[vslot])


class RandomPolicy(ArrayPolicy):
    name = "RANDOM"

    def __init__(self, capacity, store=None, seed=0, **kw):
        super().__init__(capacity, store)
        self.rng = random.Random(seed)
        self.keys: list[int] = []
        self.pos: dict[int, int] = {}

    def on_hit(self, cid, req, t):
        pass

    def on_hit_batch(self, cids, reqs, ts):
        pass

    def on_admit(self, cid, req, t):
        self.pos[cid] = len(self.keys)
        self.keys.append(cid)

    def victim(self, t):
        i = self.rng.randrange(len(self.keys))
        cid = self.keys[i]
        last = self.keys.pop()
        if last != cid:
            self.keys[i] = last
            self.pos[last] = i
        del self.pos[cid]
        return cid


BASELINES: dict[str, type[Policy]] = {
    p.name: p for p in [
        FIFOPolicy, LRUPolicy, CLOCKPolicy, TTLPolicy, LFUPolicy,
        TinyLFUPolicy, ARCPolicy, S3FIFOPolicy, SIEVEPolicy, TwoQPolicy,
        LRU2Policy, GDSFPolicy, LHDPolicy, LeCaRPolicy, BeladyPolicy,
        RandomPolicy,
    ]
}

#: baselines whose decisions consume randomness (seed-threading targets)
RNG_BASELINES = frozenset({"TinyLFU", "LHD", "LeCaR", "RANDOM"})
