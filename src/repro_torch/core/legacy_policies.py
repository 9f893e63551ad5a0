"""Legacy host-loop baseline policies — the frozen parity oracle, the
port's copy of ``repro/core/legacy_policies.py`` (host numpy, unchanged).

This module preserves the historical per-request implementations of every
baseline (OrderedDict / heap / deque state, scalar ``on_hit`` / ``on_admit``
/ ``victim``) exactly as they ran before the array-state refactor of
:mod:`repro_torch.core.policies`.  They are NOT used by the replay drivers;
they exist so tests can assert that each vectorized array-state policy
makes bit-identical hit/miss/eviction decisions to its host-loop
counterpart.  Do not "improve" these classes: their value is that they
never change.

``LEGACY_BASELINES`` mirrors :data:`repro_torch.core.policies.BASELINES`
name for name.  ``TinyLFUPolicy`` takes the same ``seed`` kwarg as the
array version (feeding the count-min sketch salt) so seeded runs stay
comparable.
"""
from __future__ import annotations

import heapq
import random
from collections import OrderedDict, deque

import numpy as np

from .policies import INF, Policy, _CountMinSketch

class FIFOPolicy(Policy):
    name = "FIFO"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.q: deque[int] = deque()

    def on_hit(self, cid, req, t):
        pass

    def on_admit(self, cid, req, t):
        self.q.append(cid)

    def victim(self, t):
        return self.q.popleft()


class LRUPolicy(Policy):
    name = "LRU"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.od: OrderedDict[int, None] = OrderedDict()

    def on_hit(self, cid, req, t):
        self.od.move_to_end(cid)

    def on_admit(self, cid, req, t):
        self.od[cid] = None

    def victim(self, t):
        cid, _ = self.od.popitem(last=False)
        return cid


class CLOCKPolicy(Policy):
    name = "CLOCK"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.ring: OrderedDict[int, bool] = OrderedDict()  # cid -> ref bit

    def on_hit(self, cid, req, t):
        self.ring[cid] = True

    def on_admit(self, cid, req, t):
        self.ring[cid] = False

    def victim(self, t):
        # sweep: give second chance to referenced entries
        while True:
            cid, ref = next(iter(self.ring.items()))
            if ref:
                self.ring[cid] = False
                self.ring.move_to_end(cid)
            else:
                del self.ring[cid]
                return cid


class TTLPolicy(Policy):
    """Expire-first (admit time + ttl), LRU among the unexpired."""
    name = "TTL"

    def __init__(self, capacity, store=None, ttl: int = 2000, **kw):
        super().__init__(capacity, store)
        self.ttl = ttl
        self.od: OrderedDict[int, None] = OrderedDict()
        self.deadline: dict[int, int] = {}

    def on_hit(self, cid, req, t):
        self.od.move_to_end(cid)

    def on_admit(self, cid, req, t):
        self.od[cid] = None
        self.deadline[cid] = t + self.ttl

    def victim(self, t):
        expired = [c for c in self.od if self.deadline[c] <= t]
        if expired:
            cid = min(expired, key=lambda c: self.deadline[c])
        else:
            cid = next(iter(self.od))
        del self.od[cid]
        del self.deadline[cid]
        return cid


class LFUPolicy(Policy):
    """LFU with LRU tie-break (lazy heap)."""
    name = "LFU"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.freq: dict[int, int] = {}
        self.stamp: dict[int, int] = {}
        self.heap: list[tuple[int, int, int]] = []   # (freq, stamp, cid)
        self._n = 0

    def _touch(self, cid, t):
        self._n += 1
        self.stamp[cid] = self._n
        heapq.heappush(self.heap, (self.freq[cid], self._n, cid))

    def on_hit(self, cid, req, t):
        self.freq[cid] += 1
        self._touch(cid, t)

    def on_admit(self, cid, req, t):
        self.freq[cid] = 1
        self._touch(cid, t)

    def victim(self, t):
        while True:
            f, s, cid = heapq.heappop(self.heap)
            if cid in self.freq and self.freq[cid] == f and self.stamp[cid] == s:
                del self.freq[cid]
                del self.stamp[cid]
                return cid


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


class TinyLFUPolicy(Policy):
    """TinyLFU admission over an LRU main cache (simplified W-TinyLFU).

    Admission control is expressed through victim selection: the newly
    inserted entry itself is evicted when its sketch frequency does not beat
    the main cache's LRU victim.
    """
    name = "TinyLFU"

    def __init__(self, capacity, store=None, seed: int = 0, **kw):
        super().__init__(capacity, store)
        self.od: OrderedDict[int, None] = OrderedDict()
        self.sketch = _CountMinSketch(width=capacity * 8, seed=7 + seed)
        self.window: deque[int] = deque()         # recent admissions (window)
        self.window_size = max(1, capacity // 100)

    def on_hit(self, cid, req, t):
        self.sketch.add(cid)
        self.od.move_to_end(cid)

    def on_admit(self, cid, req, t):
        self.sketch.add(cid)
        self.od[cid] = None
        self.window.append(cid)
        while len(self.window) > self.window_size:
            self.window.popleft()

    def victim(self, t):
        newest = next(reversed(self.od))
        oldest = next(iter(self.od))
        if newest in self.window and newest != oldest:
            # admission duel: candidate vs main LRU victim
            if self.sketch.estimate(newest) > self.sketch.estimate(oldest):
                del self.od[oldest]
                return oldest
            del self.od[newest]
            return newest
        del self.od[oldest]
        return oldest


class ARCPolicy(Policy):
    """Adaptive Replacement Cache (Megiddo & Modha, FAST'03)."""
    name = "ARC"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.p = 0.0
        self.t1: OrderedDict[int, None] = OrderedDict()
        self.t2: OrderedDict[int, None] = OrderedDict()
        self.b1: OrderedDict[int, None] = OrderedDict()
        self.b2: OrderedDict[int, None] = OrderedDict()

    def on_hit(self, cid, req, t):
        if cid in self.t1:
            del self.t1[cid]
            self.t2[cid] = None
        else:
            self.t2.move_to_end(cid)

    def on_admit(self, cid, req, t):
        c = self.capacity
        if cid in self.b1:
            self.p = min(c, self.p + max(1.0, len(self.b2) / max(1, len(self.b1))))
            del self.b1[cid]
            self.t2[cid] = None
        elif cid in self.b2:
            self.p = max(0.0, self.p - max(1.0, len(self.b1) / max(1, len(self.b2))))
            del self.b2[cid]
            self.t2[cid] = None
        else:
            l1 = len(self.t1) + len(self.b1)
            if l1 >= c:
                if self.b1:
                    self.b1.popitem(last=False)
            elif l1 + len(self.t2) + len(self.b2) >= 2 * c:
                if self.b2:
                    self.b2.popitem(last=False)
            self.t1[cid] = None

    def victim(self, t):
        if self.t1 and (len(self.t1) > self.p or not self.t2):
            cid, _ = self.t1.popitem(last=False)
            self.b1[cid] = None
        else:
            cid, _ = self.t2.popitem(last=False)
            self.b2[cid] = None
        # bound ghost lists
        while len(self.b1) > self.capacity:
            self.b1.popitem(last=False)
        while len(self.b2) > self.capacity:
            self.b2.popitem(last=False)
        return cid


class S3FIFOPolicy(Policy):
    """S3-FIFO (Yang et al., SOSP'23 / NSDI'23): small + main + ghost FIFOs."""
    name = "S3-FIFO"

    def __init__(self, capacity, store=None, small_frac: float = 0.1, **kw):
        super().__init__(capacity, store)
        self.small_cap = max(1, int(capacity * small_frac))
        self.small: deque[int] = deque()
        self.main: deque[int] = deque()
        self.ghost: OrderedDict[int, None] = OrderedDict()
        self.freq: dict[int, int] = {}
        self.in_main: set[int] = set()

    def on_hit(self, cid, req, t):
        self.freq[cid] = min(3, self.freq.get(cid, 0) + 1)

    def on_admit(self, cid, req, t):
        self.freq[cid] = 0
        if cid in self.ghost:
            del self.ghost[cid]
            self.main.append(cid)
            self.in_main.add(cid)
        else:
            self.small.append(cid)

    def _evict_main(self) -> int:
        while True:
            cid = self.main.popleft()
            if cid not in self.in_main:
                continue
            if self.freq.get(cid, 0) > 0:
                self.freq[cid] -= 1
                self.main.append(cid)
            else:
                self.in_main.discard(cid)
                self.freq.pop(cid, None)
                return cid

    def victim(self, t):
        if len(self.small) > self.small_cap or not self.main:
            while self.small:
                cid = self.small.popleft()
                if self.freq.get(cid, 0) > 1:
                    self.main.append(cid)       # promote
                    self.in_main.add(cid)
                    self.freq[cid] = 0
                else:
                    self.ghost[cid] = None
                    while len(self.ghost) > self.capacity:
                        self.ghost.popitem(last=False)
                    self.freq.pop(cid, None)
                    return cid
        return self._evict_main()


class SIEVEPolicy(Policy):
    """SIEVE (Zhang et al., NSDI'24): FIFO queue + moving hand + visited bits."""
    name = "SIEVE"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.order: OrderedDict[int, bool] = OrderedDict()  # head=oldest
        self.hand: int | None = None                         # cid at hand

    def on_hit(self, cid, req, t):
        self.order[cid] = True

    def on_admit(self, cid, req, t):
        self.order[cid] = False   # insert at tail (newest)

    def victim(self, t):
        keys = list(self.order.keys())
        idx = keys.index(self.hand) if self.hand in self.order else 0
        n = len(keys)
        for _ in range(2 * n + 1):
            cid = keys[idx % n]
            if cid not in self.order:
                idx += 1
                continue
            if self.order[cid]:
                self.order[cid] = False
                idx += 1
            else:
                nxt = keys[(idx + 1) % n]
                self.hand = nxt if nxt != cid else None
                del self.order[cid]
                return cid
        cid, _ = self.order.popitem(last=False)   # fallback (unreachable)
        return cid


class TwoQPolicy(Policy):
    """2Q (Johnson & Shasha, VLDB'94): A1in FIFO + A1out ghost + Am LRU."""
    name = "2Q"

    def __init__(self, capacity, store=None, kin_frac=0.25, kout_frac=0.5, **kw):
        super().__init__(capacity, store)
        self.kin = max(1, int(capacity * kin_frac))
        self.kout = max(1, int(capacity * kout_frac))
        self.a1in: deque[int] = deque()
        self.a1out: OrderedDict[int, None] = OrderedDict()
        self.am: OrderedDict[int, None] = OrderedDict()
        self.in_a1in: set[int] = set()

    def on_hit(self, cid, req, t):
        if cid in self.am:
            self.am.move_to_end(cid)
        # hits in A1in leave position unchanged (2Q semantics)

    def on_admit(self, cid, req, t):
        if cid in self.a1out:
            del self.a1out[cid]
            self.am[cid] = None
        else:
            self.a1in.append(cid)
            self.in_a1in.add(cid)

    def victim(self, t):
        if len(self.a1in) > self.kin or not self.am:
            while self.a1in:
                cid = self.a1in.popleft()
                if cid in self.in_a1in:
                    self.in_a1in.discard(cid)
                    self.a1out[cid] = None
                    while len(self.a1out) > self.kout:
                        self.a1out.popitem(last=False)
                    return cid
        cid, _ = self.am.popitem(last=False)
        return cid


class LRU2Policy(Policy):
    """LRU-2 (O'Neil et al.): evict max backward-2nd-access distance."""
    name = "LRU-2"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.hist: dict[int, tuple[int, int]] = {}   # cid -> (t_prev, t_last)
        self.heap: list[tuple[int, int, int]] = []   # (k2_time, t_last, cid)

    def _push(self, cid):
        k2, last = self.hist[cid]
        heapq.heappush(self.heap, (k2, last, cid))

    def on_hit(self, cid, req, t):
        _, last = self.hist[cid]
        self.hist[cid] = (last, t)
        self._push(cid)

    def on_admit(self, cid, req, t):
        self.hist[cid] = (-10**9, t)                 # no 2nd-to-last yet
        self._push(cid)

    def victim(self, t):
        while True:
            k2, last, cid = heapq.heappop(self.heap)
            if cid in self.hist and self.hist[cid] == (k2, last):
                del self.hist[cid]
                return cid


class GDSFPolicy(Policy):
    """GreedyDual-Size-Frequency with unit size/cost: H = L + freq."""
    name = "GDSF"

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.L = 0.0
        self.freq: dict[int, int] = {}
        self.h: dict[int, float] = {}
        self.heap: list[tuple[float, int, int]] = []
        self._n = 0

    def _push(self, cid):
        self._n += 1
        heapq.heappush(self.heap, (self.h[cid], self._n, cid))

    def on_hit(self, cid, req, t):
        self.freq[cid] += 1
        self.h[cid] = self.L + self.freq[cid]
        self._push(cid)

    def on_admit(self, cid, req, t):
        self.freq[cid] = 1
        self.h[cid] = self.L + 1.0
        self._push(cid)

    def victim(self, t):
        while True:
            h, _, cid = heapq.heappop(self.heap)
            if cid in self.h and self.h[cid] == h:
                self.L = h
                del self.h[cid]
                del self.freq[cid]
                return cid


class LHDPolicy(Policy):
    """LHD (Beckmann et al., NSDI'18), simplified with sampling.

    Hit density per log2-age class is estimated online from observed hit /
    eviction ages; eviction samples ``n_sample`` residents and removes the
    minimum-density one (as in the paper's implementation).
    """
    name = "LHD"
    N_CLASSES = 32

    def __init__(self, capacity, store=None, n_sample: int = 64, seed: int = 0, **kw):
        super().__init__(capacity, store)
        self.n_sample = n_sample
        self.rng = random.Random(seed)
        self.last: dict[int, int] = {}
        self.keys: list[int] = []
        self.pos: dict[int, int] = {}
        self.hit_age = np.ones(self.N_CLASSES)
        self.ev_age = np.ones(self.N_CLASSES)

    @staticmethod
    def _cls(age: int) -> int:
        return min(LHDPolicy.N_CLASSES - 1, max(0, int(np.log2(age + 1))))

    def _density(self, cid: int, t: int) -> float:
        age = t - self.last[cid]
        c = self._cls(age)
        p_hit = self.hit_age[c] / (self.hit_age[c] + self.ev_age[c])
        exp_life = (age + 1.0)
        return p_hit / exp_life

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
        self.hit_age[self._cls(t - self.last[cid])] += 1
        self.last[cid] = t

    def on_admit(self, cid, req, t):
        self.last[cid] = t
        self._add(cid)

    def victim(self, t):
        n = len(self.keys)
        sample = (self.keys if n <= self.n_sample
                  else [self.keys[self.rng.randrange(n)] for _ in range(self.n_sample)])
        cid = min(sample, key=lambda c: (self._density(c, t), -self.last[c], c))
        self.ev_age[self._cls(t - self.last[cid])] += 1
        self._del(cid)
        del self.last[cid]
        return cid


class LeCaRPolicy(Policy):
    """LeCaR (Vietri et al., HotStorage'18): regret-weighted LRU/LFU experts."""
    name = "LeCaR"

    def __init__(self, capacity, store=None, learning_rate=0.45,
                 discount=None, seed=0, **kw):
        super().__init__(capacity, store)
        self.lr = learning_rate
        self.d = discount if discount is not None else 0.005 ** (1.0 / capacity)
        self.w = np.array([0.5, 0.5])            # [LRU, LFU]
        self.rng = random.Random(seed)
        self.lru: OrderedDict[int, None] = OrderedDict()
        self.freq: dict[int, int] = {}
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
        self.lru.move_to_end(cid)
        self.freq[cid] += 1

    def on_admit(self, cid, req, t):
        self._reward(self.h_lru, 0, cid, t)
        self._reward(self.h_lfu, 1, cid, t)
        self.lru[cid] = None
        self.freq[cid] = 1

    def victim(self, t):
        use_lru = self.rng.random() < self.w[0]
        if use_lru:
            cid = next(iter(self.lru))
            self.h_lru[cid] = t
            while len(self.h_lru) > self.capacity:
                self.h_lru.popitem(last=False)
        else:
            cid = min(self.freq, key=lambda c: (self.freq[c], c))
            self.h_lfu[cid] = t
            while len(self.h_lfu) > self.capacity:
                self.h_lfu.popitem(last=False)
        del self.lru[cid]
        del self.freq[cid]
        return cid


class BeladyPolicy(Policy):
    """Belady's MIN — offline optimal; uses precomputed next-use indices."""
    name = "Belady"
    requires_future = True

    def __init__(self, capacity, store=None, **kw):
        super().__init__(capacity, store)
        self.next_use: dict[int, int] = {}
        self.heap: list[tuple[int, int]] = []    # (-next_use_key, cid)

    @staticmethod
    def _key(nu: int) -> int:
        return 10 ** 12 if nu < 0 else nu        # never-used-again = farthest

    def _record(self, cid, req):
        self.next_use[cid] = req.next_use
        heapq.heappush(self.heap, (-self._key(req.next_use), cid))

    def on_hit(self, cid, req, t):
        self._record(cid, req)

    def on_admit(self, cid, req, t):
        self._record(cid, req)

    def victim(self, t):
        while True:
            negk, cid = heapq.heappop(self.heap)
            if cid in self.next_use and -negk == self._key(self.next_use[cid]):
                del self.next_use[cid]
                return cid


class RandomPolicy(Policy):
    name = "RANDOM"

    def __init__(self, capacity, store=None, seed=0, **kw):
        super().__init__(capacity, store)
        self.rng = random.Random(seed)
        self.keys: list[int] = []
        self.pos: dict[int, int] = {}

    def on_hit(self, cid, req, t):
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


LEGACY_BASELINES: dict[str, type[Policy]] = {
    p.name: p for p in [
        FIFOPolicy, LRUPolicy, CLOCKPolicy, TTLPolicy, LFUPolicy,
        TinyLFUPolicy, ARCPolicy, S3FIFOPolicy, SIEVEPolicy, TwoQPolicy,
        LRU2Policy, GDSFPolicy, LHDPolicy, LeCaRPolicy, BeladyPolicy,
        RandomPolicy,
    ]
}
