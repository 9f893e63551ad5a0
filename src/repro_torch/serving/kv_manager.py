"""RAC-scored paged KV-block manager (the paper's KV-cache instantiation).

Prefix blocks form a radix tree (SGLang-style): a cached prefix of tokens
maps to a chain of fixed-size blocks; a new request reuses the longest
cached prefix ("compositional content equivalence", paper §2).  Eviction
under block pressure uses RAC's Value = TP(topic)·TSI(block):

  - each *root* block routes to a topic by its conversation; child blocks
    inherit the topic (a conversation = a topic episode);
  - the radix parent edge IS the dependency link — dep(parent) accumulates
    child hit mass exactly as Alg. 3 does via DetectParent;
  - structural validity (SGLang: children must be evicted before parents)
    is preserved by masking blocks with live children out of the victim
    scan — RAC's TSI already biases the same way (Theorem 1), the mask
    makes it a hard constraint.

:class:`KVBlockManager` is built ON the unified cache facade: it owns the
radix *tree* (token keys, prefix matching) but delegates residency,
admission, eviction scoring, payloads, metrics, and hooks to a
content-mode :class:`repro_torch.cache.SemanticCache` running
:class:`repro_torch.core.radix.RadixRACPolicy`.  Victim selection is one
batched ``rac_value_masked`` call through the cache backend: on the
``"kernel"`` backend (the default) one B3 launch with the children-first
mask applied in the kernel, on the card by default (``device="cpu"`` runs
the kernel's plain version); ``backend="numpy"`` is the float64 host
oracle.  Block eviction and response eviction share one
metrics/hook/checkpoint surface and one scoring path.

:class:`LegacyKVBlockManager` is the original self-contained host
implementation, kept as the decision-parity oracle.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np

from repro_torch.cache import CacheConfig, SemanticCache


@dataclasses.dataclass
class Block:
    bid: int
    parent: int                  # -1 for root
    tokens: tuple                # the token slice this block covers
    topic: int = -1
    freq: float = 0.0
    dep: float = 0.0
    last_t: int = -1
    children: set = dataclasses.field(default_factory=set)

    @property
    def tsi(self) -> float:
        return self.freq + self.dep


class KVBlockManager:
    """Radix prefix-block cache behind the :class:`SemanticCache` facade.

    The manager walks/updates the radix indexes; every residency decision
    (hit bookkeeping, admission, victim election) goes through the
    facade.  Block ids are monotone uids — ``blocks``/``root_index``/
    ``child_index`` mirror the tree for prefix matching and tests; the
    authoritative scoring state lives in the policy's slabs.
    """

    def __init__(self, n_blocks: int, block_tokens: int = 16, *,
                 alpha: float = 0.001, lam: float = 2.0,
                 backend: str = "kernel", device: str = "cuda"):
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.cache = SemanticCache(CacheConfig(
            capacity=n_blocks, dim=1, hit_mode="content",
            backend=backend, policy="RadixRAC", device=device,
            policy_kwargs={"alpha": alpha, "lam": lam}))
        self._emb = np.zeros(1, dtype=np.float32)   # content mode: unused
        self.blocks: dict[int, Block] = {}
        self.root_index: dict[tuple, int] = {}     # token-slice -> root bid
        self.child_index: dict[tuple[int, tuple], int] = {}
        self._next_bid = 0
        self._evicted_now: list[int] = []          # victims, current request
        self.t = 0
        self.cache.subscribe("evict", self._on_evict)

    @property
    def policy(self):
        return self.cache.policy

    @property
    def used(self) -> int:
        return len(self.cache)

    # -- prefix match / insert --------------------------------------------
    def match_prefix(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached block-chain prefix.  Returns (bids, n_tokens)."""
        bids: list[int] = []
        pos = 0
        parent = -1
        while pos + self.block_tokens <= len(tokens):
            key = tuple(tokens[pos:pos + self.block_tokens])
            bid = (self.root_index.get(key) if parent < 0
                   else self.child_index.get((parent, key)))
            if bid is None:
                break
            bids.append(bid)
            parent = bid
            pos += self.block_tokens
        return bids, pos

    def on_request(self, tokens: list[int], topic: int | None = None) -> dict:
        """Serve one request's prefix: hit blocks get Alg.3 updates through
        the facade; missing blocks are admitted (evicting by Value when
        full).  Returns hit/new block ids plus the victims this request
        caused."""
        self.t += 1
        bids, pos = self.match_prefix(tokens)
        hit_tokens = pos
        # topic: from the matched root or a fresh label per new conversation
        tpc = self.blocks[bids[0]].topic if bids else topic
        tpc = self.policy.touch_topic(tpc, self.t)       # Alg. 2, once/request
        self._evicted_now = []
        for bid in bids:                      # hits: the facade drives the
            self.cache.lookup(self._emb, cid=bid, t=self.t)   # Alg.3 cascade
        parent = bids[-1] if bids else -1
        new_bids = []
        while pos + self.block_tokens <= len(tokens):
            key = tuple(tokens[pos:pos + self.block_tokens])
            bid = self._alloc(parent, key, tpc)
            if bid < 0:
                break                          # no evictable block
            new_bids.append(bid)
            parent = bid
            pos += self.block_tokens
        return {"hit_blocks": bids, "new_blocks": new_bids,
                "hit_tokens": hit_tokens, "topic": tpc,
                "evicted": self._evicted_now}

    def _alloc(self, parent: int, key: tuple, topic: int) -> int:
        bid = self._next_bid
        self._next_bid += 1
        self.cache.lookup(self._emb, cid=bid, t=self.t)   # charge the miss
        self.policy.stage(topic=topic, parent=parent)
        evicted = self.cache.admit(bid, self._emb, payload=key, t=self.t)
        self.policy.protect.clear()
        if bid in evicted:
            return -1            # every block structurally protected: fail
        # the mirror records STRUCTURE only (tokens/parent/children/topic
        # for prefix matching); freq/dep/last_t live in the policy slabs
        b = Block(bid=bid, parent=parent, tokens=key, topic=topic)
        self.blocks[bid] = b
        if parent < 0:
            self.root_index[key] = bid
        else:
            self.child_index[(parent, key)] = bid
            p = self.blocks.get(parent)
            if p is not None:
                p.children.add(bid)
        return bid

    # -- checkpoint/restore ------------------------------------------------
    def checkpoint(self) -> dict:
        """Snapshot the facade state AND the radix mirror together (the
        facade's checkpoint alone would leave the mirror claiming prefix
        hits for blocks the restored cache no longer holds)."""
        return {"cache": self.cache.checkpoint(),
                "mirror": copy.deepcopy(
                    (self.blocks, self.root_index, self.child_index,
                     self._next_bid, self.t))}

    def restore(self, state: dict):
        self.cache.restore(state["cache"])
        (self.blocks, self.root_index, self.child_index,
         self._next_bid, self.t) = copy.deepcopy(state["mirror"])

    def _on_evict(self, ev):
        """Facade victim applied: prune the radix mirror."""
        b = self.blocks.pop(ev.cid, None)
        if b is None:
            return                            # self-evicted fresh block
        self._evicted_now.append(ev.cid)
        if b.parent >= 0:
            self.child_index.pop((b.parent, b.tokens), None)
            p = self.blocks.get(b.parent)
            if p is not None:
                p.children.discard(ev.cid)
        else:
            self.root_index.pop(b.tokens, None)


class LegacyKVBlockManager:
    """The pre-facade host implementation (self-contained TP/TSI scoring
    over host dicts).  Kept verbatim as the parity oracle for the
    facade-routed manager."""

    def __init__(self, n_blocks: int, block_tokens: int = 16, *,
                 alpha: float = 0.001, lam: float = 2.0):
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.alpha = alpha
        self.lam = lam
        self.blocks: dict[int, Block] = {}
        self.root_index: dict[tuple, int] = {}     # token-slice -> root bid
        self.child_index: dict[tuple[int, tuple], int] = {}
        self.free: list[int] = list(range(n_blocks - 1, -1, -1))
        # topic TP state (persistent, Alg. 2 Data)
        self.tp_last: dict[int, float] = {}
        self.t_last: dict[int, int] = {}
        self.t = 0

    # -- topic handling (one conversation root = one topic) ---------------
    def _refresh_tp(self, topic: int):
        tp = self.tp_last.get(topic, 0.0)
        tl = self.t_last.get(topic, self.t)
        self.tp_last[topic] = 0.5 ** (self.alpha * (self.t - tl)) * tp + 1.0
        self.t_last[topic] = self.t

    def tp_now(self, topic: int) -> float:
        tp = self.tp_last.get(topic, 0.0)
        tl = self.t_last.get(topic, self.t)
        return 0.5 ** (self.alpha * (self.t - tl)) * tp

    # -- prefix match / insert --------------------------------------------
    def match_prefix(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached block-chain prefix.  Returns (bids, n_tokens)."""
        bids: list[int] = []
        pos = 0
        parent = -1
        while pos + self.block_tokens <= len(tokens):
            key = tuple(tokens[pos:pos + self.block_tokens])
            bid = (self.root_index.get(key) if parent < 0
                   else self.child_index.get((parent, key)))
            if bid is None:
                break
            bids.append(bid)
            parent = bid
            pos += self.block_tokens
        return bids, pos

    def on_request(self, tokens: list[int], topic: int | None = None) -> dict:
        """Serve one request's prefix: hit blocks get Alg.3 updates; missing
        blocks are allocated (evicting by Value when full)."""
        self.t += 1
        bids, pos = self.match_prefix(tokens)
        hit_tokens = pos
        # topic: from the matched root or a fresh label per new conversation
        if bids:
            tpc = self.blocks[bids[0]].topic
        else:
            tpc = topic if topic is not None else (max(
                self.tp_last.keys(), default=-1) + 1)
        self._refresh_tp(tpc)
        for bid in bids:                      # hits: freq + dep cascade
            b = self.blocks[bid]
            b.freq += 1
            b.last_t = self.t
            if b.parent >= 0 and b.parent in self.blocks:
                self.blocks[b.parent].dep += 1
        parent = bids[-1] if bids else -1
        new_bids = []
        while pos + self.block_tokens <= len(tokens):
            key = tuple(tokens[pos:pos + self.block_tokens])
            bid = self._alloc(parent, key, tpc)
            if bid < 0:
                break                          # no evictable block
            new_bids.append(bid)
            parent = bid
            pos += self.block_tokens
        return {"hit_blocks": bids, "new_blocks": new_bids,
                "hit_tokens": hit_tokens, "topic": tpc}

    def _alloc(self, parent: int, key: tuple, topic: int) -> int:
        if not self.free:
            victim = self._find_victim(exclude=parent)
            if victim < 0:
                return -1
            self._evict(victim)
        bid = self.free.pop()
        b = Block(bid=bid, parent=parent, tokens=key, topic=topic,
                  freq=1.0, last_t=self.t)
        self.blocks[bid] = b
        if parent < 0:
            self.root_index[key] = bid
        else:
            self.child_index[(parent, key)] = bid
            p = self.blocks.get(parent)
            if p is not None:
                p.children.add(bid)
                p.dep += 1.0                  # new link: Alg.3 new=1 path
        return bid

    def _find_victim(self, exclude: int = -1) -> int:
        """argmin TP(topic)·TSI over leaf blocks (children-first order).
        ``exclude`` protects the chain tip currently being extended."""
        best, best_v = -1, None
        for bid, b in self.blocks.items():
            if b.children or bid == exclude:
                continue                      # structural validity (radix)
            v = (self.tp_now(b.topic) * (b.freq + self.lam * b.dep),
                 b.last_t, bid)
            if best_v is None or v < best_v:
                best, best_v = bid, v
        return best

    def _evict(self, bid: int):
        b = self.blocks.pop(bid)
        if b.parent >= 0:
            self.child_index.pop((b.parent, b.tokens), None)
            p = self.blocks.get(b.parent)
            if p is not None:
                p.children.discard(bid)
        else:
            self.root_index.pop(b.tokens, None)
        self.free.append(bid)

    @property
    def used(self) -> int:
        return len(self.blocks)
