"""Datatypes for the unified semantic-cache facade.

One configuration object (:class:`CacheConfig`), one result algebra
(:class:`CacheHit` / :class:`CacheMiss`), one metrics block
(:class:`CacheMetrics`), and one event record (:class:`CacheEvent`) shared
by every consumer of :class:`repro_torch.cache.SemanticCache` — the simulator,
the serving engine, examples, and benchmarks all see the same protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union


@dataclasses.dataclass
class TierConfig:
    """Configuration for the tiering subsystem behind the facade
    (:mod:`repro_torch.cache.tiers`).

    ``host_capacity`` sizes the host-DRAM second tier that catches device
    evictions (demotion) and serves device misses (promotion back through
    the admission path); 0 disables it.  ``ghost_capacity`` bounds the
    metadata-only ghost tier underneath (ARC B1/B2-style: one list for
    never-promoted demotions, one for promoted-then-re-evicted entries);
    0 disables ghosts.  ``promote_k`` is the host-tier scan width: the
    Top-K shortlist scored per miss (K > 1 reserved for prefetch-style
    co-promotion policies; the serve decision itself is Top-1).

    With ``host_capacity=0`` and ``ghost_capacity=0`` the facade never
    constructs a tier manager and every decision is bit-identical to the
    single-tier path.
    """

    host_capacity: int = 0
    ghost_capacity: int = 0
    promote_k: int = 1


@dataclasses.dataclass
class CacheConfig:
    """Configuration for one :class:`~repro_torch.cache.SemanticCache` instance.

    ``hit_mode`` mirrors the simulator's two equivalent hit semantics:
    ``"semantic"`` (Top-1 cosine >= tau_hit; the paper's semantic cache) and
    ``"content"`` (content-id residency; O(1), used for large sweeps).
    ``backend`` selects the lookup/scoring implementation: ``"kernel"``
    (the default: the CUDA kernels behind ``kernels/ops.fused_decide``,
    ``sim_top1`` and ``rac_value``) or ``"numpy"`` (the host slab scan, the
    oracle); both produce identical hit decisions.  ``device`` is where the
    kernel backend keeps its mirrors and launches: ``"cuda"`` (the default;
    raises on a machine without a card) or ``"cpu"``, where every kernel
    wrapper runs its plain PyTorch version.  ``backend_kwargs`` are
    forwarded to the backend constructor.

    ``tracker`` attaches a :class:`repro_torch.telemetry.Tracker` (instance
    or spec string like ``"memory"`` / ``"jsonl:<path>"``) that the facade
    and the device backend emit latencies, counters, windowed series, and
    spans through — strictly observation-only: decisions are identical with
    any tracker, and ``None`` (the default) skips emission entirely.

    ``debug_hooks`` controls event-subscriber failure handling: by
    default a raising hook is caught mid-operation and counted
    (``CacheMetrics.hook_errors`` + the ``cache.hook_errors`` tracker
    counter); with ``debug_hooks=True`` the exception propagates to the
    ``lookup``/``admit`` caller (the development mode).

    ``quantized_lookup`` enables the int8 candidate scan with an fp32
    rescore (:mod:`repro_torch.cache.quantized`) and ``pruned_lookup`` the
    topic-pruned two-stage scan (:mod:`repro_torch.cache.pruned`); each is
    ``False`` (off, the default), ``True`` (defaults), a dict of overrides
    or a ready config object, and the two compose.  Decisions are those of
    the exact scan either way.

    ``async_admit`` decouples admission from the request path: ``False``
    (default) applies insert + eviction scoring inline; ``True`` queues
    admissions for a background worker and ``flush()`` settles them at
    batch boundaries; ``"sync"`` queues without a worker — the queue only
    drains inside ``flush()``/``drain()``, the deterministic replay-parity
    mode.  After a flush all three produce identical state.  ``tiers``
    adds the host-DRAM and ghost tiers behind the device slab
    (:class:`TierConfig`).
    """

    capacity: int
    dim: int
    tau_hit: float = 0.85
    hit_mode: str = "semantic"           # "semantic" | "content"
    backend: str = "kernel"              # "kernel" | "numpy"
    policy: str = "RAC"                  # "RAC", "RadixRAC" or a BASELINES
                                         # name
    policy_kwargs: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"                 # kernel backend: "cuda" | "cpu"
    backend_kwargs: dict = dataclasses.field(default_factory=dict)
    async_admit: bool | str = False      # False | True (worker) | "sync"
    tiers: Optional[TierConfig] = None   # None = single-tier (bit-exact)
    tracker: Any = None                  # Tracker | spec str | None (off)
    debug_hooks: bool = False            # re-raise subscriber-hook errors
    quantized_lookup: Any = False        # False | True | dict | config obj
    pruned_lookup: Any = False           # False | True | dict | config obj


@dataclasses.dataclass
class CacheHit:
    """Lookup resolved to a resident entry."""

    cid: int                             # resident entry that served the query
    sim: float                           # Top-1 cosine (nan in content mode)
    payload: Any = None                  # whatever admit() stored, or None
    t: int = -1                          # logical time of the lookup

    @property
    def hit(self) -> bool:
        return True

    def __bool__(self) -> bool:
        return True


@dataclasses.dataclass
class CacheMiss:
    """Lookup found no resident entry above the hit threshold."""

    best_cid: int = -1                   # nearest resident (may be -1: empty)
    best_sim: float = float("-inf")      # its similarity (below tau_hit)
    t: int = -1

    @property
    def hit(self) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


CacheResult = Union[CacheHit, CacheMiss]


@dataclasses.dataclass
class DecisionBatch:
    """One fused decision launch over a (B, D) query block.

    The snapshot scoring surface of the whole RAC decision loop (see
    ``LookupBackend.decide_batch``): Top-1 hit candidates per query, Alg. 4
    topic-routing candidates per query, and Eq. 1 victim values over the
    slot table.  Routing outputs are *candidates* — gate ``route_sim``
    against ``tau_route`` before use (an invalid/retired topic row can win
    only with a non-positive similarity).  ``victim_value`` is the
    Eq.1-literal ``TP·TSI`` (the ``value_mode="paper"`` reading, what
    ``rac_value`` computes); free slots score ``+inf``.  It is ``None``
    when the policy has no :class:`~repro_torch.core.policy_table.PolicyTable`
    (baseline policies), in which case ``route_*`` degrade to ``-1``/
    ``-inf`` and only the hit columns are meaningful.
    """

    hit_cid: "np.ndarray"                # (B,) int64: Top-1 resident or -1
    hit_sim: "np.ndarray"                # (B,) float64: its cosine or -inf
    route_tid: "np.ndarray"              # (B,) int64: best topic row or -1
    route_sim: "np.ndarray"              # (B,) float64: rep cosine or -inf
    victim_value: Optional["np.ndarray"] = None   # (n_slots,) float64
    # tier-aware fall-through (None on single-tier caches): the host tier's
    # Top-1 per query — a host_sim >= tau_hit means the entry can be served
    # (and promoted) from host DRAM even though the device tier missed
    host_cid: Optional["np.ndarray"] = None       # (B,) int64 or None
    host_sim: Optional["np.ndarray"] = None       # (B,) float64 or None


@dataclasses.dataclass
class CacheEvent:
    """One observable cache transition, delivered to subscribed hooks."""

    kind: str                            # "hit" | "miss" | "admit" | "evict"
    cid: int
    t: int
    sim: float = float("nan")
    payload: Any = None
    tier: str = "device"                 # tier that produced the transition:
                                         # "device" | "host" (host-tier hit /
                                         # demoted-not-dropped eviction)


@dataclasses.dataclass
class CacheMetrics:
    """Counters + per-op latency accumulators (seconds)."""

    hits: int = 0
    misses: int = 0
    admissions: int = 0
    evictions: int = 0
    lookups: int = 0
    lookup_s: float = 0.0
    admit_s: float = 0.0
    hook_errors: int = 0                 # subscriber hooks that raised

    @property
    def requests(self) -> int:
        return self.hits + self.misses

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(1, self.requests)

    def snapshot(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "admissions": self.admissions, "evictions": self.evictions,
            "lookups": self.lookups, "hit_ratio": self.hit_ratio,
            "lookup_s": self.lookup_s, "admit_s": self.admit_s,
            "hook_errors": self.hook_errors,
        }
