"""Core RAC library of the port: host state machines, RAC, the simulator.

Public API:
    - Trace generation:  synthetic_trace, oasst_style_trace, SynthConfig,
      OASSTConfig
    - Policies:          RACPolicy (+ make_rac, RAC_VARIANTS), the 16
      BASELINES (RNG_BASELINES take a seed), Policy, ArrayPolicy,
      RadixRACPolicy (the KV prefix-block policy)
    - Policy state:      PolicyTable (journaled RAC scoring slabs; device
      backends mirror it for the fused decide_batch path), MutationJournal
    - Simulation:        run_policy, run_policy_batched (exact incremental
      batched replay; replay_batched runs its loop on a cache you hold),
      run_many, default_factories, hr_full
    - Arena:             run_arena, ArenaStore (P policies in one pass over
      one stacked slab, one policy-stacked kernel launch per chunk)
    - Types:             Request, Trace, Stats

The cache protocol itself (lookup / admit / evict, payloads, metrics,
backends) lives in :mod:`repro_torch.cache`; the simulation drivers here
replay traces through that facade.
"""
from .arena import ArenaStore, run_arena
from .embeddings import EmbeddingSpace, cosine
from .policies import BASELINES, RNG_BASELINES, ArrayPolicy, Policy
from .policy_table import PolicyTable, SlabTable
from .rac import RAC_VARIANTS, RACPolicy, make_rac
from .radix import RadixRACPolicy
from .simulator import (default_factories, hr_full, replay_batched,
                        run_many, run_policy, run_policy_batched, with_seed)
from .store import MutationJournal, ResidentStore
from .structural import pagerank_power, pagerank_reversed, pagerank_scores
from .traces import (OASSTConfig, SynthConfig, measured_long_reuse_ratio,
                     oasst_style_trace, synthetic_trace)
from .types import Request, Stats, Trace, summarize

__all__ = [
    "EmbeddingSpace", "cosine", "BASELINES", "RNG_BASELINES", "Policy",
    "ArrayPolicy", "ArenaStore", "run_arena", "run_many",
    "default_factories", "PolicyTable", "SlabTable",
    "RAC_VARIANTS", "RACPolicy", "RadixRACPolicy", "make_rac", "hr_full",
    "run_policy",
    "run_policy_batched", "replay_batched", "with_seed", "MutationJournal",
    "ResidentStore",
    "pagerank_power", "pagerank_reversed", "pagerank_scores", "OASSTConfig",
    "SynthConfig", "measured_long_reuse_ratio", "oasst_style_trace",
    "synthetic_trace", "Request", "Stats", "Trace", "summarize",
]
