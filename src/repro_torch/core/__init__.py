"""Core RAC library of the port: host state machines, RAC, the simulator.

Public API:
    - Trace generation:  synthetic_trace, oasst_style_trace, SynthConfig,
      OASSTConfig
    - Policies:          RACPolicy (+ make_rac, RAC_VARIANTS), Policy
    - Policy state:      PolicyTable (journaled RAC scoring slabs; device
      backends mirror it for the fused decide_batch path), MutationJournal
    - Simulation:        run_policy, run_policy_batched (exact incremental
      batched replay), hr_full
    - Types:             Request, Trace, Stats

The cache protocol itself (lookup / admit / evict, payloads, metrics,
backends) lives in :mod:`repro_torch.cache`; the simulation drivers here
replay traces through that facade.
"""
from .embeddings import EmbeddingSpace, cosine
from .policies import Policy
from .policy_table import PolicyTable, SlabTable
from .rac import RAC_VARIANTS, RACPolicy, make_rac
from .simulator import hr_full, run_policy, run_policy_batched, with_seed
from .store import MutationJournal, ResidentStore
from .structural import pagerank_power, pagerank_reversed, pagerank_scores
from .traces import (OASSTConfig, SynthConfig, measured_long_reuse_ratio,
                     oasst_style_trace, synthetic_trace)
from .types import Request, Stats, Trace, summarize

__all__ = [
    "EmbeddingSpace", "cosine", "Policy", "PolicyTable", "SlabTable",
    "RAC_VARIANTS", "RACPolicy", "make_rac", "hr_full", "run_policy",
    "run_policy_batched", "with_seed", "MutationJournal", "ResidentStore",
    "pagerank_power", "pagerank_reversed", "pagerank_scores", "OASSTConfig",
    "SynthConfig", "measured_long_reuse_ratio", "oasst_style_trace",
    "synthetic_trace", "Request", "Stats", "Trace", "summarize",
]
