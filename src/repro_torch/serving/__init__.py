"""The port's serving stack: both RAC instantiations behind one facade.

  - **Query-level response cache** — :class:`ServingEngine` runs
    continuous batching on the model stack (B9 per decode step and layer)
    behind a semantic-mode :class:`repro_torch.cache.SemanticCache`;
    completed responses can be queued for admission
    (``EngineConfig.async_admit``) and demoted to a host tier
    (``host_capacity``/``ghost_capacity``), with outputs identical to
    synchronous single-tier admission.
  - **KV prefix-block cache** — :class:`KVBlockManager` keeps the radix
    tree (compositional prefix reuse) and delegates residency, Alg. 3 TSI
    bookkeeping and TP·TSI victim scoring to a content-mode facade running
    :class:`repro_torch.core.radix.RadixRACPolicy`; each eviction is one B3
    launch with the children-first mask applied in the kernel.

:class:`LegacyKVBlockManager` is the pre-facade host implementation, kept
as the decision-parity oracle.
"""
from .engine import EngineConfig, RequestState, ServingEngine
from .kv_manager import Block, KVBlockManager, LegacyKVBlockManager

__all__ = ["EngineConfig", "RequestState", "ServingEngine", "Block",
           "KVBlockManager", "LegacyKVBlockManager"]
