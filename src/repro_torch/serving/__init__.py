"""The port's serving stack: :class:`ServingEngine` runs continuous
batching on the model stack (B9 per decode step and layer) behind the
:class:`repro_torch.cache.SemanticCache` facade.  The KV prefix-block
manager waits for ``ROADMAP.md`` queue A item 9."""
from .engine import EngineConfig, RequestState, ServingEngine

__all__ = ["EngineConfig", "RequestState", "ServingEngine"]
