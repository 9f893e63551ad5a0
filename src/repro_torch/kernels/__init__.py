"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) with plain PyTorch
versions beside them.

  - similarity_topk: Top-1 cosine retrieval (hit determination and Alg. 4
    routing), split over candidates across blocks with an ordered merge,
    and fp32/int8 Top-K (the approximate lookups).
  - decision: occupancy-masked Eq. 1 victim scoring with a runtime t_now.
  - rac_value: per-eviction Eq. 1 scoring over the resident table.
  - flash_attention / decode_attention: causal GQA prefill attention and
    one-token decode attention over a KV cache, fp32 online softmax, for
    the model stack (:mod:`repro_torch.models`).

Top-1, int8 Top-K and the victim scoring also come policy-stacked
(``sim_top1_multi``, ``sim_topk_q8_multi``, ``victim_value_multi``): P
slabs or tables in one launch, the policy a grid axis, for the
multi-policy arena.

Public API: :mod:`repro_torch.kernels.ops` (dispatch wrappers, the
``dispatch_stats`` ledger); plain versions in
:mod:`repro_torch.kernels.ref`; the build in ``_build``.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
