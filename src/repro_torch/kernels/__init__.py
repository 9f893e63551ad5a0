"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) with plain PyTorch
versions beside them.

  - similarity_topk: Top-1 cosine retrieval (hit determination and Alg. 4
    routing), split over candidates across blocks with an ordered merge.
  - decision: occupancy-masked Eq. 1 victim scoring with a runtime t_now.
  - rac_value: per-eviction Eq. 1 scoring over the resident table.

Public API: :mod:`repro_torch.kernels.ops` (dispatch wrappers, the
``dispatch_stats`` ledger); plain versions in
:mod:`repro_torch.kernels.ref`; the build in ``_build``.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
