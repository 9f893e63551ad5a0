"""PyTorch + CUDA port of the RAC semantic cache (the ``repro`` package is
the JAX reference it is held against).

This package imports ``torch`` and numpy only.  Its device entry points
run on the card unless the caller passes ``device="cpu"``; on the CPU the
kernel wrappers take their plain PyTorch versions.  Layout mirrors the
reference: :mod:`repro_torch.core` (host state machines, RAC, simulator),
:mod:`repro_torch.cache` (the :class:`SemanticCache` facade and its
backends), :mod:`repro_torch.kernels` (CUDA kernels, their wrappers and
plain versions), :mod:`repro_torch.telemetry`.
"""
