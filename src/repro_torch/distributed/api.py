"""Logical-axis sharding annotations, after ``repro/distributed/api.py``.

Models annotate activations with *logical* axis names (``"batch"``,
``"heads"``, ``"ffn"``, ``"expert"``, ...).  The launcher activates a rule
set mapping logical names to mesh axes; outside a rule context the
annotations are no-ops, so the same model code runs on one card and on a
512-rank mesh.

    with use_rules(mesh, {"batch": ("pod", "data"), "heads": "model", ...}):
        logits = model.forward(params, batch)     # params, batch: DTensors

A spec is a tuple with one entry per tensor dim: ``None``, a mesh-axis
name, or a tuple of names (that dim sharded over each, major to minor, as
JAX's ``PartitionSpec`` has it).  :func:`to_placements` turns one into
DTensor placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

_state = threading.local()


def _current() -> tuple:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(mesh, rules: dict[str, Union[str, tuple, None]]):
    """Activate a logical -> mesh axis mapping for the annotations below
    (``mesh``: a ``DeviceMesh`` or an abstract mesh)."""
    prev = _current()
    _state.mesh, _state.rules = mesh, dict(rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def spec_entry(m):
    """One spec entry as JAX's ``PartitionSpec`` keeps it: a tuple of mesh
    axes, a single axis as its name."""
    if isinstance(m, (tuple, list)):
        return m[0] if len(m) == 1 else tuple(m)
    return m


def logical_to_spec(axes: tuple[Optional[str], ...], rules: dict) -> tuple:
    """The spec of logical ``axes`` under ``rules``; a mesh axis is used at
    most once (a later dim that would reuse one stays unsharded)."""
    parts = []
    used: set = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is None:
            parts.append(None)
            continue
        key = tuple(m) if isinstance(m, (tuple, list)) else (m,)
        if any(k in used for k in key):
            parts.append(None)
        else:
            used.update(key)
            parts.append(spec_entry(m))
    return tuple(parts)


def spec_for(axes: tuple[Optional[str], ...]) -> tuple:
    """Resolve logical axes to a spec under the active rules."""
    _, rules = _current()
    return logical_to_spec(axes, rules or {})


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) of ``spec``: mesh
    dim ``i`` gets ``Shard(d)`` where spec entry ``d`` names it, else
    ``Replicate()``.  An entry naming several mesh axes must list them in
    the mesh's order (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"to_placements: {part} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_count(spec_part, sizes: dict) -> int:
    """Ranks one spec entry splits its dim over."""
    if spec_part is None:
        return 1
    n = 1
    for ax in (spec_part if isinstance(spec_part, tuple) else (spec_part,)):
        n *= sizes[ax]
    return n


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of an abstract mesh (whose ``.shape`` is that
    map already) or a ``DeviceMesh`` (whose ``.shape`` is a tuple)."""
    if isinstance(mesh.shape, dict):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def lc(x, *axes: Optional[str]):
    """Logical constraint: lay ``x`` out by logical axis names.  A no-op
    outside a rule context, when ``x`` is not a DTensor, or when a dim
    does not divide its mesh axes; otherwise ``x.redistribute`` to the
    rules' placements (``None`` entries replicated, as JAX's constraint
    replicates them)."""
    rules = getattr(_state, "rules", None)
    if not rules:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = logical_to_spec(axes, rules)
    sizes = axis_sizes(mesh)
    for dim, part in zip(x.shape, spec):
        if dim % shard_count(part, sizes):
            return x
    placements = to_placements(spec, mesh)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)
