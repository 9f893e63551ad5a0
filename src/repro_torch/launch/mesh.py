"""Meshes of the port, after ``repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module touches
neither the CUDA runtime nor any process group.

  - :func:`make_cache_mesh`: the cards that hold the shards of the sharded
    semantic cache;
  - :func:`make_production_mesh`: the reference's production meshes as a
    ``torch.distributed`` :class:`DeviceMesh`, (16, 16) over axes
    ``("data", "model")`` = 256 ranks, or (2, 16, 16) over ``("pod",
    "data", "model")`` = 512 ranks, in a process group of exactly that
    size (the dry run starts a fake one: :func:`fake_world`);
  - :func:`make_local_mesh`: the degenerate (world, 1) mesh, the same code
    path on one card;
  - :func:`abstract_mesh`: a device-free mesh (axis names and sizes) that
    the sharding rules read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_cache_mesh(n_shards: int, device="cuda"):
    """One card per shard of the row-partitioned resident slab: the list
    ``[cuda:0, ..., cuda:n_shards-1]``.

    Returns ``None`` when ``device`` is not CUDA, when ``n_shards <= 1``,
    or when fewer cards exist: callers then run the identical per-shard
    math and merge as a loop on one device, so decisions never depend on
    the machine."""
    if torch.device(device).type != "cuda" or n_shards <= 1 \
            or torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", s) for s in range(n_shards)]


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the initialized
    process group; ``ValueError`` unless that group holds exactly 256 (or
    512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    n = math.prod(shape)
    if _world_size() != n:
        raise ValueError(f"the production mesh {shape} needs a world of {n} "
                         f"ranks, this one has {_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type="cuda"):
    """The degenerate ``(world, 1)`` ``("data", "model")`` mesh (the same
    code path as production).  Without a process group it first starts a
    world of one on this process (NCCL on card 0 for ``cuda``, gloo
    otherwise, over an in-process store: no network)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks in which this process is rank 0 and
    every collective returns at once (PyTorch's ``"fake"`` backend): the
    dry run's world.  Torn down on exit.  ``torch.testing._internal`` is
    an internal API; this helper is the port's only use of it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh without devices: ``shape`` maps each axis name to its size,
    as the reference's ``AbstractMesh`` does."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def abstract_mesh(shape, axis_names) -> AbstractMesh:
    """A device-free mesh of ``shape`` over ``axis_names``."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"abstract_mesh: shape {shape} and axes "
                         f"{axis_names} differ in length")
    return AbstractMesh(axis_names, shape)

