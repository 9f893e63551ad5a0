"""The model stack's few ops that DTensor cannot lay out on its own, each run
on the local shards (the dry run's meta DTensors; on plain tensors they
are the plain ops):

  - :func:`embedding`: a lookup in a table split along its vocabulary
    (each rank looks up the ids its rows hold, zeros elsewhere, summed
    across the vocabulary's ranks), as Megatron's vocabulary-parallel
    embedding does;
  - :func:`logsumexp` over the last dim of logits split along the
    vocabulary: a max and a sum reduced across ranks, no gather;
  - :func:`take_last`: ``torch.gather`` along the last dim of logits
    split along the vocabulary (the loss's gold logit), the same way;
  - :func:`write_rows`: the decode step's in-place cache write;
  - :func:`experts`: an MoE's routed experts split over ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (one attribute read on the hot path)."""
    return hasattr(x, "placements")


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``.  For a DTensor table split along its
    rows (the vocabulary) each rank looks up the ids that fall in its rows
    (the others read row 0 and are zeroed), the result a partial sum over
    those ranks; a table split along its columns is gathered where the
    ids are split on the same mesh dim, else keeps its split."""
    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    tp, out = [], []
    for i, (p, q) in enumerate(zip(table.placements, ids.placements)):
        q_sharded = q.is_shard()
        if p.is_shard() and p.dim == 1 and q_sharded:
            p = Replicate()
        tp.append(p)
        if p.is_shard() and p.dim == 0:
            out.append(Partial())
        elif p.is_shard():
            out.append(Shard(ids.dim()))
        else:
            out.append(Shard(q.dim) if q_sharded else Replicate())
    tab = table.redistribute(mesh, tp).to_local()
    rel = ids.to_local() - _vocab_offset(mesh, tp, 0, tab.shape[0])
    inside = (rel >= 0) & (rel < tab.shape[0])
    x = F.embedding(torch.where(inside, rel, 0), tab)
    x = x * inside.unsqueeze(-1).to(x.dtype)
    return DTensor.from_local(x, mesh, out, run_check=False)


def _vocab_offset(mesh, placements, dim: int, size: int) -> int:
    """The first index of this rank's part of a dim split by
    ``placements`` into local parts of ``size``."""
    lo = 0
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim == dim:
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    return lo * size


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, dim=-1)``.  For a DTensor: ``m + log(sum(exp(x
    - m)))`` with ``m`` the (detached) max, each a reduction DTensor
    splits across ranks."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    m = x.detach().amax(dim=-1, keepdim=True)
    return (x - m).exp().sum(dim=-1).log() + m.squeeze(-1)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx)``.  For a DTensor ``x`` split along its
    last dim each rank gathers the indices its part holds (zeros
    elsewhere), the result a partial sum over those ranks."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, last = x.device_mesh, x.dim() - 1
    xp = [Replicate() if p.is_partial() else p for p in x.placements]
    ip = [Replicate() if p.is_shard() and p.dim == last else p
          for p in xp]
    out = [Partial() if p.is_shard() and p.dim == last else p for p in xp]
    xl = x.redistribute(mesh, xp).to_local()
    il = _as_dtensor(idx, mesh).redistribute(mesh, ip).to_local()
    rel = il - _vocab_offset(mesh, xp, last, xl.shape[-1])
    inside = (rel >= 0) & (rel < xl.shape[-1])
    g = torch.gather(xl, -1, torch.where(inside, rel, 0))
    return DTensor.from_local(g * inside.to(g.dtype), mesh, out,
                              run_check=False)


def write_rows(cache: torch.Tensor, pos: torch.Tensor,
               rows: torch.Tensor) -> None:
    """``cache[b, pos[b]] = rows[b]`` for every batch row b, in place
    (cache (B,S,...), rows (B,...)).  A DTensor cache writes on its local
    shards, ``rows`` and ``pos`` laid out as the cache's batch and inner
    dims are; where the cache is split along S each rank writes one row
    of its shard (the dry run reads the bytes of the write, not its
    values)."""
    if not is_dtensor(cache):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, pos] = rows.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    rp, pp = [], []
    for p in cache.placements:
        if p.is_shard() and p.dim != 1:
            rp.append(Shard(p.dim - 1) if p.dim > 1 else Shard(0))
        else:
            rp.append(Replicate())
        pp.append(Shard(0) if p.is_shard() and p.dim == 0 else Replicate())
    c = cache.to_local()
    r = _as_dtensor(rows, mesh).redistribute(mesh, rp).to_local()
    q = _as_dtensor(pos, mesh).redistribute(mesh, pp).to_local()
    bl = torch.arange(c.shape[0], device=c.device)
    c[bl, q.clamp(max=c.shape[1] - 1)] = r.to(c.dtype)


def _whole(x, keep_dims=()):
    """x's local tensor with every mesh dim replicated but those that split
    one of the tensor dims ``keep_dims``, and the placements kept."""
    from torch.distributed.tensor import Replicate
    pl = [p if p.is_shard() and p.dim in keep_dims else Replicate()
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl).to_local(), pl


def experts(p: dict, x: torch.Tensor, run) -> torch.Tensor:
    """An MoE's routed experts on DTensors: the tokens x (B,S,d) and the
    router gathered on every rank, each rank runs ``run(p_local, xt,
    e_lo)`` (:func:`repro_torch.models.layers.moe_experts`) over all T
    tokens with the experts its shards hold (the weights gathered but
    along their expert and expert-FFN dims), and the result (T,d) is a
    partial sum over the mesh dims that split the experts (or their FFN
    width), whole on the others.  The capacity is the global T's, as the
    reference's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    xt, _ = _whole(x.reshape(-1, x.shape[-1]))
    local = {"router": _whole(p["router"])[0]}
    split = [False] * mesh.ndim
    e_lo = 0
    for name, dims in (("wi", (0, 2)), ("wg", (0, 2)), ("wo", (0, 1))):
        if name not in p:
            continue
        local[name], pl = _whole(p[name], dims)
        for i, q in enumerate(pl):
            split[i] |= q.is_shard()
        if name == "wi":
            e_lo = _vocab_offset(mesh, pl, 0, local[name].shape[0])
    y = run(local, xt, e_lo)
    return DTensor.from_local(y, mesh, [Partial() if s else Replicate()
                                        for s in split], run_check=False)
