"""The hooks through which the model stack and the kernel wrappers talk to
the dry run's cost counter (``launch/op_cost.py``), without importing it.

  - :func:`scan` runs a loop of equal-shaped iterations (the Mamba chunk
    loop, the mLSTM and sLSTM token loops, gradient accumulation), as the
    reference's ``lax.scan`` does.  With no counter active it is the plain
    loop.  Under a counter, which runs on meta tensors where only shapes
    matter, it runs three iterations and charges the middle one's costs
    (and its backward's) for all but two, with the costs and shapes of
    the full loop.
  - :func:`split` cuts a batch into microbatches;
  - :func:`remat_contexts` gives a checkpointed block's recompute (which
    runs inside the backward pass, where no ``TorchFunctionMode`` is
    active) the function modes the counter's forward ran under;
  - :func:`charge` reports the FLOPs and bytes of a kernel that ran as a
    shape-only stub (B8 and B9 on ``meta``) to the active counter.

Both are no-ops outside a dry run (one module-global read).
"""
from __future__ import annotations

from typing import Callable

import torch

#: the active counter (``launch/op_cost.py::OpCost``) or None
counter = None


def charge(name: str, flops: float, nbytes: float) -> None:
    """Add a kernel's FLOPs and bytes moved to the active counter."""
    if counter is not None:
        counter.charge(name, flops, nbytes)


class _Ends(torch.autograd.Function):
    """Shape-only stand-in (meta tensors) for ``x.unbind(dim)`` where a
    collapsed loop reads only slices 0, 1 and n - 1: forward those views;
    backward the three gradients joined to ``x``'s shape (the middle one
    expanded to n - 2), which moves the bytes of ``unbind``'s backward,
    the stack of n slices' gradients."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return x.select(dim, 0), x.select(dim, 1), x.select(dim, ctx.n - 1)

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return _join(ctx.dim, ctx.n, g0, g1, g2), None


class _Join(torch.autograd.Function):
    """Shape-only stand-in for stacking a collapsed loop's n outputs along
    ``dim`` from iterations 0, 1 (for the n - 2 middle ones) and n - 1:
    the stack's bytes forward, views backward (as the stack's are)."""

    @staticmethod
    def forward(ctx, y0, y1, y2, n: int, dim: int):
        ctx.dim = dim
        return _join(dim, n, y0, y1, y2)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        return (g.select(d, 0), g.select(d, 1), g.select(d, g.shape[d] - 1),
                None, None)


def _join(dim: int, n: int, y0, y1, y2):
    ref = next(t for t in (y0, y1, y2) if t is not None)
    y0, y1, y2 = (torch.zeros_like(ref) if t is None else t
                  for t in (y0, y1, y2))
    mid = y1.unsqueeze(dim)
    shape = list(mid.shape)
    shape[dim] = n - 2
    return torch.cat([y0.unsqueeze(dim), mid.expand(shape),
                      y2.unsqueeze(dim)], dim)


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing for the
    forward; for the recompute, the active counter's ``function_modes``
    entered again (none outside a dry run)."""
    import contextlib
    modes = getattr(counter, "function_modes", ())

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            for m in modes:
                stack.enter_context(m)
            yield
    return contextlib.nullcontext(), recompute()


def split(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, ...) as ``n`` microbatches (n, B/n, ...) of contiguous
    rows.  A DTensor (the dry run's) sharded along its first dim splits
    each rank's local rows instead (a rank runs ``n`` microbatches of its
    own rows): the shapes are the same, the grouping of the rows is not,
    and on meta tensors only the shapes matter."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    local = x.to_local()
    local = local.reshape(n, local.shape[0] // n, *local.shape[1:])
    placements = [Shard(p.dim + 1) if p.is_shard() else p
                  for p in x.placements]
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False)


def _settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (the dry run's) with its pending partial sums reduced, so
    that a loop does not reduce each of its slices apart; anything else
    as it is."""
    pl = getattr(x, "placements", ())
    if not any(p.is_partial() for p in pl):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in pl])


def scan(n: int, body: Callable, carry, xs=(), *, xs_dim: int = 1,
         stack_dim: int | None = None):
    """``for i in range(n): carry, y = body(i, carry, *x_i)``, ``x_i`` the
    ``i``-th slices of the tensors ``xs`` along ``xs_dim`` (each of length
    ``n`` there; ``unbind``'s views); returns ``(carry, ys)``, ``ys`` the
    list of the ``y``s or, with ``stack_dim``, their ``torch.stack``
    along that dim.  Every iteration sees inputs and gives outputs of one
    shape.  Under a counter, past 3 iterations, the body runs three times:
    iteration 0 (whose carry records no gradient yet), iteration 1, whose
    costs and whose backward's count n - 2 times
    (``counter.repeated``), and iteration n - 1 (the last gradient sum of
    a tensor every iteration reads falls there); the stacked output
    repeats iteration 1's output n - 2 times.  Costs and shapes are the
    full loop's."""
    xs = [_settled(x) for x in xs]
    if counter is None or n <= 3 or not counter.collapse:
        slices = [x.unbind(xs_dim) for x in xs]
        ys = []
        for i in range(n):
            carry, y = body(i, carry, *(s[i] for s in slices))
            ys.append(y)
        if stack_dim is None:
            return carry, ys
        return carry, torch.stack(ys, stack_dim)
    ends = [_Ends.apply(x, xs_dim) for x in xs]
    carry, y0 = body(0, carry, *(e[0] for e in ends))
    with counter.repeated(n - 2):
        carry, y1 = body(1, carry, *(e[1] for e in ends))
    carry, y2 = body(n - 1, carry, *(e[2] for e in ends))
    if stack_dim is None:
        return carry, [y0] + [y1] * (n - 2) + [y2]
    return carry, _Join.apply(y0, y1, y2, n, stack_dim)
