"""Per-rank cost model of an eager step, the counterpart of the reference's
``launch/hlo_cost.py`` (a trip-count-aware walk of compiled HLO).

:class:`OpCost` is a ``TorchDispatchMode``.  The dry run runs a cell's step
on meta DTensors under it: DTensor turns each op into this rank's local
ops on its shards (and the collectives its redistributions need), and
the mode sees those local ops, so every term is per rank:

  - flops: ``torch.utils.flop_counter``'s formulas on the local shapes
    (matmuls, attention), plus the kernels the stubs report
    (:func:`repro_torch.costing.charge`: B8 and B9 on meta);
  - hbm_bytes: operand plus result bytes of every dispatched op, views
    free (in eager mode every op makes its own round trip to HBM, so the
    reference's list of ops the TPU fuses has no counterpart here);
    indexed reads and writes (embedding, gather, index, index_put, the
    cache writes) move the rows they touch, twice, not their tables;
  - coll_bytes: ring-algorithm link bytes of every functional collective
    (the reference's factors: all-reduce 2b(n-1)/n, all-gather b(n-1)/n of
    the gathered result, reduce-scatter b(n-1) of the result shard,
    all-to-all b(n-1)/n, a permute b), with the part whose group stays
    inside one node of 8 cards counted apart (``nvlink_bytes``).

It is trip-aware: :func:`repro_torch.costing.scan` runs a loop's body once
inside :meth:`OpCost.repeated`, which weights that body's ops, and the
backward ops of the autograd nodes it created, by the trip count.  It
also tracks the bytes of the storages the step allocates (live and
peak), for the dry run's temp and peak memory.
"""
from __future__ import annotations

import collections
import contextlib
import math
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import costing

aten = torch.ops.aten

#: cards a node holds: a collective whose ranks lie in one node runs on
#: NVLink, one that spans nodes on the network
CARDS_PER_NODE = 8

# creation and aliasing ops: no bytes move
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default}
# indexed reads: the rows read (= the result) and the rows written
_GATHERS = {aten.embedding.default, aten.index_select.default,
            aten.gather.default, aten.index.Tensor}
# indexed writes (the update last): the update's rows read and written
_SCATTERS = {aten.index_put_.default, aten.index_put.default,
             aten._index_put_impl_.default, aten.index_copy_.default,
             aten.index_copy.default, aten.index_add_.default,
             aten.index_add.default, aten.scatter_.src, aten.scatter.src,
             aten.scatter_add_.default, aten.scatter_add.default}
_RING = {"all_reduce": lambda b, n: 2.0 * b * (n - 1) / n,
         "all_gather_into_tensor": lambda b, n: b * (n - 1) / n,
         "reduce_scatter_tensor": lambda b, n: b * (n - 1),
         "all_to_all_single": lambda b, n: b * (n - 1) / n,
         "shard_dim_alltoall": lambda b, n: b * (n - 1) / n,
         "broadcast": lambda b, n: float(b)}


def _tensors(tree):
    out = []
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _seq() -> int:
    """The next autograd sequence number of this thread (a throwaway node
    takes it)."""
    with torch.enable_grad():
        x = torch.empty((), device="meta", requires_grad=True)
        return x.view(()).grad_fn._sequence_nr()


class OpCost(TorchDispatchMode):
    """Counts flops, HBM bytes and collective link bytes of the local ops
    it sees (a rank's), and the bytes of the storages they allocate.
    ``collapse=False`` runs :func:`~repro_torch.costing.scan`'s loops in
    full (for checking the collapse); ``by`` keys :attr:`breakdown` by
    ``"opcode"`` (the aten op or kernel) or ``"meta"`` (the innermost
    model functions on the Python stack)."""

    def __init__(self, collapse: bool = True, by: str = "opcode"):
        super().__init__()
        self.collapse, self.by = collapse, by
        self.flops = self.hbm_bytes = 0.0
        self.coll_bytes = self.nvlink_bytes = 0.0
        self.breakdown = {k: collections.Counter()
                          for k in ("flops", "hbm_bytes", "coll_bytes")}
        self.n_ops = 0
        self.weight = 1.0
        self._regions: list[list] = []      # [first seq, last seq, n]
        self.live = self.peak = 0
        self._storages: dict[int, tuple] = {}
        self._prev = None
        #: ``TorchFunctionMode``s a rematerialised block's recompute runs
        #: under (:func:`repro_torch.costing.remat_contexts`)
        self.function_modes: tuple = ()

    # -- context --------------------------------------------------------
    def __enter__(self):
        self._prev, costing.counter = costing.counter, self
        return super().__enter__()

    def __exit__(self, *exc):
        costing.counter = self._prev
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Weight the ops run inside by ``n``, and the backward ops of the
        autograd nodes created inside as well."""
        region = [_seq(), math.inf, float(n)]     # open while inside
        self._regions.append(region)
        self.weight *= n
        try:
            yield
        finally:
            self.weight /= n
            region[1] = _seq()

    def _weight(self) -> float:
        node = torch._C._current_autograd_node()
        if node is None:
            return self.weight
        seq, w = node._sequence_nr(), 1.0
        for lo, hi, n in self._regions:
            if lo < seq < hi:
                w *= n
        return w

    def _key(self, name: str) -> str:
        if self.by != "meta":
            return name
        scope = []
        f = sys._getframe(2)
        while f is not None and len(scope) < 3:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith("repro_torch.models") or \
                    mod.startswith("repro_torch.kernels"):
                scope.append(f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}")
            f = f.f_back
        return "/".join(reversed(scope)) or f"({name})"

    # -- counting ---------------------------------------------------------
    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """A kernel's cost, reported by its shape-only stub."""
        w = self._weight()
        key = self._key(name)
        self.flops += w * flops
        self.hbm_bytes += w * nbytes
        self.breakdown["flops"][key] += w * flops
        self.breakdown["hbm_bytes"][key] += w * nbytes

    def _count(self, name: str, nbytes: float) -> None:
        w = self._weight()
        self.hbm_bytes += w * nbytes
        self.breakdown["hbm_bytes"][self._key(name)] += w * nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = (n, weakref.ref(st, self._freed(key)))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _freed(self, key: int):
        def cb(_):
            n, _ = self._storages.pop(key, (0, None))
            self.live -= n
        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                func.namespace == "profiler":   # a span: no work
            return func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs, its local ops come back
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            # DTensor views a local shard whose strides do not allow it
            # (a gradient laid out transposed): reshape's copy, charged
            if func is not aten.view.default or "view size" not in str(e):
                raise
            self._count("aten.clone", 2 * _nbytes(args[0]))
            out = func(args[0].contiguous(), *args[1:], **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            return out                  # DTensor's shape propagation
        self.n_ops += 1
        ns = func.namespace
        name = func._overloadpacket.__name__
        key = self._key(f"{ns}.{name}")
        w = self._weight()
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if "c10d_functional" in ns or ns == "_dtensor":
            if name in _RING:
                group = _group(args[-1])
                n = group.size()
                b = sum(_nbytes(t) for t in outs)
                link = w * _RING[name](b, n)
                self.coll_bytes += link
                ranks = torch.distributed.get_process_group_ranks(group)
                if len({r // CARDS_PER_NODE for r in ranks}) == 1:
                    self.nvlink_bytes += link
                self.breakdown["coll_bytes"][key] += link
                hb = w * (sum(_nbytes(t) for t in ins) + b)
                self.hbm_bytes += hb
                self.breakdown["hbm_bytes"][key] += hb
            self._track(out)
            return out
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            fl = w * formula(*args, **kwargs, out_val=out)
            self.flops += fl
            self.breakdown["flops"][key] += fl
        if func in _FREE or func.is_view:
            return out
        if func in _GATHERS:          # the table first, then indices
            nb = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:])
        elif func in _SCATTERS:       # the target, indices, the update
            nb = 2 * _nbytes(ins[-1]) + sum(_nbytes(t) for t in ins[1:-1])
        else:
            nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.hbm_bytes += w * nb
        self.breakdown["hbm_bytes"][key] += w * nb
        if not func._schema.is_mutable:     # in place: no new storage
            self._track(out)
        return out

    def row(self) -> dict:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=self.coll_bytes,
                    nvlink_bytes=self.nvlink_bytes, n_ops=self.n_ops)
