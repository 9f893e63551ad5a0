"""Multi-pod dry run: every (architecture x input shape x mesh) cell's step
run on the production mesh without a card, with its per-device memory
and roofline terms, after ``repro/launch/dryrun.py``.

XLA's SPMD compile becomes PyTorch's own SPMD: a fake process group of
256 or 512 ranks (this process is rank 0; collectives return at once), a
``DeviceMesh`` with the reference's axis names, every parameter, AdamW
moment, input and cache a meta DTensor laid out by the ported
``ShardingPlan``, and the cell's step (train step, prefill or decode
step) run eagerly under ``implicit_replication()`` and the activation
rules, inside :class:`~repro_torch.launch.op_cost.OpCost`, which counts
one rank's flops, bytes and collective bytes on its local shards.
Nothing is allocated and no card is needed.  The process group is global,
so the dry run runs in a process of its own.

Per-device memory: arguments are the exact sum of the local shards'
bytes; temp is the peak of the bytes the step allocates (the counter's
live storages) less its outputs'; peak = arguments + outputs + temp.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k [--multi-pod] [--both-meshes] [--all] \\
        [--out results.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from repro_torch.configs import ARCH_IDS, get_config, input_specs, shape_cells
from repro_torch.distributed.api import to_placements, use_rules
from repro_torch.distributed.sharding import (ShardingPlan, activation_rules,
                                              batch_shardings,
                                              param_shardings)
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, fake_world,
                                     make_production_mesh)
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import roofline_from_counter
from repro_torch.models import Model, make_train_step
from repro_torch.models.config import SHAPES, shape_config
from repro_torch.optim import AdamWConfig


def _map(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _map(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, s) for v, s in zip(tree, spec)]
    return fn(tree, spec)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors (and tensors)."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def shard(t: torch.Tensor, spec: tuple, mesh, dtype=None):
    """A meta DTensor of ``t``'s shape (and ``dtype``, default ``t``'s)
    laid out by ``spec`` on ``mesh``: its local shard is allocated on
    meta, nothing else."""
    from torch.distributed.tensor import DTensor
    placements = to_placements(spec, mesh)
    shape = list(t.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    local = torch.empty(shape, dtype=dtype or t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _shard_inputs(specs: dict, b_specs: dict, mesh) -> dict:
    """The inputs as DTensors; MLA's ``c_kv`` and ``k_rope`` stay column
    views of one row buffer, laid out as ``c_kv``."""
    batch = _map(lambda t, s: shard(t, s, mesh), specs, b_specs)
    kv = specs.get("cache", {}).get("kv", {})
    if "c_kv" in kv:
        r = kv["c_kv"].shape[-1]
        base = kv["c_kv"]._base
        rows = shard(base, b_specs["cache"]["kv"]["c_kv"], mesh)
        batch["cache"]["kv"] = {"c_kv": rows[..., :r],
                                "k_rope": rows[..., r:]}
    return batch


@dataclasses.dataclass
class Cell:
    """One cell laid out on its mesh, ready to run."""
    shape: Any                   # a name of SHAPES or a ShapeConfig
    cfg: Any
    model: Model
    mesh: Any
    plan: ShardingPlan
    rules: dict
    params: dict
    opt_state: dict | None
    batch: dict
    argument_bytes: int


def build_cell(arch: str, shape, multi_pod: bool = False,
               mesh=None) -> Cell:
    """Lay out one cell (``shape`` a name of ``SHAPES`` or a
    ``ShapeConfig``) on ``mesh`` (default the production mesh of the
    running world, which must hold 256 or 512 ranks)."""
    cfg = get_config(arch)
    model = Model(cfg, "meta")
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    sc = shape_config(shape)
    plan = ShardingPlan.for_mesh(mesh, cfg, shape_kind=sc.kind)
    specs = input_specs(cfg, shape)
    params_struct = model.init_shapes()
    p_specs = param_shardings(params_struct, cfg, plan, mesh)
    b_specs = batch_shardings(cfg, shape, specs, plan, mesh)
    params = _map(lambda t, s: shard(t, s, mesh), params_struct, p_specs)
    opt = None
    if sc.kind == "train":
        # fp32 moments share the param specs; the step is replicated
        def moment(t, s):
            return shard(t, s, mesh, torch.float32)
        opt = {"m": _map(moment, params_struct, p_specs),
               "v": _map(moment, params_struct, p_specs),
               "step": shard(torch.empty((), dtype=torch.int32,
                                         device="meta"), (), mesh)}
    batch = _shard_inputs(specs, b_specs, mesh)
    arg = local_bytes(params) + local_bytes(opt or {}) + local_bytes(batch)
    return Cell(shape, cfg, model, mesh, plan,
                activation_rules(cfg, shape, plan, mesh), params, opt,
                batch, arg)


def accum_steps(cell: Cell) -> int:
    """The reference's rule: cap the per-device microbatch at
    ``DRYRUN_MICROBATCH_TOKENS`` (default 16,384) tokens."""
    sc = shape_config(cell.shape)
    budget = int(os.environ.get("DRYRUN_MICROBATCH_TOKENS", "16384"))
    sizes = dict(zip(cell.mesh.mesh_dim_names, cell.mesh.shape))
    dp_size = math.prod(sizes[a] for a in cell.plan.dp)
    local_tokens = sc.global_batch // dp_size * sc.seq_len
    return max(1, min(sc.global_batch // dp_size, local_tokens // budget))


_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.bmm, torch.Tensor.bmm, torch.einsum}


class Reshard(torch.overrides.TorchFunctionMode):
    """Three of the layout choices XLA's partitioner makes that DTensor
    does not make on its own (each redistribution is counted):

      - a gradient is laid out as the tensor it is the gradient of (the
        backward of a sum hands on a replicated gradient, which DTensor
        would carry, computing every product after it in full on every
        rank);

      - a weight split over the data axes (FSDP) is gathered over them
        where it is used, as ZeRO-3 does (the gather's backward
        reduce-scatters its gradient): a product's last operand, and an
        operand an elementwise op broadcasts (a norm's scale, a bias)
        where the larger operand is not split the same way;
      - a view that would merge a split dim into the one before it (a
        strided split, whose redistributions DTensor plans by a search
        that does not end on the 3-D mesh) gathers that dim first;
        where DTensor refuses a view of a split dim (a head axis of 8 or
        4 over 16 ranks), the input's split dims but the batch's are
        gathered and the view retried."""

    def __init__(self, dp_dims: tuple):
        super().__init__()
        self.dp_dims = dp_dims

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.dp_dims and args:
            args = self._gather_weights(func, args)
        if func in _VIEWS and args and hasattr(args[0], "placements"):
            args = (_unstrided(args[0], _view_shape(func, args, kwargs)),
                    *args[1:])
        try:
            return _keep_grad_layout(func(*args, **kwargs))
        except RuntimeError as e:
            # "unevenly sharded" (PyTorch 2.13), "split the sharded
            # dimension" (2.11): a view DTensor will not lay out
            x = args[0] if args else None
            if func not in _VIEWS or "shard" not in str(e).lower() or \
                    not hasattr(x, "placements"):
                raise
        from torch.distributed.tensor import Replicate
        keep = [p if p.is_shard() and p.dim == 0 else Replicate()
                for p in x.placements]
        x = x.redistribute(x.device_mesh, keep)
        return _keep_grad_layout(func(x, *args[1:], **kwargs))

    def _gather_weights(self, func, args):
        from torch.distributed.tensor import Replicate
        dts = [a for a in args if hasattr(a, "placements")]
        if len(dts) < 2 and func not in _PRODUCTS:
            return args
        big = max(dts, key=lambda a: a.numel(), default=None)
        out = list(args)
        for j, a in enumerate(args):
            if not hasattr(a, "placements"):
                continue
            if func in _PRODUCTS:
                if j != len(args) - 1:
                    continue
            elif a is big or a.dim() >= big.dim():
                continue
            shift = big.dim() - a.dim()
            pl = list(a.placements)
            for i in self.dp_dims:
                p, q = pl[i], big.placements[i]
                if p.is_shard() and (func in _PRODUCTS or not (
                        q.is_shard() and q.dim == p.dim + shift)):
                    pl[i] = Replicate()
            if pl != list(a.placements):
                out[j] = a.redistribute(a.device_mesh, pl)
        return tuple(out)


_VIEWS = {torch.Tensor.reshape, torch.Tensor.view, torch.reshape,
          torch.Tensor.flatten, torch.flatten}


def _view_shape(func, args, kwargs) -> list | None:
    """The shape a reshape, view or flatten call asks for (None where it
    is not a shape: ``view(dtype)``)."""
    x = args[0]
    if func in (torch.Tensor.flatten, torch.flatten):
        start = args[1] if len(args) > 1 else kwargs.get("start_dim", 0)
        end = args[2] if len(args) > 2 else kwargs.get("end_dim", -1)
        start, end = start % x.dim(), end % x.dim()
        shp = list(x.shape)
        return shp[:start] + [math.prod(shp[start:end + 1])] + shp[end + 1:]
    shape = args[1:] if len(args) > 1 else (kwargs.get("shape")
                                            or kwargs.get("size"))
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = shape[0]
    if not all(isinstance(d, int) for d in shape):
        return None
    shape = list(shape)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    return shape


def _unstrided(x, new: list | None):
    """``x`` with every mesh dim gathered that splits a dim the view
    ``new`` merges into a dim before it (the first dim of each merged
    group may stay split)."""
    if new is None:
        return x
    old = list(x.shape)
    first = {}                   # old dim -> first old dim of its group
    i = j = 0
    while i < len(old) and j < len(new):
        i0, a, b = i, old[i], new[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b and i < len(old):
                a *= old[i]
                i += 1
            elif b < a and j < len(new):
                b *= new[j]
                j += 1
            else:                # not a view of x: leave it to torch
                return x
        for d in range(i0, i):
            first[d] = i0
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and first.get(p.dim, p.dim) != p.dim
          else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _keep_grad_layout(out):
    """Hook every DTensor of ``out`` that records a gradient so that its
    gradient is redistributed to its own placements (a partial sum
    reduced, a replicated one split)."""
    for t in torch.utils._pytree.tree_leaves(out):
        if hasattr(t, "placements") and t.requires_grad \
                and t.grad_fn is not None:
            placements = tuple(p for p in t.placements)
            if not any(p.is_partial() for p in placements):
                t.register_hook(lambda g, pl=placements: g if tuple(
                    g.placements) == pl else g.redistribute(
                        g.device_mesh, pl))
    return out


def run_cell(cell: Cell, counter: OpCost) -> Any:
    """The cell's step under the activation rules, implicit replication,
    :class:`Reshard` and ``counter``; returns its outputs."""
    from torch.distributed.tensor.experimental import implicit_replication
    sc = shape_config(cell.shape)
    names = cell.mesh.mesh_dim_names
    reshard = Reshard(tuple(names.index(a) for a in cell.plan.dp))
    counter.function_modes = (reshard,)
    with use_rules(cell.mesh, cell.rules), implicit_replication(), \
            reshard, counter:
        if sc.kind == "train":
            step = make_train_step(cell.model, AdamWConfig(),
                                   accum_steps=accum_steps(cell))
            return step(cell.params, cell.opt_state, cell.batch)
        if sc.kind == "prefill":
            return cell.model.prefill(cell.params, cell.batch)
        batch = dict(cell.batch)
        cache = batch.pop("cache")
        logits, _ = cell.model.decode_step(cell.params, cache, batch)
        # the greedy token (the cache is updated in place): the logits
        # gathered along the vocabulary first
        from torch.distributed.tensor import Replicate
        last = logits.dim() - 1
        pl = [Replicate() if p.is_partial() or (p.is_shard() and p.dim ==
                                                 last) else p
              for p in logits.placements]
        return logits.redistribute(logits.device_mesh, pl).argmax(dim=-1)


def model_flops(cfg, sc) -> float:
    """MODEL_FLOPS = 6·N·D for train, 2·N·D for inference (a token), the
    active parameters for an MoE (the reference's formula)."""
    n_params = cfg.n_params()
    active = n_params
    if cfg.is_moe:
        e_ff = cfg.expert_d_ff or cfg.d_ff
        n_in = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        moe_total = cfg.n_layers * cfg.n_experts * n_in * cfg.d_model * e_ff
        moe_active = cfg.n_layers * cfg.top_k * n_in * cfg.d_model * e_ff
        active = n_params - moe_total + moe_active
    tokens = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
    return (6 if sc.kind == "train" else 2) * active * tokens


def lower_cell(arch: str, shape, multi_pod: bool,
               verbose: bool = True, mesh=None) -> dict:
    """Lay out and run one cell; return its roofline record."""
    t0 = time.time()
    cell = build_cell(arch, shape, multi_pod, mesh)
    cfg, sc = cell.cfg, shape_config(shape)
    counter = OpCost()
    out = run_cell(cell, counter)
    out_bytes = local_bytes(out)
    n_chips = cell.mesh.size()
    rl = roofline_from_counter(counter, n_chips)
    mflops = model_flops(cfg, sc)
    temp = max(0, counter.peak - out_bytes)
    mesh_name = "x".join(str(s) for s in cell.mesh.shape)
    rec = dict(
        arch=arch, shape=sc.name, mesh=mesh_name, n_chips=n_chips,
        kind=sc.kind, seconds_to_compile=round(time.time() - t0, 1),
        params_b=round(cfg.n_params() / 1e9, 2),
        argument_bytes_per_device=cell.argument_bytes,
        output_bytes_per_device=out_bytes,
        temp_bytes_per_device=temp,
        peak_bytes_per_device=cell.argument_bytes + out_bytes + temp,
        model_flops_total=mflops,
        **rl.row(),
    )
    rec["model_flops_per_chip"] = mflops / n_chips
    rec["useful_flop_frac"] = (mflops / n_chips) / max(rl.flops, 1.0)
    if verbose:
        print(f"[dryrun] {arch} × {sc.name} × {rec['mesh']}: "
              f"run {rec['seconds_to_compile']}s, "
              f"peak {rec['peak_bytes_per_device']/2**30:.2f} GiB/dev, "
              f"t_comp {rl.t_compute*1e3:.2f} ms, "
              f"t_mem {rl.t_memory*1e3:.2f} ms, "
              f"t_coll {rl.t_collective*1e3:.2f} ms "
              f"-> {rl.bottleneck}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="assignment id (e.g. gemma-7b) or module id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch × shape) cells")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCH_IDS:
            for s in shape_cells(get_config(a)):
                cells.append((a, s))
    else:
        arch = args.arch or "gemma-7b"
        shapes = [args.shape] if args.shape else shape_cells(
            get_config(arch))
        cells = [(arch, s) for s in shapes]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records, failures = [], []
    for mp in meshes:
        with fake_world(math.prod(PRODUCTION_SHAPES[mp][0])):
            for arch, shape in cells:
                try:
                    records.append(lower_cell(arch, shape, mp))
                except Exception as e:  # noqa: BLE001 — report and continue
                    traceback.print_exc()
                    failures.append(dict(arch=arch, shape=shape,
                                         mesh="2x16x16" if mp else "16x16",
                                         error=str(e)[:500]))
    if args.out:
        with open(args.out, "a") as f:
            for r in records + failures:
                f.write(json.dumps(r) + "\n")
    print(f"[dryrun] {len(records)} ok, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_["arch"], f_["shape"], f_["mesh"],
                  f_["error"][:200])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
