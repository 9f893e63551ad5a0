"""The port's sharding rules against the JAX package's, on device-free
meshes: logical-axis specs, the plan of every (arch x shape cell) on the
(2, 2), (16, 16) and (2, 16, 16) meshes, every parameter's spec (the
reference's ``init_shapes()`` leaves with their leading layer axis
dropped against the port's per-layer leaves), the input and cache specs,
the activation rules, ``input_specs`` and ``init_shapes`` shapes and
dtypes, and a cell's argument bytes on a fake world against the shard
shapes the reference's specs give.  All exact."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import input_specs as r_input_specs
from repro.configs import shape_cells as r_shape_cells
from repro.distributed import api as r_api
from repro.distributed import sharding as RS
from repro.launch.mesh import abstract_mesh as r_abstract_mesh
from repro.models import build_model as r_build_model
from repro_torch.configs import ARCH_IDS, get_config, input_specs, shape_cells
from repro_torch.distributed import api, sharding as S
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import Model, SHAPES

MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32}


def _ref_leaves(tree):
    """(path, leaf) of a reference pytree, its own path strings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(RS._path_str(p), leaf) for p, leaf in flat]


_REF_SHAPES: dict = {}


def _ref_params(arch):
    if arch not in _REF_SHAPES:
        _REF_SHAPES[arch] = r_build_model(r_get_config(arch)).init_shapes()
    return _REF_SHAPES[arch]


def _port_to_ref(path: str, ref: dict) -> str:
    """The reference path of a port leaf: the per-layer index dropped
    where the reference stacks its layers on a leading axis."""
    parts = path.split("/")
    if parts[0] in ("blocks", "enc") and isinstance(ref[parts[0]], dict):
        return "/".join([parts[0]] + parts[2:])
    return path


@pytest.mark.parametrize("axes,rules", [
    (("batch", "seq", None), {"batch": "data", "seq": None}),
    (("batch", "seq", "heads", None),
     {"batch": ("pod", "data"), "heads": "model", "seq": None}),
    (("batch", "seq_sp", "dmodel"),
     {"batch": "data", "seq_sp": "model", "dmodel": "data"}),
    (("expert", None, None), {"expert": "model"}),
    (("batch", "seq", "vocab"),
     {"batch": None, "seq": "data", "vocab": "model"}),
    (("heads", "kv_heads"), {"heads": "model", "kv_heads": "model"}),
    ((None, "ffn"), {}),
])
def test_logical_to_spec_matches_the_reference(axes, rules):
    assert api.logical_to_spec(axes, rules) == tuple(
        r_api.logical_to_spec(axes, rules))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_and_parameter_specs_match_the_reference(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    ref = _ref_params(arch)
    ref_leaves = dict(_ref_leaves(ref))
    port = S.tree_paths(Model(cfg, "meta").init_shapes())
    port = [(p, tuple(t.shape)) for p, t in port]
    assert len({_port_to_ref(p, ref) for p, _ in port}) == len(ref_leaves)
    assert shape_cells(cfg) == r_shape_cells(rcfg)
    for shape, axes in MESHES:
        mesh, rmesh = abstract_mesh(shape, axes), r_abstract_mesh(shape, axes)
        seen = set()
        for cell in shape_cells(cfg):
            kind = SHAPES[cell].kind
            plan = S.ShardingPlan.for_mesh(mesh, cfg, kind)
            rplan = RS.ShardingPlan.for_mesh(rmesh, rcfg, kind)
            assert (plan.tp, plan.dp, plan.fsdp, plan.decode_2d) == (
                rplan.tp, tuple(rplan.dp), rplan.fsdp, rplan.decode_2d)
            if plan in seen:
                continue
            seen.add(plan)
            ref_specs = {p: tuple(RS.param_spec(p, leaf.shape, rcfg, rplan,
                                                rmesh))
                         for p, leaf in ref_leaves.items()}
            for path, shp in port:
                rp = _port_to_ref(path, ref)
                rshape = ref_leaves[rp].shape
                stacked = len(rshape) == len(shp) + 1
                assert tuple(rshape[stacked:]) == shp, path
                want = ref_specs[rp]
                if stacked and want:
                    assert want[0] is None
                    want = want[1:]
                got = S.param_spec(path, shp, cfg, plan, mesh)
                assert got == want, (path, shape, got, want)


def _spec_tree_equal(port_tree, ref_tree, what):
    ref = {p: tuple(s.spec) for p, s in _ref_leaves(ref_tree)}
    port = dict(S.tree_paths(port_tree, ""))
    assert set(port) == set(ref), what
    for p in port:
        assert port[p] == ref[p], (what, p, port[p], ref[p])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_batch_shardings_and_rules_match_the_reference(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    for cell in shape_cells(cfg):
        kind = SHAPES[cell].kind
        specs, rspecs = input_specs(cfg, cell), r_input_specs(rcfg, cell)
        port = {p: t for p, t in S.tree_paths(specs)}
        ref = dict(_ref_leaves(rspecs))
        assert set(port) == set(ref), cell
        for p, t in port.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[p].shape), (cell, p)
            assert t.dtype == _DT[str(ref[p].dtype)], (cell, p)
        kv = specs.get("cache", {}).get("kv", {})
        if "c_kv" in kv:        # column views of one (L,B,S,r+rh) buffer
            r = kv["c_kv"].shape[-1]
            assert kv["c_kv"].stride() == kv["k_rope"].stride()
            assert kv["c_kv"].stride(-2) == r + kv["k_rope"].shape[-1]
            assert kv["k_rope"].storage_offset() == r
        for shape, axes in MESHES:
            mesh = abstract_mesh(shape, axes)
            rmesh = r_abstract_mesh(shape, axes)
            plan = S.ShardingPlan.for_mesh(mesh, cfg, kind)
            rplan = RS.ShardingPlan.for_mesh(rmesh, rcfg, kind)
            got = S.batch_shardings(cfg, cell, specs, plan, mesh)
            want = RS.batch_shardings(rcfg, cell, rspecs, rplan, rmesh)
            _spec_tree_equal(got, want, (cell, shape))
            rules = S.activation_rules(cfg, cell, plan, mesh)
            rrules = RS.activation_rules(rcfg, cell, rplan, rmesh)
            assert rules == {k: tuple(v) if isinstance(v, list) else v
                             for k, v in rrules.items()}, (cell, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_shapes_match_the_reference(arch):
    ref = _ref_params(arch)
    ref_leaves = dict(_ref_leaves(ref))
    for path, t in S.tree_paths(Model(get_config(arch), "meta").init_shapes()):
        leaf = ref_leaves[_port_to_ref(path, ref)]
        assert t.device.type == "meta"
        assert t.dtype == _DT[str(leaf.dtype)], path
        n = len(leaf.shape) - t.dim()
        assert tuple(leaf.shape[n:]) == tuple(t.shape), path


def _ref_shard_bytes(leaves, specs, sizes) -> int:
    total = 0
    for (p, leaf), spec in zip(leaves, specs):
        shp = list(leaf.shape)
        for d, part in enumerate(spec):
            shp[d] //= api.shard_count(part, sizes)
        total += math.prod(shp) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,cell,multi_pod", [
    ("smollm-360m", "train_4k", False),
    ("gemma-7b", "train_4k", False),
    ("deepseek-v2-lite-16b", "decode_32k", True),
    ("xlstm-125m", "decode_32k", True),
    ("whisper-medium", "prefill_32k", False),
])
def test_argument_bytes_equal_the_reference_specs_shard_shapes(
        arch, cell, multi_pod):
    """The dry run's argument bytes (the local shards of the meta
    DTensors on a fake world: parameters, for training both AdamW
    moments in fp32 and the step, the batch and cache) equal the bytes
    of the shard shapes the reference's specs give."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_world
    rcfg, kind = r_get_config(arch), SHAPES[cell].kind
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    rmesh = r_abstract_mesh(shape, axes)
    sizes = dict(zip(axes, shape))
    rplan = RS.ShardingPlan.for_mesh(rmesh, rcfg, kind)
    ref = _ref_params(arch)
    pl = _ref_leaves(ref)
    pspecs = [tuple(RS.param_spec(p, leaf.shape, rcfg, rplan, rmesh))
              for p, leaf in pl]
    want = _ref_shard_bytes(pl, pspecs, sizes)
    if kind == "train":       # m and v in fp32, the int32 step
        want += 2 * sum(_ref_shard_bytes(
            [(p, jax.ShapeDtypeStruct(leaf.shape, np.float32))], [s], sizes)
            for (p, leaf), s in zip(pl, pspecs)) + 4
    rspecs = r_input_specs(rcfg, cell)
    bl = _ref_leaves(rspecs)
    bs = RS.batch_shardings(rcfg, cell, rspecs, rplan, rmesh)
    want += _ref_shard_bytes(bl, [tuple(s.spec) for _, s in
                                  _ref_leaves(bs)], sizes)
    with fake_world(math.prod(shape)):
        cell_state = dryrun.build_cell(arch, cell, multi_pod)
        got = cell_state.argument_bytes
    assert got == want


def test_lc_is_a_no_op_outside_rules_and_on_plain_tensors():
    x = torch.zeros(4, 6)
    assert api.lc(x, "batch", None) is x
    with api.use_rules(abstract_mesh((2, 2), ("data", "model")),
                       {"batch": "data"}):
        assert api.lc(x, "batch", None) is x          # not a DTensor
        assert api.spec_for(("batch", None)) == ("data", None)
    assert api.spec_for(("batch", None)) == (None, None)
