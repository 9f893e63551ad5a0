"""The port's dry run: the per-rank cost model (``launch/op_cost.py``) on
hand-checkable programs, its ring factors against the reference's HLO cost
model, the trip-collapsed loops against the full ones, and whole cells run
in subprocesses on fake 256- and 512-rank worlds, asserting what
``tests/test_dryrun.py`` asserts of the reference's, plus an MoE cell and
a train cell whose ``model_flops_total`` is the reference's formula."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch.hlo_cost import HloCostModel
from repro.models.config import SHAPES as R_SHAPES
from repro_torch import costing
from repro_torch.configs import get_config
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import smoke_variant
from repro_torch.models import ssm as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_op_cost_counts_a_scanned_matmul_exactly():
    """12 trips of a 128^3 matmul through the trip helper: 12 · 2 · 128^3
    flops, run once; the same as the full loop."""
    def body(_, x):
        return x @ x, None
    got = []
    for collapse in (True, False):
        with OpCost(collapse=collapse) as c:
            a = torch.empty(128, 128, device="meta")
            costing.scan(12, body, a)
        got.append((c.flops, c.hbm_bytes))
    assert got[0][0] == 12 * 2 * 128 ** 3
    assert got[0] == got[1]
    assert got[0][1] == 12 * 3 * 128 * 128 * 4      # two operands, a result


_HLO = """
HloModule test

ENTRY %main (p: f32[64]) -> f32[64] {{
  %p = f32[64]{{0}} parameter(0)
  ROOT %c = {shape} {op}(%p), replica_groups={{{{0,1,2,3}}}}, to_apply=%add
}}
"""


@pytest.mark.parametrize("op,fn,out_numel", [
    ("all-reduce", "all_reduce", 64),
    ("all-gather", "all_gather_into_tensor", 256),
    ("reduce-scatter", "reduce_scatter_tensor", 16),
    ("all-to-all", "all_to_all_single", 64),
])
def test_collective_ring_factors_match_the_reference(op, fn, out_numel):
    """The link bytes of each functional collective over a group of 4, as
    the reference's HLO cost model bills the same collective (its
    all-reduce case is ``tests/test_hlo_cost.py``'s: 384 bytes)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from repro_torch.launch.mesh import fake_world
    want = HloCostModel(_HLO.format(shape=f"f32[{out_numel}]{{0}}",
                                    op=op)).entry_cost()[1]
    with fake_world(4):
        g = dist.group.WORLD
        x = torch.empty(64, device="meta")
        with OpCost() as c:
            if fn == "all_reduce":
                y = fc.all_reduce(x, "sum", g)
            elif fn == "all_gather_into_tensor":
                y = fc.all_gather_tensor(x, 0, g)
            elif fn == "reduce_scatter_tensor":
                y = fc.reduce_scatter_tensor(x, "sum", 0, g)
            else:
                y = fc.all_to_all_single(x, None, None, g)
            y = fc.wait_tensor(y)
    assert y.numel() == out_numel
    assert c.coll_bytes == want
    if op == "all-reduce":
        assert want == 2 * 64 * 4 * 3 / 4


def _cell_cfg(arch, **over):
    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **over)


def _costs(fn, collapse):
    with OpCost(collapse=collapse) as c:
        out = fn()
    return c.flops, c.hbm_bytes, out


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta").requires_grad_(grad)


@pytest.mark.parametrize("cell,t", [("mlstm", 9), ("slstm", 7),
                                    ("mamba", 5 * S.CHUNK + 5)])
def test_collapsed_loops_cost_and_shape_as_the_full_loops(cell, t):
    """A cell over T tokens on meta tensors, forward alone and forward with
    its backward: the collapsed loop's flops, bytes and output and
    gradient shapes equal the full loop's."""
    arch = "hymba-1.5b" if cell == "mamba" else "xlstm-125m"
    cfg = _cell_cfg(arch)
    init = {"mlstm": S.init_mlstm, "slstm": S.init_slstm,
            "mamba": S.init_mamba}[cell]
    apply = {"mlstm": S.mlstm_apply, "slstm": S.slstm_apply,
             "mamba": S.mamba_apply}[cell]
    p = init(cfg, None, torch.device("meta"))
    x = _meta(2, t, cfg.d_model)

    def fwd():
        with torch.no_grad():
            out, state = apply(p, cfg, x)
        return [tuple(out.shape)] + [tuple(v.shape) for v in state.values()]

    def train():
        live = {k: v.detach().requires_grad_() for k, v in p.items()}
        xg = x.detach().requires_grad_()
        out, _ = apply(live, cfg, xg)
        grads = torch.autograd.grad(out.sum(), [xg, *live.values()],
                                    allow_unused=True)
        return [None if g is None else tuple(g.shape) for g in grads]
    for fn in (fwd, train):
        assert _costs(fn, True) == _costs(fn, False)


@pytest.mark.parametrize("causal,window,t", [(True, 0, 96), (True, 40, 96),
                                             (False, 0, 50)])
def test_attention_kernels_on_meta_are_shape_only(causal, window, t):
    """B8 and B9 on meta tensors: the plain version's output shape and
    dtype, no arithmetic, and the kernel's flops charged to the counter
    (2 (D + Dv) a scored pair: the pairs the plain version's mask keeps;
    every cache slot for B9); B8's gradients have their inputs' shapes."""
    from repro_torch.kernels import decode_attention as b9
    from repro_torch.kernels import flash_attention as b8
    from repro_torch.kernels import ref
    b, h, hkv, s, d, dv = 2, 4, 2, 96, 32, 32
    plain = [torch.randn(b, h, s, d), torch.randn(b, hkv, t, d),
             torch.randn(b, hkv, t, dv)]
    want = ref.attention_ref(*plain, causal=causal, window=window)
    qi, ki = torch.arange(s)[:, None], torch.arange(t)[None]
    keep = (ki <= qi) & ((ki > qi - window) if window else True) \
        if causal else torch.ones(s, t, dtype=torch.bool)
    q, k, v = (x.to("meta").requires_grad_() for x in plain)
    with OpCost() as c:
        out = b8.flash_attention(q, k, v, window=window, causal=causal)
        grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert out.device.type == "meta"
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    assert [g.shape for g in grads] == [x.shape for x in (q, k, v)]
    assert c.breakdown["flops"]["flash_attention"] == \
        2 * b * h * int(keep.sum()) * (d + dv)
    kc = torch.empty(b, t, hkv, d, device="meta")
    pos = torch.zeros(b, dtype=torch.int32, device="meta")
    with OpCost() as c:
        o9 = b9.decode_attention(torch.empty(b, h, d, device="meta"), kc,
                                 kc, pos)
    assert o9.shape == (b, h, d) and o9.device.type == "meta"
    assert c.flops == 2 * b * h * t * (d + d)
    assert c.hbm_bytes == 4 * (2 * b * h * d + b * t * hkv * d)   # v in k


def _dryrun(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args], env=env, capture_output=True, text=True,
                       timeout=timeout)
    return r


def _model_flops(arch, shape):
    """The reference's MODEL_FLOPS (``repro/launch/dryrun.py``): 6·N·D to
    train, 2·N·D to infer, an MoE's active parameters."""
    cfg, sc = r_get_config(arch), R_SHAPES[shape]
    n = cfg.n_params()
    active = n
    if cfg.is_moe:
        e_ff = cfg.expert_d_ff or cfg.d_ff
        n_in = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        active = (n - cfg.n_layers * cfg.n_experts * n_in * cfg.d_model * e_ff
                  + cfg.n_layers * cfg.top_k * n_in * cfg.d_model * e_ff)
    tokens = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
    return (6 if sc.kind == "train" else 2) * active * tokens


@pytest.mark.parametrize("arch,shape,flags", [
    ("smollm-360m", "prefill_32k", []),
    ("xlstm-125m", "decode_32k", ["--multi-pod"]),
    ("deepseek-v2-lite-16b", "decode_32k", []),
    ("smollm-360m", "train_4k", []),
])
def test_dryrun_cell_runs(arch, shape, flags, tmp_path):
    out = tmp_path / "rec.jsonl"
    r = _dryrun("--arch", arch, "--shape", shape, "--out", str(out), *flags)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["flops"] > 0
    assert rec["peak_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["n_chips"] == (512 if "--multi-pod" in flags else 256)
    assert rec["mesh"] == ("2x16x16" if "--multi-pod" in flags else "16x16")
    assert rec["model_flops_total"] == _model_flops(arch, shape)
    assert rec["peak_bytes_per_device"] == (
        rec["argument_bytes_per_device"] + rec["output_bytes_per_device"]
        + rec["temp_bytes_per_device"])
    assert rec["useful_flop_frac"] > 0


def test_mesh_factories():
    """Importing ``launch/mesh.py`` touches no process group; the
    production mesh needs a world of exactly 256 (512) ranks, as the
    reference's needs 256 devices; the abstract mesh reads as a name ->
    size map, as a DeviceMesh's sizes do."""
    import torch.distributed as dist
    from repro_torch.distributed.api import axis_sizes
    from repro_torch.launch.mesh import (abstract_mesh, fake_world,
                                         make_production_mesh)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        make_production_mesh()
    for n, mp, names in ((256, False, ("data", "model")),
                         (512, True, ("pod", "data", "model"))):
        with fake_world(n):
            with pytest.raises(ValueError):
                make_production_mesh(multi_pod=not mp)
            mesh = make_production_mesh(multi_pod=mp)
            assert mesh.size() == n and mesh.mesh_dim_names == names
            assert axis_sizes(mesh) == axis_sizes(
                abstract_mesh(mesh.shape, names))
    assert not dist.is_initialized()
