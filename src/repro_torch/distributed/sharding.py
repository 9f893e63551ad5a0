"""Sharding rule engine, after ``repro/distributed/sharding.py``: maps every
parameter, input and cache tensor of an (arch x shape) cell onto the
production mesh.

Strategy (the reference's):
  - TP over ``model``: attention heads, FFN hidden, vocab, MoE experts
    (experts fall back to intra-expert FFN TP when n_experts doesn't divide
    the axis, e.g. grok-1's 8 experts on a 16-way axis).
  - DP over ``("pod", "data")`` for the batch.
  - FSDP/ZeRO over ``data`` for params + optimizer moments of large models.
  - Decode KV caches: batch over DP, sequence over ``model`` when KV heads
    don't divide the TP axis, else KV heads over ``model``.
  - long_500k (batch=1): states over ``model``, ring-window over ``data``
    (sequence parallelism).

Divisibility is checked per tensor: anything that doesn't divide cleanly
is replicated on that axis (never an error).  A spec is a tuple of mesh
axis names, tuples of names or ``None``, one entry per dim
(:mod:`repro_torch.distributed.api`); the mesh is a ``DeviceMesh`` or an
abstract mesh.  The port's parameters are per-layer lists, so a path is
``blocks/3/attn/wq`` with no leading layer axis; the patterns end in
``$`` and match it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from repro_torch.models.config import ModelConfig, shape_config

from .api import axis_sizes, spec_entry


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    tp: str = "model"
    dp: tuple = ("data",)            # ("pod","data") on the multi-pod mesh
    fsdp: bool = False               # shard params/moments over dp[-1]
    # training shards params+moments over data from 8B params (memory);
    # decode avoids weight sharding until 12B: TP-only weights are
    # resident and the per-token gathers vanish
    fsdp_min_params_train: int = 8_000_000_000
    fsdp_min_params_decode: int = 12_000_000_000
    # decode weight-stationary mode: replicate the token batch over dp for
    # the dense compute so the 2D-sharded weights are consumed in place
    # (partial matmul + small activation all-reduce) instead of
    # re-gathering every layer's weights per generated token.  The KV
    # cache stays batch-sharded (attention runs batch-local).
    decode_2d: bool = False

    @staticmethod
    def for_mesh(mesh, cfg: ModelConfig,
                 shape_kind: str = "train") -> "ShardingPlan":
        sizes = axis_sizes(mesh)
        dp = tuple(a for a in ("pod", "data") if a in sizes)
        n = cfg.n_params()
        if shape_kind == "decode":
            fsdp = n >= ShardingPlan.fsdp_min_params_decode
            return ShardingPlan(dp=dp, fsdp=fsdp, decode_2d=fsdp)
        return ShardingPlan(dp=dp,
                            fsdp=n >= ShardingPlan.fsdp_min_params_train)


# -- parameter logical axes -------------------------------------------------
# leaf-name -> logical axis names per dim (a leading "layer" dim, where a
# path has one, is prepended automatically)
_PARAM_AXES: list[tuple[str, tuple]] = [
    (r"emb/tok$",            ("vocab", "embed")),
    (r"emb/unembed$",        ("embed", "vocab")),
    (r"(^|/)ln\w*/scale$",   ("embed",)),
    (r"norm_f/scale$",       ("embed",)),
    (r"gn_scale$",           ("inner",)),
    (r"attn/wq$",            ("embed", "heads", "hd")),
    (r"attn/w[kv]$",         ("embed", "kv_heads", "hd")),
    (r"attn/wo$",            ("heads", "hd", "embed")),
    (r"attn/b[q]$",          ("heads", "hd")),
    (r"attn/b[kv]$",         ("kv_heads", "hd")),
    (r"xattn/wq$",           ("embed", "heads", "hd")),
    (r"xattn/w[kv]$",        ("embed", "kv_heads", "hd")),
    (r"xattn/wo$",           ("heads", "hd", "embed")),
    (r"attn/wdkv$",          ("embed", "kv_lora")),
    (r"attn/wu[kv]$",        ("kv_lora", "heads", "hd")),
    (r"attn/wkr$",           ("embed", None)),
    (r"mlp/w[ig]$",          ("embed", "ffn")),
    (r"mlp/wo$",             ("ffn", "embed")),
    (r"moe/router$",         ("embed", "expert")),
    (r"moe/w[ig]$",          ("expert", "embed", "expert_ffn")),
    (r"moe/wo$",             ("expert", "expert_ffn", "embed")),
    (r"moe/shared/w[ig]$",   ("embed", "ffn")),
    (r"moe/shared/wo$",      ("ffn", "embed")),
    (r"mamba/w_in$",         ("embed", "inner")),
    (r"mamba/conv$",         (None, "inner")),
    (r"mamba/w_bc$",         ("inner", None)),
    (r"mamba/w_dt$",         ("inner", "inner2")),
    (r"mamba/[ab]_dt$",      ("inner",)),
    (r"mamba/a_log$",        ("inner", None)),
    (r"mamba/d_skip$",       ("inner",)),
    (r"mamba/w_out$",        ("inner", "embed")),
    (r"mlstm/w_up$",         ("embed", "inner")),
    (r"mlstm/w_qkv$",        ("inner", "inner2")),
    (r"mlstm/w_if$",         ("inner", None)),
    (r"mlstm/b_if$",         (None,)),
    (r"mlstm/w_down$",       ("inner", "embed")),
    (r"slstm/w_x$",          ("embed", "inner")),
    (r"slstm/r_h$",          (None, None, None)),
    (r"slstm/b$",            (None,)),
    (r"slstm/w_up$",         ("embed", "inner")),
    (r"slstm/w_down$",       ("inner", "embed")),
]


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict/list tree, paths joined by
    ``/`` (dict keys, list indices), in the tree's order; a tuple (a
    spec) is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _fits(mesh, dim: int, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def param_spec(path_s: str, shape: tuple, cfg: ModelConfig,
               plan: ShardingPlan, mesh) -> tuple:
    """The spec of one parameter leaf."""
    axes: Optional[tuple] = None
    for pat, ax in _PARAM_AXES:
        if re.search(pat, path_s):
            axes = ax
            break
    if axes is None:
        return ()
    # stacked layers carry a leading layer dim
    if len(shape) == len(axes) + 1:
        axes = (None, *axes)
    elif len(shape) != len(axes):
        return ()

    tp_used = False
    fsdp_used = False
    parts: list = []
    # TP priority order per logical name
    for dim, name in zip(shape, axes):
        part = None
        if name in ("vocab", "heads", "kv_heads", "ffn", "expert",
                    "kv_lora", "inner", "expert_ffn") and not tp_used:
            if _fits(mesh, dim, plan.tp):
                part = plan.tp
                tp_used = True
        parts.append(part)
    # second pass: FSDP shards the first eligible unused dim over data
    if plan.fsdp:
        fsdp_ax = plan.dp[-1]
        for i, (dim, name) in enumerate(zip(shape, axes)):
            if parts[i] is None and name == "embed" and \
                    _fits(mesh, dim, fsdp_ax):
                parts[i] = fsdp_ax
                fsdp_used = True
                break
        if not fsdp_used:       # fall back: any unsharded divisible dim
            for i, dim in enumerate(shape):
                if parts[i] is None and axes[i] is not None and \
                        _fits(mesh, dim, fsdp_ax):
                    parts[i] = fsdp_ax
                    break
    return tuple(parts)


def param_shardings(params_tree, cfg: ModelConfig, plan: ShardingPlan,
                    mesh):
    """A tree of specs shaped like ``params_tree`` (tensors, meta ones
    included)."""
    return _map_paths(lambda path, leaf: param_spec(
        path, tuple(leaf.shape), cfg, plan, mesh), params_tree)


# -- inputs / caches --------------------------------------------------------
def _batch_dp(sc, plan: ShardingPlan, mesh):
    return plan.dp if _fits(mesh, sc.global_batch, plan.dp) else (
        plan.dp[-1] if _fits(mesh, sc.global_batch, plan.dp[-1]) else None)


def batch_shardings(cfg: ModelConfig, shape, specs_tree,
                    plan: ShardingPlan, mesh):
    """A tree of specs for the :func:`~repro_torch.configs.input_specs`
    tree of one cell (``shape`` a name of ``SHAPES`` or a
    ``ShapeConfig``)."""
    sc = shape_config(shape)
    dp = _batch_dp(sc, plan, mesh)

    def cache_spec(path_s: str, shp: tuple) -> tuple:
        # stacked caches: (L, B, S, ...): batch over DP; seq or heads on TP
        parts: list = [None] * len(shp)
        if len(shp) >= 2 and _fits(mesh, shp[1], dp):
            parts[1] = spec_entry(dp)
        if len(shp) >= 3:
            # kv: (L,B,S,Hkv,hd) | mla: (L,B,S,r) | ring: (L,B,W,Hkv,hd)
            if "kv/k" in path_s or "kv/v" in path_s or "c_kv" in path_s \
                    or "k_rope" in path_s:
                if len(shp) == 5 and _fits(mesh, shp[3], plan.tp):
                    parts[3] = plan.tp           # kv heads divide TP
                elif _fits(mesh, shp[2], plan.tp):
                    parts[2] = plan.tp           # shard the sequence
            else:
                # recurrent states: shard the widest inner dim on TP
                for i in range(2, len(shp)):
                    if parts[i] is None \
                            and shp[i] % _axis_size(mesh, plan.tp) == 0 \
                            and shp[i] >= _axis_size(mesh, plan.tp):
                        parts[i] = plan.tp
                        break
        return tuple(parts)

    def f(path_s, leaf):
        shp = tuple(leaf.shape)
        if "cache" in path_s:
            return cache_spec(path_s, shp)
        parts: list = [None] * len(shp)
        if (len(shp) >= 1 and dp is not None and shp[0] == sc.global_batch
                and _fits(mesh, shp[0], dp)
                and not (plan.decode_2d and sc.kind == "decode")):
            parts[0] = spec_entry(dp)
        return tuple(parts)

    return _map_paths(f, specs_tree)


def activation_rules(cfg: ModelConfig, shape, plan: ShardingPlan,
                     mesh) -> dict:
    """Logical-axis rules for :func:`repro_torch.distributed.api.use_rules`."""
    sc = shape_config(shape)
    dp = _batch_dp(sc, plan, mesh)
    tp = _axis_size(mesh, plan.tp)
    rules = {
        "batch": None if (plan.decode_2d and sc.kind == "decode") else dp,
        "heads": plan.tp if cfg.n_heads % tp == 0 else None,
        "kv_heads": plan.tp if cfg.n_kv_heads % tp == 0 else None,
        "ffn": plan.tp,
        "vocab": plan.tp,
        "expert": plan.tp if (cfg.n_experts and
                              cfg.n_experts % tp == 0) else None,
        "seq": None,
        # Megatron sequence parallelism: residual stream seq-sharded over
        # the TP axis between TP regions (train/prefill, attention models;
        # recurrent scans keep their sequence axis unsharded); narrow
        # models (d_model < 4096) skip it
        "seq_sp": (plan.tp if sc.kind in ("train", "prefill") and
                   cfg.family in ("dense", "moe", "encdec", "vlm") and
                   cfg.d_model >= 4096 else None),
        # decode weight-stationary mode: residual features sharded over the
        # data axis so every matmul is a local partial sum + a small
        # activation all-reduce (no per-token weight gathers)
        "dmodel": (plan.dp[-1] if (plan.decode_2d and sc.kind == "decode")
                   else None),
    }
    if sc.name == "long_500k":
        rules["seq"] = plan.dp[-1]      # sequence parallelism for SP decode
    return rules
