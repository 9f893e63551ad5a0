"""Model assembly for the dense decoder-only LMs, after
``repro/models/model.py``.

Three entry points per model (built by :func:`build_model`):
  - ``forward(params, batch)``            -> logits (teacher-forced, causal)
  - ``prefill(params, batch)``            -> last-position logits
  - ``decode_step(params, cache, batch)`` -> (logits, cache)  (one token)

Attention runs on the hand-written kernels: B8 (``flash_attention``) in
``forward``/``prefill``, B9 (``decode_attention``) in ``decode_step``, one
launch per layer each.  The layer stack is a Python loop over a list of
per-layer param dicts; :func:`params_from_reference` turns the JAX
package's parameters (as numpy arrays, the scanned layout with a leading
L axis or the unrolled list) into this form.

The decode cache is ``{"kv": {"k": (L,B,S,Hkv,D), "v": ...}}`` in the
compute dtype, and ``decode_step`` writes the new K/V into it IN PLACE
(the returned cache is the same tensors): the reference's functional
update would copy the whole cache per step.  A decode ``pos`` must lie
in ``[0, max_seq)``.

Only ``family == "dense"`` with ``attention == "full"`` is ported; every
other family raises ``NotImplementedError`` (``ROADMAP.md`` queue A item 11).
Entry points run on the card unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise L.not_ported(f"the {cfg.family!r} model family")
    if cfg.attention != "full":
        raise L.not_ported(f"{cfg.attention!r} attention")


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (nothing
    falls back to the CPU when no card is there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run on the host")
    return dev


# --------------------------------------------------------------- embeddings
def init_embeddings(cfg: ModelConfig, gen: torch.Generator,
                    device: torch.device) -> dict:
    pd = cfg.pdtype
    p = {"tok": L.normal(gen, (cfg.padded_vocab, cfg.d_model), pd, device),
         "norm_f": L._norm_init(cfg.d_model, pd, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = L.normal(gen, (cfg.d_model, cfg.padded_vocab), pd,
                                device)
    return p


def embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["tok"].to(cfg.cdtype))


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(p["norm_f"], x, cfg.norm_eps)
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w.to(cfg.cdtype)


# ------------------------------------------------------------------ blocks
def init_block(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> dict:
    p: dict[str, Any] = {"ln1": L._norm_init(cfg.d_model, cfg.pdtype, device),
                         "ln2": L._norm_init(cfg.d_model, cfg.pdtype, device),
                         "attn": L.init_attention(cfg, gen, device)}
    if cfg.d_ff > 0:
        p["mlp"] = L.init_mlp(cfg, gen, device)
    return p


def block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache=None, cache_pos=None,
                rope=None):
    """Returns (x, new_cache).  ``cache`` is this layer's ``{"kv": ...}``
    (decode only); ``rope`` the precomputed ``(cos, sin)``."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, kv = L.attention_apply(
        p["attn"], cfg, h, positions,
        kv_cache=None if cache is None else cache["kv"],
        cache_positions=cache_pos, rope=rope)
    x = x + attn_out
    if cfg.d_ff > 0:
        x = x + L.mlp_apply(p["mlp"], cfg, L.rmsnorm(p["ln2"], x,
                                                     cfg.norm_eps))
    return x, {"kv": kv}


# ------------------------------------------------------------------- Model
class Model:
    """The dense decoder-only model on ``device`` (default the card)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- init ---------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> dict:
        """Fresh parameters: the reference's shapes and its 0.02 normal
        init (unit norm scales, zero qkv biases), drawn from
        ``generator`` (default: seed 0 on the model's device)."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        return {"emb": init_embeddings(cfg, generator, self.device),
                "blocks": [init_block(cfg, generator, self.device)
                           for _ in range(cfg.n_layers)]}

    # -- helpers ------------------------------------------------------
    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _run_stack(self, params, x, positions, cache=None, cache_pos=None):
        cfg = self.cfg
        rope = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        for i, layer_p in enumerate(params["blocks"]):
            layer_cache = None if cache is None else {
                "kv": {k: a[i] for k, a in cache["kv"].items()}}
            x, _ = block_apply(layer_p, cfg, x, positions, layer_cache,
                               cache_pos, rope)
        return x

    # -- full-sequence forward ----------------------------------------
    @torch.no_grad()
    def forward(self, params, batch: dict) -> torch.Tensor:
        tokens = self._tokens(batch["tokens"])
        b, s_len = tokens.shape
        x = embed(params["emb"], self.cfg, tokens)
        positions = torch.arange(s_len, device=self.device)[None].expand(
            b, s_len)
        x = self._run_stack(params, x, positions)
        return unembed(params["emb"], self.cfg, x)

    # -- caches --------------------------------------------------------
    def cache_spec(self, batch: int, max_seq: int) -> dict:
        """Shapes/dtypes of the decode cache (per layer, stacked on L)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"kv": {"k": (shape, cfg.cdtype), "v": (shape, cfg.cdtype)}}

    def init_cache(self, batch: int, max_seq: int) -> dict:
        return {"kv": {k: torch.zeros(shape, dtype=dt, device=self.device)
                       for k, (shape, dt) in
                       self.cache_spec(batch, max_seq)["kv"].items()}}

    # -- decode --------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params, cache, batch: dict):
        """One-token decode.  batch: tokens (B,1), pos (B,) the current
        position (kept on the device; no host sync reads it).  The cache is
        updated in place and returned."""
        tokens = self._tokens(batch["tokens"])
        pos = torch.as_tensor(batch["pos"], device=self.device).to(
            torch.int32)
        x = embed(params["emb"], self.cfg, tokens)
        x = self._run_stack(params, x, pos[:, None], cache=cache,
                            cache_pos=pos)
        logits = unembed(params["emb"], self.cfg, x)
        return logits[:, 0], cache

    # -- prefill -------------------------------------------------------
    def prefill(self, params, batch: dict) -> torch.Tensor:
        """Teacher-forced pass returning last-position logits."""
        return self.forward(params, batch)[:, -1]


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)


# ------------------------------------------------- reference parameters
def _to_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiu":      # bfloat16 arrives as its own type
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device="cuda") -> dict:
    """The JAX package's parameters for ``cfg`` (its nested dict with every
    leaf passed through ``np.asarray``) as the port's, in ``cfg.pdtype`` on
    ``device``.  ``tree["blocks"]`` may be the
    scanned layout (one dict, every leaf stacked on a leading L axis) or
    the unrolled list of per-layer dicts."""
    _check_ported(cfg)
    dev = resolve_device(device)

    def conv(a):
        return _to_tensor(a, cfg.pdtype, dev)
    blocks = tree["blocks"]
    if isinstance(blocks, dict):
        n = {np.shape(a)[0] for a in _leaves(blocks)}
        if n != {cfg.n_layers}:
            raise ValueError(f"stacked blocks have leading axes {n}, "
                             f"expected {cfg.n_layers}")
        blocks = [_map(lambda a, i=i: np.asarray(a)[i], blocks)
                  for i in range(cfg.n_layers)]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
    return {"emb": _map(conv, tree["emb"]),
            "blocks": [_map(conv, blk) for blk in blocks]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
