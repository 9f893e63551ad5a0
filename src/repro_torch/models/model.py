"""Model assembly, after ``repro/models/model.py``: the decoder-only LMs
of the dense, MoE/MLA, hybrid and xLSTM (``ssm``) families, the
encoder-decoder (``encdec``, whisper) and the VLM backbone (``vlm``,
precomputed image embeddings in place of the first text tokens).

Three entry points per model (built by :func:`build_model`):
  - ``forward(params, batch)``            -> logits (teacher-forced, causal)
  - ``prefill(params, batch)``            -> last-position logits
  - ``decode_step(params, cache, batch)`` -> (logits, cache)  (one token)

Attention runs on the hand-written kernels: B8 (``flash_attention``) in
``forward``/``prefill``, B9 (``decode_attention``) in ``decode_step``, one
launch per layer each.  A block is the reference's: attention (GQA, MLA
or, for the hybrid family, a sliding window beside parallel Mamba heads,
averaged) and then an MLP or an MoE.  An xLSTM block is an mLSTM or an
sLSTM cell (``cfg.slstm_at`` lists the sLSTM layers) and no MLP: the
reference computes both cells in every layer and blends them with a 0/1
selector, and the port runs only the selected one, which gives the same
output; the unselected cell's decode state is left as it was (the
reference's evolves unused).  The encoder-decoder's ``forward`` runs
``batch["audio_embeds"]`` (B,T,d) through the encoder (non-causal
self-attention on B8, RoPE over positions ``0..T-1``, no final norm),
and every decoder block adds cross attention over its output (B8,
non-causal with T keys; no RoPE).  ``decode_step`` takes the encoder's
output as an optional ``batch["enc_out"]`` (cross attention then runs
on B9 over all T positions); without it the decoder blocks run
self-attention and the MLP alone, as the reference's do (its serving
engine passes none).  The layer stacks are Python loops over lists of
per-layer param dicts; :func:`params_from_reference` turns the JAX
package's parameters (as numpy arrays, the scanned layout with a leading
L axis or the unrolled list) into this form.

The decode cache holds the reference's keys, stacked on a leading L axis,
and ``decode_step`` writes into it IN PLACE (the returned cache is the
same tensors): the reference's functional update would copy the whole
cache per step.
  - dense/MoE: ``{"kv": {"k": (L,B,S,Hkv,D), "v": ...}}`` in the compute
    dtype;
  - MLA: ``{"kv": {"c_kv": (L,B,S,r), "k_rope": (L,B,S,rh)}}``, both
    column views of one ``(L,B,S,r+rh)`` row buffer that B9 reads;
  - hybrid: ``{"kv": {"k", "v": (L,B,W,Hkv,D)}, "mamba": {"ssm":
    (L,B,di,N), "conv": (L,B,K-1,di)}}``, the attention cache a ring of
    ``W = min(window, max_seq)`` slots (position ``p`` at slot ``p mod
    W``, B9 over slots ``[0, min(p, W-1)]``), the Mamba state fp32;
  - ssm: ``{"mlstm": {"c": (L,B,H,hd,hd), "n", "m"}, "slstm": {"h", "c",
    "n", "m": (L,B,H,d/H)}}``, fp32; its ``decode_step`` reads no ``pos``.
A decode ``pos`` must lie in ``[0, max_seq)``.  Entry points run on the
card unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import costing
from repro_torch.distributed import spmd
from repro_torch.distributed.api import lc
from repro_torch.telemetry.tracing import annotate

from . import layers as L
from . import ssm as S
from .config import ModelConfig

_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (one of "
                         f"{_FAMILIES})")


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
    x = spmd.embedding(p["tok"].to(cfg.cdtype), tokens)
    return lc(x, "batch", "seq", None)


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the vocabulary product, in the profiler span
    ``model/unembed``."""
    with annotate("model/unembed"):
        x = lc(x, "batch", "seq", None)  # gather SP residual before the head
        x = L.rmsnorm(p["norm_f"], x, cfg.norm_eps)
        w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
        return lc(x @ w.to(cfg.cdtype), "batch", "seq", "vocab")


# ------------------------------------------------------------------ blocks
def init_block(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device, i: int = 0) -> dict:
    """Decoder block ``i``'s params (family-dependent; an MoE model's
    first ``cfg.first_dense_layers`` blocks hold an MLP of ``d_ff`` in
    place of the MoE)."""
    p: dict[str, Any] = {"ln1": L._norm_init(cfg.d_model, cfg.pdtype, device),
                         "ln2": L._norm_init(cfg.d_model, cfg.pdtype, device)}
    if cfg.family == "ssm":     # xLSTM: both cells, a layer runs one
        p["mlstm"] = S.init_mlstm(cfg, gen, device)
        p["slstm"] = S.init_slstm(cfg, gen, device)
        return p
    if cfg.attention == "mla":
        p["attn"] = L.init_mla(cfg, gen, device)
    else:
        p["attn"] = L.init_attention(cfg, gen, device)
    if cfg.family == "hybrid" and cfg.ssm_state > 0:
        p["mamba"] = S.init_mamba(cfg, gen, device)
    if cfg.moe_layer(i):
        p["moe"] = L.init_moe(cfg, gen, device)
    elif cfg.d_ff > 0:
        p["mlp"] = L.init_mlp(cfg, gen, device)
    return p


def block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache=None, cache_pos=None,
                attend_pos=None, rope=None, slstm: bool = False):
    """Returns (x, new_cache).  ``cache`` is this layer's cache (decode
    only), ``cache_pos`` the slot each row writes, ``attend_pos`` the
    newest slot it attends to; ``rope`` the precomputed ``(cos, sin)``;
    ``slstm`` picks an xLSTM layer's cell.  The residual stream is laid
    out ``("batch", "seq_sp", "dmodel")`` between the halves, their inputs
    ``("batch", "seq", "dmodel")`` (:func:`_norm_in`)."""
    out, new_cache = mixer_apply(p, cfg, _norm_in(p["ln1"], cfg, x),
                                 positions, cache, cache_pos, attend_pos,
                                 rope, slstm)
    x = _residual(x + out)
    if has_ffn(cfg):
        x = x + ffn_apply(p, cfg, _norm_in(p["ln2"], cfg, x))
    return _residual(x), new_cache


def _norm_in(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """A half's normed input, gathered to the full sequence once (the
    Megatron SP boundary)."""
    return lc(L.rmsnorm(p, x, cfg.norm_eps), "batch", "seq", "dmodel")


def _residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream, sequence-sharded between TP regions where the
    rules say so."""
    return lc(x, "batch", "seq_sp", "dmodel")


def has_ffn(cfg: ModelConfig) -> bool:
    """Whether a decoder block has its second half (an MLP or an MoE)."""
    return cfg.family != "ssm" and (cfg.is_moe or cfg.d_ff > 0)


def ffn_apply(p: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """A block's second half on its normed input ``h``: the MoE or the
    MLP, whichever the block holds."""
    if "moe" in p:
        return L.moe_apply(p["moe"], cfg, h)
    return L.mlp_apply(p["mlp"], cfg, h)


def mixer_apply(p: dict, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, cache=None, cache_pos=None,
                attend_pos=None, rope=None, slstm: bool = False):
    """A block's first half on its normed input ``h``: attention (beside
    the Mamba heads for the hybrid family) or an xLSTM cell.  Returns
    (its output, new_cache)."""
    if cfg.family == "ssm":
        name = "slstm" if slstm else "mlstm"
        cell = S.slstm_apply if slstm else S.mlstm_apply
        out, state = cell(p[name], cfg, h,
                          None if cache is None else cache[name])
        return out, {name: state}          # d_ff = 0: no MLP
    window = cfg.sliding_window if cfg.attention == "sliding" else 0
    kv = None if cache is None else cache["kv"]
    if cfg.attention == "mla":
        attn_out, kv = L.mla_apply(p["attn"], cfg, h, positions,
                                   kv_cache=kv, cache_positions=cache_pos,
                                   rope=rope)
    else:
        attn_out, kv = L.attention_apply(
            p["attn"], cfg, h, positions, window=window, kv_cache=kv,
            cache_positions=cache_pos, attend_pos=attend_pos, rope=rope)
    new_cache = {"kv": kv}
    if cfg.family == "hybrid":
        mb_out, mb_state = S.mamba_apply(
            p["mamba"], cfg, h, None if cache is None else cache["mamba"])
        attn_out = 0.5 * (attn_out + mb_out)       # parallel heads (hymba)
        new_cache["mamba"] = mb_state
    return attn_out, new_cache


def block_remat(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rope=None, slstm: bool = False,
                enc_out=None) -> torch.Tensor:
    """A decoder block of a training forward, rematerialised as the
    reference's ``cfg.remat`` does: ``remat_policy="none"`` keeps only
    the block's input and recomputes the whole block in the backward pass;
    ``"save_boundaries"`` checkpoints the norms and the two halves apart,
    so the halves' normed inputs are kept (the reference's
    ``blk_attn_in`` / ``blk_mlp_in``; a block with cross attention names
    none there, and is recomputed whole)."""
    def ckpt(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=costing.remat_contexts)
    if enc_out is not None:
        return ckpt(lambda x_: xattn_block_apply(p, cfg, x_, positions,
                                                  enc_out, rope=rope)[0], x)
    if cfg.remat_policy != "save_boundaries":
        return ckpt(lambda x_: block_apply(p, cfg, x_, positions, rope=rope,
                                           slstm=slstm)[0], x)
    h = ckpt(lambda x_: _norm_in(p["ln1"], cfg, x_), x)
    x = _residual(x + ckpt(lambda h_: mixer_apply(
        p, cfg, h_, positions, rope=rope, slstm=slstm)[0], h))
    if has_ffn(cfg):
        h2 = ckpt(lambda x_: _norm_in(p["ln2"], cfg, x_), x)
        x = x + ckpt(lambda h_: ffn_apply(p, cfg, h_), h2)
    return _residual(x)


# ----------------------------------------------------------- encoder blocks
def init_enc_block(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> dict:
    pd = cfg.pdtype
    return {"ln1": L._norm_init(cfg.d_model, pd, device),
            "ln2": L._norm_init(cfg.d_model, pd, device),
            "attn": L.init_attention(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def enc_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, rope=None) -> torch.Tensor:
    """An encoder block: non-causal self-attention (B8 over all T keys,
    with RoPE), then the MLP."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _ = L.attention_apply(p["attn"], cfg, h, positions, causal=False,
                             rope=rope)
    x = x + a
    return x + L.mlp_apply(p["mlp"], cfg, L.rmsnorm(p["ln2"], x,
                                                     cfg.norm_eps))


def init_xattn_block(cfg: ModelConfig, gen: torch.Generator,
                     device: torch.device) -> dict:
    pd = cfg.pdtype
    return {"ln1": L._norm_init(cfg.d_model, pd, device),
            "lnx": L._norm_init(cfg.d_model, pd, device),
            "ln2": L._norm_init(cfg.d_model, pd, device),
            "attn": L.init_attention(cfg, gen, device),
            "xattn": L.init_attention(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def xattn_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, enc_out: torch.Tensor,
                      cache=None, cache_pos=None, rope=None):
    """A decoder block with cross attention: causal self-attention (B8, or
    B9 through ``cache`` in decode), cross attention over ``enc_out``
    (B8 non-causal, or B9 for a decode step's one row; no RoPE), then the
    MLP.  Returns (x, new_cache)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = L.attention_apply(p["attn"], cfg, h, positions,
                              kv_cache=None if cache is None
                              else cache["kv"], cache_positions=cache_pos,
                              rope=rope)
    x = _residual(x + a)
    hx = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
    xa, _ = L.attention_apply(p["xattn"], cfg, hx, positions,
                              xattn_kv=enc_out)
    x = _residual(x + xa)
    x = x + L.mlp_apply(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return _residual(x), {"kv": kv}


# ------------------------------------------------------------------- Model
class Model:
    """A model of any of :data:`_FAMILIES` on ``device`` (default the
    card)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- init ---------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> dict:
        """Fresh parameters: the reference's shapes, dtypes (the leaves of
        :data:`~repro_torch.models.layers.FP32_LEAVES` in fp32) and its
        0.02 normal init (unit norm scales, zero qkv biases, Mamba's
        constant leaves), drawn from ``generator`` (default: seed 0 on the
        model's device).  On ``meta`` nothing is drawn."""
        cfg = self.cfg
        if generator is None and self.device.type != "meta":
            generator = torch.Generator(self.device).manual_seed(0)
        params = {"emb": init_embeddings(cfg, generator, self.device),
                  "blocks": [init_xattn_block(cfg, generator, self.device)
                             if cfg.n_enc_layers else
                             init_block(cfg, generator, self.device, i)
                             for i in range(cfg.n_layers)]}
        if cfg.n_enc_layers:
            params["enc"] = [init_enc_block(cfg, generator, self.device)
                             for _ in range(cfg.n_enc_layers)]
        return params

    def init_shapes(self) -> dict:
        """Every parameter as a meta tensor of :meth:`init`'s shape and
        dtype, nothing allocated (the dry run's parameters)."""
        return Model(self.cfg, "meta").init()

    # -- helpers ------------------------------------------------------
    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _rope(self, positions):
        cfg = self.cfg
        if cfg.family == "ssm":
            return None
        dim = cfg.rope_head_dim if cfg.attention == "mla" else cfg.hd
        return L.rope_cos_sin(positions, dim, cfg.rope_theta,
                              cfg.rope_scaling)

    def _run_stack(self, params, x, positions, cache=None, cache_pos=None,
                   attend_pos=None, enc_out=None):
        cfg = self.cfg
        rope = self._rope(positions)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer_p in enumerate(params["blocks"]):
            if remat and (x.requires_grad or any(
                    t.requires_grad for t in _leaves(layer_p))):
                x = block_remat(layer_p, cfg, x, positions, rope,
                                i in cfg.slstm_at, enc_out)
                continue
            layer_cache = None if cache is None else _map(
                lambda a, _, i=i: a[i], cache)
            if enc_out is not None:
                x, _ = xattn_block_apply(layer_p, cfg, x, positions, enc_out,
                                         layer_cache, cache_pos, rope)
            else:
                x, _ = block_apply(layer_p, cfg, x, positions, layer_cache,
                                   cache_pos, attend_pos, rope,
                                   slstm=i in cfg.slstm_at)
        return x

    def _encode(self, params, audio_embeds) -> torch.Tensor:
        """The encoder over (B,T,d) frame embeddings: ``n_enc_layers``
        blocks of non-causal self-attention and MLP, no final norm."""
        x = torch.as_tensor(audio_embeds, device=self.device).to(
            self.cfg.cdtype)
        b, t = x.shape[:2]
        positions = torch.arange(t, device=self.device)[None].expand(b, t)
        rope = self._rope(positions)
        for layer_p in params["enc"]:
            x = enc_block_apply(layer_p, self.cfg, x, positions, rope)
        return x

    # -- full-sequence forward (train) --------------------------------
    def forward(self, params, batch: dict) -> torch.Tensor:
        """Teacher-forced logits (B,S,V) of ``batch["tokens"]`` (B,S);
        the VLM's ``batch["image_embeds"]`` (B,n_img,d) replace the first
        n_img token embeddings, the encoder-decoder's
        ``batch["audio_embeds"]`` (B,T,d) feed its encoder.  Records a
        graph where grad mode is on and a parameter requires grad (the
        train step's), each decoder block then rematerialised when
        ``cfg.remat`` (:func:`block_remat`); the model's own parameters
        require none, so a serving caller builds no graph."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        b, s_len = tokens.shape
        x = embed(params["emb"], cfg, tokens)
        if cfg.family == "vlm":
            img = torch.as_tensor(batch["image_embeds"],
                                  device=self.device).to(cfg.cdtype)
            n_img = img.shape[1]
            if n_img > s_len:
                raise ValueError(f"vlm: {n_img} image tokens exceed "
                                 f"seq_len {s_len}")
            x = torch.cat([img, x[:, n_img:]], dim=1)
        positions = torch.arange(s_len, device=self.device)[None].expand(
            b, s_len)
        enc_out = (self._encode(params, batch["audio_embeds"])
                   if cfg.n_enc_layers else None)
        x = self._run_stack(params, x, positions, enc_out=enc_out)
        return unembed(params["emb"], cfg, x)

    # -- caches --------------------------------------------------------
    def cache_spec(self, batch: int, max_seq: int) -> dict:
        """Shapes/dtypes of the decode cache (per layer, stacked on L)."""
        cfg = self.cfg
        ls, kd = cfg.n_layers, cfg.cdtype
        if cfg.family == "ssm":
            return {cell: {k: ((ls, *v), torch.float32)
                           for k, v in shape(cfg, batch).items()}
                    for cell, shape in (("mlstm", S.mlstm_state_shape),
                                        ("slstm", S.slstm_state_shape))}
        if cfg.family == "hybrid":
            w = min(cfg.sliding_window or max_seq, max_seq)
            kv = (ls, batch, w, cfg.n_kv_heads, cfg.hd)
            return {"kv": {"k": (kv, kd), "v": (kv, kd)},
                    "mamba": {k: ((ls, *v), torch.float32) for k, v in
                              S.mamba_state_shape(cfg, batch).items()}}
        if cfg.attention == "mla":
            return {"kv": {
                "c_kv": ((ls, batch, max_seq, cfg.kv_lora_rank), kd),
                "k_rope": ((ls, batch, max_seq, cfg.rope_head_dim), kd)}}
        kv = (ls, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"kv": {"k": (kv, kd), "v": (kv, kd)}}

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """A zero cache of :meth:`cache_spec`'s shapes; MLA's ``c_kv`` and
        ``k_rope`` are column views of one row buffer, so B9 reads each
        cache row once."""
        spec = self.cache_spec(batch, max_seq)
        if self.cfg.attention == "mla":
            (shape, dt), r = spec["kv"]["c_kv"], self.cfg.kv_lora_rank
            rows = torch.zeros((*shape[:-1], r + self.cfg.rope_head_dim),
                               dtype=dt, device=self.device)
            return {"kv": {"c_kv": rows[..., :r], "k_rope": rows[..., r:]}}
        return _map(lambda sd, _: torch.zeros(sd[0], dtype=sd[1],
                                              device=self.device), spec)

    # -- decode --------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params, cache, batch: dict):
        """One-token decode.  batch: tokens (B,1), pos (B,) the current
        position (kept on the device; no host sync reads it; the xLSTM
        family reads none), and for the encoder-decoder an optional
        ``enc_out`` (B,T,d), the encoder's output.  The cache is updated
        in place and returned.  The hybrid family's ring writes slot ``pos
        mod W`` and attends to slots ``[0, min(pos, W-1)]``, both computed
        on the card."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        pos = torch.as_tensor(batch["pos"], device=self.device).to(
            torch.int32)
        cache_pos = attend = pos
        if cfg.family == "hybrid":
            w = cache["kv"]["k"].shape[2]
            cache_pos = torch.remainder(pos, w)
            attend = torch.clamp(pos, max=w - 1)
        enc_out = batch.get("enc_out")
        if enc_out is not None:
            enc_out = torch.as_tensor(enc_out, device=self.device)
        x = embed(params["emb"], cfg, tokens)
        x = self._run_stack(params, x, pos[:, None], cache=cache,
                            cache_pos=cache_pos, attend_pos=attend,
                            enc_out=enc_out)
        logits = unembed(params["emb"], self.cfg, x)
        return logits[:, 0], cache

    # -- prefill -------------------------------------------------------
    @torch.no_grad()
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


def _map(fn, tree, key=""):
    """``fn(leaf, its key)`` over the leaves of a nested dict (a
    ``(shape, dtype)`` spec pair is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(tree, key)


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device="cuda") -> dict:
    """The JAX package's parameters for ``cfg`` (its nested dict with every
    leaf passed through ``np.asarray``) as the port's on ``device``, in
    ``cfg.pdtype`` but for the leaves the reference keeps in fp32 whatever
    the config says (:data:`~repro_torch.models.layers.FP32_LEAVES`: the
    MoE router, whose Top-k a bf16 rounding would change, and Mamba's
    ``a_log`` and ``d_skip``), which stay fp32.  ``tree["blocks"]`` (and
    an encoder-decoder's ``tree["enc"]``) may be the scanned layout (one
    dict, every leaf stacked on a leading L axis) or the unrolled list of
    per-layer dicts."""
    _check_family(cfg)
    dev = resolve_device(device)

    def conv(a, name):
        dt = torch.float32 if name in L.FP32_LEAVES else cfg.pdtype
        return _to_tensor(a, dt, dev)
    out = {"emb": _map(conv, tree["emb"]),
           "blocks": [_map(conv, blk) for blk in
                      _unstack(tree["blocks"], cfg.n_layers, "blocks")]}
    if cfg.n_enc_layers:
        out["enc"] = [_map(conv, blk) for blk in
                      _unstack(tree["enc"], cfg.n_enc_layers, "enc")]
    return out


def _unstack(layers, n: int, what: str) -> list:
    """Per-layer dicts from the scanned layout (one dict, every leaf
    stacked on a leading axis of ``n``) or the unrolled list."""
    if isinstance(layers, dict):
        lead = {np.shape(a)[0] for a in _leaves(layers)}
        if lead != {n}:
            raise ValueError(f"stacked {what} have leading axes {lead}, "
                             f"expected {n}")
        layers = [_map(lambda a, _, i=i: np.asarray(a)[i], layers)
                  for i in range(n)]
    if len(layers) != n:
        raise ValueError(f"{len(layers)} {what} for {n} layers")
    return layers


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
