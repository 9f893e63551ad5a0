"""Dense transformer layers of the port: RMSNorm, RoPE, GQA self-attention
and the four MLPs (SwiGLU / GeGLU / squared-ReLU / GELU), after
``repro/models/layers.py``.

Functional style, as in the reference: ``init_*`` builds a param dict of
tensors with the reference's shapes; ``*_apply`` consumes it.  Attention
runs on the hand-written kernels through :mod:`repro_torch.kernels.ops`:
prefill and full-sequence passes through ``flash_attention`` (B8), decode
through an in-place write of the new K/V at ``pos`` followed by
``decode_attention`` (B9) over ``[0, pos]``; on the card both take every
head dim ``configs/`` and the smoke variants use (32, 64, 128, 192, 256).
On CPU tensors those take their plain PyTorch versions.

Not ported (``NotImplementedError``): MLA, MoE, sliding-window, non-causal
and cross attention (``ROADMAP.md`` queue A item 11).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import ModelConfig


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               "(ROADMAP.md, queue A item 11)")


def normal(gen: torch.Generator, shape, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """The reference's init: standard normal draws from ``gen`` (on its
    device) times 0.02, in ``dtype`` on ``device``."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    return x.to(device=device, dtype=dtype)


def _norm_init(d: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions: (...,) integer -> cos/sin of shape (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., heads, dim); cos/sin broadcast over the head axis."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> dict:
    d = cfg.d_model
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    pd = cfg.pdtype
    p = {
        "wq": normal(gen, (d, h, hd), pd, device),
        "wk": normal(gen, (d, hkv, hd), pd, device),
        "wv": normal(gen, (d, hkv, hd), pd, device),
        "wo": normal(gen, (h, hd, d), pd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=pd, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=pd, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=pd, device=device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one (B*S, d) x (d, h*k)
    product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(cd)).view(*x.shape[:-1], h, k)


def attention_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, kv_cache: Optional[dict] = None,
                    cache_positions: Optional[torch.Tensor] = None,
                    xattn_kv=None, rope=None):
    """Causal GQA self-attention.  Modes:
       - train/prefill: ``kv_cache`` None; x (B,S,d) through B8;
       - decode: ``kv_cache = dict(k=(B,T,Hkv,D), v=...)``, x (B,1,d),
         ``cache_positions`` (B,) int32 on the device: the new K/V are
         written at that index IN PLACE (the cache tensors are updated,
         not copied), then B9 attends over ``[0, cache_positions]``.
    ``positions`` (B,S) feed RoPE; ``rope`` may carry their precomputed
    ``(cos, sin)``.  Returns ``(y (B,S,d), kv_cache or None)``."""
    if not causal:
        raise not_ported("non-causal attention")
    if window > 0:
        raise not_ported("sliding-window attention")
    if xattn_kv is not None:
        raise not_ported("cross attention")
    cd = cfg.cdtype
    b, s, _ = x.shape
    q = _heads(x, p["wq"], cd)
    k = _heads(x, p["wk"], cd)
    v = _heads(x, p["wv"], cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    cos, sin = rope if rope is not None else rope_cos_sin(
        positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)         # decode: positions is (B,1) = current
    if kv_cache is not None:
        idx = cache_positions                      # (B,) int32 write index
        bidx = torch.arange(b, device=x.device)
        kc, vc = kv_cache["k"], kv_cache["v"]
        kc[bidx, idx] = k[:, 0].to(kc.dtype)
        vc[bidx, idx] = v[:, 0].to(vc.dtype)
        out = ops.decode_attention(q[:, 0].contiguous(), kc, vc,
                                   idx)[:, None]
    else:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2)).transpose(1, 2)
    h, hd = cfg.n_heads, cfg.hd
    y = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1).to(cd)
    return y, kv_cache


# ------------------------------------------------------------------- MLPs
def _n_in(mlp: str) -> int:
    return 2 if mlp in ("swiglu", "geglu") else 1


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.pdtype
    p = {"wi": normal(gen, (d, f), pd, device)}
    if _n_in(cfg.mlp) == 2:
        p["wg"] = normal(gen, (d, f), pd, device)
    p["wo"] = normal(gen, (f, d), pd, device)
    return p


def _act(h: torch.Tensor, g: Optional[torch.Tensor], kind: str):
    if kind == "swiglu":
        return F.silu(g) * h
    if kind == "geglu":
        return F.gelu(g, approximate="tanh") * h   # the reference's GELU
    if kind == "relu2":
        r = F.relu(h)
        return r * r
    return F.gelu(h, approximate="tanh")


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.cdtype
    h = x @ p["wi"].to(cd)
    g = x @ p["wg"].to(cd) if "wg" in p else None
    return _act(h, g, cfg.mlp) @ p["wo"].to(cd)
