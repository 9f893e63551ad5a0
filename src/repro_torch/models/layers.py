"""Transformer layers of the port: RMSNorm, RoPE, GQA attention (causal,
optionally over a sliding window; an encoder's non-causal self-attention;
cross attention over encoder states), multi-head latent attention (MLA,
DeepSeek-V2 and -V3: a query latent, the KV latent's norm, YaRN), the
four MLPs (SwiGLU / GeGLU / squared-ReLU / GELU) and
the capacity-factor MoE with token dispatch, after
``repro/models/layers.py``.

Functional style, as in the reference: ``init_*`` builds a param dict of
tensors with the reference's shapes; ``*_apply`` consumes it.  Attention
runs on the hand-written kernels through :mod:`repro_torch.kernels.ops`:
prefill and full-sequence passes through ``flash_attention`` (B8, which
skips key tiles outside a window's band; non-causal over K/V of their
own length for an encoder and for cross attention), decode through an
in-place write of the new K/V followed by ``decode_attention`` (B9) over
the valid cache slots, and a decoder's one-row cross attention through B9
over all the encoder's positions.  MLA's prefill decompresses K/V per
head and runs B8 at (Q/K, V) head dims (hd + rope, hd); its absorbed
decode scores the ``r``-wide latent plus the rope key of each cache row
through B9 with one kv head for all query heads, V being a view of the
row's first ``r`` columns.  On CPU tensors the kernels take their plain
PyTorch versions.  The MoE's dispatch and expert products are plain
PyTorch, as they are XLA in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.distributed.api import lc
from repro_torch.kernels import ops
from repro_torch.telemetry.tracing import annotate

from .config import ModelConfig, YaRN


def normal(gen: torch.Generator, shape, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """The reference's init: standard normal draws from ``gen`` (on its
    device) times 0.02, in ``dtype`` on ``device``; on ``meta`` nothing is
    drawn (``gen`` may be None)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                 yarn: Optional[YaRN] = None):
    """positions: (...,) integer -> cos/sin of shape (..., dim//2); with
    ``yarn``, at its frequencies and times its cos/sin factor."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    if yarn is not None:
        ramp = yarn_ramp(yarn, dim, theta).to(positions.device)
        inv = inv / yarn.factor * ramp + inv * (1 - ramp)
    ang = positions.to(torch.float32)[..., None] * inv
    if yarn is None:
        return torch.cos(ang), torch.sin(ang)
    m = yarn_m(yarn, yarn.mscale) / yarn_m(yarn, yarn.mscale_all_dim)
    return torch.cos(ang) * m, torch.sin(ang) * m


def yarn_ramp(yarn: YaRN, dim: int, theta: float) -> torch.Tensor:
    """(dim//2,) fp32: each rotary pair's share of the interpolated
    frequency (theta's over ``factor``), 0 for the pairs that turn more
    than ``beta_fast`` times over ``original_max_position`` (kept as they
    are), 1 for those that turn fewer than ``beta_slow`` times, linear
    between; DeepSeek's ``yarn_find_correction_range`` and
    ``yarn_linear_ramp_mask``."""
    def pair(turns):
        return dim * math.log(yarn.original_max_position
                              / (turns * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(pair(yarn.beta_fast)), 0)
    hi = min(math.ceil(pair(yarn.beta_slow)), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float32)
    return torch.clamp((i - lo) / max(hi - lo, 1e-3), 0, 1)


def yarn_m(yarn: YaRN, mscale: float) -> float:
    """DeepSeek's ``yarn_get_mscale``: 1 + 0.1 mscale ln(factor) (1 at a
    factor of 1 or below)."""
    if yarn.factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(yarn.factor) + 1.0


def yarn_attention_factor(cfg: ModelConfig) -> float:
    """YaRN's factor on the softmax scale, ``m(mscale_all_dim)**2``, where
    the configuration scales its rotary embedding and names that key; 1
    otherwise."""
    y = cfg.rope_scaling
    if y is None or not y.mscale_all_dim:
        return 1.0
    return yarn_m(y, y.mscale_all_dim) ** 2


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
                    attend_pos: Optional[torch.Tensor] = None,
                    xattn_kv: Optional[torch.Tensor] = None, rope=None):
    """GQA attention.  Modes:
       - self-attention train/prefill: ``kv_cache`` None; x (B,S,d)
         through B8, causal and banded to the last ``window`` keys when
         ``window > 0``, or with ``causal=False`` (an encoder) every query
         over all S keys;
       - decode: ``kv_cache = dict(k=(B,T,Hkv,D), v=...)``, x (B,1,d),
         ``cache_positions`` (B,) int32 on the device: the new K/V are
         written at that slot IN PLACE (the cache tensors are updated,
         not copied), then B9 attends over slots ``[0, attend_pos]``
         (default ``cache_positions``; a ring-buffer window cache passes
         its own clamp);
       - cross attention: ``xattn_kv`` the encoder's states (B,T,d), from
         which K and V are projected; no RoPE and no cache.  Every query
         attends to all T positions: through B8 (non-causal, T free of
         S), or, for one query row (a decode step), through B9 with every
         row's ``pos`` at T - 1.
    ``positions`` (B,S) feed RoPE (self-attention only); ``rope`` may
    carry their precomputed ``(cos, sin)``.  Returns ``(y (B,S,d),
    kv_cache or None)``."""
    cd = cfg.cdtype
    b, s, _ = x.shape
    kv_src = x if xattn_kv is None else xattn_kv.to(cd)
    q = _heads(x, p["wq"], cd)
    k = _heads(kv_src, p["wk"], cd)
    v = _heads(kv_src, p["wv"], cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = lc(q, "batch", "seq", "heads", None)
    k = lc(k, "batch", "seq", "kv_heads", None)
    v = lc(v, "batch", "seq", "kv_heads", None)
    if xattn_kv is None:
        cos, sin = rope if rope is not None else rope_cos_sin(
            positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)     # decode: positions is (B,1) = current
    if xattn_kv is not None:
        if window:
            raise ValueError("cross attention takes no window")
        kv_cache = None
        if s == 1:                      # a decode step: B9 over all T keys
            last = torch.full((b,), k.shape[1] - 1, dtype=torch.int32,
                              device=x.device)
            out = ops.decode_attention(q[:, 0].contiguous(), k, v,
                                       last)[:, None]
        else:
            out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      causal=False).transpose(1, 2)
    elif kv_cache is not None:
        idx = cache_positions                      # (B,) int32 write index
        kc, vc = kv_cache["k"], kv_cache["v"]
        spmd.write_rows(kc, idx, k[:, 0])
        spmd.write_rows(vc, idx, v[:, 0])
        out = ops.decode_attention(
            q[:, 0].contiguous(), kc, vc,
            idx if attend_pos is None else attend_pos)[:, None]
    else:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), window=window,
                                  causal=causal).transpose(1, 2)
    out = lc(out, "batch", "seq", "heads", None)
    h, hd = cfg.n_heads, cfg.hd
    y = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1).to(cd)
    return lc(y, "batch", "seq", None), kv_cache


# ------------------------------------------------------------------- MLA
def init_mla(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> dict:
    """MLA's leaves; with ``q_lora_rank`` the query latent ``wq_a``, its
    norm ``q_norm`` and ``wq_b`` in place of ``wq``, with
    ``kv_latent_norm`` the latent's norm ``kv_norm``."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    r, rh, ql = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank
    pd = cfg.pdtype
    if ql:
        p = {"wq_a": normal(gen, (d, ql), pd, device),
             "q_norm": _norm_init(ql, pd, device),
             "wq_b": normal(gen, (ql, h, hd + rh), pd, device)}
    else:
        p = {"wq": normal(gen, (d, h, hd + rh), pd, device)}
    p["wdkv"] = normal(gen, (d, r), pd, device)
    if cfg.kv_latent_norm:
        p["kv_norm"] = _norm_init(r, pd, device)
    p.update(wuk=normal(gen, (r, h, hd), pd, device),
             wuv=normal(gen, (r, h, hd), pd, device),
             wkr=normal(gen, (d, rh), pd, device),
             wo=normal(gen, (h, hd, d), pd, device))
    return p


def latent_rows(kv: dict) -> torch.Tensor:
    """The (B,S,1,r+rh) cache rows ``[c_kv | k_rope]`` that ``kv["c_kv"]``
    (B,S,r) and ``kv["k_rope"]`` (B,S,rh) are column views of (the layout
    :meth:`repro_torch.models.Model.init_cache` builds); anything else
    raises."""
    c, kr = kv["c_kv"], kv["k_rope"]
    if spmd.is_dtensor(c):      # the local shards' rows, laid out as c_kv
        from torch.distributed.tensor import DTensor
        rows = latent_rows({"c_kv": c.to_local(), "k_rope": kr.to_local()})
        return DTensor.from_local(rows, c.device_mesh, c.placements,
                                  run_check=False)
    b, s, r = c.shape
    w = r + kr.shape[-1]
    if (c.stride(-1) != 1 or c.stride(-2) != w or kr.stride() != c.stride()
            or kr.data_ptr() != c.data_ptr() + r * c.element_size()):
        raise ValueError("MLA decode: c_kv and k_rope must be column views "
                         "of one (B, S, r + rope_head_dim) row buffer")
    return c.as_strided((b, s, 1, w), (c.stride(0), w, w, 1))


def mla_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, kv_cache: Optional[dict] = None,
              cache_positions: Optional[torch.Tensor] = None, rope=None):
    """Multi-head latent attention (DeepSeek-V2 and -V3), in the profiler
    span ``attention/mla``.

    Queries from ``x`` through ``wq``, or (``q_lora_rank``) through the
    latent ``wq_a``, its RMSNorm and ``wq_b``; the KV latent ``c_kv =
    x wdkv``, RMS-normed where ``kv_latent_norm``.
    Prefill/train: decompress K/V per head and run B8 on the head-dim
    concat of the nope and rope terms (Q/K at hd + rh, V at hd, Hkv = H).
    B8 scales by 1/sqrt(hd + rh); YaRN's factor on the softmax scale
    (:func:`yarn_attention_factor`) is folded into the query first, one
    more rounding of it in the compute dtype.
    Decode: the *absorbed* path.  ``wuk`` folds into the query, whose
    ``r`` latent columns plus its rope part score each cache row
    ``[c_kv | k_rope]`` through B9 (one kv head, G = H), with V the row's
    first ``r`` columns (a view: the row is read once) and the scale
    1/sqrt(hd + rh) times YaRN's factor; ``wuv`` then maps the latent
    output to the heads.  The new row (the normed latent) is written IN
    PLACE at ``cache_positions``.  ``rope`` may carry the precomputed ``(cos,
    sin)`` of ``positions`` at dim rh."""
    with annotate("attention/mla"):
        cd = cfg.cdtype
        hd, h, rh, r = cfg.hd, cfg.n_heads, cfg.rope_head_dim, cfg.kv_lora_rank
        b, s, _ = x.shape
        if cfg.q_lora_rank:
            ql = rmsnorm(p["q_norm"], x @ p["wq_a"].to(cd), cfg.norm_eps)
            q = _heads(ql, p["wq_b"], cd)
        else:
            q = _heads(x, p["wq"], cd)
        q = lc(q, "batch", "seq", "heads", None)
        q_nope, q_rope = q[..., :hd], q[..., hd:]
        cos, sin = rope if rope is not None else rope_cos_sin(
            positions, rh, cfg.rope_theta, cfg.rope_scaling)
        q_rope = apply_rope(q_rope, cos, sin)
        c_kv = x @ p["wdkv"].to(cd)                              # (B,S,r)
        if cfg.kv_latent_norm:
            c_kv = rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps)
        k_rope = apply_rope((x @ p["wkr"].to(cd))[:, :, None, :], cos, sin)
        m2 = yarn_attention_factor(cfg)
        if kv_cache is None:
            k_nope = _heads(c_kv, p["wuk"], cd)
            vv = _heads(c_kv, p["wuv"], cd)
            q_cat = torch.cat([q_nope, q_rope], dim=-1)
            # B8's scale is 1/sqrt(hd + rh), the head dim of q_cat
            if m2 != 1.0:
                q_cat = q_cat * m2
            k_cat = torch.cat([k_nope, k_rope.expand(b, s, h, rh)], dim=-1)
            out = ops.flash_attention(q_cat.transpose(1, 2),
                                      k_cat.transpose(1, 2),
                                      vv.transpose(1, 2)).transpose(1, 2)
        else:
            rows = latent_rows(kv_cache)
            spmd.write_rows(rows[:, :, 0], cache_positions,
                            torch.cat([c_kv[:, 0], k_rope[:, 0, 0]], dim=-1))
            q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0],
                                 p["wuk"].to(cd))
            q_lat = torch.cat([q_abs, q_rope[:, 0]], dim=-1).contiguous()
            scale = m2 / float(hd + rh) ** 0.5
            out_c = ops.decode_attention(q_lat, rows, rows[..., :r],
                                         cache_positions, scale)  # (B,H,r)
            out = torch.einsum("bhr,rhk->bhk", out_c,
                               p["wuv"].to(cd))[:, None]
        y = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1).to(cd)
        return lc(y, "batch", "seq", None), kv_cache


# ------------------------------------------------------------------- MLPs
def _n_in(mlp: str) -> int:
    return 2 if mlp in ("swiglu", "geglu") else 1


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
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
    h = lc(_act(h, g, cfg.mlp), "batch", "seq", "ffn")
    return lc(h @ p["wo"].to(cd), "batch", "seq", None)


# -------------------------------------------------------------------- MoE
#: leaves the reference creates in fp32 whatever ``param_dtype`` says: the
#: MoE router (``repro/models/layers.py``) and Mamba's ``a_log`` and
#: ``d_skip`` (``repro/models/ssm.py``)
FP32_LEAVES = ("router", "a_log", "d_skip")


def init_moe(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> dict:
    """The fp32 router over all ``n_experts`` (d, E), the layer's share of
    the routed experts (``experts_held``: the first of them) and the
    shared experts.  The ``sigmoid_group`` router's selection bias
    (DeepSeek-V3's ``e_score_correction_bias``) is the router's last row,
    (d + 1, E): one fp32 leaf that the loss reaches, though the bias row's
    gradient is zero (it only selects)."""
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.expert_d_ff or cfg.d_ff
    pd = cfg.pdtype
    rows = d + 1 if cfg.router == "sigmoid_group" else d
    p = {"router": normal(gen, (rows, e), torch.float32, device)}
    e = cfg.experts_held
    p["wi"] = normal(gen, (e, d, f), pd, device)
    if _n_in(cfg.mlp) == 2:
        p["wg"] = normal(gen, (e, d, f), pd, device)
    p["wo"] = normal(gen, (e, f, d), pd, device)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, device,
                               d_ff=f * cfg.n_shared_experts)
    return p


def moe_route(router: torch.Tensor, xt: torch.Tensor, k: int,
              cfg: Optional[ModelConfig] = None):
    """Top-k routing of tokens xt (T,d) over all E experts, from fp32
    logits against the fp32 router's first d rows, in the profiler span
    ``moe/route``.  ``cfg.router`` (``"softmax"`` where ``cfg`` is None):

    - ``"softmax"``: the k best experts by softmax probability, their
      probabilities renormalised;
    - ``"sigmoid_group"`` (DeepSeek-V3's ``noaux_tc``): sigmoid scores;
      for the choice alone, the bias (the router's row d) added; each of
      ``cfg.n_group`` groups of experts scored by the sum of its two best
      biased scores, the best ``cfg.topk_group`` groups kept and the
      others' experts masked to -inf; the k best of what is left; their
      unbiased scores renormalised to sum 1, times ``cfg.routed_scale``.

    Every choice is a stable descending sort: ties go to the lower expert
    (and group), as the reference's top_k.  Returns (weights (T,K) fp32,
    experts (T,K) int64), the experts in descending order."""
    with annotate("moe/route"):
        d = xt.shape[-1]
        logits = xt.to(torch.float32) @ router[:d]
        if cfg is None or cfg.router == "softmax":
            probs = torch.softmax(logits, dim=-1)
            topv, topi = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
            topv, topi = topv[:, :k], topi[:, :k]
            return topv / topv.sum(-1, keepdim=True).clamp_min(1e-9), topi
        scores = torch.sigmoid(logits)
        choice = scores + router[d]
        t, e = choice.shape
        grouped = choice.view(t, cfg.n_group, e // cfg.n_group)
        best2 = torch.sort(grouped, dim=-1, descending=True).values[..., :2]
        groups = torch.sort(best2.sum(-1), dim=-1, descending=True,
                            stable=True).indices[:, :cfg.topk_group]
        keep = torch.zeros_like(grouped[..., 0], dtype=torch.bool)
        keep.scatter_(1, groups, True)
        choice = grouped.masked_fill(~keep[..., None], float("-inf"))
        topi = torch.sort(choice.view(t, e), dim=-1, descending=True,
                          stable=True).indices[:, :k]
        topv = scores.gather(1, topi)
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
        return topv * cfg.routed_scale, topi


def moe_slots(topi: torch.Tensor, e: int, cap: int):
    """Capacity slots of the (token, k) pairs: a pair's slot is its rank
    among its expert's pairs under a stable sort of the pairs by expert
    id, which equals the reference's running count over the pairs in
    token-major order; a pair at or past ``cap`` is dropped.  O(T*K) work
    and no host synchronisation.  Returns (experts (T*K,), slots (T*K,),
    kept (T*K,)).  In the profiler span ``moe/slots``."""
    with annotate("moe/slots"):
        e_flat = topi.reshape(-1)
        srt, order = torch.sort(e_flat, stable=True)
        first = torch.searchsorted(srt, torch.arange(
            e, device=srt.device, dtype=srt.dtype))
        rank = torch.arange(srt.shape[0], device=srt.device) - first[srt]
        pos = torch.empty_like(rank).scatter_(0, order, rank)
        return e_flat, pos, pos < cap


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Top-k capacity-factor MoE with scatter dispatch (Switch-style), the
    reference's dispatch exactly: ``cap = ceil(T k cf / E)`` slots an
    expert, slots by a running count over the token-major (T*K) pairs, a
    pair past ``cap`` dropped (it adds nothing), the expert products one
    ``torch.bmm`` each over (E, cap, d) buffers, the combine a sum over k
    weighted by the renormalised probabilities, plus the shared experts
    as one MLP of width ``f * n_shared``.  ``cap`` depends on T, so a
    forward pass and a decode step drop different pairs, as in the
    reference.  On DTensors the routed experts run on each rank's shards
    (:func:`repro_torch.distributed.spmd.experts`)."""
    b, s_len, d = x.shape
    if spmd.is_dtensor(x):
        y = spmd.experts(p, x, lambda p_, xt, e_lo: moe_experts(
            p_, cfg, xt, e_lo))
    else:
        y = moe_experts(p, cfg, x.reshape(-1, d))
    if "shared" in p:
        y = y + mlp_apply(p["shared"], cfg, x).reshape(-1, d)
    return lc(y.view(b, s_len, d), "batch", "seq", None)


def moe_experts(p: dict, cfg: ModelConfig, xt: torch.Tensor,
                e_lo: int = 0) -> torch.Tensor:
    """The routed experts of :func:`moe_apply` on tokens xt (T,d), of which
    ``p["wi"]`` holds experts ``[e_lo, e_lo + E_l)`` (all E by default):
    every token is routed over all E experts, and the pairs sent to
    experts held elsewhere add nothing here.  Returns (T,d).  Routing,
    slots, dispatch, the expert products and the combine run in the
    profiler span ``moe/experts``."""
    with annotate("moe/experts"):
        cd = cfg.cdtype
        d = xt.shape[1]
        e, k = cfg.n_experts, cfg.top_k
        e_l = p["wi"].shape[0]
        t = xt.shape[0]
        cap = max(1, -(-int(t * k * cfg.capacity_factor) // e))
        topv, topi = moe_route(p["router"], xt, k, cfg)
        e_flat, pos, keep = moe_slots(topi, e, cap)
        if e_l != e:                   # a part of the experts lives here
            e_flat = e_flat - e_lo
            keep = keep & (e_flat >= 0) & (e_flat < e_l)
            e_flat = torch.where(keep, e_flat, 0)
        # kept pairs fill distinct (expert, slot) rows; dropped ones go to one
        # spare row past the buffers, which nothing reads
        row = torch.where(keep, e_flat * cap + pos, e_l * cap)
        src = torch.arange(t, device=xt.device).repeat_interleave(k)
        buf = xt.new_zeros((e_l * cap + 1, d))
        buf.index_copy_(0, row, xt[src])
        xb = lc(buf[:e_l * cap].view(e_l, cap, d), "expert", None, None)
        h = torch.bmm(xb, p["wi"].to(cd))
        g = torch.bmm(xb, p["wg"].to(cd)) if "wg" in p else None
        out_buf = lc(torch.bmm(_act(h, g, cfg.mlp), p["wo"].to(cd)),
                     "expert", None, None)
        gathered = out_buf.reshape(e_l * cap, d)[
            e_flat * cap + torch.where(keep, pos, cap - 1)]
        gathered = torch.where(keep[:, None], gathered, 0)
        return (gathered.view(t, k, d) * topv.view(t, k, 1).to(cd)).sum(dim=1)
