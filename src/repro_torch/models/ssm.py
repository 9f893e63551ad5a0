"""Mamba-style selective SSM heads (hymba's parallel heads) and xLSTM's
mLSTM and sLSTM cells, after ``repro/models/ssm.py``.  Plain PyTorch: the
reference runs them through XLA (``associative_scan`` and ``lax.scan``),
with no Pallas kernel.

Prefill runs the recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t``
as a scan over chunks of :data:`CHUNK` tokens: inside a chunk a
Hillis-Steele doubling scan of the (decay, input) pairs (the reference's
``associative_scan`` combine), then the carry from the previous chunk.
Only one chunk's (B, CHUNK, di, N) fp32 tensors are live at a time (at
hymba-1.5b's S = 4,096 one whole-sequence tensor would be 839 MB a
layer).  Decode is one O(1) state update, written IN PLACE into the
state it is given.

The xLSTM cells run the reference's stabilised recurrences (Beck et al.
'24), token by token, all state and gate arithmetic in fp32.  Prefill
starts from the reference's constants (mLSTM ``m = -1e30``; sLSTM ``n =
1``, ``m = -1e30``), decode from the state it is given (the model's
``init_cache`` zeros, as in the reference), which it updates IN PLACE.
The sLSTM feeds ``h`` back into its gates, so its prefill is a loop over
tokens; the mLSTM's is one too, which keeps the reference's stabiliser
``m_t = max(log_f_t + m_{t-1}, log_i_t)`` and its order of operations
exactly.  A token costs 22 elementwise and product launches in an mLSTM
layer's loop (:func:`_mlstm_step`) and 24 in an sLSTM layer's
(:func:`_slstm_step`): xlstm-125m's prefill runs ~272 CUDA kernels a
token over its 12 layers (17,401 for 64 tokens on an H100), host-bound;
decode adds the projections around one step.  The chunk and token loops
run through :func:`repro_torch.costing.scan` (a dry run charges one
iteration for all of them).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import costing
from repro_torch.distributed.api import lc

from .config import ModelConfig
from .layers import normal

#: tokens a prefill scan chunk holds
CHUNK = 256


def init_mamba(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> dict:
    d, n = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    pd = cfg.pdtype
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "w_in": normal(gen, (d, 2 * di), pd, device),
        "conv": normal(gen, (cfg.ssm_conv, di), pd, device),
        "w_bc": normal(gen, (di, 2 * n), pd, device),
        "w_dt": normal(gen, (di, di), pd, device) * 0.25,
        "b_dt": torch.full((di,), -4.6, dtype=pd, device=device),
        "a_log": torch.log(a).expand(di, n).contiguous(),
        "d_skip": torch.ones(di, dtype=torch.float32, device=device),
        "w_out": normal(gen, (di, d), pd, device),
    }


def _mamba_core(p, cfg, xz, conv_state=None):
    """Shared pre-SSM computation.  xz: (B,S,2*di).  Returns scan inputs
    and the conv window's last K-1 inputs."""
    cd = cfg.cdtype
    di = cfg.ssm_expand * cfg.d_model
    x, z = xz[..., :di], xz[..., di:]
    kw = p["conv"].to(cd)                           # (K, di)
    k = cfg.ssm_conv
    if conv_state is None:                          # causal depthwise conv
        pad = F.pad(x, (0, 0, k - 1, 0))
        xc = sum(pad[:, i:i + x.shape[1]] * kw[i] for i in range(k))
        new_conv = pad[:, -(k - 1):] if k > 1 else None
    else:        # decode: conv_state (B, K-1, di) holds the previous inputs
        window = torch.cat([conv_state.to(cd), x], dim=1)
        xc = (window * kw[None]).sum(dim=1, keepdim=True)
        new_conv = window[:, 1:]
    xc = F.silu(xc)
    b_ssm, c_ssm = (xc @ p["w_bc"].to(cd)).chunk(2, dim=-1)  # (B,S,N) each
    dt = F.softplus(xc @ p["w_dt"].to(cd) + p["b_dt"].to(cd))  # (B,S,di)
    a = -torch.exp(p["a_log"])                      # (di, N) fp32
    return z, xc, b_ssm, c_ssm, dt, a, new_conv


def _chunk(a, h_prev, dt, b_ssm, xc, c_ssm):
    """One chunk of the scan: its (B,L,...) inputs and the carry h_prev
    (B,di,N) -> (the state after it, y (B,L,di) fp32)."""
    dtf = dt.to(torch.float32)[..., None]
    decay = torch.exp(dtf * a)                                 # (B,L,di,N)
    hs = (dtf * b_ssm.to(torch.float32)[:, :, None, :]
          * xc.to(torch.float32)[..., None])
    # doubling scan of (decay, input): after it, decay[t] is the product of
    # the chunk's decays up to t and hs[t] the state from a zero carry (new
    # tensors each round, so autograd can record it)
    step, n = 1, hs.shape[1]
    while step < n:
        hs = torch.cat([hs[:, :step],
                        decay[:, step:] * hs[:, :-step] + hs[:, step:]],
                       dim=1)
        decay = torch.cat([decay[:, :step],
                           decay[:, step:] * decay[:, :-step]], dim=1)
        step *= 2
    hs = hs + decay * h_prev[:, None]
    y = (hs @ c_ssm.to(torch.float32)[..., None])[..., 0]
    return hs[:, -1], y


def _scan(xc, b_ssm, c_ssm, dt, a):
    """The selective scan over the sequence from a zero state, chunk by
    chunk (the full chunks through :func:`repro_torch.costing.scan`, then
    the tail): y (B,S,di) fp32 (before the skip) and the last state
    (B,di,N)."""
    bsz, s_len, di = xc.shape
    h = xc.new_zeros((bsz, di, a.shape[1]), dtype=torch.float32)
    full = s_len // CHUNK
    ins = (dt, b_ssm, xc, c_ssm)
    ys = []
    if full:
        h, y = costing.scan(
            full, lambda i, h_, *x: _chunk(a, h_, *x), h,
            [t[:, :full * CHUNK].unflatten(1, (full, CHUNK)) for t in ins],
            stack_dim=1)
        ys.append(y.flatten(1, 2))
    if s_len % CHUNK:
        h, y = _chunk(a, h, *(t[:, full * CHUNK:] for t in ins))
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


def mamba_apply(p: dict, cfg: ModelConfig, x_in: torch.Tensor,
                state: Optional[dict] = None):
    """``state=None``: full-sequence prefill through the chunked scan.
    ``state=dict(conv=(B,K-1,di), ssm=(B,di,N))`` (fp32): one-step decode,
    the new state written into those tensors IN PLACE.  Returns
    ``(out (B,S,d), state)`` (prefill: the state after the last token)."""
    cd = cfg.cdtype
    xz = x_in @ p["w_in"].to(cd)
    if state is None:
        z, xc, b_ssm, c_ssm, dt, a, new_conv = _mamba_core(p, cfg, xz)
        y, h_last = _scan(xc, b_ssm, c_ssm, dt, a)
        y = y + xc.to(torch.float32) * p["d_skip"]
        new_state = {"ssm": h_last}
        if new_conv is not None:
            new_state["conv"] = new_conv
    else:
        z, xc, b_ssm, c_ssm, dt, a, new_conv = _mamba_core(
            p, cfg, xz, conv_state=state.get("conv"))
        dtf = dt.to(torch.float32)[:, 0, :, None]                 # (B,di,1)
        h = (torch.exp(dtf * a) * state["ssm"]
             + dtf * b_ssm.to(torch.float32)[:, 0, None, :]
             * xc.to(torch.float32)[:, 0, :, None])               # (B,di,N)
        y = (h @ c_ssm[:, 0].to(torch.float32)[..., None])[..., 0][:, None]
        y = y + xc.to(torch.float32) * p["d_skip"]
        state["ssm"].copy_(h)
        if new_conv is not None:
            state["conv"].copy_(new_conv)
        new_state = state
    y = y.to(cd) * F.silu(z)
    return lc(y @ p["w_out"].to(cd), "batch", "seq", None), new_state


def mamba_state_shape(cfg: ModelConfig, batch: int) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    st = {"ssm": (batch, di, cfg.ssm_state)}
    if cfg.ssm_conv > 1:
        st["conv"] = (batch, cfg.ssm_conv - 1, di)
    return st


# ------------------------------------------------------------------ mLSTM
def init_mlstm(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    di = cfg.xlstm_expand * d
    pd = cfg.pdtype
    b_if = torch.cat([torch.zeros(h), torch.full((h,), 3.0)])
    return {
        "w_up": normal(gen, (d, 2 * di), pd, device),
        "w_qkv": normal(gen, (di, 3 * di), pd, device),
        "w_if": normal(gen, (di, 2 * h), pd, device),
        "b_if": b_if.to(device=device, dtype=pd),
        "w_down": normal(gen, (di, d), pd, device),
        "gn_scale": torch.ones(di, dtype=pd, device=device),
    }


def _mlstm_step(c, n, m, q, k, v, log_i, log_f):
    """One stabilised mLSTM step (Beck et al. '24, eqs. 19-27): state c
    (B,H,hd,hd), n (B,H,hd), m (B,H); inputs q, k, v (B,H,hd), log_i,
    log_f (B,H).  Returns (c, n, m, h (B,H,hd))."""
    m_new = torch.maximum(log_f + m, log_i)
    i_g = torch.exp(log_i - m_new)[..., None]
    f_g = torch.exp(log_f + m - m_new)[..., None]
    c = f_g[..., None] * c + i_g[..., None] * (v[..., :, None]
                                               * k[..., None, :])
    n = f_g * n + i_g * k
    denom = torch.maximum((n * q).sum(-1).abs()[..., None],
                          torch.exp(-m_new)[..., None])
    h = (c @ q[..., None])[..., 0] / denom
    return c, n, m_new, h


def mlstm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[dict] = None):
    """``state=None``: prefill of x (B,S,d) from the reference's initial
    state, a loop over the S tokens.  ``state=dict(c, n, m)`` (fp32, see
    :func:`mlstm_state_shape`): one decode step, the new state written
    into those tensors IN PLACE.  Returns ``(out (B,S,d), state)``."""
    cd = cfg.cdtype
    b, s_len, d = x.shape
    hh = cfg.n_heads
    di = cfg.xlstm_expand * d
    hd = di // hh
    up = x @ p["w_up"].to(cd)
    u, z = up[..., :di], up[..., di:]
    q, k, v = (u @ p["w_qkv"].to(cd)).to(torch.float32).chunk(3, dim=-1)
    root = math.sqrt(hd)
    q = q.reshape(b, s_len, hh, hd) / root                    # (B,S,H,hd)
    k = k.reshape(b, s_len, hh, hd) / root
    v = v.reshape(b, s_len, hh, hd)
    gates = (u @ p["w_if"].to(cd) + p["b_if"].to(cd)).to(torch.float32)
    log_i, f_pre = gates[..., :hh], gates[..., hh:]
    log_f = -F.softplus(-f_pre)                               # log sigmoid
    if state is None:
        c = x.new_zeros((b, hh, hd, hd), dtype=torch.float32)
        n = x.new_zeros((b, hh, hd), dtype=torch.float32)
        m = x.new_full((b, hh), -1e30, dtype=torch.float32)

        def step(_, cnm, *xt):
            c_, n_, m_, h = _mlstm_step(*cnm, *xt)
            return (c_, n_, m_), h
        (c, n, m), h_seq = costing.scan(s_len, step, (c, n, m),
                                        (q, k, v, log_i, log_f),
                                        stack_dim=1)          # (B,S,H,hd)
        new_state = {"c": c, "n": n, "m": m}
    else:
        c, n, m, h = _mlstm_step(state["c"], state["n"], state["m"],
                                 q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                 log_f[:, 0])
        for key, val in (("c", c), ("n", n), ("m", m)):
            state[key].copy_(val)
        h_seq = h[:, None]
        new_state = state
    h_flat = h_seq.reshape(b, -1, di).to(cd)
    # group-norm-ish stabilisation, then the gate
    h_flat = h_flat * torch.rsqrt(
        (h_flat.to(torch.float32) ** 2).mean(-1, keepdim=True) + 1e-6
    ).to(cd) * p["gn_scale"].to(cd)
    out = (h_flat * F.silu(z)) @ p["w_down"].to(cd)
    return lc(out, "batch", "seq", None), new_state


def mlstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    di = cfg.xlstm_expand * cfg.d_model
    hd = di // cfg.n_heads
    return {"c": (batch, cfg.n_heads, hd, hd),
            "n": (batch, cfg.n_heads, hd),
            "m": (batch, cfg.n_heads)}


# ------------------------------------------------------------------ sLSTM
def init_slstm(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    pd = cfg.pdtype
    return {
        "w_x": normal(gen, (d, 4 * d), pd, device),
        "r_h": normal(gen, (h, hd, 4 * hd), pd, device),
        "b": torch.zeros(4 * d, dtype=pd, device=device),
        "w_up": normal(gen, (d, 2 * cfg.xlstm_expand * d), pd, device),
        "w_down": normal(gen, (cfg.xlstm_expand * d, d), pd, device),
    }


def _slstm_step(r_h, h_prev, c_prev, n_prev, m_prev, x_t):
    """One stabilised sLSTM step with per-head recurrent mixing: state h,
    c, n, m (B,H,hd) fp32, r_h (H,hd,4hd) fp32, x_t (B,4d) the input's
    gate pre-activations.  Returns (h, c, n, m)."""
    b, hh, hd = h_prev.shape
    rec = torch.einsum("bhd,hde->bhe", h_prev, r_h)
    gates = x_t.reshape(b, hh, 4 * hd).to(torch.float32) + rec
    zi, ii, fi, oi = gates.chunk(4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_f = -F.softplus(-fi)
    m_new = torch.maximum(log_f + m_prev, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(log_f + m_prev - m_new)
    c = f_g * c_prev + i_g * z
    n = f_g * n_prev + i_g
    h = o * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def slstm_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[dict] = None):
    """``state=None``: prefill of x (B,S,d) from the reference's initial
    state (h = c = 0, n = 1, m = -1e30), a loop over the S tokens (h
    feeds the next token's gates).  ``state=dict(h, c, n, m)`` (fp32, see
    :func:`slstm_state_shape`): one decode step, the new state written
    into those tensors IN PLACE.  Returns ``(out (B,S,d), state)``."""
    cd = cfg.cdtype
    b, s_len, d = x.shape
    hh = cfg.n_heads
    hd = d // hh
    xg = x @ p["w_x"].to(cd) + p["b"].to(cd)
    r_h = p["r_h"].to(torch.float32)
    if state is None:
        h = x.new_zeros((b, hh, hd), dtype=torch.float32)
        c = torch.zeros_like(h)
        n = torch.ones_like(h)
        m = torch.full_like(h, -1e30)

        def step(_, hcnm, x_t):
            new = _slstm_step(r_h, *hcnm, x_t)
            return new, new[0]
        (h, c, n, m), h_seq = costing.scan(s_len, step, (h, c, n, m), (xg,),
                                           stack_dim=1)
        h_seq = h_seq.reshape(b, s_len, d)
        new_state = {"h": h, "c": c, "n": n, "m": m}
    else:
        new = _slstm_step(r_h, state["h"], state["c"], state["n"],
                          state["m"], xg[:, 0])
        for key, val in zip(("h", "c", "n", "m"), new):
            state[key].copy_(val)
        h_seq = new[0].reshape(b, 1, d)
        new_state = state
    up = h_seq.to(cd) @ p["w_up"].to(cd)
    di = cfg.xlstm_expand * d
    u, z = up[..., :di], up[..., di:]
    out = (u * F.silu(z)) @ p["w_down"].to(cd)
    return lc(out, "batch", "seq", None), new_state


def slstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    hd = cfg.d_model // cfg.n_heads
    sh = (batch, cfg.n_heads, hd)
    return {"h": sh, "c": sh, "n": sh, "m": sh}
