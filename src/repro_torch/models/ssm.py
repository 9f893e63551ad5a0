"""Mamba-style selective SSM heads (hymba's parallel heads), after
``repro/models/ssm.py``.  Plain PyTorch: the reference runs them through
XLA, with no Pallas kernel.

Prefill runs the recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t``
as a scan over chunks of :data:`CHUNK` tokens: inside a chunk a
Hillis-Steele doubling scan of the (decay, input) pairs (the reference's
``associative_scan`` combine), then the carry from the previous chunk.
Only one chunk's (B, CHUNK, di, N) fp32 tensors are live at a time (at
hymba-1.5b's S = 4,096 one whole-sequence tensor would be 839 MB a
layer).  Decode is one O(1) state update, written IN PLACE into the
state it is given.

xLSTM's mLSTM and sLSTM cells are not ported yet (``ROADMAP.md`` queue A
item 11).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def _scan(xc, b_ssm, c_ssm, dt, a):
    """The selective scan over the sequence from a zero state, chunk by
    chunk: y (B,S,di) fp32 (before the skip) and the last state (B,di,N)."""
    bsz, s_len, di = xc.shape
    h_prev = xc.new_zeros((bsz, di, a.shape[1]), dtype=torch.float32)
    ys = []
    for s0 in range(0, s_len, CHUNK):
        sl = slice(s0, s0 + CHUNK)
        dtf = dt[:, sl].to(torch.float32)[..., None]
        decay = torch.exp(dtf * a)                             # (B,L,di,N)
        hs = (dtf * b_ssm[:, sl].to(torch.float32)[:, :, None, :]
              * xc[:, sl].to(torch.float32)[..., None])
        # doubling scan of (decay, input): after it, decay[t] is the
        # product of the chunk's decays up to t and hs[t] the state from a
        # zero carry
        step, n = 1, hs.shape[1]
        while step < n:
            hs[:, step:] = decay[:, step:] * hs[:, :-step] + hs[:, step:]
            decay[:, step:] = decay[:, step:] * decay[:, :-step]
            step *= 2
        hs += decay * h_prev[:, None]
        ys.append((hs @ c_ssm[:, sl].to(torch.float32)[..., None])[..., 0])
        h_prev = hs[:, -1]
        del decay, hs
    return torch.cat(ys, dim=1), h_prev


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
    return y @ p["w_out"].to(cd), new_state


def mamba_state_shape(cfg: ModelConfig, batch: int) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    st = {"ssm": (batch, di, cfg.ssm_state)}
    if cfg.ssm_conv > 1:
        st["conv"] = (batch, cfg.ssm_conv - 1, di)
    return st
