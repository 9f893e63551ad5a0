"""The port's encoder-decoder (whisper-medium), xLSTM (xlstm-125m) and VLM
(internvl2-26b) families against the JAX package's, on the CPU in fp32 at
smoke width.

Inputs and weights are numpy draws from a seed handed to both packages.
Attention's plain version and the layers (encoder block, cross-attention
block, mLSTM and sLSTM cells) must agree within 1e-5 (fp32 products summed
in another order; the outputs are O(0.1)); whole-model logits from
``params_from_reference``, in the scanned and the unrolled layout, within
1e-4 through ``forward`` and teacher-forced ``decode_step``.  The xLSTM
smoke variant keeps no sLSTM layer (``smoke_variant`` drops ``slstm_at``
entries past its two layers), so every xLSTM test sets ``slstm_at=(1,)``
in both packages.  The port runs only each layer's selected cell: the
tests compare outputs and the selected cell's state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import smoke_variant as r_smoke
from repro.models import ssm as RS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import (Model, make_decode_step, make_prefill_step,
                                params_from_reference, smoke_variant)
from repro_torch.models import model as M
from repro_torch.models import ssm as S

ATOL_LAYER = 1e-5
ATOL = 1e-4
ARCHS = ["whisper-medium", "xlstm-125m", "internvl2-26b"]
# the xLSTM smoke variant with an sLSTM layer (layer 1; layer 0 mLSTM)
OVER = {"xlstm-125m": {"slstm_at": (1,)}}


def _cfgs(arch, **over):
    over = {**OVER.get(arch, {}), **over}
    rc = dataclasses.replace(r_smoke(r_get_config(arch)), **over)
    tc = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    return rc, tc


def _draw(rng, tree, scale=0.05):
    """A numpy draw shaped like ``tree`` (a dict of arrays), as the
    reference's jnp arrays and the port's tensors."""
    if isinstance(tree, dict):
        pairs = {k: _draw(rng, v, scale) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: t for k, (_, t) in pairs.items()})
    x = (scale * rng.standard_normal(np.shape(tree))).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _x(rng, shape, scale=1.0):
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("t", [1, 16, 37])
@pytest.mark.parametrize("h,hkv,d,s", [(4, 4, 32, 12), (6, 2, 64, 40),
                                       (16, 16, 64, 1)])
def test_attention_ref_non_causal_matches_sdpa(rng, t, h, hkv, d, s):
    """``ref.attention_ref(causal=False)`` with K/V of T rows against
    ``repro.models.layers.sdpa(causal=False)``: every query over all T
    keys (an encoder, cross attention)."""
    b = 2
    qj, qt = _x(rng, (b, s, h, d))
    kj, kt = _x(rng, (b, t, hkv, d))
    vj, vt = _x(rng, (b, t, hkv, d))
    want = np.asarray(RL.sdpa(qj, kj, vj, causal=False))
    got = tref.attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                             vt.transpose(1, 2),
                             causal=False).transpose(1, 2)
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), want, atol=ATOL_LAYER)


def test_flash_attention_wrapper_checks_causal_lengths_and_windows(rng):
    """The wrapper (on the CPU, its plain version) takes T != S only
    without the causal mask, and a window only with it."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.from_numpy(rng.standard_normal((1, 4, 10, 32)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 2, 7, 32)).astype(
        np.float32))
    out = fa.flash_attention(q, kv, kv, causal=False)
    assert out.shape == (1, 4, 10, 32)
    torch.testing.assert_close(out, tref.attention_ref(q, kv, kv,
                                                       causal=False))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q[:, :2], q[:, :2], window=4, causal=False)
    # the op layer passes the mode through
    torch.testing.assert_close(ops.flash_attention(q, kv, kv, causal=False),
                               out)


# ---------------------------------------------------------------- blocks
def _positions(b, s):
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


def test_enc_block_apply_matches_the_reference(rng):
    """The encoder block: non-causal self-attention with RoPE over
    positions 0..T-1, then the MLP."""
    rc, tc = _cfgs("whisper-medium")
    rp = jax.tree.map(np.asarray, RM.init_enc_block(rc, jax.random.PRNGKey(1)))
    rp, tp = _draw(rng, rp, scale=0.1)
    xj, xt = _x(rng, (2, 16, tc.d_model))
    pj, pt = _positions(2, 16)
    want = np.asarray(RM.enc_block_apply(rp, rc, xj, pj))
    got = M.enc_block_apply(tp, tc, xt, pt)
    np.testing.assert_allclose(_np(got), want, atol=ATOL_LAYER)


@pytest.mark.parametrize("s,t", [(12, 16), (1, 16), (20, 5)])
def test_xattn_block_apply_matches_the_reference(rng, s, t):
    """The decoder block with cross attention (Q from the decoder, K/V
    projected from the encoder's T states, no RoPE) in a full pass."""
    rc, tc = _cfgs("whisper-medium")
    rp = jax.tree.map(np.asarray,
                      RM.init_xattn_block(rc, jax.random.PRNGKey(2)))
    rp, tp = _draw(rng, rp, scale=0.1)
    xj, xt = _x(rng, (2, s, tc.d_model))
    ej, et = _x(rng, (2, t, tc.d_model))
    pj, pt = _positions(2, s)
    want, _ = RM.xattn_block_apply(rp, rc, xj, pj, None, ej)
    got, cache = M.xattn_block_apply(tp, tc, xt, pt, et)
    assert cache == {"kv": None}
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_LAYER)


def test_xattn_block_decode_step_matches_the_reference(rng):
    """One decode step of the cross-attention block: self-attention
    through its KV cache (written in place), cross attention of the one
    row over all T encoder states (B9's path)."""
    rc, tc = _cfgs("whisper-medium")
    rp = jax.tree.map(np.asarray,
                      RM.init_xattn_block(rc, jax.random.PRNGKey(3)))
    rp, tp = _draw(rng, rp, scale=0.1)
    b, t, max_seq = 3, 16, 10
    xj, xt = _x(rng, (b, 1, tc.d_model))
    ej, et = _x(rng, (b, t, tc.d_model))
    kv = {k: rng.standard_normal((b, max_seq, tc.n_kv_heads, tc.hd)).astype(
        np.float32) for k in ("k", "v")}
    pos = np.array([0, 4, max_seq - 1], np.int32)
    mask = np.arange(max_seq)[None] <= pos[:, None]
    want, wcache = RM.xattn_block_apply(
        rp, rc, xj, jnp.asarray(pos[:, None]), jnp.asarray(mask), ej,
        {"kv": {k: jnp.asarray(v) for k, v in kv.items()}},
        jnp.asarray(pos))
    cache = {"kv": {k: torch.from_numpy(v.copy()) for k, v in kv.items()}}
    posd = torch.from_numpy(pos)
    n9 = ops.dispatch_stats["launches"]
    got, new = M.xattn_block_apply(tp, tc, xt, posd[:, None], et, cache,
                                   posd)
    # two decode-attention dispatches: self, then cross
    assert ops.dispatch_stats["launches"] - n9 == 2
    assert new["kv"] is cache["kv"]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_LAYER)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache["kv"][k]),
                                   np.asarray(wcache["kv"][k]),
                                   atol=ATOL_LAYER)


# ------------------------------------------------------------ xLSTM cells
def _cell_pair(rng, init):
    rc, tc = _cfgs("xlstm-125m")
    rp = jax.tree.map(np.asarray, init(rc, jax.random.PRNGKey(4)))
    const = {k: rp[k] for k in ("b_if", "gn_scale") if k in rp}
    rp, tp = _draw(rng, rp)
    # the reference's own gate biases (input 0, forget 3) and norm scale
    for k, v in const.items():
        rp[k], tp[k] = jnp.asarray(v), torch.from_numpy(v.copy())
    return rc, tc, rp, tp


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("s", [1, 9, 40])
def test_xlstm_cell_prefill_matches_the_reference(rng, cell, s):
    """The cell over S tokens from the reference's initial state (mLSTM m
    = -1e30; sLSTM n = 1, m = -1e30): outputs and the final state."""
    init, apply_r, apply_t = {
        "mlstm": (RS.init_mlstm, RS.mlstm_apply, S.mlstm_apply),
        "slstm": (RS.init_slstm, RS.slstm_apply, S.slstm_apply)}[cell]
    rc, tc, rp, tp = _cell_pair(rng, init)
    xj, xt = _x(rng, (2, s, tc.d_model))
    want, wstate = apply_r(rp, rc, xj)
    got, state = apply_t(tp, tc, xt)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_LAYER)
    assert set(state) == set(wstate)
    for key in state:
        np.testing.assert_allclose(_np(state[key]), np.asarray(wstate[key]),
                                   atol=ATOL_LAYER, rtol=1e-6)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("start", ["zeros", "drawn"])
def test_xlstm_cell_decode_matches_the_reference(rng, cell, start):
    """One decode step from ``init_cache``'s zeros or from a drawn state,
    the new state written in place."""
    init, apply_r, apply_t, shape_r, shape_t = {
        "mlstm": (RS.init_mlstm, RS.mlstm_apply, S.mlstm_apply,
                  RS.mlstm_state_shape, S.mlstm_state_shape),
        "slstm": (RS.init_slstm, RS.slstm_apply, S.slstm_apply,
                  RS.slstm_state_shape, S.slstm_state_shape)}[cell]
    rc, tc, rp, tp = _cell_pair(rng, init)
    shapes = shape_t(tc, 3)
    assert shapes == shape_r(rc, 3)
    st = {k: (np.zeros(v, np.float32) if start == "zeros" else
              rng.standard_normal(v).astype(np.float32))
          for k, v in shapes.items()}
    if start == "drawn" and "n" in st and cell == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5          # a normaliser's range
    xj, xt = _x(rng, (3, 1, tc.d_model))
    want, wstate = apply_r(rp, rc, xj,
                           {k: jnp.asarray(v) for k, v in st.items()})
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got, new = apply_t(tp, tc, xt, state)
    assert new is state
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_LAYER)
    for key in state:
        np.testing.assert_allclose(_np(state[key]), np.asarray(wstate[key]),
                                   atol=ATOL_LAYER, rtol=1e-6)


def _mlstm_f64(p, cfg, x):
    """The mLSTM prefill in float64 numpy from the same weights: the exact
    value that both packages' fp32 outputs are held to."""
    p = {k: v.numpy().astype(np.float64) for k, v in p.items()}
    x = x.numpy().astype(np.float64)
    b, s, d = x.shape
    hh = cfg.n_heads
    di = cfg.xlstm_expand * d
    hd = di // hh
    up = x @ p["w_up"]
    u, z = up[..., :di], up[..., di:]
    q, k, v = (a.reshape(b, s, hh, hd)
               for a in np.split(u @ p["w_qkv"], 3, axis=-1))
    q, k = q / np.sqrt(hd), k / np.sqrt(hd)
    gates = u @ p["w_if"] + p["b_if"]
    log_i, log_f = gates[..., :hh], -np.logaddexp(0.0, -gates[..., hh:])
    c, n = np.zeros((b, hh, hd, hd)), np.zeros((b, hh, hd))
    m = np.full((b, hh), -1e30)
    hs = []
    for t in range(s):
        m_new = np.maximum(log_f[:, t] + m, log_i[:, t])
        i_g = np.exp(log_i[:, t] - m_new)[..., None]
        f_g = np.exp(log_f[:, t] + m - m_new)[..., None]
        c = f_g[..., None] * c + i_g[..., None] * (v[:, t, :, :, None]
                                                   * k[:, t, :, None, :])
        n = f_g * n + i_g * k[:, t]
        denom = np.maximum(np.abs((n * q[:, t]).sum(-1)), np.exp(-m_new))
        hs.append((c @ q[:, t, :, :, None])[..., 0] / denom[..., None])
        m = m_new
    h = np.stack(hs, axis=1).reshape(b, s, di)
    h = h / np.sqrt((h ** 2).mean(-1, keepdims=True) + 1e-6) * p["gn_scale"]
    return (h * z / (1.0 + np.exp(-z))) @ p["w_down"]


def test_mlstm_prefill_error_at_larger_weights_is_the_references():
    """At weight scale 0.1 the mLSTM's outputs are O(5) and neither
    package holds 1e-5 of the float64 value (both sit up to ~3e-5 away:
    fp32 noise through the |n.q| denominator, which nearly cancels at some
    tokens).  Over six seeds and three lengths the port's largest error
    against float64 stays within twice the reference's own."""
    errs = {"port": 0.0, "reference": 0.0}
    for seed in range(6):
        rng = np.random.default_rng(seed)
        rc, tc = _cfgs("xlstm-125m")
        rp = jax.tree.map(np.asarray, RS.init_mlstm(rc, jax.random.PRNGKey(4)))
        const = {k: rp[k] for k in ("b_if", "gn_scale")}
        rp, tp = _draw(rng, rp, scale=0.1)
        for k, v in const.items():
            rp[k], tp[k] = jnp.asarray(v), torch.from_numpy(v.copy())
        for s in (1, 9, 40):
            xj, xt = _x(rng, (2, s, tc.d_model))
            exact = _mlstm_f64(tp, tc, xt)
            for name, out in (("port", S.mlstm_apply(tp, tc, xt)[0]),
                              ("reference", RS.mlstm_apply(rp, rc, xj)[0])):
                errs[name] = max(errs[name],
                                 float(np.abs(_np(out) - exact).max()))
    assert errs["port"] <= 2.0 * errs["reference"], errs


# ----------------------------------------------------------- whole models
def _batch(tc, rng, b=2, s=12):
    """Tokens plus the family's extras: whisper's 16 smoke frames (S !=
    16), internvl2's 8 image rows."""
    batch = {"tokens": rng.integers(2, tc.vocab_size, (b, s))}
    if tc.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (b, tc.n_frontend_tokens, tc.d_model)).astype(np.float32)
    if tc.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, tc.n_frontend_tokens, tc.d_model)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_the_reference(rng, arch, scan):
    """forward, prefill and teacher-forced decode_step (whisper's with the
    encoder's output) within 1e-4 of ``repro.models``, the reference's
    parameters carried over from its scanned or unrolled layout; decode
    also reproduces the port's forward where the tokens are its only input
    (whisper with the encoder's output, xlstm; not internvl2, whose
    forward puts image rows where decode reads tokens)."""
    rc, tc = _cfgs(arch, scan_layers=scan)
    rmodel = r_build_model(rc)
    rparams = rmodel.init(jax.random.PRNGKey(6))
    assert isinstance(rparams["blocks"], dict) == scan
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    assert len(params["blocks"]) == tc.n_layers
    assert len(params.get("enc", [])) == tc.n_enc_layers
    model = Model(tc, "cpu")
    batch = _batch(tc, rng)
    want = np.asarray(rmodel.forward(rparams, _jnp(batch)))
    got = _np(model.forward(params, batch))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    last = _np(make_prefill_step(model)(params, batch))
    np.testing.assert_allclose(last, want[:, -1], atol=ATOL)

    extra = {}
    if tc.family == "encdec":
        extra["enc_out"] = np.array(rmodel._encode(
            rparams, jnp.asarray(batch["audio_embeds"])))
        np.testing.assert_allclose(
            _np(model._encode(params, batch["audio_embeds"])),
            extra["enc_out"], atol=ATOL_LAYER)
    tok = batch["tokens"]
    rcache, cache = rmodel.init_cache(2, 16), model.init_cache(2, 16)
    step = make_decode_step(model)
    for p in range(tok.shape[1]):
        b = {"tokens": tok[:, p:p + 1], "pos": np.full(2, p, np.int32),
             **extra}
        rlogits, rcache = rmodel.decode_step(rparams, rcache, _jnp(b))
        _, logits, cache = step(params, cache, b)
        np.testing.assert_allclose(_np(logits), np.asarray(rlogits),
                                   atol=ATOL)
        if tc.family != "vlm":
            np.testing.assert_allclose(_np(logits), got[:, p], atol=ATOL)
    _compare_caches(tc, cache, rcache)


def _compare_caches(tc, cache, rcache):
    """The port's decode cache against the reference's: every key of the
    attention families; an xLSTM layer's selected cell only."""
    if tc.family != "ssm":
        for kind in ("k", "v"):
            np.testing.assert_allclose(_np(cache["kv"][kind]),
                                       np.asarray(rcache["kv"][kind]),
                                       atol=ATOL)
        return
    for i in range(tc.n_layers):
        cell = "slstm" if i in tc.slstm_at else "mlstm"
        for key, val in cache[cell].items():
            np.testing.assert_allclose(_np(val[i]),
                                       np.asarray(rcache[cell][key][i]),
                                       atol=ATOL, rtol=1e-5)


def test_whisper_decode_without_enc_out_is_the_references(rng):
    """Without ``enc_out`` the decoder blocks run self-attention and the
    MLP alone (the reference's behaviour, which its serving engine
    relies on): logits and KV cache equal to ``repro``'s."""
    rc, tc = _cfgs("whisper-medium")
    rmodel = r_build_model(rc)
    rparams = rmodel.init(jax.random.PRNGKey(8))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    model = Model(tc, "cpu")
    tok = rng.integers(2, tc.vocab_size, (3, 9))
    rcache, cache = rmodel.init_cache(3, 12), model.init_cache(3, 12)
    assert set(cache) == set(rcache) == {"kv"}
    for p in range(tok.shape[1]):
        b = {"tokens": tok[:, p:p + 1], "pos": np.full(3, p, np.int32)}
        rlogits, rcache = rmodel.decode_step(rparams, rcache, _jnp(b))
        logits, cache = model.decode_step(params, cache, b)
        np.testing.assert_allclose(_np(logits), np.asarray(rlogits),
                                   atol=ATOL)
    _compare_caches(tc, cache, rcache)


def test_vlm_refuses_more_image_rows_than_tokens(rng):
    _, tc = _cfgs("internvl2-26b")
    model = Model(tc, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(tc, rng, s=tc.n_frontend_tokens - 1)
    with pytest.raises(ValueError, match="image tokens"):
        model.forward(params, batch)


def _shape_tree(t):
    if isinstance(t, dict):
        return {k: _shape_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shape_tree(v) for v in t]
    return tuple(t.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_fresh_parameters_have_the_reference_shapes(arch):
    """``Model.init``: the reference's tree (whisper's ``enc`` too), its
    0.02 normal init and its constant leaves (xLSTM's gate biases and norm
    scale)."""
    rc, tc = _cfgs(arch)
    want = _shape_tree(r_build_model(rc).init(jax.random.PRNGKey(0)))
    params = Model(tc, "cpu").init(torch.Generator().manual_seed(0))
    assert _shape_tree(params) == want
    blk = params["blocks"][0]
    w = blk["mlstm"]["w_up"] if "mlstm" in blk else blk["mlp"]["wi"]
    assert 0.018 < float(w.std()) < 0.022
    if "mlstm" in blk:
        h = tc.n_heads
        assert blk["mlstm"]["b_if"].tolist() == [0.0] * h + [3.0] * h
        assert bool((blk["slstm"]["b"] == 0).all())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_and_runs(arch):
    """Every config of ``repro_torch.configs`` at smoke width: ``Model``
    builds, ``forward`` and ``decode_step`` give finite logits."""
    tc = smoke_variant(get_config(arch))
    model = Model(tc, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    batch = _batch(tc, np.random.default_rng(1), s=max(
        10, tc.n_frontend_tokens))
    logits = model.forward(params, batch)
    assert logits.shape[:2] == batch["tokens"].shape
    assert bool(torch.isfinite(logits).all())
    cache = model.init_cache(2, 8)
    step, _ = model.decode_step(params, cache, {
        "tokens": batch["tokens"][:, :1], "pos": np.zeros(2, np.int32)})
    assert step.shape == (2, tc.padded_vocab)
    assert bool(torch.isfinite(step).all())
