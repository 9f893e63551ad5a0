"""The port's MoE, MLA, Mamba and windowed-attention layers against the JAX
package's, on the CPU in fp32, and the attention plain versions' new
arguments (V's own head dim, a window, a scale) against the reference's
XLA attention.

Inputs and weights come from a numpy seed and are handed to both packages.
Layer outputs must agree within 1e-5 (fp32 products summed in another
order; the outputs are O(0.1)); the MoE must also keep and drop exactly the
reference's (token, k) pairs, ties in the router going to the lower expert
as ``jax.lax.top_k`` sends them.
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
from repro.models import smoke_variant as r_smoke
from repro.models import ssm as RS
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.models import Model, params_from_reference, smoke_variant
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

ATOL = 1e-5


def _cfgs(arch, **over):
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


def _x(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reference_keep(router, x, cfg):
    """The reference's kept (token, k) pairs, by its own expressions
    (``repro/models/layers.py::moe_apply``)."""
    xt = x.reshape(-1, x.shape[-1])
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    cap = max(1, -(-int(t * k * cfg.capacity_factor) // e))
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    e_flat = topi.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, e, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return np.asarray(e_flat), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("arch,cf,drops", [
    ("deepseek-v2-lite-16b", 4.0, False),   # the smoke variant: no drops
    ("deepseek-v2-lite-16b", 0.5, True),    # capacity below the load
    ("grok-1-314b", 0.75, True)])           # GeGLU, no shared experts
def test_moe_apply_matches_the_reference(rng, arch, cf, drops):
    rc, tc = _cfgs(arch, capacity_factor=cf)
    rp = RL.init_moe(rc, jax.random.PRNGKey(3))
    rp, tp = _draw(rng, jax.tree.map(np.asarray, rp))
    xj, xt = _x(rng, (2, 24, tc.d_model))
    want = np.asarray(RL.moe_apply(rp, rc, xj))
    got = _np(L.moe_apply(tp, tc, xt))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the same pairs kept and dropped, in the same slots
    e_flat, pos, keep = _reference_keep(rp["router"], xj, rc)
    _, topi = L.moe_route(tp["router"], xt.reshape(-1, tc.d_model),
                          tc.top_k)
    t = xt.shape[0] * xt.shape[1]
    cap = max(1, -(-int(t * tc.top_k * cf) // tc.n_experts))
    got_e, got_pos, got_keep = L.moe_slots(topi, tc.n_experts, cap)
    assert np.array_equal(got_e.numpy(), e_flat)
    assert np.array_equal(got_pos.numpy(), pos)
    assert np.array_equal(got_keep.numpy(), keep)
    assert (not keep.all()) == drops


def _running_count_slots(topi, e, cap):
    """The slots as the reference writes them: each (token, k) pair takes
    its expert's running count over the pairs in token-major order."""
    e_flat = topi.reshape(-1)
    onehot = torch.nn.functional.one_hot(e_flat, e)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return e_flat, pos, pos < cap


_SLOT_SHAPES = [(1, 1, 4), (7, 2, 8), (48, 6, 64), (4096, 6, 64)]
_SLOT_CAPS = ["one", "below_load", "cf_1.25", "t"]


def _slot_cap(name, t, k, e):
    return {"one": 1,
            "below_load": max(1, t * k // (2 * e)),
            "cf_1.25": -(-int(t * k * 1.25) // e),
            "t": t}[name]


def _routed(rng, t, k, e):
    """Top-k expert ids (T,K) as the router gives them: k distinct experts
    a token, in a random order."""
    return torch.from_numpy(
        np.argsort(rng.random((t, e)), axis=-1)[:, :k].astype(np.int64))


def _assert_slots_bit_equal(topi, e, cap):
    got = L.moe_slots(topi, e, cap)
    want = _running_count_slots(topi, e, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("cap_name", _SLOT_CAPS)
@pytest.mark.parametrize("t,k,e", _SLOT_SHAPES)
def test_moe_slots_equal_the_running_count(rng, t, k, e, cap_name):
    """Slots by a stable sort on expert id are the running count's
    integers, the same pairs kept at every capacity."""
    _assert_slots_bit_equal(_routed(rng, t, k, e), e,
                            _slot_cap(cap_name, t, k, e))


@pytest.mark.parametrize("case", ["an_expert_unpicked", "all_on_one_expert"])
@pytest.mark.parametrize("t,k,e", _SLOT_SHAPES)
def test_moe_slots_edge_cases_equal_the_running_count(rng, t, k, e, case):
    """An expert no pair picks (the first, a middle one and the last where
    E allows), and every pair on one expert."""
    if case == "an_expert_unpicked":
        unpicked = {0, e // 2, e - 1} if e > k + 3 else {e // 2}
        ids = np.array([i for i in range(e) if i not in unpicked])
        topi = torch.from_numpy(ids[np.argsort(
            rng.random((t, len(ids))), axis=-1)[:, :k]])
    else:
        topi = torch.full((t, k), e // 2, dtype=torch.int64)
    for cap_name in _SLOT_CAPS:
        _assert_slots_bit_equal(topi, e, _slot_cap(cap_name, t, k, e))


def test_moe_router_ties_go_to_the_lower_expert(rng):
    """Equal router columns give equal probabilities: the port's Top-k
    keeps ``jax.lax.top_k``'s order (the lower expert first)."""
    rc, tc = _cfgs("deepseek-v2-lite-16b")
    router = rng.standard_normal((tc.d_model, tc.n_experts)).astype(
        np.float32)
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 0]
    x = rng.standard_normal((64, tc.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    wv, wi = jax.lax.top_k(probs, tc.top_k)
    gv, gi = L.moe_route(torch.from_numpy(router), torch.from_numpy(x),
                         tc.top_k)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(
        gv.numpy(), np.asarray(wv / wv.sum(-1, keepdims=True)), atol=1e-6)


def _mla_pair(rng, arch="deepseek-v2-lite-16b"):
    rc, tc = _cfgs(arch)
    rp = jax.tree.map(np.asarray, RL.init_mla(rc, jax.random.PRNGKey(1)))
    rp, tp = _draw(rng, rp, scale=0.1)
    return rc, tc, rp, tp


def test_mla_prefill_matches_the_reference(rng):
    rc, tc, rp, tp = _mla_pair(rng)
    b, s = 2, 37
    xj, xt = _x(rng, (b, s, tc.d_model))
    pos = np.broadcast_to(np.arange(s), (b, s))
    want, _ = RL.mla_apply(rp, rc, xj, jnp.asarray(pos))
    got, cache = L.mla_apply(tp, tc, xt, torch.from_numpy(pos.copy()))
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_mla_absorbed_decode_matches_the_reference(rng):
    """Decode over a filled latent cache: the new row written in place
    into the one row buffer that c_kv and k_rope are views of, and B9's
    plain version over it with V the row's first r columns."""
    rc, tc, rp, tp = _mla_pair(rng)
    b, t, r, rh = 3, 20, tc.kv_lora_rank, tc.rope_head_dim
    rows = torch.from_numpy(
        rng.standard_normal((b, t, r + rh)).astype(np.float32))
    kv = {"c_kv": rows[..., :r], "k_rope": rows[..., r:]}
    rkv = {"c_kv": jnp.asarray(rows[..., :r].numpy()),
           "k_rope": jnp.asarray(rows[..., r:].numpy())}
    p = np.array([0, 7, t - 1], np.int32)
    xj, xt = _x(rng, (b, 1, tc.d_model))
    mask = np.arange(t)[None] <= p[:, None]
    want, rnew = RL.mla_apply(rp, rc, xj, jnp.asarray(p[:, None]),
                              kv_cache=rkv, cache_positions=jnp.asarray(p),
                              decode_mask=jnp.asarray(mask))
    got, new = L.mla_apply(tp, tc, xt, torch.from_numpy(p[:, None]),
                           kv_cache=kv, cache_positions=torch.from_numpy(p))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    assert new is kv and new["c_kv"].data_ptr() == rows.data_ptr()
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(kv[key]), np.asarray(rnew[key]),
                                   atol=ATOL)
    with pytest.raises(ValueError, match="row buffer"):
        L.latent_rows({"c_kv": rows[..., :r].contiguous(),
                       "k_rope": rows[..., r:].contiguous()})


def _mamba_pair(rng):
    rc, tc = _cfgs("hymba-1.5b")
    rp = jax.tree.map(np.asarray, RS.init_mamba(rc, jax.random.PRNGKey(2)))
    const = {k: rp[k] for k in ("b_dt", "a_log", "d_skip")}
    rp, tp = _draw(rng, rp)
    # the reference's own b_dt, a_log and d_skip: steps dt ~ 0.01, so the
    # decays exp(-dt exp(a_log)) stay near 1 and the state carries far
    # across chunk boundaries
    for k, v in const.items():
        rp[k], tp[k] = jnp.asarray(v), torch.from_numpy(v.copy())
    return rc, tc, rp, tp


@pytest.mark.parametrize("s", [5, S.CHUNK, 2 * S.CHUNK + 77])
def test_mamba_prefill_matches_the_reference(rng, s):
    """The chunked scan against ``jax.lax.associative_scan``, within one
    chunk, at exactly one and across chunk boundaries."""
    rc, tc, rp, tp = _mamba_pair(rng)
    xj, xt = _x(rng, (2, s, tc.d_model))
    want, wstate = RS.mamba_apply(rp, rc, xj)
    got, state = S.mamba_apply(tp, tc, xt)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(_np(state[key]), np.asarray(wstate[key]),
                                   atol=ATOL)


def test_mamba_decode_matches_the_reference(rng):
    """One-step decode from a nonzero state, written in place."""
    rc, tc, rp, tp = _mamba_pair(rng)
    shapes = S.mamba_state_shape(tc, 3)
    assert shapes == RS.mamba_state_shape(rc, 3)
    st = {k: rng.standard_normal(v).astype(np.float32)
          for k, v in shapes.items()}
    xj, xt = _x(rng, (3, 1, tc.d_model))
    want, wstate = RS.mamba_apply(rp, rc, xj,
                                  {k: jnp.asarray(v) for k, v in st.items()})
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got, new = S.mamba_apply(tp, tc, xt, state)
    assert new is state
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(_np(state[key]), np.asarray(wstate[key]),
                                   atol=ATOL)


@pytest.mark.parametrize("window,s", [(64, 150), (16, 100), (1, 9)])
def test_windowed_attention_matches_the_reference(rng, window, s):
    rc, tc = _cfgs("hymba-1.5b")
    rp = jax.tree.map(np.asarray,
                      RL.init_attention(rc, jax.random.PRNGKey(4)))
    rp, tp = _draw(rng, rp, scale=0.1)
    xj, xt = _x(rng, (2, s, tc.d_model))
    pos = np.broadcast_to(np.arange(s), (2, s))
    want, _ = RL.attention_apply(rp, rc, xj, jnp.asarray(pos),
                                 window=window)
    got, _ = L.attention_apply(tp, tc, xt, torch.from_numpy(pos.copy()),
                               window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("h,hkv,d,dv,window", [
    (4, 4, 48, 32, 0), (4, 4, 48, 32, 20), (16, 16, 192, 128, 0),
    (6, 2, 64, 64, 50), (4, 2, 32, 32, 7), (4, 4, 48, 32, 33)])
def test_attention_ref_new_arguments_match_sdpa(rng, h, hkv, d, dv, window):
    """``ref.attention_ref`` with V's own head dim and a window against
    ``repro.models.layers.sdpa`` (the (B,S,H,D) layout)."""
    b, s = 2, 70
    qj, qt = _x(rng, (b, s, h, d))
    kj, kt = _x(rng, (b, s, hkv, d))
    vj, vt = _x(rng, (b, s, hkv, dv))
    want = np.asarray(RL.sdpa(qj, kj, vj, causal=True, window=window))
    got = tref.attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                             vt.transpose(1, 2), causal=True,
                             window=window).transpose(1, 2)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


@pytest.mark.parametrize("h,hkv,d,scale", [(16, 1, 80, 48 ** -0.5),
                                           (4, 2, 64, None),
                                           (5, 5, 32, 0.7)])
def test_decode_attention_ref_scale_matches_decode_sdpa(rng, h, hkv, d,
                                                        scale):
    b, t = 3, 40
    qj, qt = _x(rng, (b, h, d))
    kj, kt = _x(rng, (b, t, hkv, d))
    vj, vt = _x(rng, (b, t, hkv, d))
    pos = np.array([0, 17, t - 1], np.int32)
    mask = np.arange(t)[None] <= pos[:, None]
    want = np.asarray(RL._decode_sdpa(qj[:, None], kj, vj,
                                      jnp.asarray(mask), scale=scale))[:, 0]
    got = tref.decode_attention_ref(qt, kt, vt, torch.from_numpy(pos),
                                    scale)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def test_decode_attention_ref_v_as_a_view_of_k(rng):
    """MLA's absorbed scores: V the first r columns of each [c_kv | k_rope]
    row, the scale 1/sqrt(hd + rh), against the reference's two-term
    einsums (``repro/models/layers.py::mla_apply``)."""
    b, t, h, r, rh, hd = 2, 30, 4, 64, 16, 32
    rows = rng.standard_normal((b, t, r + rh)).astype(np.float32)
    q = rng.standard_normal((b, h, r + rh)).astype(np.float32)
    pos = np.array([3, t - 1], np.int32)
    scale = 1.0 / (hd + rh) ** 0.5
    ckv, kr = jnp.asarray(rows[..., :r]), jnp.asarray(rows[..., r:])
    sc = (jnp.einsum("bhr,btr->bht", jnp.asarray(q[..., :r]), ckv)
          + jnp.einsum("bhk,btk->bht", jnp.asarray(q[..., r:]), kr)) * scale
    sc = jnp.where(jnp.asarray(np.arange(t)[None] <= pos[:, None])[:, None],
                   sc, -1e30)
    want = np.asarray(jnp.einsum("bht,btr->bhr", jax.nn.softmax(sc, -1),
                                 ckv))
    kt = torch.from_numpy(rows)[:, :, None, :]
    got = tref.decode_attention_ref(torch.from_numpy(q), kt, kt[..., :r],
                                    torch.from_numpy(pos), scale)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hymba-1.5b"])
def test_fp32_leaves_carry_over_in_fp32(arch):
    """At bf16 parameters the router, a_log and d_skip stay fp32, bit for
    bit, in params_from_reference and in a fresh init; every other leaf
    is bf16."""
    rc, tc = _cfgs(arch, param_dtype="bfloat16")
    rparams = r_build_model(rc).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    fresh = Model(tc, "cpu").init(torch.Generator().manual_seed(0))
    seen = set()
    for tree, rtree in ((params["blocks"][1], rparams["blocks"][1]),
                        (fresh["blocks"][1], rparams["blocks"][1])):
        for part, leaves in tree.items():
            for name, t in leaves.items():
                if isinstance(t, dict):       # the MoE's shared experts
                    assert all(v.dtype == torch.bfloat16
                               for v in t.values())
                    continue
                if name in L.FP32_LEAVES:
                    seen.add(name)
                    assert t.dtype == torch.float32, (part, name)
                    assert np.asarray(rtree[part][name]).dtype == np.float32
                else:
                    assert t.dtype == torch.bfloat16, (part, name)
    want = {"deepseek-v2-lite-16b": {"router"},
            "hymba-1.5b": {"a_log", "d_skip"}}[arch]
    assert seen == want
    for part, name in [(p, n) for p in ("moe", "mamba")
                       for n in L.FP32_LEAVES
                       if n in params["blocks"][0].get(p, {})]:
        np.testing.assert_array_equal(
            params["blocks"][0][part][name].numpy(),
            np.asarray(rparams["blocks"][0][part][name]))
