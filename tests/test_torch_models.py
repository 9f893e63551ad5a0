"""The port's model stack against the JAX package's, on the CPU in fp32.

The reference's parameters go through ``params_from_reference`` (both the
scanned layout, blocks stacked on a leading L axis, and the unrolled
list); ``forward``, ``prefill`` and ``decode_step`` logits must then agree
with ``repro.models.Model``'s within 1e-4 (fp32 products summed in another
order; the logits are O(1)).  Teacher-forced decode through the KV cache
must reproduce the port's own forward at every position (1e-4, as
``tests/test_models.py`` checks the reference's).  The MoE/MLA (deepseek,
grok) and hybrid (hymba) families run the same checks; hymba's decode runs
past its smoke window of 64, so its ring cache wraps.  The xLSTM,
encoder-decoder and VLM families are held to the reference in
``tests/test_torch_families_rest.py``; here, what each of them refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.configs import shape_cells as r_shape_cells
from repro.models import SHAPES as R_SHAPES
from repro.models import build_model as r_build_model
from repro.models import smoke_variant as r_smoke
from repro_torch.configs import ALIASES, ARCH_IDS, get_config, shape_cells
from repro_torch.kernels import ops
from repro_torch.models import (SHAPES, Model, build_model,
                                make_decode_step, make_prefill_step,
                                params_from_reference, smoke_variant)
from repro_torch.models import layers as L

ATOL = 1e-4
DENSE = ["paper", "smollm-360m", "gemma-7b", "qwen1.5-110b",
         "nemotron-4-340b"]
FAMILIES = ["deepseek-v2-lite-16b", "grok-1-314b", "hymba-1.5b"]
# the families ported last, under the reference's arch ids
UNPORTED = [a for a in R_ARCH_IDS
            if r_get_config(a).family in ("ssm", "encdec", "vlm")]


def _cfgs(arch, **over):
    """The reference's and the port's smoke config of ``arch``."""
    rc = dataclasses.replace(r_smoke(r_get_config(arch)), **over)
    tc = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    return rc, tc


def _reference_params(rc, seed=0):
    params = r_build_model(rc).init(jax.random.PRNGKey(seed))
    if rc.qkv_bias:
        # the reference inits biases to zero: give them values to carry
        rng = np.random.default_rng(seed)

        def bias(a):
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        blocks = params["blocks"]
        for blk in (blocks if isinstance(blocks, list) else [blocks]):
            for name in ("bq", "bk", "bv"):
                blk["attn"][name] = bias(blk["attn"][name])
    return params


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (b, s))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_config(rc, tc):
    """Every field of the reference's config equal in the port's, and
    every field the port has beyond them (DeepSeek-V3's, which no
    reference config uses) at its default, off."""
    mine, theirs = dataclasses.asdict(tc), dataclasses.asdict(rc)
    assert {k: v for k, v in mine.items() if k in theirs} == theirs
    extra = {f.name: f.default for f in dataclasses.fields(tc)
             if f.name not in theirs}
    assert extra and {k: mine[k] for k in extra} == extra


@pytest.mark.parametrize("arch", list(ALIASES))
def test_configs_are_the_reference_configs(arch):
    rc, tc = r_get_config(arch), get_config(arch)
    _same_config(rc, tc)
    assert tc.n_params() == rc.n_params()
    assert tc.padded_vocab == rc.padded_vocab
    assert shape_cells(tc) == r_shape_cells(rc)
    rs, ts = _cfgs(arch)
    _same_config(rs, ts)
    assert tc.pdtype == getattr(torch, rc.param_dtype)


def test_shapes_and_arch_ids_are_the_reference_ones():
    assert ARCH_IDS == R_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_forward_prefill_and_decode_match_the_reference(arch):
    rc, tc = _cfgs(arch)
    rparams = _reference_params(rc)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    rmodel, model = r_build_model(rc), build_model(tc, "cpu")
    # hymba: past its smoke window of 64, in a cache of 72 slots (a ring
    # of 64), so decode writes over the ring's oldest slots
    s_len, max_seq, steps = (80, 72, 70) if tc.family == "hybrid" \
        else (12, 16, 6)
    tok = _tokens(tc, s=s_len)
    want = np.asarray(rmodel.forward(rparams, {"tokens": jnp.asarray(tok)}))
    got = _np(model.forward(params, {"tokens": torch.from_numpy(tok)}))
    assert got.shape == want.shape == (2, s_len, tc.padded_vocab)
    np.testing.assert_allclose(got, want, atol=ATOL)
    last = _np(make_prefill_step(model)(params, {"tokens": tok}))
    np.testing.assert_allclose(last, want[:, -1], atol=ATOL)

    rcache = rmodel.init_cache(2, max_seq)
    cache = model.init_cache(2, max_seq)
    step = make_decode_step(model)
    for p in range(steps):
        batch = {"tokens": tok[:, p:p + 1],
                 "pos": np.full(2, p, np.int32)}
        rlogits, rcache = rmodel.decode_step(
            rparams, rcache, {k: jnp.asarray(v) for k, v in batch.items()})
        nxt, logits, cache = step(params, cache, batch)
        np.testing.assert_allclose(_np(logits), np.asarray(rlogits),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(logits), got[:, p], atol=ATOL)
        assert np.array_equal(_np(nxt), _np(logits).argmax(-1))
    # the caches hold the reference's keys and values (its layouts)
    for path in _leaf_paths(rcache):
        np.testing.assert_allclose(_np(_at(cache, path)),
                                   np.asarray(_at(rcache, path)), atol=ATOL)


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, path + (k,))
    else:
        yield path


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ["gemma-7b", "nemotron-4-340b"])
def test_own_head_dims_match_the_reference(arch):
    """gemma's head dim 256 and nemotron's 192 (the card's widest B8/B9
    cases) at smoke width and two layers, reference weights carried over:
    forward and teacher-forced decode within 1e-4 of the reference."""
    rc, tc = _cfgs(arch, head_dim=get_config(arch).head_dim)
    assert tc.hd in (192, 256) and tc.n_layers == 2
    rparams = _reference_params(rc, seed=5)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    rmodel, model = r_build_model(rc), build_model(tc, "cpu")
    tok = _tokens(tc, s=10, seed=5)
    want = np.asarray(rmodel.forward(rparams, {"tokens": jnp.asarray(tok)}))
    got = _np(model.forward(params, {"tokens": torch.from_numpy(tok)}))
    np.testing.assert_allclose(got, want, atol=ATOL)
    rcache, cache = rmodel.init_cache(2, 12), model.init_cache(2, 12)
    step = make_decode_step(model)
    for p in range(4):
        batch = {"tokens": tok[:, p:p + 1],
                 "pos": np.full(2, p, np.int32)}
        rlogits, rcache = rmodel.decode_step(
            rparams, rcache, {k: jnp.asarray(v) for k, v in batch.items()})
        _, logits, cache = step(params, cache, batch)
        np.testing.assert_allclose(_np(logits), np.asarray(rlogits),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(logits), got[:, p], atol=ATOL)


@pytest.mark.parametrize("arch", ["paper", "qwen1.5-110b"])
def test_scanned_reference_layout_carries_over(arch):
    """The paper config's default layout: blocks stacked on a leading L
    axis (``scan_layers=True``)."""
    rc, tc = _cfgs(arch, scan_layers=True)
    rparams = _reference_params(rc, seed=1)
    assert isinstance(rparams["blocks"], dict)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    assert len(params["blocks"]) == tc.n_layers
    tok = _tokens(tc, seed=1)
    want = np.asarray(r_build_model(rc).forward(
        rparams, {"tokens": jnp.asarray(tok)}))
    got = _np(Model(tc, "cpu").forward(params, {"tokens": tok}))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bf16_parameters_carry_over_exactly():
    rc, tc = _cfgs("paper", param_dtype="bfloat16")
    rparams = _reference_params(rc)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    w = params["blocks"][1]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.to(torch.float32).numpy(),
        np.asarray(rparams["blocks"][1]["attn"]["wq"], np.float32))


def test_three_query_heads_per_kv_head():
    """G = 3 (the paper model's 15/5 ratio) at smoke width."""
    rc, tc = _cfgs("paper", n_heads=6, n_kv_heads=2)
    rparams = _reference_params(rc, seed=2)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                   "cpu")
    tok = _tokens(tc, s=20, seed=2)
    want = np.asarray(r_build_model(rc).forward(
        rparams, {"tokens": jnp.asarray(tok)}))
    got = _np(Model(tc, "cpu").forward(params, {"tokens": tok}))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decode_matches_forward_over_a_long_prompt():
    """Teacher forcing through the cache reproduces forward at every
    position (tests/test_models.py's check, on the port alone)."""
    tc = smoke_variant(get_config("paper"))
    model = Model(tc, "cpu")
    params = model.init(torch.Generator().manual_seed(4))
    tok = torch.from_numpy(_tokens(tc, b=3, s=30, seed=4))
    full = model.forward(params, {"tokens": tok})
    cache = model.init_cache(3, 32)
    d0 = ops.dispatch_stats["launches"]
    for p in range(30):
        logits, cache = model.decode_step(params, cache, {
            "tokens": tok[:, p:p + 1],
            "pos": torch.full((3,), p, dtype=torch.int32)})
        assert float((logits - full[:, p]).abs().max()) <= ATOL
    # one decode-attention dispatch per layer and step
    assert ops.dispatch_stats["launches"] - d0 == 30 * tc.n_layers


def _shape_tree(t):
    if isinstance(t, dict):
        return {k: _shape_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shape_tree(v) for v in t]
    return tuple(t.shape)


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_fresh_parameters_have_the_reference_shapes_and_scale(arch):
    rc, tc = _cfgs(arch)
    want = _shape_tree(r_build_model(rc).init(jax.random.PRNGKey(0)))
    params = Model(tc, "cpu").init(torch.Generator().manual_seed(0))
    assert _shape_tree(params) == want
    blk = params["blocks"][0]
    std = float((blk["moe"] if "moe" in blk else blk["mlp"])["wi"].std())
    assert 0.018 < std < 0.022


@pytest.mark.parametrize("arch", UNPORTED)
def test_other_families_raise(arch):
    """These families build now; what raises is a family the port does
    not know (under this arch's config), a stacked layout of the wrong
    depth, and the family's own refusal: whisper's forward without its
    audio frames, internvl2's with more image rows than tokens (the
    reference's assertion)."""
    _, tc = _cfgs(arch)
    model = Model(tc, "cpu")
    other = dataclasses.replace(tc, family="retnet")
    with pytest.raises(ValueError, match="family"):
        Model(other, "cpu")
    with pytest.raises(ValueError, match="family"):
        params_from_reference({"emb": {}, "blocks": []}, other, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    stacked = {"w": np.zeros((tc.n_layers + 1, 2))}
    with pytest.raises(ValueError, match="leading axes"):
        params_from_reference({"emb": {}, "blocks": stacked}, tc, "cpu")
    tok = _tokens(tc, s=6)
    if tc.family == "encdec":
        with pytest.raises(KeyError, match="audio_embeds"):
            model.forward(params, {"tokens": tok})
    elif tc.family == "vlm":
        img = np.zeros((2, 7, tc.d_model), np.float32)
        with pytest.raises(ValueError, match="image tokens"):
            model.forward(params, {"tokens": tok, "image_embeds": img})
    else:
        assert model.forward(params, {"tokens": tok}).shape[:2] == (2, 6)


def test_unported_attention_modes_raise():
    """Non-causal and cross attention run now (held to the reference in
    ``tests/test_torch_families_rest.py``); a window beside either, which
    no config has, raises."""
    tc = smoke_variant(get_config("paper"))
    p = L.init_attention(tc, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    x = torch.zeros((1, 4, tc.d_model))
    pos = torch.arange(4)[None]
    enc = torch.zeros((1, 3, tc.d_model))
    for kw in ({"causal": False}, {"xattn_kv": enc}):
        y, _ = L.attention_apply(p, tc, x, pos, **kw)
        assert y.shape == x.shape
        with pytest.raises(ValueError, match="window"):
            L.attention_apply(p, tc, x, pos, window=2, **kw)


def test_the_card_is_the_default_and_is_never_replaced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = smoke_variant(get_config("paper"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference({"emb": {}, "blocks": []}, tc)
