"""The port's training path against the JAX package's, on the CPU in fp32
at smoke width: the loss and its gradients for every architecture, AdamW,
the train step with and without accumulation, the schedule, the token
pipeline, the int8 codec, B8's rematerialised gradient and remat (the
launcher's restart: ``test_torch_distributed.py``).

Inputs are numpy draws from a seed handed to both packages; weights are
the reference's, carried over with ``params_from_reference`` (the smoke
variants are unrolled, ``scan_layers=False``, so the trees map leaf for
leaf).  Tolerances: the loss within 1e-5 relative and every gradient leaf
within 1e-4 of the leaf's max |g| (fp32 sums in another order through
two layers and a 2,048-wide vocabulary); AdamW within 1e-6 on the same
gradients (one step moves a parameter by about lr); B8's gradient within
1e-5 of autograd through the plain version (the same arithmetic, chunked);
remat, the token pipeline and the int8 codec bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.data import DataConfig as RDataConfig
from repro.data import TokenPipeline as RTokenPipeline
from repro.kernels import quant as RQ
from repro.models import build_model as r_build_model
from repro.models import make_loss_fn as r_make_loss_fn
from repro.models import make_train_step as r_make_train_step
from repro.models import smoke_variant as r_smoke
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import cosine_lr as r_cosine_lr
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quant as Q
from repro_torch.kernels import ref as tref
from repro_torch.models import (Model, make_loss_fn, make_train_step,
                                params_from_reference, smoke_variant,
                                value_and_grad)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.tree import tree_leaves, tree_map, tree_paths

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # of the leaf's max |g|
ADAM_TOL = 1e-6
ATT_GRAD_TOL = 1e-5
ARCHS = list(R_ARCH_IDS) + ["paper"]
# the xLSTM smoke variant with an sLSTM layer (layer 1; layer 0 mLSTM), so
# the sLSTM cell has a gradient
OVER = {"xlstm_125m": {"slstm_at": (1,)}}


def _cfgs(arch, **over):
    over = {**OVER.get(arch, {}), **over}
    rc = dataclasses.replace(r_smoke(r_get_config(arch)), **over)
    tc = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    return rc, tc


def _reference(rc, seed=0):
    """The reference's model and parameters; qkv biases (zero at init)
    get values, so their gradients carry over too."""
    rmodel = r_build_model(rc)
    params = rmodel.init(jax.random.PRNGKey(seed))
    if rc.qkv_bias:
        rng = np.random.default_rng(seed)
        for blk in params["blocks"]:
            for name in ("bq", "bk", "bv"):
                blk["attn"][name] = jnp.asarray(
                    0.1 * rng.standard_normal(blk["attn"][name].shape),
                    blk["attn"][name].dtype)
    return rmodel, params


def _batch(cfg, b=2, s=16, seed=0):
    """tests/test_models.py's batch, as numpy: tokens, labels (the next
    tokens, the last few masked with -1) and the frontends' embeddings
    (normal draws at 0.1: with that file's constant rows every cross
    attention output is V's one row, and the query side has no
    gradient)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(2, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[:, -3:] = -1
    batch = {"tokens": tok[:, :-1], "labels": labels}
    if cfg.frontend in ("audio", "vision"):
        key = "audio_embeds" if cfg.frontend == "audio" else "image_embeds"
        batch[key] = (0.1 * rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _port(rparams, tc):
    return params_from_reference(jax.tree.map(np.asarray, rparams), tc,
                                 "cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_tree_close(got, want, tol, what):
    """Every leaf of the port's tree within ``tol`` of the max |x| of the
    reference's leaf under the same key."""
    want = dict(tree_paths(jax.tree.map(np.asarray, want)))
    got = dict(tree_paths(got))
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        g = _np(got[key])
        assert g.shape == w.shape, (what, key)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (what, key, err, scale)


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    rc, tc = _cfgs(arch)
    rmodel, rparams = _reference(rc)
    batch = _batch(tc)
    want_loss, want_g = jax.value_and_grad(r_make_loss_fn(rmodel))(
        rparams, _j(batch))
    model = Model(tc, "cpu")
    loss, grads = value_and_grad(make_loss_fn(model))(_port(rparams, tc),
                                                      _t(batch))
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    assert float(make_loss_fn(model)(_port(rparams, tc), _t(batch))) == \
        float(loss)
    _assert_tree_close(grads, want_g, GRAD_TOL, arch)


def test_loss_masks_labels_and_counts_unmasked_positions():
    """Every label masked: the loss is 0 (divided by max(0, 1)); the
    z-loss is part of it where labels count."""
    _, tc = _cfgs("smollm_360m")
    model = Model(tc, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _t(_batch(tc))
    full = float(make_loss_fn(model)(params, batch))
    assert full > 0
    masked = dict(batch, labels=torch.full_like(batch["labels"], -1))
    assert float(make_loss_fn(model)(params, masked)) == 0.0


# ------------------------------------------------------------------ AdamW
def test_cosine_lr_end_points():
    for cfg, rcfg in ((AdamWConfig(), RAdamWConfig()),
                      (AdamWConfig(warmup_steps=0, total_steps=7),
                       RAdamWConfig(warmup_steps=0, total_steps=7))):
        for step in (0, 1, cfg.warmup_steps, cfg.warmup_steps + 1,
                     cfg.total_steps // 2, cfg.total_steps,
                     cfg.total_steps + 5):
            got = float(cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)))
            want = float(r_cosine_lr(rcfg, jnp.int32(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    cfg = AdamWConfig()
    assert float(cosine_lr(cfg, torch.tensor(0))) == 0.0
    assert float(cosine_lr(cfg, torch.tensor(cfg.warmup_steps))) == \
        pytest.approx(cfg.lr, rel=1e-6)
    assert float(cosine_lr(cfg, torch.tensor(cfg.total_steps))) == \
        pytest.approx(cfg.lr * cfg.min_lr_frac, rel=1e-6)


@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_v2_lite_16b"])
def test_adamw_matches_the_reference_on_its_gradients(arch):
    """Three steps from the same parameters, both optimizers fed the
    reference's gradients (at its parameters of each step): parameters,
    moments, grad_norm and lr within 1e-6."""
    rc, tc = _cfgs(arch)
    rmodel, rparams = _reference(rc)
    grad_fn = jax.value_and_grad(r_make_loss_fn(rmodel))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rcfg, cfg = RAdamWConfig(**kw), AdamWConfig(**kw)
    params = _port(rparams, tc)
    rstate, state = r_adamw_init(rparams), adamw_init(params)
    for step in range(3):
        _, rg = grad_fn(rparams, _j(_batch(tc, seed=step)))
        grads = _port(rg, tc)
        rparams, rstate, rmet = r_adamw_update(rcfg, rparams, rg, rstate)
        params, state, met = adamw_update(cfg, params, grads, state)
        assert int(state["step"]) == int(rstate["step"]) == step + 1
        for name in ("grad_norm", "lr"):
            assert float(met[name]) == pytest.approx(float(rmet[name]),
                                                     rel=ADAM_TOL)
        for got, want in ((params, rparams), (state["m"], rstate["m"]),
                          (state["v"], rstate["v"])):
            _assert_tree_close(got, want, ADAM_TOL, arch)


def test_adamw_keeps_dtypes_and_leaves_its_inputs():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": [torch.zeros(2)]}
    grads = tree_map(lambda p: torch.full_like(p, 0.5), params)
    state = adamw_init(params)
    new, new_state, _ = adamw_update(AdamWConfig(lr=0.1, warmup_steps=1),
                                     params,
                                     grads, state)
    assert new["w"].dtype == torch.bfloat16 and new["b"][0].dtype == \
        torch.float32
    assert new_state["m"]["w"].dtype == torch.float32
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert bool((params["w"] == 1).all()) and bool((new["w"] != 1).all())


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_125m"])
def test_train_step_matches_the_reference(arch, accum):
    rc, tc = _cfgs(arch)
    rmodel, rparams = _reference(rc)
    batch = _batch(tc, b=4)
    ropt = RAdamWConfig(lr=1e-3, warmup_steps=1)
    _, _, rmet = r_make_train_step(rmodel, ropt, accum)(
        rparams, r_adamw_init(rparams), _j(batch))
    params = _port(rparams, tc)
    model = Model(tc, "cpu")
    new, state, met = make_train_step(
        model, AdamWConfig(lr=1e-3, warmup_steps=1), accum)(
            params, adamw_init(params), _t(batch))
    assert float(met["loss"]) == pytest.approx(float(rmet["loss"]),
                                               rel=LOSS_RTOL)
    assert float(met["grad_norm"]) == pytest.approx(
        float(rmet["grad_norm"]), rel=GRAD_TOL)
    assert int(state["step"]) == 1


@pytest.mark.parametrize("arch", R_ARCH_IDS)
def test_one_train_step_finite(arch):
    """tests/test_models.py's test of one train step, on the port: finite
    loss and grad norm, the parameters moved."""
    _, tc = _cfgs(arch)
    model = Model(tc, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(tc)
    batch["labels"] = batch["tokens"]
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    params2, _, metrics = step(params, adamw_init(params), _t(batch))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    d = [float((a.float() - b.float()).abs().max()) for a, b in
         zip(tree_leaves(params), tree_leaves(params2))]
    assert max(d) > 0


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("policy", ["none", "save_boundaries"])
@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_v2_lite_16b",
                                  "hymba_15b", "xlstm_125m",
                                  "whisper_medium"])
def test_remat_changes_no_gradient(arch, policy):
    """``cfg.remat`` on and off give the same loss and gradients, bit for
    bit: the recompute repeats the forward's arithmetic, and the backward
    graph is the forward's."""
    _, tc = _cfgs(arch)
    params = Model(tc, "cpu").init(torch.Generator().manual_seed(0))
    batch = _t(_batch(tc))
    out = []
    for remat in (False, True):
        model = Model(dataclasses.replace(tc, remat=remat,
                                          remat_policy=policy), "cpu")
        out.append(value_and_grad(make_loss_fn(model))(params, batch))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_recomputes_each_block():
    """With remat, every block's attention runs twice a step (forward and
    recompute); without, once."""
    _, tc = _cfgs("smollm_360m")
    params = Model(tc, "cpu").init(torch.Generator().manual_seed(0))
    batch = _t(_batch(tc))
    calls = []
    saved = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return saved(*a, **kw)
    ops.flash_attention = counting
    try:
        for remat in (False, True):
            calls.clear()
            model = Model(dataclasses.replace(tc, remat=remat), "cpu")
            value_and_grad(make_loss_fn(model))(params, batch)
            assert len(calls) == tc.n_layers * (2 if remat else 1)
        calls.clear()
        model.forward(params, batch)            # no graph: no checkpoint
        assert len(calls) == tc.n_layers
    finally:
        ops.flash_attention = saved


def test_serving_entry_points_record_no_graph():
    """The model's parameters require no grad, so ``forward`` records
    nothing, and ``prefill`` and ``decode_step`` run under no_grad even
    with parameters that do."""
    _, tc = _cfgs("smollm_360m")
    model = Model(dataclasses.replace(tc, remat=True), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in tree_leaves(params))
    tok = torch.from_numpy(_batch(tc)["tokens"])
    assert model.forward(params, {"tokens": tok}).grad_fn is None
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    assert model.forward(live, {"tokens": tok}).grad_fn is not None
    assert model.prefill(live, {"tokens": tok}).grad_fn is None
    cache = model.init_cache(2, 4)
    logits, _ = model.decode_step(live, cache, {
        "tokens": tok[:, :1], "pos": torch.zeros(2, dtype=torch.int32)})
    assert logits.grad_fn is None


# ------------------------------------------------------ B8's gradient
def _qkv(rng, b, h, hkv, s, t, d, dv):
    def x(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    # the layers hand B8 (B,S,H,D) projections as transpose(1, 2) views
    return (x(b, s, h, d).transpose(1, 2), x(b, t, hkv, d).transpose(1, 2),
            x(b, t, hkv, dv).transpose(1, 2), x(b, h, s, dv))


ATT_CASES = [  # (B, H, Hkv, S, T, D, Dv, causal, window)
    (2, 4, 2, 40, 40, 32, 32, True, 0),
    (1, 6, 2, 37, 37, 64, 64, True, 8),
    (2, 4, 4, 12, 29, 32, 32, False, 0),
    (1, 4, 4, 33, 33, 48, 32, True, 0),
    (1, 2, 1, 1100, 1100, 32, 32, True, 0),      # chunked: S > 1,024
    (1, 2, 2, 1100, 1100, 32, 16, True, 300),
    (1, 2, 1, 1030, 70, 32, 32, False, 0),
]


@pytest.mark.parametrize("case", ATT_CASES)
def test_flash_attention_gradient_on_the_cpu(rng, case):
    """``ops.flash_attention``'s gradient (autograd through the plain
    version on the CPU) and :func:`attention_grad` (the card's backward:
    the plain version recomputed, chunked past 1,024 queries) against
    ``torch.autograd.grad`` of ``attention_ref``: causal, windowed,
    non-causal with T != S, Dv != D; in the inputs' shapes."""
    b, h, hkv, s, t, d, dv, causal, window = case
    q, k, v, dout = _qkv(rng, b, h, hkv, s, t, d, dv)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        tref.attention_ref(*leaves, causal=causal, window=window),
        leaves, dout)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    got_op = torch.autograd.grad(
        ops.flash_attention(*leaves, window=window, causal=causal),
        leaves, dout)
    got = fa.attention_grad(q, k, v, dout, causal, window)
    for g_op, g, w, x in zip(got_op, got, want, (q, k, v)):
        assert g.shape == w.shape == x.shape and g.dtype == x.dtype
        torch.testing.assert_close(g_op, w, rtol=0, atol=0)
        torch.testing.assert_close(g, w, rtol=0, atol=ATT_GRAD_TOL)


def test_attention_ref_query_offset_is_a_chunk_of_the_whole(rng):
    """``attention_ref(q_start=lo)`` on a chunk of queries equals those
    rows of the whole pass (the backward's chunks)."""
    q, k, v, _ = _qkv(rng, 1, 4, 2, 50, 50, 32, 32)
    for causal, window in ((True, 0), (True, 7), (False, 0)):
        whole = tref.attention_ref(q, k, v, causal=causal, window=window)
        part = tref.attention_ref(q[:, :, 20:35], k, v, causal=causal,
                                  window=window, q_start=20)
        torch.testing.assert_close(part, whole[:, :, 20:35], rtol=0,
                                   atol=1e-6)


# -------------------------------------------------------- data, codec
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_token_pipeline_is_the_references_bit_for_bit(n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab_size=512, seq_len=33, global_batch=4, seed=3,
                  n_hosts=n_hosts, host=host)
        got, want = TokenPipeline(DataConfig(**kw)), RTokenPipeline(
            RDataConfig(**kw))
        for cursor in (0, 1, 7, 1000):
            a, b = got.batch_at(cursor), want.batch_at(cursor)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_quantize_int8_is_the_references_bit_for_bit(rng):
    """Including ties at .5 (round half to even) and the clip."""
    g = rng.standard_normal((17, 33)).astype(np.float32)
    ties = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -62.5,
                     0.0], np.float32)      # scale 1 + 1e-30: exact halves
    for x in (g, ties, np.zeros(5, np.float32),
              (1e-3 * g).astype(np.float32)):
        q, s = Q.quantize_int8(torch.from_numpy(x))
        rq, rs = RQ.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(
            Q.dequantize_int8(q, s).numpy(),
            np.asarray(RQ.dequantize_int8(rq, rs)))
    q, _ = Q.quantize_int8(torch.from_numpy(ties))
    assert q.tolist() == [127, -127, 0, 2, 2, 0, -2, 64, -62, 0]
