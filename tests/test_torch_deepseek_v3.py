"""DeepSeek-V3 in the port, held in fp32 on the CPU at a tiny size against
the benchmark's plain reference of it (``perfbench/reference/deepseek_v3
.py``, plain torch, no import of the port): YaRN's rotary table and
softmax scale against their closed form, the ``noaux_tc`` router's
choices (a bias that flips one, a group mask that removes a higher
score), prefill logits, decode through the latent cache, and the expert
share: the parts that every expert-parallel share adds, with the shared
expert once, make the uncut layer.  The configuration is the benchmark's
file cut to its family's tiny size (``perfbench/families/deepseek_v3.py``).
DeepSeek-V2-Lite, whose configuration leaves every new field at its
default, gives the numbers it gave before those fields existed."""
import dataclasses
import importlib
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import (Model, make_loss_fn, smoke_variant,
                                value_and_grad)
from repro_torch.models import layers as L

PERFBENCH = Path(__file__).resolve().parent.parent / "perfbench"
if str(PERFBENCH) not in sys.path:
    sys.path.append(str(PERFBENCH))
RC = importlib.import_module("reference.common")
R3 = importlib.import_module("reference.deepseek_v3")
program = importlib.import_module("harness.program")
spec = importlib.import_module("harness.spec")

FILE = PERFBENCH / "configs" / "deepseek-v3-671b.json"
PUBLISHED = json.loads(FILE.read_text())
RTOL = 1e-5
NUM = RC.Numerics()


def tiny(**over) -> dict:
    """The configuration file at its family's tiny size, in fp32."""
    cfg = dict(PUBLISHED, dtype="float32")
    cfg.update(spec.family(cfg).TINY, **over)
    return cfg


def port_cfg(cfg: dict):
    return program.model_config(cfg, remat=False)


def _model(cfg: dict, seed: int = 0):
    model = Model(port_cfg(cfg), "cpu")
    return model, model.init(torch.Generator().manual_seed(seed))


def _W(params):
    def W(path):
        t = params
        for k in path:
            t = t[k]
        return t.float()
    return W


def _tokens(cfg, b, s, seed=1):
    return torch.randint(0, cfg["vocab_size"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


# -------------------------------------------------------------------- YaRN
def test_yarn_table_is_its_closed_form():
    """At the published numbers (rotary dim 64, base 10,000, factor 40,
    4,096 original positions, beta 32 and 1) pairs below 10 keep their
    frequency, pairs from 23 are divided by 40, the ramp (i - 10) / 13
    lies between; cos/sin unscaled (mscale / mscale_all_dim = 1)."""
    y = port_cfg(PUBLISHED).rope_scaling
    cos, sin = L.rope_cos_sin(torch.tensor([1]), 64, 1e4, y)
    got = torch.atan2(sin, cos)[0].double()           # position 1: inv
    base = 1e4 ** -(torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = base * (1 - ramp) + base / 40 * ramp
    assert torch.equal(ramp[:11], torch.zeros(11))
    assert torch.equal(ramp[23:], torch.ones(9))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(R3.yarn_inv_freq(PUBLISHED, 64), want,
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(cos * cos + sin * sin, torch.ones(1, 32))


def test_yarn_softmax_scale_at_the_published_numbers():
    """(1 + 0.1 ln 40)^2 / sqrt(192) = 1.873854 / 13.856406 = 0.135234, in
    the port and the reference; 1 / sqrt(192) without the scaling."""
    m2 = (1 + 0.1 * math.log(40)) ** 2
    assert L.yarn_attention_factor(port_cfg(PUBLISHED)) == pytest.approx(
        m2, rel=1e-12)
    assert m2 / math.sqrt(192) == pytest.approx(0.135234, abs=1e-6)
    assert R3.softmax_scale(PUBLISHED) == pytest.approx(
        m2 / math.sqrt(192), rel=1e-12)
    plain = dict(PUBLISHED, rope_scaling=None)
    assert L.yarn_attention_factor(port_cfg(plain)) == 1.0
    assert R3.softmax_scale(plain) == pytest.approx(192 ** -0.5)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_selections_equal_the_reference(seed):
    """Random tokens and router (its last row the bias): the same experts
    in the same order, the same weights."""
    cfg = tiny()
    mc = port_cfg(cfg)
    g = torch.Generator().manual_seed(seed)
    d, e = cfg["hidden_size"], cfg["n_routed_experts"]
    xt = torch.randn(256, d, generator=g)
    router = torch.randn(d + 1, e, generator=g) * 0.1
    wv, wi = L.moe_route(router, xt, mc.top_k, mc)
    rv, ri = R3.route(cfg, xt, router)
    assert torch.equal(wi, ri)
    torch.testing.assert_close(wv, rv, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(wv.sum(-1), torch.full((256,), 2.5))


def _hand_router(logits, bias):
    """A router whose logits for the one token ``e_0`` are ``logits``."""
    e = len(logits)
    router = torch.zeros(e + 1, e)
    router[0] = torch.tensor(logits)
    router[e] = torch.tensor(bias)
    return torch.eye(e)[:1], router


def _route_both(cfg, xt, router):
    mc = port_cfg(cfg)
    got = L.moe_route(router, xt, mc.top_k, mc)
    want = R3.route(cfg, xt, router)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    return got


def test_router_bias_flips_a_choice():
    """Expert 1 scores under expert 0, but its bias puts it first; the
    weights are the unbiased scores, normalised, times 2.5."""
    cfg = tiny(n_routed_experts=8, n_group=1, topk_group=1,
               num_experts_per_tok=2, ep_size=1)
    logits = [2.0, 1.9, -4, -4, -4, -4, -4, -4]
    xt, router = _hand_router(logits, [0, 0.1, 0, 0, 0, 0, 0, 0])
    wv, wi = _route_both(cfg, xt, router)
    assert wi.tolist() == [[1, 0]]
    s = torch.sigmoid(torch.tensor([1.9, 2.0]))
    torch.testing.assert_close(wv[0], s / s.sum() * 2.5)
    xt, router = _hand_router(logits, [0] * 8)
    assert _route_both(cfg, xt, router)[1].tolist() == [[0, 1]]


def test_router_group_mask_removes_a_higher_scoring_expert():
    """Four groups of two, two kept by their two best scores: expert 0
    scores highest, but its group's pair sums under groups 1 and 2, so it
    is masked; experts 2 and 3 tie and go in order."""
    cfg = tiny(n_routed_experts=8, n_group=4, topk_group=2,
               num_experts_per_tok=2, ep_size=1)
    xt, router = _hand_router([3.0, -5, 1.0, 1.0, 0.9, 0.9, -3, -3], [0] * 8)
    wv, wi = _route_both(cfg, xt, router)
    assert wi.tolist() == [[2, 3]]
    torch.testing.assert_close(wv[0], torch.tensor([1.25, 1.25]))


# ------------------------------------------------------------------- model
def test_tiny_model_has_the_published_structure():
    """One dense layer, then MoE layers holding half of the 16 experts
    under a router over all 16 (its last row the bias); the query latent
    and both norms; every leaf the benchmark's layout."""
    cfg = tiny()
    model, params = _model(cfg)
    blocks = params["blocks"]
    assert "mlp" in blocks[0] and "moe" not in blocks[0]
    assert all("moe" in b and "mlp" not in b for b in blocks[1:])
    moe = blocks[1]["moe"]
    assert moe["router"].shape == (65, 16)
    assert moe["router"].dtype == torch.float32
    assert moe["wi"].shape == (8, 64, 32)
    assert {"wq_a", "q_norm", "wq_b", "kv_norm"} <= set(blocks[0]["attn"])
    program.check_layout(model, cfg)
    n = sum(t.numel() for b in params["blocks"] for t in _leaves(b))
    n += sum(t.numel() for t in _leaves(params["emb"]))
    # n_params counts the vocabulary unpadded and, as the reference's
    # does, leaves out the final norm
    pad = (model.cfg.padded_vocab - model.cfg.vocab_size) * 64 * 2
    assert n - pad - 64 == model.cfg.n_params()


def test_published_sizes_count_as_laid_out():
    """27 layers at the published widths: 17.68 B parameters as the
    benchmark lays them out (the vocabulary padded to 131,072), counted
    on meta tensors."""
    model = Model(port_cfg(PUBLISHED), "meta")
    shapes = model.init_shapes()
    n = sum(t.numel() for t in _leaves(shapes))
    assert n == 17_677_153_280
    cfg = model.cfg
    pad = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * 2
    assert n - pad - cfg.d_model == cfg.n_params()
    program.check_layout(model, PUBLISHED)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


@pytest.mark.parametrize("over", [{}, {"rope_scaling": None}],
                         ids=["yarn", "unscaled"])
def test_prefill_logits_equal_the_reference(over):
    cfg = tiny(**over)
    model, params = _model(cfg)
    tok = _tokens(cfg, 2, 40)
    got = model.prefill(params, {"tokens": tok})
    want = RC.prefill_logits(cfg, _W(params), tok, NUM)
    assert _rel(got, want) <= RTOL


def test_prefill_then_decode_equals_the_reference():
    """The prompt through the latent cache a token at a time (the port's
    way of filling it), then 4 decode steps: every step's logits against
    the reference's full forward at that position, the prompt's last
    against the prefill's."""
    cfg = tiny()
    model, params = _model(cfg)
    s, n_new = 20, 4
    tok = _tokens(cfg, 2, s + n_new)
    W = _W(params)
    full = RC.unembed(cfg, W, RC.hidden(cfg, W, tok, NUM), NUM)
    pre = model.prefill(params, {"tokens": tok[:, :s]})
    assert _rel(pre, full[:, s - 1]) <= RTOL
    cache = model.init_cache(2, s + n_new)
    for p in range(s + n_new):
        logits, cache = model.decode_step(params, cache, {
            "tokens": tok[:, p:p + 1],
            "pos": torch.full((2,), p, dtype=torch.int32)})
        if p >= s - 1:
            assert _rel(logits, full[:, p]) <= RTOL, p
    # the cache holds the normed latent: every row's c_kv at unit RMS
    c = cache["kv"]["c_kv"][0, :, :s + n_new]
    torch.testing.assert_close(c.pow(2).mean(-1),
                               torch.ones(2, s + n_new), rtol=1e-4, atol=0)


@pytest.mark.parametrize("ep_size", [2, 4, 8])
def test_expert_shares_add_up_to_the_uncut_layer(ep_size):
    """Each share ``[e_lo, e_lo + 16 / ep_size)`` of the routed experts,
    in the port and in the reference (which also agree share by share),
    summed with the shared expert once, equals the uncut layer (all 16
    experts held)."""
    cfg_all = tiny(ep_size=1)
    mc_all = port_cfg(cfg_all)
    p = L.init_moe(mc_all, torch.Generator().manual_seed(3), torch.device(
        "cpu"))
    cfg = tiny(ep_size=ep_size)
    mc = port_cfg(cfg)
    x = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(4))
    xt = x.reshape(-1, 64)
    whole = L.moe_apply(p, mc_all, x).reshape(-1, 64)
    held = 16 // ep_size
    shared = L.mlp_apply(p["shared"], mc, x).reshape(-1, 64)
    ref_shared = RC.swiglu(xt, p["shared"]["wi"], p["shared"]["wg"],
                           p["shared"]["wo"], NUM)
    port_sum, ref_sum = shared.clone(), ref_shared.clone()
    for lo in range(0, 16, held):
        part = dict(p, **{k: p[k][lo:lo + held] for k in ("wi", "wg", "wo")})
        mine = L.moe_experts(part, mc, xt, lo)
        ref = R3.moe(cfg, lambda *k, part=part: _W(part)(k[1:]), x, NUM,
                     lo).reshape(-1, 64) - ref_shared
        torch.testing.assert_close(mine, ref, rtol=1e-5, atol=1e-6)
        port_sum += mine
        ref_sum += ref
    torch.testing.assert_close(port_sum, whole, rtol=1e-5, atol=1e-6)
    ref_whole = R3.moe(cfg_all, lambda *k: _W(p)(k[1:]), x, NUM).reshape(
        -1, 64)
    torch.testing.assert_close(ref_sum, ref_whole, rtol=1e-5, atol=1e-6)


def test_train_gradient_reaches_the_router_not_its_bias():
    """A loss and gradient through the tiny model: the router's rows take a
    gradient, its bias row (which only selects) none."""
    cfg = tiny()
    model, params = _model(cfg)
    tok = _tokens(cfg, 2, 17)
    loss, grads = value_and_grad(make_loss_fn(model))(
        params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    assert math.isfinite(float(loss))
    for b in grads["blocks"][1:]:
        g = b["moe"]["router"]
        assert float(g[:-1].abs().sum()) > 0
        assert torch.equal(g[-1], torch.zeros_like(g[-1]))


@pytest.mark.parametrize("key,value", [
    ("num_nextn_predict_layers", 1), ("scoring_func", "softmax"),
    ("norm_topk_prob", False), ("ep_size", 3), ("topk_group", 0),
    ("rope_scaling", {"type": "linear", "factor": 4})])
def test_family_refuses_what_the_port_would_not_run(key, value):
    with pytest.raises(ValueError):
        port_cfg(dict(PUBLISHED, **{key: value}))


# ------------------------------------------------- DeepSeek-V2-Lite as it was
#: the smoke variant's numbers (fp32, CPU) before the new fields existed
V2_FORWARD = ([0.178306401, 0.227687463, -0.111861691, 0.139864609],
              [-0.158611774, -0.094934002, 0.033203255],
              21.127878071880332, 11820.654743858717)
V2_DECODE = ([0.206765577, 0.266205996, -0.048101835, -0.009535779],
             5.419710616173688, 738.4047738377121)


def test_v2_lite_gives_the_numbers_it_gave_before():
    """Its ``ModelConfig`` leaves every new field at its default, and its
    smoke variant's forward and decode logits are the pinned ones."""
    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    new = {"router": "softmax", "n_group": 1, "topk_group": 1,
           "routed_scale": 1.0, "ep_size": 1, "first_dense_layers": 0,
           "q_lora_rank": 0, "kv_latent_norm": False, "rope_scaling": None}
    assert {k: getattr(cfg, k) for k in new} == new
    assert {f.name: f.default for f in dataclasses.fields(cfg)
            if f.name in new} == new
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    logits = model.forward(params, {"tokens": tok})
    row, cols, total, mass = V2_FORWARD
    torch.testing.assert_close(logits[0, -1, :4], torch.tensor(row),
                               rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(logits[1, 3, 100:103], torch.tensor(cols),
                               rtol=1e-6, atol=1e-8)
    assert float(logits.double().sum()) == pytest.approx(total, rel=1e-6)
    assert float(logits.double().abs().sum()) == pytest.approx(mass,
                                                               rel=1e-6)
    cache = model.init_cache(2, 8)
    for pos in range(3):
        lg, cache = model.decode_step(params, cache, {
            "tokens": tok[:, pos:pos + 1],
            "pos": torch.full((2,), pos, dtype=torch.int32)})
    row, total, mass = V2_DECODE
    torch.testing.assert_close(lg[0, :4], torch.tensor(row), rtol=1e-6,
                               atol=1e-8)
    assert float(lg.double().sum()) == pytest.approx(total, rel=1e-6)
    assert float(lg.double().abs().sum()) == pytest.approx(mass, rel=1e-6)
