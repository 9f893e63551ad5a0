"""The port's profiler spans on the train and prefill path, on the CPU:
``attention/grad`` (B8's backward), ``optim/adamw`` (the whole update),
``model/unembed`` (the final norm and the vocabulary product),
``attention/mla`` (the whole of MLA), ``moe/experts`` and, nested in it,
``moe/route`` and ``moe/slots``.  Each opens once a call
at its layer's boundary (never per chunk, leaf or expert), and a profiler
that records them changes no result: losses, gradients, updated
parameters and prefill logits are bit-equal with and without one.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import (Model, make_loss_fn, make_prefill_step,
                                make_train_step, smoke_variant,
                                value_and_grad)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten

SPANS = ("attention/grad", "optim/adamw", "model/unembed", "moe/experts",
         "moe/slots", "moe/route", "attention/mla")
ARCHS = ["smollm-360m", "deepseek-v2-lite-16b"]


def _profiled(fn):
    """``fn()``'s result and the host events of the spans it opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in SPANS]


def _count(events, name):
    return sum(e.name == name for e in events)


def _model(arch, **over):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    model = Model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _batch(cfg, b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("s", [40, 1100], ids=["whole", "chunked"])
def test_attention_grad_opens_one_span_a_call(s):
    """One span a call, past ``NAIVE_MAX_SEQ`` too, where the gradient
    runs in chunks of ``Q_CHUNK`` queries."""
    g = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(1, 2, s, 32, generator=g) for _ in range(2))
    k, v = (torch.randn(1, 1, s, 32, generator=g) for _ in range(2))
    grads, evs = _profiled(lambda: fa.attention_grad(q, k, v, dout))
    assert [e.name for e in evs] == ["attention/grad"]
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]


def test_attention_grad_span_from_the_autograd_function():
    """B8's ``Function`` (the card's route; on meta tensors here) opens
    the span once in its backward."""
    q = torch.empty(1, 2, 64, 32, device="meta", requires_grad=True)
    k = torch.empty(1, 1, 64, 32, device="meta", requires_grad=True)
    v = torch.empty(1, 1, 64, 32, device="meta", requires_grad=True)

    def run():
        out = fa.flash_attention(q, k, v)
        return torch.autograd.grad(out.sum(), (q, k, v))
    grads, evs = _profiled(run)
    assert _count(evs, "attention/grad") == 1
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(arch, accum):
    """A train step opens ``optim/adamw`` once, ``model/unembed`` once a
    microbatch's forward, and the MoE and MLA spans once an MoE or MLA
    layer a forward."""
    model, params = _model(arch)
    step = make_train_step(model, AdamWConfig(warmup_steps=1), accum)
    opt = adamw_init(params)
    batch = _batch(model.cfg, b=4)

    def two_steps():
        p, o = params, opt
        for _ in range(2):
            p, o, _ = step(p, o, batch)
        return p
    _, evs = _profiled(two_steps)
    assert _count(evs, "optim/adamw") == 2
    assert _count(evs, "model/unembed") == 2 * accum
    n_moe = model.cfg.n_layers if model.cfg.is_moe else 0
    assert _count(evs, "moe/experts") == 2 * accum * n_moe
    assert _count(evs, "moe/slots") == 2 * accum * n_moe
    assert _count(evs, "moe/route") == 2 * accum * n_moe
    n_mla = model.cfg.n_layers if model.cfg.attention == "mla" else 0
    assert _count(evs, "attention/mla") == 2 * accum * n_mla


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_open_one_unembed_span(arch):
    model, params = _model(arch)
    batch = _batch(model.cfg)
    _, evs = _profiled(lambda: model.prefill(params, batch))
    assert _count(evs, "model/unembed") == 1
    cache = model.init_cache(2, 8)
    _, evs = _profiled(lambda: model.decode_step(
        params, cache, {"tokens": batch["tokens"][:, :1],
                        "pos": torch.zeros(2, dtype=torch.int32)}))
    assert _count(evs, "model/unembed") == 1


def _nested_in_experts(inner):
    """A 3-layer prefill's ``moe/experts`` spans and its ``inner`` spans,
    each of which opened inside one of them."""
    model, params = _model("deepseek-v2-lite-16b", n_layers=3)
    _, evs = _profiled(lambda: model.prefill(params, _batch(model.cfg)))
    experts = [e for e in evs if e.name == "moe/experts"]
    slots = [e for e in evs if e.name == inner]
    assert len(experts) == len(slots) == 3
    for s in slots:
        parent = s.cpu_parent
        while parent is not None and parent.name != "moe/experts":
            parent = parent.cpu_parent
        assert parent is not None
        assert parent.time_range.start <= s.time_range.start
        assert s.time_range.end <= parent.time_range.end
    return evs, experts


def test_moe_slots_nest_in_moe_experts_once_a_layer():
    _nested_in_experts("moe/slots")


def test_moe_route_nests_in_moe_experts_and_mla_stands_apart():
    """``moe/route`` opens once inside each ``moe/experts``;
    ``attention/mla`` once a layer, outside them."""
    evs, experts = _nested_in_experts("moe/route")
    mla = [e for e in evs if e.name == "attention/mla"]
    assert len(mla) == 3
    for e in mla:
        assert all(e.time_range.end <= x.time_range.start
                   or x.time_range.end <= e.time_range.start
                   for x in experts)


def test_mla_and_route_spans_in_decode():
    """A decode step opens ``attention/mla`` and ``moe/route`` once a
    layer too (the absorbed path, the router over one row a sequence)."""
    model, params = _model("deepseek-v2-lite-16b", n_layers=3)
    cache = model.init_cache(2, 8)
    _, evs = _profiled(lambda: model.decode_step(
        params, cache, {"tokens": torch.zeros(2, 1, dtype=torch.long),
                        "pos": torch.zeros(2, dtype=torch.int32)}))
    assert _count(evs, "attention/mla") == 3
    assert _count(evs, "moe/route") == 3


def _train_and_prefill(model, params, batch):
    """Loss and gradients, two train steps' parameters and moments, and
    the prefill's logits."""
    loss, grads = value_and_grad(make_loss_fn(model))(params, batch)
    step = make_train_step(model, AdamWConfig(warmup_steps=1))
    p, o = params, adamw_init(params)
    for _ in range(2):
        p, o, met = step(p, o, batch)
    logits = make_prefill_step(model)(p, batch)
    return ([loss, met["loss"], met["grad_norm"], logits] + tree_leaves(grads)
            + tree_leaves(p) + tree_leaves(o["m"]) + tree_leaves(o["v"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_results_bit_equal_with_and_without_the_profiler(arch):
    model, params = _model(arch)
    batch = _batch(model.cfg)
    plain = _train_and_prefill(model, params, batch)
    traced, evs = _profiled(lambda: _train_and_prefill(model, params, batch))
    assert _count(evs, "optim/adamw") == 2
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_spans_are_no_work_to_the_cost_model():
    """The dry run's counter leaves the profiler's span ops out."""
    model, params = _model("smollm-360m")
    grads = [torch.ones_like(p) for p in tree_leaves(params)]
    with OpCost() as cost:
        adamw_update(AdamWConfig(), params, tree_unflatten(params, grads),
                     adamw_init(params))
    assert cost.n_ops > 0
    assert not [k for c in cost.breakdown.values() for k in c
                if k.startswith("profiler")]
