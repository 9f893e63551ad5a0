"""The port's multi-policy arena against ``repro.core.arena``.

``run_arena`` with the 15 ``default_factories`` policies, in content and
semantic mode, with the exact, quantized, pruned and composed stacked
scans, on the port's numpy oracle and on its kernel backend on the CPU
(the kernels' plain versions) and on its sharded backend against the
reference's numpy, kernel and sharded (``use_pallas=False``) backends: identical per-policy ``Stats`` and
identical ``quant_stats``/``prune_stats`` ledgers.  Also the arena against
the port's own sequential replays (``run_many``), ``top1_multi`` across
backends and across mutations, and the three stacked plain versions
against the reference's Pallas kernels run in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cache.backends as r_backends
import repro_torch.cache.backends as t_backends
from repro.core import SynthConfig as RSynth
from repro.core import synthetic_trace as r_synth
from repro.core.arena import run_arena as r_run_arena
from repro.core.simulator import default_factories as r_default_factories
from repro.kernels import ops as rops
from repro_torch.cache import KernelBackend, NumpyBackend
from repro_torch.core import (SynthConfig, default_factories, run_arena,
                              run_many, synthetic_trace)
from repro_torch.core.arena import ArenaStore
from repro_torch.kernels import ops, ref

DIM, CAP, LEN, CHUNK = 32, 40, 400, 64

# (the port's backend kwargs, the reference's)
BACKENDS = {"numpy": ({"backend": "numpy"}, {"backend": "numpy"}),
            "kernel": ({"backend": "kernel", "device": "cpu"},
                       {"backend": "kernel", "use_pallas": False}),
            "sharded": ({"backend": "sharded", "device": "cpu"},
                        {"backend": "sharded", "use_pallas": False})}
APPROX = {"exact": {}, "quantized": {"quantized": True},
          "pruned": {"pruned": True},
          "both": {"quantized": True, "pruned": True}}


@pytest.fixture(scope="module")
def traces():
    kw = dict(trace_len=LEN, n_topics=8, dim=DIM, capacity_ref=CAP, seed=11)
    return r_synth(RSynth(**kw)), synthetic_trace(SynthConfig(**kw))


def _counts(stats):
    return [(s.policy, s.capacity, s.requests, s.hits, s.misses,
             s.evictions, s.hr_full) for s in stats]


def _capture(monkeypatch, module) -> list:
    """Record every backend ``module.get_backend`` builds (``run_arena``
    looks it up at call time), so a test can read its ledgers."""
    made, orig = [], module.get_backend

    def get_backend(*a, **kw):
        be = orig(*a, **kw)
        made.append(be)
        return be
    monkeypatch.setattr(module, "get_backend", get_backend)
    return made


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("mode,approx", [("content", "exact")] + [
    ("semantic", a) for a in APPROX])
def test_arena_matches_reference(traces, monkeypatch, backend, mode, approx):
    ref_tr, port_tr = traces
    pkw, rkw = BACKENDS[backend]
    made_r = _capture(monkeypatch, r_backends)
    made_p = _capture(monkeypatch, t_backends)
    want = r_run_arena(ref_tr, CAP, r_default_factories(seed=0),
                       hit_mode=mode, chunk=CHUNK, **rkw, **APPROX[approx])
    got = run_arena(port_tr, CAP, default_factories(seed=0), hit_mode=mode,
                    chunk=CHUNK, **pkw, **APPROX[approx])
    assert len(got) == 15
    assert _counts(got) == _counts(want)
    assert all(s.hits > 0 and s.evictions > 0 for s in got)
    (rbe,), (pbe,) = made_r, made_p
    assert pbe.quant_stats == rbe.quant_stats
    assert pbe.prune_stats == rbe.prune_stats
    if mode == "semantic" and "quantized" in APPROX[approx] \
            and approx != "both":
        assert pbe.quant_stats["queries"] > 0
    if "pruned" in APPROX[approx]:
        assert pbe.prune_stats["queries"] > 0


@pytest.mark.parametrize("approx", sorted(APPROX))
def test_arena_matches_sequential_replays(traces, approx):
    """One arena pass makes each policy's sequential decisions
    (``run_many(arena=True)`` against ``run_many``, the per-request loop
    with the same approximate lookup)."""
    _, tr = traces
    facs = default_factories(seed=0)
    arena = run_many(tr, CAP, facs, arena=True, hit_mode="semantic",
                     backend="kernel", device="cpu", chunk=CHUNK,
                     **APPROX[approx])
    seq = run_many(tr, CAP, facs, hit_mode="semantic", backend="numpy")
    assert _counts(arena) == _counts(seq)
    assert arena[0].wall_s > 0


def test_arena_counts_one_stacked_launch_per_chunk(traces):
    """The exact semantic arena on the kernel backend makes one stacked
    dispatch per chunk (an empty arena included)."""
    _, tr = traces
    before = ops.dispatch_stats["launches"]
    launches = []
    orig = ops.sim_top1_multi

    def counted(*a, **kw):
        launches.append(1)
        return orig(*a, **kw)
    try:
        ops.sim_top1_multi = counted
        run_arena(tr, CAP, default_factories(seed=0), hit_mode="semantic",
                  backend="kernel", device="cpu", chunk=CHUNK)
    finally:
        ops.sim_top1_multi = orig
    assert len(launches) == -(-LEN // CHUNK)
    assert ops.dispatch_stats["launches"] > before


def test_run_arena_sharded_raises_naming_a10(traces):
    """The sharded arena, which raised before, runs: one shard a device
    (one on the CPU) and a prebuilt two-shard backend both give the numpy
    oracle's per-policy ``Stats``."""
    from repro_torch.cache import ShardedKernelBackend
    _, tr = traces
    kw = dict(hit_mode="semantic", chunk=CHUNK, seed=0)
    want = run_arena(tr, CAP, default_factories(seed=0), backend="numpy",
                     **kw)
    for be in ({"backend": "sharded", "device": "cpu"},
               {"backend": ShardedKernelBackend(n_shards=2, device="cpu")}):
        got = run_arena(tr, CAP, default_factories(seed=0), **be, **kw)
        assert _counts(got) == _counts(want)


def test_run_arena_defaults_to_the_card():
    import inspect
    params = inspect.signature(run_arena).parameters
    assert params["backend"].default == "kernel"
    assert params["device"].default == "cuda"
    if not torch.cuda.is_available():
        tr = synthetic_trace(SynthConfig(trace_len=10, dim=8, seed=0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_arena(tr, 4, default_factories(), hit_mode="semantic")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same_top1_decisions(nc, ns, kc, ks):
    """Identical winners wherever the best similarity is positive, and
    agreement that nothing clears a positive gate elsewhere (a zeroed free
    slot may out-score a negative real best on one engine only)."""
    pos = np.asarray(ns) > 0
    np.testing.assert_array_equal(pos, np.asarray(ks) > 0)
    np.testing.assert_array_equal(np.asarray(nc)[pos], np.asarray(kc)[pos])
    np.testing.assert_allclose(np.asarray(ns)[pos], np.asarray(ks)[pos],
                               atol=1e-5)


def test_top1_multi_backends_agree():
    rng = np.random.default_rng(0)
    dim = 32
    arena = ArenaStore(3, 50, dim, track_rows=True)
    for p, n in enumerate((40, 51, 3)):
        embs = _unit(rng, n, dim)
        for i in range(n):
            arena.views[p].insert(1000 * p + i, embs[i])
    q = _unit(rng, 9, dim)
    nc, ns = NumpyBackend().top1_multi(arena, q)
    assert nc.shape == ns.shape == (3, 9)
    assert (ns[0] > 0).any() and (ns[1] > 0).any()
    _assert_same_top1_decisions(nc, ns,
                                *KernelBackend("cpu").top1_multi(arena, q))
    rc, rs = r_backends.NumpyBackend().top1_multi(arena, q)
    np.testing.assert_array_equal(nc, rc)
    np.testing.assert_array_equal(ns, rs)


def test_kernel_top1_multi_tracks_mutations():
    """The stacked device mirror follows inserts and removals (dirty-row
    copies keyed on the arena's flat journal), and single-store calls on a
    view read the same mirror."""
    rng = np.random.default_rng(1)
    dim = 16
    arena = ArenaStore(2, 20, dim, track_rows=True)
    embs = _unit(rng, 30, dim)
    for i in range(10):
        arena.views[0].insert(i, embs[i])
        arena.views[1].insert(100 + i, embs[i + 10])
    kb, nb = KernelBackend("cpu"), NumpyBackend()
    q = embs[20:25]
    _assert_same_top1_decisions(*nb.top1_multi(arena, q),
                                *kb.top1_multi(arena, q))
    arena.views[0].remove(3)
    arena.views[1].insert(999, q[0])
    nc, ns = nb.top1_multi(arena, q)
    assert nc[1, 0] == 999 and ns[1, 0] > 0.99   # the fresh row must win
    _assert_same_top1_decisions(nc, ns, *kb.top1_multi(arena, q))
    assert kb.sync_stats["incremental"] >= 1
    # a view's single-store scan reads its rows of the arena mirror
    assert kb.top1(arena.views[1], q[0])[0] == 999
    assert kb.top1(arena.views[0], embs[3])[0] != 3
    assert kb._store_mirror.arrays is None


# ------------------------------------------ stacked plain versions (B7)
@pytest.mark.parametrize("n", [512, 2048])
def test_sim_top1_multi_ref_matches_reference_pallas(n):
    rng = np.random.default_rng(2)
    p_, d, b = 3, 128, 16
    slabs = rng.standard_normal((p_, n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    nv = np.array([100, n, 1], dtype=np.int32)
    rv, ri = rops.sim_top1_multi(jnp.asarray(q), jnp.asarray(slabs), nv,
                                 use_pallas=True, interpret=True)
    v, i = ref.sim_top1_multi_ref(torch.from_numpy(q),
                                  torch.from_numpy(slabs),
                                  torch.from_numpy(nv))
    assert tuple(v.shape) == tuple(i.shape) == (p_, b)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-5)
    assert (i[2] == 0).all()
    # through the dispatch wrapper: one counted dispatch, same answer
    before = ops.dispatch_stats["launches"]
    wv, wi = ops.sim_top1_multi(q, slabs, nv)
    assert ops.dispatch_stats["launches"] == before + 1
    assert torch.equal(wv, v) and torch.equal(wi, i)


@pytest.mark.parametrize("n", [512, 2048])
def test_sim_topk_q8_multi_ref_matches_reference_pallas(n):
    from repro_torch.kernels.quant import quantize_rows_int8
    rng = np.random.default_rng(3)
    p_, d, b, k = 3, 128, 16, 8
    q8, qs, _ = quantize_rows_int8(_unit(rng, b, d))
    c8, cs, _ = quantize_rows_int8(_unit(rng, p_ * n, d))
    c8, cs = c8.reshape(p_, n, d), cs.reshape(p_, n)
    nv = np.array([1, n, n // 3], dtype=np.int32)
    rv, ri = rops.sim_topk_q8_multi(jnp.asarray(q8), jnp.asarray(qs),
                                    jnp.asarray(c8), jnp.asarray(cs), k, nv,
                                    use_pallas=True, interpret=True)
    v, i = ops.sim_topk_q8_multi(q8, qs, c8, cs, k, n_valid=nv)
    rv, ri = np.asarray(rv), np.asarray(ri)
    assert tuple(v.shape) == rv.shape == (p_, b, k)
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(v.numpy()), fin)
    np.testing.assert_allclose(v.numpy()[fin], rv[fin], atol=1e-5)
    np.testing.assert_array_equal(i.numpy()[fin], ri[fin])
    # k is clamped to the slot axis, as the reference clamps it
    v2, _ = ops.sim_topk_q8_multi(q8, qs, c8[:, :5], cs[:, :5], k,
                                  n_valid=np.full(p_, 5, np.int32))
    assert tuple(v2.shape) == (p_, b, 5)


def test_victim_value_multi_ref_matches_reference_pallas():
    rng = np.random.default_rng(4)
    p_, n, t = 3, 2048, 32
    tsi = rng.random((p_, n)).astype(np.float32)
    tid = rng.integers(-1, t, (p_, n)).astype(np.int32)
    occ = rng.integers(0, 2, (p_, n)).astype(np.int32)
    tp = (rng.random((p_, t)) * 5).astype(np.float32)
    tl = rng.integers(0, 500, (p_, t)).astype(np.int32)
    want = np.asarray(rops.victim_value_multi(
        *map(jnp.asarray, (tsi, tid, occ, tp, tl)), 700, alpha=0.01,
        use_pallas=True, interpret=True))
    got = ops.victim_value_multi(tsi, tid, occ, tp, tl, 700,
                                 alpha=0.01).numpy()
    assert got.shape == (p_, n)
    free = occ == 0
    assert np.isinf(got[free]).all() and np.isinf(want[free]).all()
    np.testing.assert_allclose(got[~free], want[~free], rtol=1e-6, atol=0)
