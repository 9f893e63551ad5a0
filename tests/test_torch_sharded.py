"""The port's sharded semantic cache against ``repro.cache.sharded``.

``ShardedStore`` placement, and ``ShardedKernelBackend`` on the CPU (the
kernels' plain versions, ``device="cpu"``) against the reference's sharded
backend (``use_pallas=False``: its single-device per-shard loop) and the
numpy oracle, on the same numpy-seeded inputs: RAC's hit/admit/evict
sequences for S in {1, 2, 4} in semantic mode at chunks {1, 7, 512} and
in content mode, ``lookup_batch`` (cids equal, sims within 1e-6), empty
and freed shards, capacity boundaries for S in {1, 2, 3, 4},
checkpoint/restore, Eq. 1 scoring (chunked, ``n < S``, masked), the
quantized shortlist before certification and the quantized decisions,
the pruned lookup fused and staged, and ``run_arena`` (exact, quantized,
pruned).  The multi-card code path runs under a patched
``make_cache_mesh`` (``[cpu] * S``) and must equal the one-device loop;
the slab syncs once in full, then by dirty rows; and the two new modules
import neither JAX nor the reference package.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.cache.quantized as r_quantized
from repro.cache import CacheConfig as RConfig
from repro.cache import SemanticCache as RCache
from repro.cache import ShardedKernelBackend as RSharded
from repro.cache import ShardedStore as RShardedStore
from repro.core import SynthConfig as RSynth
from repro.core import simulator as rsim
from repro.core import synthetic_trace as r_synth
from repro.core.arena import run_arena as r_run_arena
from repro.core.rac import make_rac as r_make_rac
from repro.core.simulator import default_factories as r_default_factories
from repro.kernels import ops as rops
from repro_torch.cache import (CacheConfig, KernelBackend, NumpyBackend,
                               SemanticCache, ShardedKernelBackend,
                               ShardedStore, get_backend)
from repro_torch.core import (SynthConfig, default_factories, make_rac,
                              run_arena, synthetic_trace)
from repro_torch.core import simulator as tsim
from repro_torch.kernels import fused, ops
from repro_torch.launch import mesh

DIM, CAP, LEN = 32, 64, 1_000
SIM_ATOL = 1e-6
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def traces():
    kw = dict(trace_len=LEN, n_topics=12, dim=DIM, capacity_ref=CAP, seed=3)
    ref, port = r_synth(RSynth(**kw)), synthetic_trace(SynthConfig(**kw))
    assert [r.cid for r in ref.requests] == [r.cid for r in port.requests]
    return ref, port


def unit_rows(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture
def cpu_mesh(monkeypatch):
    """The multi-card code path on the CPU: every shard's card is the
    CPU (the test seam the chip smoke uses with ``cuda:0``)."""
    monkeypatch.setattr(mesh, "make_cache_mesh",
                        lambda n, device="cuda": [torch.device("cpu")] * n)


def recording(factory, log):
    def make(capacity, store):
        pol = factory(capacity, store)
        on_hit, on_admit, victim = pol.on_hit, pol.on_admit, pol.victim

        def hit(cid, req, t):
            log.append(("hit", int(cid), int(t)))
            return on_hit(cid, req, t)

        def admit(cid, req, t):
            log.append(("admit", int(cid), int(t)))
            return on_admit(cid, req, t)

        def evict(t):
            v = victim(t)
            log.append(("evict", int(v), int(t)))
            return v

        pol.on_hit, pol.on_admit, pol.victim = hit, admit, evict
        return pol
    return make


def _stats(s):
    return (s.hits, s.misses, s.evictions, s.hr_full)


def _run(pkg, trace, n_shards, mode, chunk, made):
    """RAC through the package's own replay driver (``run_policy`` in
    content mode, ``run_policy_batched`` at ``chunk`` in semantic mode)
    on its sharded backend with ``n_shards`` shards."""
    log: list = []
    sim = tsim if pkg == "port" else rsim

    def make_cache(trace, capacity, factory, hit_mode, tau_hit, backend,
                   place):
        if pkg == "port":
            cfg = CacheConfig(capacity=capacity, dim=DIM, tau_hit=tau_hit,
                              hit_mode=hit_mode, backend=backend,
                              device=place,
                              backend_kwargs={"n_shards": n_shards})
            made.append(SemanticCache(cfg, policy_factory=factory))
        else:
            cfg = RConfig(capacity=capacity, dim=DIM, tau_hit=tau_hit,
                          hit_mode=hit_mode, backend=backend,
                          use_pallas=place,
                          backend_kwargs={"n_shards": n_shards})
            made.append(RCache(cfg, policy_factory=factory))
        return made[-1]

    place = {"device": "cpu"} if pkg == "port" else {"use_pallas": False}
    fac = recording(make_rac() if pkg == "port" else r_make_rac(), log)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim, "_make_cache", make_cache)
        if mode == "content":
            st = sim.run_policy(trace, CAP, fac, hit_mode="content",
                                backend="sharded", **place)
        else:
            st = sim.run_policy_batched(trace, CAP, fac, hit_mode="semantic",
                                        backend="sharded", chunk=chunk,
                                        **place)
    return st, log


_ORACLE: dict = {}


def _oracle(trace, mode, chunk):
    key = (mode, chunk)
    if key not in _ORACLE:
        log: list = []
        fac = recording(make_rac(), log)
        if mode == "content":
            st = tsim.run_policy(trace, CAP, fac, hit_mode="content",
                                 backend="numpy")
        else:
            st = tsim.run_policy_batched(trace, CAP, fac, backend="numpy",
                                         hit_mode="semantic", chunk=chunk)
        _ORACLE[key] = (st, log)
    return _ORACLE[key]


# ---------------------------------------------------------------- placement
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_store_placement_matches_reference(n_shards):
    rng = np.random.default_rng(11)
    cap = 37
    port, ref = (ShardedStore(cap, 8, n_shards), RShardedStore(cap, 8,
                                                                n_shards))
    assert port.rows_per_shard == ref.rows_per_shard
    assert port.emb.shape == ref.emb.shape
    live: list = []
    for step in range(400):
        if live and (len(live) > cap or rng.random() < 0.4):
            cid = live.pop(int(rng.integers(len(live))))
            assert port.remove(cid) == ref.remove(cid)
        else:
            cid = 1000 + step
            emb = rng.standard_normal(8).astype(np.float32)
            assert port.insert(cid, emb) == ref.insert(cid, emb)
            live.append(cid)
        np.testing.assert_array_equal(port.load, ref.load)
        np.testing.assert_array_equal(port.local_hwm, ref.local_hwm)
    assert port.slot_of == ref.slot_of
    assert port._free_by_shard == ref._free_by_shard
    assert port._free == ref._free == []
    assert port.hwm == ref.hwm
    np.testing.assert_array_equal(port.emb, ref.emb)
    np.testing.assert_array_equal(port.shard_view(), ref.shard_view())
    assert [port.shard_of(s) for s in range(port.emb.shape[0])] == \
        [ref.shard_of(s) for s in range(ref.emb.shape[0])]


# ---------------------------------------------------------------- decisions
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("mode,chunk", [("semantic", 1), ("semantic", 7),
                                        ("semantic", 512), ("content", 1)])
def test_decisions_match_reference_and_oracle(traces, n_shards, mode,
                                              chunk):
    ref_tr, port_tr = traces
    made: list = []
    st, log = _run("port", port_tr, n_shards, mode, chunk, made)
    rst, rlog = _run("ref", ref_tr, n_shards, mode, chunk, [])
    ost, olog = _oracle(port_tr, mode, chunk)
    assert log == rlog == olog
    assert _stats(st) == _stats(rst) == _stats(ost)
    assert st.evictions > 0 and (mode == "content" or st.hits > 0)
    store = made[0].store
    assert isinstance(store, ShardedStore) and store.n_shards == n_shards
    recount = np.bincount([s // store.rows_per_shard
                           for s in store.slot_of.values()],
                          minlength=n_shards)
    np.testing.assert_array_equal(store.load, recount)


def _filled(n_shards=4, capacity=50, n=40, seed=5):
    """The port's sharded cache, the reference's and the port's numpy
    oracle, filled with the same rows; and queries near those rows and
    far from them."""
    rng = np.random.default_rng(seed)
    embs = unit_rows(rng, n)
    caches = [
        SemanticCache(CacheConfig(capacity=capacity, dim=DIM, policy="LRU",
                                  backend="sharded", device="cpu",
                                  backend_kwargs={"n_shards": n_shards})),
        RCache(RConfig(capacity=capacity, dim=DIM, policy="LRU",
                       backend="sharded", use_pallas=False,
                       backend_kwargs={"n_shards": n_shards})),
        SemanticCache(CacheConfig(capacity=capacity, dim=DIM, policy="LRU",
                                  backend="numpy"))]
    for c in caches:
        for i, e in enumerate(embs):
            c.admit(i, e, payload=[i])
    near = embs + 0.15 * unit_rows(rng, n)
    queries = np.concatenate([near / np.linalg.norm(near, axis=1,
                                                    keepdims=True),
                              unit_rows(rng, 9)]).astype(np.float32)
    return caches, queries


def test_lookup_batch_matches_reference():
    (port, ref, oracle), q = _filled()
    got = port.lookup_batch(q, cids=list(range(len(q))))
    want = ref.lookup_batch(q, cids=list(range(len(q))))
    def key(rs):
        return [(r.hit, r.cid if r.hit else r.best_cid) for r in rs]
    assert key(got) == key(want)
    assert sum(r.hit for r in got) > 0 and not all(r.hit for r in got)
    pc, ps = port.peek_batch(q)
    for other in (ref, oracle):
        oc, os_ = other.peek_batch(q)
        np.testing.assert_array_equal(pc, oc)
        np.testing.assert_allclose(ps, os_, atol=SIM_ATOL, rtol=0)


def test_empty_shards_and_freed_slots():
    rng = np.random.default_rng(3)
    e = unit_rows(rng, 3)
    caches = [SemanticCache(CacheConfig(capacity=6, dim=DIM, policy="LRU",
                                        backend="sharded", device="cpu",
                                        backend_kwargs={"n_shards": 4})),
              RCache(RConfig(capacity=6, dim=DIM, policy="LRU",
                             backend="sharded", use_pallas=False,
                             backend_kwargs={"n_shards": 4}))]
    for cache in caches:
        r = cache.lookup(e[0], cid=0)                 # every slot empty
        assert not r.hit and r.best_cid == -1
        cache.admit(0, e[0])                          # 3 of 4 shards empty
        assert (cache.store.load > 0).sum() == 1
        assert cache.lookup(e[0], cid=0).hit
        r = cache.lookup(e[1], cid=1)
        assert not r.hit and r.best_cid == 0
    # every slot freed again: the high-water marks stay, nothing is live
    for store in (ShardedStore(6, DIM, 4), RShardedStore(6, DIM, 4)):
        for i in range(5):
            store.insert(i, e[i % 3])
        for i in range(5):
            store.remove(i)
        assert store.local_hwm.sum() == 5
        for be in (ShardedKernelBackend(n_shards=4, device="cpu"),
                   RSharded(n_shards=4, use_pallas=False)):
            cids, sims = be.top1_batch(store, e)
            assert (cids == -1).all() and np.isneginf(sims).all()


def test_b1_on_an_empty_shard_matches_reference():
    """A shard with ``local_hwm = 0`` scores under ``n_valid = 0``: every
    row is ``(-inf, 0)``, in the port's plain B1 as in the reference's."""
    rng = np.random.default_rng(2)
    q, c = unit_rows(rng, 5), unit_rows(rng, 7)
    v, i = ops.sim_top1(torch.from_numpy(q), torch.from_numpy(c), n_valid=0)
    rv, ri = rops.sim_top1(q, c, n_valid=0, use_pallas=False)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert np.isneginf(v.numpy()).all() and (i.numpy() == 0).all()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_capacity_boundary(n_shards):
    rng = np.random.default_rng(4)
    cap = 8
    embs = unit_rows(rng, cap + 1)

    def fill(cache):
        evicted = []
        for i in range(cap):
            evicted += cache.admit(i, embs[i])
        assert evicted == [] and len(cache) == cap
        evicted = cache.admit(cap, embs[cap])
        assert len(evicted) == 1 and len(cache) == cap
        return evicted, dict(cache.store.slot_of)

    kw = dict(capacity=cap, dim=DIM, policy="RAC")
    port = fill(SemanticCache(CacheConfig(
        backend="sharded", device="cpu",
        backend_kwargs={"n_shards": n_shards}, **kw)))
    ref = fill(RCache(RConfig(backend="sharded", use_pallas=False,
                              backend_kwargs={"n_shards": n_shards}, **kw)))
    oracle = fill(SemanticCache(CacheConfig(backend="numpy", **kw)))
    assert port == ref
    assert port[0] == oracle[0]


@pytest.mark.parametrize("backend", ["sharded", "kernel"])
def test_checkpoint_restore_round_trips(backend):
    """Every sharded field survives the facade's checkpoint/restore with no
    backend cooperation, and the restored store is scored from its own
    rows: no mirror (the kernel backend's either) may alias the rows the
    store wrote after the snapshot."""
    rng = np.random.default_rng(5)
    embs = unit_rows(rng, 30)
    extra = unit_rows(rng, 50)

    def run(cache):
        for i, e in enumerate(embs):
            cache.admit(i, e, payload=[i])
        cache.lookup(embs[3], cid=3)
        snap = cache.checkpoint()
        def state():
            st = cache.store
            shards = ((st.load.tolist(), st.local_hwm.tolist())
                      if backend == "sharded" else None)
            return sorted(st.keys()), shards, cache.metrics.hits
        before = state()
        for j, e in enumerate(extra):
            cache.admit(2000 + j, e)
        assert sorted(cache.store.keys()) != before[0]
        cache.restore(snap)
        assert state() == before
        assert cache.lookup(embs[3], cid=3).hit
        tail = [cache.lookup(e, cid=3000 + j).best_cid for j, e in
                enumerate(extra[:10])]
        return before, tail, getattr(cache.store, "_free_by_shard", None)

    bkw = {"n_shards": 4} if backend == "sharded" else {}
    kw = dict(capacity=32, dim=DIM, policy="LRU", backend=backend,
              backend_kwargs=bkw)
    port = run(SemanticCache(CacheConfig(device="cpu", **kw)))
    ref = run(RCache(RConfig(use_pallas=False, **kw)))
    assert port == ref


# ----------------------------------------------------------------- Eq. 1
def _value_args(rng, n, t=7):
    return (rng.random(n), rng.integers(0, t, n), rng.random(t),
            rng.integers(0, 50, t), 0.05, 60)


@pytest.mark.parametrize("n", [3, 4, 101])
@pytest.mark.parametrize("masked", [False, True])
def test_rac_value_chunked_and_whole(cpu_mesh, n, masked):
    """On the mesh the entry axis is cut into ceil(n/S) chunks (n >= S),
    or scored whole (n < S); off the mesh always whole.  Every way gives
    the reference's values."""
    rng = np.random.default_rng(n)
    args = _value_args(rng, n)
    valid = rng.random(n) < 0.7
    ref = RSharded(n_shards=4, use_pallas=False)
    want = (ref.rac_value_masked(*args, valid) if masked
            else ref.rac_value(*args))
    oracle = NumpyBackend()
    host = (oracle.rac_value_masked(*args, valid) if masked
            else oracle.rac_value(*args))
    be = ShardedKernelBackend(n_shards=4, device="cpu")
    assert be.mesh() is not None
    calls = []
    orig = ops.rac_value_masked if masked else ops.rac_value

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return orig(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, orig.__name__, counted)
        got = (be.rac_value_masked(*args, valid) if masked
               else be.rac_value(*args))
    assert calls == ([n] if n < 4 else
                     [min(-(-n // 4), n - lo) for lo in range(0, n,
                                                              -(-n // 4))])
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    np.testing.assert_allclose(got[fin], host[fin], rtol=1e-6)
    whole = ShardedKernelBackend(n_shards=4, device="cpu")
    whole._mesh, whole._mesh_built = None, True
    # the plain B3's exp2 is vectorised on the CPU: a chunk's tail may
    # round other than the whole table's, within the same tolerance
    np.testing.assert_allclose(
        whole.rac_value_masked(*args, valid) if masked
        else whole.rac_value(*args), got, rtol=1e-6)


# ------------------------------------------------------------- quantized
def _store_pair(n_shards, cap, n, seed, remove=()):
    rng = np.random.default_rng(seed)
    embs = unit_rows(rng, n)
    port, ref = ShardedStore(cap, DIM, n_shards), RShardedStore(cap, DIM,
                                                                n_shards)
    for s in (port, ref):
        for i, e in enumerate(embs):
            s.insert(i, e)
        for c in remove:
            s.remove(c)
    near = embs[:12] + 0.2 * unit_rows(rng, 12)
    q = np.concatenate([near / np.linalg.norm(near, axis=1, keepdims=True),
                        unit_rows(rng, 6)]).astype(np.float32)
    return port, ref, q


@pytest.mark.parametrize("n_shards,k", [(2, 8), (3, 8), (4, 40), (4, 3)])
def test_quantized_candidates_and_decisions_match_reference(n_shards, k):
    """The merged shortlist (vals, rows) before certification equals the
    reference's, where ks < R and where ks = R; the certified lookups equal
    the reference's and the exact scan's."""
    port_st, ref_st, q = _store_pair(n_shards, 60, 45, 9, remove=(4, 17))
    cfg = {"k": k, "tau_hit": 0.85}
    be = ShardedKernelBackend(n_shards=n_shards, device="cpu", quantized=cfg)
    rbe = RSharded(n_shards=n_shards, use_pallas=False, quantized=cfg)
    vals, rows, *_ = be._quantized_candidates(port_st, q)
    seen = []
    orig = r_quantized.resolve_topk

    def capture(v, r, *a, **kw):
        seen.append((np.asarray(v), np.asarray(r)))
        return orig(v, r, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_quantized, "resolve_topk", capture)
        rc, rs = rbe.top1_batch(ref_st, q)
    rv, rr = seen[0]
    assert vals.shape == rv.shape
    np.testing.assert_array_equal(np.isfinite(vals), np.isfinite(rv))
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(vals[fin], rv[fin])
    np.testing.assert_array_equal(rows[fin], rr[fin])
    pc, ps = be.top1_batch(port_st, q)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_allclose(ps, rs, atol=SIM_ATOL, rtol=0)
    ec, es = ShardedKernelBackend(n_shards=n_shards,
                                  device="cpu").top1_batch(port_st, q)
    np.testing.assert_array_equal(pc, ec)
    assert be.quant_stats == rbe.quant_stats


def _replay(cache, reqs, log):
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, k=kind: log.append((k, int(ev.cid),
                                                             int(ev.t))))
    for r in reqs:
        if not cache.lookup(r.emb, cid=r.cid, t=r.t, req=r).hit:
            cache.admit(r.cid, r.emb, t=r.t, req=r)
    return cache


@pytest.mark.parametrize("approx", ["quantized", "pruned_fused",
                                    "pruned_staged", "both"])
def test_approximate_replays_match_reference_and_oracle(traces, approx):
    ref_tr, port_tr = traces
    n = 600
    lookups = {"quantized": {"quantized_lookup": {"k": 8}},
               "pruned_fused": {"pruned_lookup": {"fused": True}},
               "pruned_staged": {"pruned_lookup": {"fused": False}},
               "both": {"quantized_lookup": True,
                        "pruned_lookup": {"fused": False}}}[approx]
    kw = dict(capacity=CAP, dim=DIM, policy="RAC", **lookups)
    logs = [[], [], [], []]
    before = fused.fused_stats["calls"]
    port = _replay(SemanticCache(CacheConfig(
        backend="sharded", device="cpu", backend_kwargs={"n_shards": 4},
        **kw)), port_tr.requests[:n], logs[0])
    fused_calls = fused.fused_stats["calls"] - before
    ref = _replay(RCache(RConfig(backend="sharded", use_pallas=False,
                                 backend_kwargs={"n_shards": 4}, **kw)),
                  ref_tr.requests[:n], logs[1])
    _replay(SemanticCache(CacheConfig(backend="numpy", **kw)),
            port_tr.requests[:n], logs[2])
    _replay(SemanticCache(CacheConfig(capacity=CAP, dim=DIM, policy="RAC",
                                      backend="numpy")),
            port_tr.requests[:n], logs[3])
    assert logs[0] == logs[1] == logs[2] == logs[3]
    assert any(e[0] == "evict" for e in logs[0])
    snap = port.metrics_snapshot()
    if approx == "quantized":
        # composed with the pruned lookup, the int8 scan books into the
        # prune ledger, as in the reference
        assert snap["quant"]["scans"] > 0
    if "pruned_lookup" in lookups:
        assert snap["prune"]["scans"] > 0
    assert (fused_calls > 0) == (approx == "pruned_fused")
    if approx == "quantized":
        assert snap["quant"] == ref.metrics_snapshot()["quant"]


# ----------------------------------------------------------------- arena
def _counts(stats):
    return [(s.policy, s.hits, s.misses, s.evictions) for s in stats]


@pytest.mark.parametrize("approx,n_shards", [
    ("exact", 1), ("exact", 2), ("exact", 3), ("quantized", 1),
    ("pruned", 1)])
def test_run_arena_matches_kernel_numpy_and_reference(traces, approx,
                                                      n_shards):
    """``backend="sharded"`` (one shard a device: one on the CPU) and
    prebuilt backends of 2 and 3 shards against the reference's, the
    kernel backend and the numpy oracle.  The quantized and pruned arena
    passes are the dense body's at every shard count, as the reference's
    are; a prebuilt backend takes no ``quantized=``/``pruned=`` flag."""
    ref_tr, port_tr = traces
    n, cap = 400, 40
    sub, rsub = port_tr.requests[:n], ref_tr.requests[:n]
    from repro.core.types import Trace as RTrace
    from repro_torch.core.types import Trace
    tr = Trace(requests=sub, n_topics=port_tr.n_topics,
               meta=dict(port_tr.meta)).with_next_use()
    rtr = RTrace(requests=rsub, n_topics=ref_tr.n_topics,
                 meta=dict(ref_tr.meta)).with_next_use()
    flag = {"exact": {}, "quantized": {"quantized": True},
            "pruned": {"pruned": True}}[approx]
    common = dict(hit_mode="semantic", chunk=64, seed=0)
    if n_shards == 1:
        got = run_arena(tr, cap, default_factories(seed=0),
                        backend="sharded", device="cpu", **common, **flag)
        want = r_run_arena(rtr, cap, r_default_factories(seed=0),
                           backend="sharded", use_pallas=False, **common,
                           **flag)
    else:
        got = run_arena(tr, cap, default_factories(seed=0),
                        backend=ShardedKernelBackend(n_shards, "cpu"),
                        **common)
        want = r_run_arena(rtr, cap, r_default_factories(seed=0),
                           backend=RSharded(n_shards=n_shards,
                                            use_pallas=False), **common)
    kern = run_arena(tr, cap, default_factories(seed=0), backend="kernel",
                     device="cpu", **common, **flag)
    host = run_arena(tr, cap, default_factories(seed=0), backend="numpy",
                     **common, **flag)
    assert _counts(got) == _counts(want) == _counts(kern) == _counts(host)
    assert sum(s.evictions for s in got) > 0


# ------------------------------------------------------- multi-card path
@pytest.mark.parametrize("n_shards", [2, 4])
def test_mesh_path_equals_the_loop(cpu_mesh, n_shards):
    """Every entry point on the multi-card code path (one mirror piece a
    shard, per-shard launches, the merge on the lead device) gives the
    one-device loop's bits."""
    port_st, _, q = _store_pair(n_shards, 70, 60, 21, remove=(0, 33, 34))
    on, off = (ShardedKernelBackend(n_shards=n_shards, device="cpu")
               for _ in range(2))
    off._mesh, off._mesh_built = None, True
    assert on.mesh() == [torch.device("cpu")] * n_shards
    for a, b in zip(on.top1_batch(port_st, q), off.top1_batch(port_st, q)):
        np.testing.assert_array_equal(a, b)
    qon, qoff = (ShardedKernelBackend(n_shards=n_shards, device="cpu",
                                      quantized={"k": 5}) for _ in range(2))
    qoff._mesh, qoff._mesh_built = None, True
    for a, b in zip(qon._quantized_candidates(port_st, q)[:2],
                    qoff._quantized_candidates(port_st, q)[:2]):
        np.testing.assert_array_equal(a, b)
    # a whole RAC replay through decide_batch: the mesh's fused per-shard
    # pass against the loop's split pass, event by event
    ref_tr = synthetic_trace(SynthConfig(trace_len=700, n_topics=8,
                                         dim=DIM, capacity_ref=48, seed=6))
    runs = []
    for mesh_on in (True, False):
        log: list = []
        made: list = []

        def make_cache(trace, capacity, factory, hit_mode, tau_hit, backend,
                       device):
            be = ShardedKernelBackend(n_shards=n_shards, device=device)
            if not mesh_on:
                be._mesh, be._mesh_built = None, True
            made.append(SemanticCache(
                CacheConfig(capacity=capacity, dim=DIM, tau_hit=tau_hit,
                            hit_mode=hit_mode, device=device),
                policy_factory=factory, backend=be))
            return made[-1]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsim, "_make_cache", make_cache)
            st = tsim.run_policy_batched(ref_tr, 48,
                                         recording(make_rac(), log),
                                         backend="sharded", chunk=32,
                                         device="cpu")
        runs.append((_stats(st), log, made[0]))
    assert runs[0][:2] == runs[1][:2]
    assert runs[0][0][2] > 0
    cache = runs[0][2]
    dec_on = cache.backend.decide_batch(cache.store, cache.policy.table, q,
                                        alpha=0.01, t_now=cache.clock)
    off_be = ShardedKernelBackend(n_shards=n_shards, device="cpu")
    off_be._mesh, off_be._mesh_built = None, True
    dec_off = off_be.decide_batch(cache.store, cache.policy.table, q,
                                  alpha=0.01, t_now=cache.clock)
    for f in dataclasses.fields(dec_on):
        a, b = getattr(dec_on, f.name), getattr(dec_off, f.name)
        if a is None:
            assert b is None
        elif f.name == "victim_value":
            # B2 over each shard's slice against B2 over the whole table
            # (the plain exp2 is vectorised on the CPU; bit-equal on the
            # card, where each entry is one exp2f)
            np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
            np.testing.assert_allclose(a[np.isfinite(b)],
                                       b[np.isfinite(b)], rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    assert cache.backend.sync_stats["incremental"] > 0


def test_mesh_arena_equals_the_loop(cpu_mesh, traces):
    _, port_tr = traces
    from repro_torch.core.types import Trace
    tr = Trace(requests=port_tr.requests[:300], n_topics=port_tr.n_topics,
               meta=dict(port_tr.meta)).with_next_use()
    off = ShardedKernelBackend(3, "cpu")
    off._mesh, off._mesh_built = None, True
    on = ShardedKernelBackend(3, "cpu")
    runs = [run_arena(tr, 30, default_factories(seed=0), backend=be,
                      hit_mode="semantic", chunk=64, seed=0)
            for be in (on, off)]
    assert on.mesh() is not None
    assert _counts(runs[0]) == _counts(runs[1])
    assert sum(s.hits for s in runs[0]) > 0
    assert on.sync_stats["full"] >= 1


# ------------------------------------------------------------------ sync
@pytest.mark.parametrize("on_mesh", [False, True])
def test_slab_syncs_once_then_by_dirty_rows(monkeypatch, on_mesh):
    if on_mesh:
        monkeypatch.setattr(mesh, "make_cache_mesh",
                            lambda n, device="cuda": [torch.device("cpu")] * n)
    rng = np.random.default_rng(8)
    embs = unit_rows(rng, 200)
    cache = SemanticCache(CacheConfig(capacity=120, dim=DIM, policy="LRU",
                                      backend="sharded", device="cpu",
                                      backend_kwargs={"n_shards": 4}))
    assert (cache.backend.mesh() is not None) == on_mesh
    for i, e in enumerate(embs):
        cache.lookup(e, cid=i)
        cache.admit(i, e)
    sync = cache.backend.sync_stats
    assert sync["full"] == 1
    assert sync["incremental"] >= len(embs) - 2
    assert sync["rows"] >= sync["incremental"]
    assert sync["bytes"] < 2 * cache.store.emb.nbytes + sync["rows"] * (
        DIM * 4 + 4)


# ------------------------------------------------------------- the wiring
def test_get_backend_and_defaults():
    be = get_backend("sharded", n_shards=2, device="cpu")
    assert isinstance(be, ShardedKernelBackend) and be.n_shards == 2
    assert be.name == "sharded" and isinstance(be, KernelBackend)
    assert ShardedKernelBackend(device="cpu").n_shards == 1
    assert ShardedKernelBackend(device="cpu").mesh() is None
    assert mesh.make_cache_mesh(4, "cpu") is None
    assert mesh.make_cache_mesh(1, "cuda") is None
    with pytest.raises(TypeError):
        get_backend("sharded", use_pallas=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedKernelBackend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SemanticCache(CacheConfig(capacity=4, dim=4, backend="sharded"))
    cache = SemanticCache(CacheConfig(capacity=4, dim=4, backend="sharded",
                                      device="cpu"))
    assert isinstance(cache.store, ShardedStore)
    assert cache.backend.device == torch.device("cpu")


@pytest.mark.parametrize("module", ["repro_torch.cache.sharded",
                                    "repro_torch.launch.mesh"])
def test_modules_stand_alone(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
