"""The port's approximate lookups against the reference's: the quantized
(int8 scan + fp32 rescore), the topic-pruned and the composed lookups,
fused and staged, through the port's ``SemanticCache`` (``"kernel"`` on
``device="cpu"``, where every kernel wrapper runs its plain version, and
the ``"numpy"`` host oracle) and the reference's (``use_pallas=False``).

Held equal: hit/miss/admit/evict event streams (similarities within 1e-5),
``decide_batch`` columns, the fused pipeline's outputs on the same inputs
(winners, certification, candidate totals, probe counts, caps and union
sizes; rescored maxima within 1e-5), the topic-bucket index and the
config plumbing.  Not demanded: fp32 bit-equality with the reference's
XLA-CPU output (its own exact-vs-approximate bit-parity tests fail on the
reference itself, ROADMAP.md § C).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CacheConfig as RConfig
from repro.cache import SemanticCache as RCache
from repro.cache import pruned as rpruned
from repro.cache import quantized as rquantized
from repro.core.policy_table import PolicyTable as RTable
from repro.core.store import ResidentStore as RStore
from repro.kernels import fused as rfused
from repro_torch.cache import (CacheConfig, KernelBackend, NumpyBackend,
                               PrunedLookupConfig, QuantizedLookupConfig,
                               SemanticCache, get_backend,
                               load_reference_state)
from repro_torch.cache import pruned, quantized
from repro_torch.core.policy_table import PolicyTable
from repro_torch.core.store import ResidentStore
from repro_torch.kernels import fused, ops
from repro_torch.kernels.quant import quantize_rows_int8

from test_torch_cache import _reference_state

SIM_ATOL = 1e-5
DIM, CAP = 32, 40


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _workload(n=240, dim=DIM, n_proto=48, jitter=0.05, seed=7):
    """Paraphrases of a few prototypes, each prototype one content id:
    hits, misses and evictions in both hit modes."""
    rng = np.random.default_rng(seed)
    protos = _unit(rng, n_proto, dim)
    reqs = []
    for i in range(n):
        j = int(rng.integers(0, n_proto))
        p = protos[j] + jitter * rng.standard_normal(dim).astype(np.float32)
        reqs.append((j, (p / np.linalg.norm(p)).astype(np.float32)))
    return reqs


def _record(cache) -> list:
    log = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, _l=log: _l.append(ev))
    return log


def _drive(cache, reqs, chunk, decisions=None):
    """Per chunk: one decision pass, one batched lookup (chunks of at most
    ``fused_max_batch`` queries take the fused path), then admit misses."""
    for lo in range(0, len(reqs), chunk):
        block = reqs[lo:lo + chunk]
        embs = np.stack([e for _, e in block])
        dec = cache.decide_batch(embs)
        if decisions is not None:
            decisions.append(dec)
        res = cache.lookup_batch(embs, cids=[c for c, _ in block])
        for (cid, emb), out in zip(block, res):
            if not out.hit:
                cache.admit(cid, emb)


def _assert_events(got, want, hit_sims_only=False):
    """Equal (kind, cid, t) streams with sims within SIM_ATOL; against the
    exact path only hit sims are held (a certified miss reports a
    best-effort sim, -inf when it scanned nothing)."""
    assert [(e.kind, e.cid, e.t) for e in got] == \
        [(e.kind, e.cid, e.t) for e in want]
    if hit_sims_only:
        got = [e for e in got if e.kind == "hit"]
        want = [e for e in want if e.kind == "hit"]
    gs = np.array([e.sim for e in got], dtype=np.float64)
    ws = np.array([e.sim for e in want], dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(gs), np.isnan(ws))
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=SIM_ATOL)


def _assert_hits(got, want, tau):
    """decide_batch hit columns: equal cids where the reference reached
    ``tau`` (a certified miss may report another best-effort cid), sims
    close."""
    hit = want.hit_sim >= tau
    np.testing.assert_array_equal(got.hit_sim >= tau, hit)
    np.testing.assert_array_equal(got.hit_cid[hit], want.hit_cid[hit])
    np.testing.assert_allclose(got.hit_sim[hit], want.hit_sim[hit],
                               atol=SIM_ATOL)
    np.testing.assert_array_equal(got.route_tid, want.route_tid)
    np.testing.assert_array_equal(np.isposinf(got.victim_value),
                                  np.isposinf(want.victim_value))


CONFIGS = {"quantized": (True, False), "pruned": (False, True),
           "composed": (True, True)}


def _spec(on, fused_on):
    return on and {"fused": fused_on}


# ------------------------------------------------------- config plumbing
def test_configs_match_the_reference():
    assert dataclasses.asdict(QuantizedLookupConfig()) == \
        dataclasses.asdict(rquantized.QuantizedLookupConfig())
    assert dataclasses.asdict(PrunedLookupConfig()) == \
        dataclasses.asdict(rpruned.PrunedLookupConfig())
    assert QuantizedLookupConfig().fused and PrunedLookupConfig().fused
    assert QuantizedLookupConfig().fused_max_batch == 16
    for norm in (quantized.as_quantized_config, pruned.as_pruned_config):
        assert norm(None) is None and norm(False) is None
        with pytest.raises(ValueError):
            norm("yes")
    qc = quantized.as_quantized_config({"k": 4, "tau_hit": 0.9})
    assert (qc.k, qc.tau_hit) == (4, 0.9)
    assert pruned.as_pruned_config(True) == PrunedLookupConfig()
    assert quantized.new_quant_stats() == rquantized.new_quant_stats()
    assert pruned.new_prune_stats() == rpruned.new_prune_stats()


def test_facade_fills_tau_in_semantic_mode_only():
    sem = SemanticCache(CacheConfig(capacity=8, dim=16, device="cpu",
                                    tau_hit=0.9, quantized_lookup=True,
                                    pruned_lookup=True))
    assert sem.backend.quantized.tau_hit == 0.9
    assert sem.backend.pruned.tau_hit == 0.9
    assert sem.backend.route_store is sem.store
    con = SemanticCache(CacheConfig(capacity=8, dim=16, device="cpu",
                                    hit_mode="content",
                                    quantized_lookup=True))
    assert con.backend.quantized.tau_hit is None


def test_prebuilt_backend_rejects_approximate_flags():
    for kw in ({"quantized_lookup": True}, {"pruned_lookup": True}):
        with pytest.raises(ValueError, match="already-built"):
            SemanticCache(CacheConfig(capacity=8, dim=16, **kw),
                          backend=NumpyBackend())


def test_arena_and_sharded_surfaces_still_raise():
    # the stacked approximate arena scans are ported, and refuse an arena
    # that keeps no row journal (their mirrors key on it), as the
    # reference's do; the sharded backend, ported now, refuses it too and
    # takes the approximate lookups' configs as the kernel backend does
    from repro_torch.core.arena import ArenaStore
    arena = ArenaStore(2, 10, 4, track_rows=False)
    arena.views[0].insert(1, np.full(4, 0.5, np.float32))
    sharded = get_backend("sharded", quantized=True, pruned=True,
                          device="cpu")
    for be in (NumpyBackend(quantized=True),
               KernelBackend("cpu", pruned=True), sharded):
        with pytest.raises(ValueError, match="track_rows"):
            be.top1_multi(arena, np.zeros((1, 4), np.float32))
    assert sharded.quantized == KernelBackend("cpu", quantized=True).quantized
    assert sharded.pruned == KernelBackend("cpu", pruned=True).pruned


# ------------------------------------------------- fused helpers (host)
def test_shape_buckets_and_tau_lo_match_the_reference():
    for n in (1, 5, 9, 64, 65, 97, 1000):
        assert fused.pad_pow2(n, 1) == rfused.pad_pow2(n, 1)
        assert fused.pad_geo(n) == rfused.pad_geo(n)
    for tau in (0.85, 0.5, 0.8, 1.0 / 3.0):
        lo = fused.tau_lo_f32(tau)
        assert lo == rfused.tau_lo_f32(tau) and float(lo) < tau
        assert np.nextafter(lo, np.float32(np.inf)) >= np.float32(tau)
    q = _unit(np.random.default_rng(2), 3, 24)
    for a, b in zip(fused.prep_queries(q, 4), rfused.prep_queries(q, 4)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------- topic-bucket index
def _clustered(rng, n, dim, n_topics, sigma=0.05, store_cls=ResidentStore,
               table_cls=PolicyTable):
    centers = _unit(rng, n_topics, dim)
    assign = rng.integers(0, n_topics, size=n)
    embs = centers[assign] + sigma * rng.standard_normal(
        (n, dim)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    store = store_cls(n + 8, dim)
    for i in range(n):
        store.insert(i, embs[i])
    table = table_cls(store.emb.shape[0], dim)
    for t in range(n_topics):
        table.set_rep(t, centers[t])
    for slot in range(n):
        table.topic_of[slot] = assign[slot]
        table.touch_slot(slot)
    return store, table


def _pair(seed, n, dim, n_topics, sigma=0.05):
    """The same clustered store + table in both packages."""
    return (_clustered(np.random.default_rng(seed), n, dim, n_topics, sigma),
            _clustered(np.random.default_rng(seed), n, dim, n_topics, sigma,
                       RStore, RTable))


def test_bucket_index_incremental_matches_rebuild_and_reference(rng):
    (store, table), (rstore, rtable) = _pair(11, 40, 24, 6)
    idx, ridx = pruned.TopicBucketIndex(), rpruned.TopicBucketIndex()
    idx.sync(store, table)
    ridx.sync(rstore, rtable)
    assert idx.stats["full"] == 1
    new = _unit(rng, 3, 24)
    for st, tb in ((store, table), (rstore, rtable)):
        st.remove(3)
        s_a = st.insert(100, new[0])
        tb.topic_of[s_a] = 2
        tb.touch_slot(s_a)
        st.insert(101, new[1])                # stays unassigned
        tb.topic_of[7] = 4
        tb.touch_slot(7)
        tb.set_rep(1, new[2])
    idx.sync(store, table)
    ridx.sync(rstore, rtable)
    assert idx.stats["incremental"] >= 1 and idx.stats["full"] == 1
    fresh = pruned.TopicBucketIndex()
    fresh.sync(store, table)
    for a in (fresh, ridx):
        for x, y in zip(idx.csr(), a.csr()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(idx.aug, a.aug)
    rows = idx.candidate_rows(idx.group_key(np.array([2])))
    assert store.slot_of[101] in rows.tolist()


def test_bucket_index_spread_bounds_members(rng):
    store, table = _clustered(rng, 60, 32, 5, sigma=0.2)
    idx = pruned.TopicBucketIndex()
    idx.sync(store, table)
    indptr, slot_ids, _ = idx.csr()
    q = _unit(rng, 50, 32)
    for t in range(5):
        rows = slot_ids[indptr[t]:indptr[t + 1]]
        if rows.size:
            best = (q @ store.emb[rows].T).max(axis=1)
            assert (best <= q @ idx.aug[t, :-1] + idx.aug[t, -1] + 1e-6).all()


# ------------------------------------------------- fused bodies vs reference
def _fused_inputs(store, table, idx, queries, probes, budget):
    indptr, slot_ids, una = idx.csr()
    t_rows = idx.aug.shape[0]
    ip, slots = fused.csr_device_arrays(indptr, slot_ids, una, t_rows)
    q8s, csc, cl1 = quantize_rows_int8(store.emb)
    prep = fused.prep_queries(queries, fused.pad_pow2(queries.shape[0], 1))
    cap_c = fused.candidate_cap(np.diff(indptr), una.size, probes, budget)
    return (*prep, store.emb, q8s, csc, cl1.astype(np.float32), idx.aug,
            ip, slots), cap_c


def _assert_fused(got, want, names):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    for name, g, w in zip(names, got, want):
        if name in ("rmax", "ub"):
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], atol=SIM_ATOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64).ravel(),
                                          w.astype(np.int64).ravel(), name)


@pytest.mark.parametrize("probes,tau,budget", [
    (1, None, 1 << 30), (2, 0.8, 1 << 30), (4, 0.8, 1 << 30),
    (2, None, 40), (3, 0.9, 25)])
def test_fused_pruned_lookup_matches_reference(probes, tau, budget):
    (store, table), (rstore, rtable) = _pair(3, 180, 48, 12, sigma=0.15)
    idx, ridx = pruned.TopicBucketIndex(), rpruned.TopicBucketIndex()
    idx.sync(store, table)
    ridx.sync(rstore, rtable)
    rng = np.random.default_rng(probes)
    queries = np.concatenate([store.emb[rng.integers(0, 180, 3)],
                              _unit(rng, 2, 48)])
    args, cap_c = _fused_inputs(store, table, idx, queries, probes, budget)
    tail = (int(table.topic_hwm), budget, queries.shape[0], tau)
    got = fused.fused_pruned_lookup(*(torch.from_numpy(a) for a in args),
                                    *tail, probes=probes, cap_c=cap_c, k=8)
    want = rfused.fused_pruned_lookup(*(jnp.asarray(a) for a in args), *tail,
                                      probes=probes, cap_c=cap_c, k=8,
                                      use_pallas=False)
    _assert_fused(got, want, ("win", "rmax", "ub", "cert", "total", "probed",
                              "capped", "n_u"))


@pytest.mark.parametrize("k,tau,n_valid", [(1, None, 150), (8, 0.8, 150),
                                           (8, None, 5), (4, 0.9, 188)])
def test_fused_quant_lookup_matches_reference(k, tau, n_valid):
    (store, table), _ = _pair(5, 180, 48, 12, sigma=0.15)
    idx = pruned.TopicBucketIndex()
    idx.sync(store, table)
    rng = np.random.default_rng(k)
    queries = np.concatenate([store.emb[rng.integers(0, 150, 2)],
                              _unit(rng, 3, 48)])
    args, _ = _fused_inputs(store, table, idx, queries, 1, 1 << 30)
    args = args[:8]
    tail = (n_valid, queries.shape[0], tau)
    got = fused.fused_quant_lookup(*(torch.from_numpy(a) for a in args),
                                   *tail, k=k)
    want = rfused.fused_quant_lookup(*(jnp.asarray(a) for a in args), *tail,
                                     k=k, use_pallas=False)
    _assert_fused(got, want, ("win", "rmax", "cert", "n_u"))


# ------------------------------------------------ facade event streams
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("hit_mode", ["semantic", "content"])
@pytest.mark.parametrize("fused_on", [True, False])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_event_streams_match_reference(config, fused_on, hit_mode, backend):
    quant, prune = (_spec(on, fused_on) for on in CONFIGS[config])
    reqs = _workload()
    kw = dict(capacity=CAP, dim=DIM, tau_hit=0.8, hit_mode=hit_mode,
              backend=backend, quantized_lookup=quant, pruned_lookup=prune)
    ref = RCache(RConfig(use_pallas=False, **kw))
    port = SemanticCache(CacheConfig(device="cpu", **kw))
    exact = SemanticCache(CacheConfig(capacity=CAP, dim=DIM, tau_hit=0.8,
                                      hit_mode=hit_mode, backend=backend,
                                      device="cpu"))
    logs = [_record(c) for c in (ref, port, exact)]
    decs = [[], [], []]
    for c, d in zip((ref, port, exact), decs):
        _drive(c, reqs, 8, d)
    _assert_events(logs[1], logs[0])
    _assert_events(logs[1], logs[2], hit_sims_only=True)
    assert ref.metrics.evictions > 0 and ref.metrics.hits > 0
    for g, w in zip(decs[1], decs[0]):
        _assert_hits(g, w, 0.8)
    snap, rsnap = port.metrics_snapshot(), ref.metrics_snapshot()
    ledger = "prune" if prune else "quant"
    assert snap[ledger]["scans"] > 0
    for key in ("scans", "queries"):
        assert snap[ledger][key] == rsnap[ledger][key]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_wide_batches_take_the_staged_path(config):
    quant, prune = CONFIGS[config]
    reqs = _workload(n=200, seed=9)
    kw = dict(capacity=CAP, dim=DIM, tau_hit=0.8, backend="kernel",
              quantized_lookup=quant, pruned_lookup=prune)
    ref = RCache(RConfig(use_pallas=False, **kw))
    port = SemanticCache(CacheConfig(device="cpu", **kw))
    logs = [_record(c) for c in (ref, port)]
    calls = fused.fused_stats["calls"]
    for c in (ref, port):
        _drive(c, reqs, 50)
    assert fused.fused_stats["calls"] == calls      # 50 > fused_max_batch
    _assert_events(logs[1], logs[0])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_matches_staged_in_the_port(config):
    """Same backend, fused vs staged: identical decisions and cids; the
    sims of certified winners come from the same rescore arithmetic."""
    reqs = _workload(n=200, seed=3)
    runs = []
    for fused_on in (True, False):
        quant, prune = (_spec(on, fused_on) for on in CONFIGS[config])
        cache = SemanticCache(CacheConfig(
            capacity=CAP, dim=DIM, tau_hit=0.8, device="cpu",
            quantized_lookup=quant, pruned_lookup=prune))
        log = _record(cache)
        for cid, emb in reqs:
            if not cache.lookup(emb, cid=cid).hit:
                cache.admit(cid, emb)
        runs.append(log)
    _assert_events(runs[0], runs[1])


def test_fused_lookup_is_one_dispatch_and_one_sync():
    reqs = _workload(n=120, seed=4)
    cache = SemanticCache(CacheConfig(capacity=CAP, dim=DIM, tau_hit=0.8,
                                      device="cpu", quantized_lookup=True,
                                      pruned_lookup=True))
    for cid, emb in reqs:
        if not cache.lookup(emb, cid=cid).hit:
            cache.admit(cid, emb)
    stats = cache.backend.prune_stats
    q = reqs[0][1][None, :]
    d0, f0 = dict(ops.dispatch_stats), stats["fallbacks"]
    cache.peek_batch(q)
    fb = stats["fallbacks"] - f0              # an exact rescan adds one each
    assert ops.dispatch_stats["launches"] - d0["launches"] == 1 + fb
    assert ops.dispatch_stats["host_syncs"] - d0["host_syncs"] == 1 + fb
    # a steady loop serves few shape buckets
    counts = fused.compile_counts()
    assert 1 <= counts["pruned"] <= 12 and set(counts) == {"pruned", "quant"}


# ------------------------------------------- telemetry, checkpoint, state
def test_metrics_snapshot_ledgers_always_present():
    cache = SemanticCache(CacheConfig(capacity=10, dim=DIM, device="cpu"))
    for cid, emb in _workload(n=30):
        if not cache.lookup(emb, cid=cid).hit:
            cache.admit(cid, emb)
    snap = cache.metrics_snapshot()
    assert snap["prune"] == pruned.new_prune_stats()
    assert snap["quant"] == quantized.new_quant_stats()


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_quantized_fallbacks_reach_the_tracker(rng, backend):
    embs = _unit(rng, 10, 48)
    cache = SemanticCache(CacheConfig(
        capacity=16, dim=48, backend=backend, device="cpu",
        tracker="memory", quantized_lookup={"k": 1}))
    for i, v in enumerate(embs):
        cache.admit(i, v)
    for v in embs:                     # exact duplicates: guaranteed hits
        assert cache.lookup(v).hit
    fb = cache.backend.quant_stats["fallbacks"]
    assert fb > 0
    assert cache.tracker.snapshot()["counters"].get(
        "cache.rescore_fallbacks") == fb
    assert cache.metrics_snapshot()["quant"]["fallbacks"] == fb


@pytest.mark.parametrize("fused_on", [True, False])
def test_pruned_fallbacks_reach_the_tracker(rng, fused_on):
    """A twin moved into a foreign topic blows up that topic's spread, so
    its bound beats every candidate: counted exact fallbacks."""
    cache = SemanticCache(CacheConfig(
        capacity=40, dim=48, tau_hit=0.5, device="cpu", tracker="memory",
        pruned_lookup={"probes": 1, "fused": fused_on}))
    center = _unit(rng, 1, 48)[0]
    tight = center + 0.01 * rng.standard_normal((10, 48)).astype(np.float32)
    tight /= np.linalg.norm(tight, axis=1, keepdims=True)
    for i, v in enumerate(np.concatenate([tight, _unit(rng, 20, 48)])):
        cache.admit(i, v)
    tbl = cache.policy.table
    slot = cache.store.slot_of[1]
    tbl.topic_of[slot] = int(tbl.topic_of[cache.store.slot_of[10]])
    tbl.touch_slot(slot)
    for a, b in zip(tight[:-1], tight[1:]):
        q = (a + b) / 2.0
        cache.lookup(q / np.linalg.norm(q), cid=-1)
    fb = cache.backend.prune_stats["fallbacks"]
    assert fb > 0
    assert cache.tracker.snapshot()["counters"].get(
        "cache.prune_fallbacks") == fb
    snap = cache.metrics_snapshot()
    assert snap["prune"]["fallbacks"] == fb and snap["sync"]["bytes"] > 0


def test_checkpoint_restore_rewires_route_store():
    reqs = _workload(n=80, seed=2)
    cache = SemanticCache(CacheConfig(capacity=12, dim=DIM, tau_hit=0.8,
                                      device="cpu", pruned_lookup=True))
    snap = cache.checkpoint()
    cache.restore(snap)
    assert cache.backend.route_store is cache.store
    log = _record(cache)
    exact = SemanticCache(CacheConfig(capacity=12, dim=DIM, tau_hit=0.8,
                                      device="cpu"))
    elog = _record(exact)
    for c in (cache, exact):
        for cid, emb in reqs:
            if not c.lookup(emb, cid=cid).hit:
                c.admit(cid, emb)
    _assert_events(log, elog, hit_sims_only=True)
    assert cache.backend.prune_stats["scans"] > 0


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
def test_load_reference_state_continues_a_warmed_approximate_cache(backend):
    from repro.core import OASSTConfig, oasst_style_trace
    tr = oasst_style_trace(OASSTConfig(trace_len=1_500, dim=64, seed=5))
    reqs = [(r.cid, r.emb) for r in tr.requests]
    kw = dict(capacity=96, dim=64, backend=backend, quantized_lookup=True,
              pruned_lookup=True)
    ref = RCache(RConfig(use_pallas=False, **kw))
    _drive(ref, reqs[:900], 64)
    assert ref.metrics.evictions > 0
    port = SemanticCache(CacheConfig(device="cpu", **kw))
    load_reference_state(port, _reference_state(ref))
    logs = [_record(c) for c in (ref, port)]
    for c in (ref, port):
        _drive(c, reqs[900:], 8)
    _assert_events(logs[1], logs[0])
    assert port.metrics.snapshot()["evictions"] == ref.metrics.evictions
    # the index and the int8 mirror were rebuilt from the journals
    assert port.backend._pidx.stats["full"] >= 1
    assert port.metrics_snapshot()["prune"]["scans"] > 0
