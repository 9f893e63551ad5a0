"""The port's ``SemanticCache`` against the reference's, driven with the
same requests: RAC on the ``"kernel"`` backend (the port on the CPU, where
every kernel wrapper runs its plain version; the reference with
``use_pallas=False``) and on the ``"numpy"`` host oracle, in content and
semantic mode.  Hit/miss/admit/evict event streams must be identical,
``decide_batch`` columns must agree (similarities within 1e-5, Eq. 1
values within 1e-6 relative), ``checkpoint``/``restore`` must round-trip,
and ``load_reference_state`` must continue a warmed reference cache with
identical decisions.  The ``"sharded"`` backend (one shard a device: one
on the CPU) takes the same event, peek and checkpoint checks.  Also:
torch ``pagerank_power`` against ``pagerank_power_jax``, and the features
that used to raise (asynchronous admission, tiers, ``"RadixRAC"``, the
sharded backend) serving like the reference's (the approximate lookups
are held against the reference in ``tests/test_torch_approx.py``, the
sharded backend at several shard counts in
``tests/test_torch_sharded.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CacheConfig as RConfig
from repro.cache import SemanticCache as RCache
from repro.core import OASSTConfig, SynthConfig, oasst_style_trace
from repro.core import synthetic_trace
from repro.core.structural import pagerank_power_jax
from repro.core.structural import pagerank_scores as r_pagerank_scores
from repro_torch.cache import (CacheConfig, KernelBackend, NumpyBackend,
                               SemanticCache, TierConfig, get_backend,
                               load_reference_state)
from repro_torch.core.structural import (pagerank_power, pagerank_reversed,
                                         pagerank_scores)

DIM, CAP, CHUNK = 64, 96, 64
SIM_ATOL, VALUE_RTOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def requests():
    # a session-structured synthetic trace (paraphrase hits, dependency
    # parents, topic reuse) short enough to replay many times
    tr = synthetic_trace(SynthConfig(trace_len=1_200, n_topics=12, dim=DIM,
                                     capacity_ref=CAP, seed=3))
    return tr.requests


def _ref(hit_mode, backend, **kw):
    return RCache(RConfig(capacity=CAP, dim=DIM, hit_mode=hit_mode,
                          backend=backend, use_pallas=False, **kw))


def _port(hit_mode, backend, **kw):
    return SemanticCache(CacheConfig(capacity=CAP, dim=DIM, hit_mode=hit_mode,
                                     backend=backend, device="cpu", **kw))


def _record(cache) -> list:
    log = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, _l=log: _l.append(ev))
    return log


def _drive(cache, reqs, decisions=None):
    """The serving loop: per chunk one fused decision pass (snapshot
    columns), one batched lookup, then admission of every miss."""
    for lo in range(0, len(reqs), CHUNK):
        block = reqs[lo:lo + CHUNK]
        embs = np.stack([r.emb for r in block]).astype(np.float32)
        if decisions is not None:
            decisions.append(cache.decide_batch(embs))
        res = cache.lookup_batch(embs, cids=[r.cid for r in block],
                                 ts=[r.t for r in block])
        for r, out in zip(block, res):
            if not out.hit:
                cache.admit(r.cid, r.emb, t=r.t)


def _assert_events(got, want):
    assert len(got) == len(want)
    assert [(e.kind, e.cid, e.t, e.tier) for e in got] == \
        [(e.kind, e.cid, e.t, e.tier) for e in want]
    gs = np.array([e.sim for e in got], dtype=np.float64)
    ws = np.array([e.sim for e in want], dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(gs), np.isnan(ws))
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=SIM_ATOL)


def _assert_decisions(got, want):
    np.testing.assert_array_equal(got.hit_cid, want.hit_cid)
    fin = np.isfinite(want.hit_sim)
    np.testing.assert_array_equal(np.isfinite(got.hit_sim), fin)
    np.testing.assert_allclose(got.hit_sim[fin], want.hit_sim[fin],
                               atol=SIM_ATOL)
    np.testing.assert_array_equal(got.route_tid, want.route_tid)
    fin = np.isfinite(want.route_sim)
    np.testing.assert_allclose(got.route_sim[fin], want.route_sim[fin],
                               atol=SIM_ATOL)
    gv, wv = got.victim_value, want.victim_value
    np.testing.assert_array_equal(np.isposinf(gv), np.isposinf(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=VALUE_RTOL)


@pytest.mark.parametrize("hit_mode", ["semantic", "content"])
@pytest.mark.parametrize("backend", ["kernel", "numpy", "sharded"])
def test_event_streams_and_decisions_match_reference(requests, backend,
                                                     hit_mode):
    ref, port = _ref(hit_mode, backend), _port(hit_mode, backend)
    ref_log, port_log = _record(ref), _record(port)
    ref_dec, port_dec = [], []
    _drive(ref, requests, ref_dec)
    _drive(port, requests, port_dec)
    _assert_events(port_log, ref_log)
    assert ref.metrics.evictions > 0 and ref.metrics.hits > 0
    for g, w in zip(port_dec, ref_dec):
        _assert_decisions(g, w)
    assert port.metrics.snapshot()["evictions"] == ref.metrics.evictions


def test_kernel_backend_reads_the_slab_through_its_mirror(requests):
    """Lookups go through the mirrored slab: after the first full upload
    only dirty rows move, so the bytes moved stay far below one slab per
    lookup."""
    port = _port("semantic", "kernel")
    _drive(port, requests[:600])
    sync = port.metrics_snapshot()["sync"]
    slab_bytes = port.store.emb.nbytes
    assert sync["incremental"] > 0
    assert sync["bytes"] < 4 * slab_bytes
    snap = port.metrics_snapshot()
    assert set(snap["dispatch"]) == {"launches", "host_syncs", "kernel_s"}


@pytest.mark.parametrize("backend", ["kernel", "numpy", "sharded"])
def test_peek_rows_matches_reference(requests, backend):
    ref, port = _ref("semantic", backend), _port("semantic", backend)
    for c in (ref, port):
        _drive(c, requests[:400])
    embs = np.stack([r.emb for r in requests[400:440]]).astype(np.float32)
    cids = [r.cid for r in requests[300:400]]
    rc, rs = ref.peek_rows(embs, cids)
    pc, ps = port.peek_rows(embs, cids)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_allclose(ps, rs, atol=SIM_ATOL)


@pytest.mark.parametrize("backend", ["kernel", "numpy", "sharded"])
def test_checkpoint_restore_round_trips(requests, backend):
    port, ref = _port("semantic", backend), _ref("semantic", backend)
    for c in (port, ref):
        _drive(c, requests[:500])
    snap = port.checkpoint()
    ref_snap = ref.checkpoint()
    logs = []
    for _ in range(2):                      # one snapshot restores twice
        port.restore(snap)
        log = _record(port)
        _drive(port, requests[500:900])
        port._hooks.clear()
        logs.append(log)
    _assert_events(logs[1], logs[0])
    ref.restore(ref_snap)
    ref_log = _record(ref)
    _drive(ref, requests[500:900])
    _assert_events(logs[0], ref_log)


def _reference_state(cache) -> dict:
    """The plain-data state of a warmed reference cache, read attribute by
    attribute (numpy arrays and Python containers only)."""
    st, pol = cache.store, cache.policy
    table = pol.table
    return {
        "store": {k: getattr(st, k) for k in ("emb", "occ", "cid", "slot_of",
                                              "_free", "hwm")},
        "table": {k: getattr(table, k) for k in (
            "freq", "dep", "tsi", "topic_of", "last_t", "arrive_t",
            "tp_last", "t_last", "rep", "rep_valid", "topic_hwm")},
        "rac": {
            "topics": {tid: {"members": set(ts.members), "src": ts.src,
                             "dirty": ts.dirty}
                       for tid, ts in pol.topics.items()},
            "par": dict(pol.par),
            "children": {c: set(ch) for c, ch in pol.children.items()},
            "ghosts": dict(pol.ghosts.items()),
            "ghost_topics": dict(pol.ghost_topics.items()),
            "_next_tid": pol._next_tid, "_evictions": pol._evictions},
        "clock": cache.clock,
        "metrics": dataclasses.asdict(cache.metrics),
    }


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
def test_load_reference_state_continues_a_warmed_cache(backend):
    tr = oasst_style_trace(OASSTConfig(trace_len=2_000, dim=DIM, seed=5))
    reqs = tr.requests
    ref = _ref("semantic", backend)
    _drive(ref, reqs[:1_200])
    assert ref.metrics.evictions > 0 and ref.policy.ghost_topics
    port = _port("semantic", backend)
    load_reference_state(port, _reference_state(ref))
    assert port.metrics.snapshot() == ref.metrics.snapshot()
    ref_log, port_log = _record(ref), _record(port)
    ref_dec, port_dec = [], []
    _drive(ref, reqs[1_200:], ref_dec)
    _drive(port, reqs[1_200:], port_dec)
    _assert_events(port_log, ref_log)
    assert any(e.kind == "evict" for e in ref_log)
    for g, w in zip(port_dec, ref_dec):
        _assert_decisions(g, w)
    assert port.clock == ref.clock
    np.testing.assert_array_equal(port.store.cid, ref.store.cid)


def test_load_reference_state_rejects_a_foreign_geometry():
    port = _port("semantic", "numpy")
    bad = {"store": {"emb": np.zeros((CAP + 2, DIM), np.float32)}}
    with pytest.raises(ValueError):
        load_reference_state(port, bad)


# ------------------------------------------------------------- pagerank
def _random_dag(rng, n):
    edges = []
    for v in range(1, n):
        if rng.random() < 0.8:               # one parent each (DetectParent)
            edges.append((int(rng.integers(0, v)), v))
    adj = np.zeros((n, n), np.float32)
    for u, v in edges:
        adj[u, v] = 1.0
    return edges, adj


@pytest.mark.parametrize("n", [2, 7, 40])
def test_pagerank_power_matches_jax(rng, n):
    edges, adj = _random_dag(rng, n)
    got = pagerank_power(torch.from_numpy(adj), beta=0.85, iters=128)
    want = pagerank_power_jax(jnp.asarray(adj), beta=0.85, iters=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        pagerank_scores(edges, n, device="cpu"),
        r_pagerank_scores(edges, n, device=True), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pagerank_scores(edges, n, device="cpu"),
                               pagerank_reversed(edges, n), atol=1e-6)


# ------------------------------------- formerly unported, now built
@pytest.mark.parametrize("field,value", [
    ("async_admit", True), ("async_admit", "sync"),
    ("tiers", TierConfig(host_capacity=8)),
    ("policy", "RadixRAC"), ("backend", "sharded")])
def test_unported_features_raise_and_point_at_the_roadmap(field, value):
    """Nothing raises any more.  Asynchronous admission, the tiers,
    RadixRAC and the sharded backend, which raised before, build and serve
    one admit and one lookup as the reference does."""
    kw = {"hit_mode": "semantic", "backend": "numpy", field: value}
    if value == "RadixRAC":
        kw["hit_mode"] = "content"
    port = SemanticCache(CacheConfig(capacity=CAP, dim=DIM, device="cpu",
                                     **kw))
    if field == "tiers":
        from repro.cache import TierConfig as RTierConfig
        kw["tiers"] = RTierConfig(**dataclasses.asdict(value))
    ref = _ref(**kw)
    emb = np.eye(DIM, dtype=np.float32)[3]
    logs = [_record(c) for c in (port, ref)]
    for cache in (port, ref):
        if value == "RadixRAC":
            pol = cache.policy
            pol.stage(topic=pol.touch_topic(None, 1), parent=-1)
        cache.admit(7, emb, payload="p", t=1)
        cache.flush()
        res = cache.lookup(emb, cid=7, t=2)
        assert res.hit and res.cid == 7 and res.payload == "p"
        cache.close()
    _assert_events(*logs)
    assert type(port.policy).__name__ == type(ref.policy).__name__


def test_unported_backend_options_raise():
    # the quantized and pruned lookups, their policy-stacked arena surface
    # and the sharded backend are all ported: the sharded backend builds
    # (on the card by default, so a machine without one must ask for the
    # CPU) and serves the facade and the arena as the others do
    from repro_torch.cache import ShardedKernelBackend
    from repro_torch.core import OASSTConfig, oasst_style_trace, run_arena
    from repro_torch.core.policies import BASELINES
    assert isinstance(get_backend("sharded", device="cpu"),
                      ShardedKernelBackend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend("sharded")
    tr = oasst_style_trace(OASSTConfig(trace_len=300, dim=DIM, seed=0))
    facs = {"LRU": BASELINES["LRU"]}
    got, want = (run_arena(tr, 4, facs, hit_mode="semantic", **kw)
                 for kw in ({"backend": "sharded", "device": "cpu"},
                            {"backend": "numpy"}))
    assert [(s.hits, s.misses, s.evictions) for s in got] == \
        [(s.hits, s.misses, s.evictions) for s in want]
    assert got[0].evictions > 0


def test_disabled_tier_config_is_single_tier(requests):
    """A TierConfig with both capacities 0 builds no tiers, as in the
    reference: decisions equal the plain single-tier cache."""
    a = _port("semantic", "numpy", tiers=TierConfig())
    b = _port("semantic", "numpy")
    la, lb = _record(a), _record(b)
    for c in (a, b):
        _drive(c, requests[:300])
    _assert_events(la, lb)


def test_tracker_is_observation_only(requests):
    a = _port("semantic", "kernel", tracker="memory")
    b = _port("semantic", "kernel")
    la, lb = _record(a), _record(b)
    for c in (a, b):
        _drive(c, requests[:500], [])
    _assert_events(la, lb)
    assert a.tracker.snapshot()["counters"]
