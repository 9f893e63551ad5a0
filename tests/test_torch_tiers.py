"""The port's asynchronous admission, host/ghost tiers and telemetry report
against the reference's, on the CPU.

Every facade flow of ``tests/test_tiers.py``, ``tests/test_async_cache.py``
(but for its sharded subprocess test) and the tier cases of
``tests/test_events.py`` runs on the port's ``SemanticCache`` and on the
reference's with the same inputs: the same events (kind, cid, t, tier),
tier counters and residency, besides the reference's own assertions.
Event streams are held to the reference's synchronous host oracle across
content/semantic mode x ``async_admit`` in {False, True, "sync"} x the
port's numpy and kernel (plain versions, ``device="cpu"``) backends, with
a checkpoint/restore in the middle (the tier flows also on the sharded
backend, two shards); ``render_text`` renders equal tracker
content identically; and the serving engine with ``async_admit=True`` and
tiers makes the reference engine's outputs on carried-over weights.
"""
import copy
import json
import math

import jax
import numpy as np
import pytest

from repro.cache import CacheConfig as RConfig
from repro.cache import SemanticCache as RCache
from repro.cache import TierConfig as RTierConfig
from repro.core import EmbeddingSpace, SynthConfig, synthetic_trace
from repro.telemetry import InMemoryTracker as RInMemoryTracker
from repro.telemetry import render_text as r_render_text
from repro.telemetry import summarize as r_summarize
from repro_torch.cache import (AsyncAdmitter, CacheConfig, GhostTier,
                               HostTier, SemanticCache, TierConfig,
                               TierManager, TierStats)
from repro_torch.core.store import ResidentStore
from repro_torch.telemetry import (InMemoryTracker, render_text, summarize,
                                   write_report)

SIM_ATOL = 1e-5


def _bkw(backend) -> dict:
    """The sharded backend runs two shards, as the reference's tier tests
    run it."""
    return {"n_shards": 2} if backend == "sharded" else {}


def _caches(capacity, dim, *, backend="numpy", tiers=None, **kw):
    """The port's cache and the reference's (numpy backend, inline
    admission unless asked) over the same configuration."""
    port = SemanticCache(CacheConfig(
        capacity=capacity, dim=dim, backend=backend, device="cpu",
        backend_kwargs=_bkw(backend),
        tiers=None if tiers is None else TierConfig(**tiers), **kw))
    ref = RCache(RConfig(
        capacity=capacity, dim=dim, backend="numpy", use_pallas=False,
        tiers=None if tiers is None else RTierConfig(**tiers), **kw))
    return port, ref


def _recorder(cache) -> list:
    log = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, _l=log: _l.append(ev))
    return log


def _key(events) -> list:
    return [(e.kind, int(e.cid), int(e.t), e.tier) for e in events]


def _assert_same_events(got, want):
    assert _key(got) == _key(want)
    gs = np.array([e.sim for e in got], dtype=np.float64)
    ws = np.array([e.sim for e in want], dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(gs), np.isnan(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], atol=SIM_ATOL)
    assert [e.payload for e in got] == [e.payload for e in want]


def _counters(cache) -> dict:
    return {k: v for k, v in cache.metrics.snapshot().items()
            if not k.endswith("_s")}


def _assert_same_state(port, ref):
    assert sorted(port.store.keys()) == sorted(ref.store.keys())
    assert port.payloads == ref.payloads
    assert port.tier_stats == ref.tier_stats
    assert _counters(port) == _counters(ref)
    assert port.clock == ref.clock
    if ref.tiers is not None and ref.tiers.host is not None:
        assert sorted(port.tiers.host.store.keys()) == \
            sorted(ref.tiers.host.store.keys())


def _space_embs(dim=32, n=24, seed=7):
    space = EmbeddingSpace(dim=dim, seed=seed)
    return space, [space.content_embedding(i % 6, i).astype(np.float32)
                   for i in range(n)]


def _tiered(capacity=4, host=16, ghost=64, **kw):
    return _caches(capacity, 32, tau_hit=0.85, policy="RAC",
                   tiers=dict(host_capacity=host, ghost_capacity=ghost), **kw)


# --------------------------------------------------------- GhostTier unit
def test_ghost_tier_fifo_bound_and_drop_report():
    g = GhostTier(3)
    assert g.put("a", 1) == [] and g.put("b", 2) == [] and g.put("c", 3) == []
    assert g.put("d", 4) == ["a"]            # oldest out, reported
    assert len(g) == 3 and "a" not in g and g["d"] == 4
    assert list(g.keys()) == ["b", "c", "d"]


def test_ghost_tier_update_keeps_insertion_position():
    g = GhostTier(2)
    g.put("a", 1)
    g.put("b", 2)
    assert g.put("a", 9) == []               # update in place, no drop
    assert g["a"] == 9
    assert g.put("c", 3) == ["a"]            # "a" kept its (oldest) slot


def test_ghost_tier_batched_drop_amortizes():
    g = GhostTier(16, batch_div=4)
    dropped = []
    for i in range(17):
        dropped += g.put(i, i)
    assert dropped == [0, 1, 2, 3]           # one batch of capacity//4
    assert len(g) == 13 and min(g.keys()) == 4


def test_ghost_tier_tiny_capacities_stay_bounded():
    for cap in (0, 1, 2):
        g = GhostTier(cap, batch_div=16)     # batch = 0 -> still drops >= 1
        for i in range(10):
            g.put(i, i)
            assert len(g) <= cap


# ---------------------------------------------------------- HostTier unit
def test_host_tier_put_take_roundtrip_is_journaled():
    ht = HostTier(capacity=4, dim=8)
    v0 = ht.store.version
    e = np.arange(8, dtype=np.float32)
    assert ht.put(3, e, ["payload"], t=1, meta={"freq": 2.0}) == []
    assert ht.store.version > v0             # demote = journal entry
    assert 3 in ht and len(ht) == 1
    v1 = ht.store.version
    emb, payload, meta = ht.take(3, t=2)
    assert ht.store.version > v1             # promote = journal entry
    np.testing.assert_array_equal(emb, e)
    assert payload == ["payload"] and meta == {"freq": 2.0}
    assert 3 not in ht and len(ht) == 0      # remove-at-serve


def test_host_tier_lru_eviction_by_demote_time():
    ht = HostTier(capacity=2, dim=4)
    e = np.ones(4, np.float32)
    ht.put(10, e, "a", t=5, meta={"tid": 1})
    ht.put(11, e, "b", t=9, meta=None)
    dropped = ht.put(12, e, "c", t=7, meta=None)
    assert dropped == [(10, {"tid": 1})]     # smallest last_t out first
    assert 10 not in ht and 11 in ht and 12 in ht
    assert [c for c, _ in ht.put(10, e, "a", t=20, meta=None)] == [12]
    assert [c for c, _ in ht.put(13, e, "d", t=21, meta=None)] == [11]
    assert 10 in ht and 13 in ht


def test_host_tier_topk_and_top1_score_occupied_rows_only():
    from repro.cache import HostTier as RHostTier
    rng = np.random.default_rng(0)
    ht, rt = HostTier(capacity=8, dim=16), RHostTier(capacity=8, dim=16)
    embs = rng.standard_normal((5, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    for i in range(5):
        ht.put(i, embs[i], None, t=i, meta=None)
        rt.put(i, embs[i], None, t=i, meta=None)
    cids, sims = ht.topk(embs[2], k=3)
    assert cids[0, 0] == 2 and sims[0, 0] == pytest.approx(1.0, abs=1e-5)
    rc, rs = rt.topk(embs[2], k=3)
    np.testing.assert_array_equal(cids, rc)
    np.testing.assert_allclose(sims, rs, atol=SIM_ATOL)
    c1, s1 = ht.top1_batch(embs[:3])
    r1, q1 = rt.top1_batch(embs[:3])
    np.testing.assert_array_equal(c1, r1)
    np.testing.assert_allclose(s1, q1, atol=SIM_ATOL)


def test_tier_stats_and_manager_surface():
    mgr = TierManager(TierConfig(host_capacity=2, ghost_capacity=4), dim=4)
    assert mgr.stats == TierStats()
    e = np.ones(4, np.float32)
    for c in range(3):
        assert mgr.demote(c, e, [c], t=c, meta={"freq": 1.0})
    assert mgr.stats.demotions == 3 and mgr.stats.host_evictions == 1
    assert mgr.ghost_get(0) == {"freq": 1.0}
    assert mgr.stats.snapshot()["ghost_inserts"] == 1


# ------------------------------------------------- facade flow: demote/promote
def test_demotion_preserves_payload_and_host_hit_promotes():
    out = []
    for cache in _tiered():
        events = _recorder(cache)
        _, embs = _space_embs()
        for i in range(12):
            assert not cache.lookup(embs[i], cid=i).hit
            cache.admit(i, embs[i], payload=[f"p{i}"])
        demoted = [c for c in range(12) if cache.in_host(c)]
        assert len(demoted) == 8             # 12 admitted - 4 on the device
        target = demoted[0]
        r = cache.lookup(embs[target], cid=target)
        assert r.hit and r.cid == target and r.payload == [f"p{target}"]
        assert (events[-1].kind, events[-1].cid, events[-1].tier) == \
            ("hit", target, "host")
        assert target in cache and not cache.in_host(target)
        st = cache.tier_stats
        assert st["host_hits"] == 1 and st["promotions"] == 1
        assert cache.metrics.hits == 1       # host hits are hits
        out.append((cache, events))
    (port, pe), (ref, re_) = out
    _assert_same_events(pe, re_)
    _assert_same_state(port, ref)


def test_content_mode_host_hit_serves_exact_cid():
    caches = _tiered(hit_mode="content")
    logs = [_recorder(c) for c in caches]
    _, embs = _space_embs()
    for cache in caches:
        for i in range(12):
            cache.admit(i, embs[i], payload=[i])
        target = next(c for c in range(12) if cache.in_host(c))
        r = cache.lookup(embs[target], cid=target)
        assert r.hit and r.cid == target and r.payload == [target]
        assert target in cache and not cache.in_host(target)
    _assert_same_events(*logs)
    _assert_same_state(*caches)


def test_promote_k_co_promotes_near_duplicates():
    space = EmbeddingSpace(dim=32, seed=9)
    caches = _caches(2, 32, tau_hit=0.85, policy="LRU",
                     tiers=dict(host_capacity=16, ghost_capacity=0,
                                promote_k=4))
    logs = [_recorder(c) for c in caches]
    base = space.content_embedding(0, 0).astype(np.float32)
    close = [space.paraphrase(base, 0, 0, j).astype(np.float32)
             for j in (1, 2)]
    far = [space.content_embedding(3 + j, 100 + j).astype(np.float32)
           for j in range(4)]
    for cache in caches:
        for cid, e in enumerate([base] + close + far):
            cache.admit(cid, e, payload=[cid])
        in_host = [c for c in range(3) if cache.in_host(c)]
        assert len(in_host) >= 2
        r = cache.lookup(base, cid=99)
        assert r.hit and r.payload == [in_host[0]]   # best host rank served
        assert cache.tier_stats["promotions"] >= 2
        for c in in_host:
            assert c in cache or cache.in_host(c)
    _assert_same_events(*logs)
    _assert_same_state(*caches)


def test_async_promotion_rides_the_admit_queue():
    caches = _tiered(async_admit="sync")
    logs = [_recorder(c) for c in caches]
    _, embs = _space_embs()
    for cache in caches:
        for i in range(12):
            cache.admit(i, embs[i], payload=[i])
        cache.flush()
        target = next(c for c in range(12) if cache.in_host(c))
        r = cache.lookup(embs[target], cid=target)
        assert r.hit and r.payload == [target]   # served before admission
        assert cache.pending_admits >= 1         # promotion queued
        assert target not in cache and not cache.in_host(target)
        cache.flush()
        assert target in cache
        assert cache.tier_stats["promotions"] == 1
        cache.close()
    _assert_same_events(*logs)
    _assert_same_state(*caches)


# ----------------------------------------------------------- ghost revival
def test_ghost_tier_readmits_demoted_topic_hot():
    caches = _caches(2, 32, tau_hit=0.85, policy="RAC",
                     policy_kwargs=dict(ghost_limit=1, ghost_topic_limit=1,
                                        tau_route=0.3),
                     tiers=dict(host_capacity=0, ghost_capacity=64))
    logs = [_recorder(c) for c in caches]
    space = EmbeddingSpace(dim=32, seed=4)
    e0 = space.content_embedding(0, 0).astype(np.float32)
    for cache in caches:
        cache.admit(0, e0, payload=["r0"])
        for _ in range(3):
            assert cache.lookup(e0, cid=0).hit
        pol = cache.policy
        tid0 = int(pol.topic_of[cache.store.slot_of[0]])
        for j in range(1, 9):
            ej = space.content_embedding(j, j).astype(np.float32)
            cache.admit(j, ej, t=5000 + j)
        assert 0 not in cache and 0 not in pol.g_freq
        assert tid0 not in pol.topics and tid0 not in pol.ghost_topics
        g = cache.tiers.ghost_get(0)
        assert g is not None and g["freq"] == 4.0
        ntid = pol._next_tid
        cache.admit(0, e0, payload=["r0-again"])
        assert cache.tier_stats["ghost_revivals"] == 1
        s0 = cache.store.slot_of[0]
        assert pol.freq[s0] == 5.0           # lifetime counter restored
        assert pol._next_tid == ntid         # topic revived, not re-created
        assert int(pol.topic_of[s0]) == tid0
    _assert_same_events(*logs)
    _assert_same_state(*caches)


def test_ghost_lists_split_arc_style():
    caches = _tiered(capacity=2, host=2, ghost=8)
    logs = [_recorder(c) for c in caches]
    _, embs = _space_embs()
    for cache in caches:
        for i in range(6):
            cache.admit(i, embs[i], payload=[i])
        tm = cache.tiers
        assert len(tm.ghost_b1) > 0 and len(tm.ghost_b2) == 0
        target = next(c for c in range(6) if cache.in_host(c))
        assert cache.lookup(embs[target], cid=target).hit
        for i in range(6, 12):
            cache.admit(i, embs[i], payload=[i], t=5000 + i)
        assert target in tm.ghost_b2         # promoted-then-lost
        st = cache.tier_stats
        assert st["ghost_drops"] + len(tm.ghost_b1) + len(tm.ghost_b2) == \
            st["ghost_inserts"]
    _assert_same_events(*logs)
    _assert_same_state(*caches)
    pt, rt = caches[0].tiers, caches[1].tiers
    for name in ("ghost_b1", "ghost_b2", "promoted"):
        assert list(getattr(pt, name).keys()) == \
            list(getattr(rt, name).keys())


# --------------------------------------------------- single-tier identity
def _replay(cache, *, n=80):
    space = EmbeddingSpace(dim=32, seed=21)
    events = _recorder(cache)
    log = []
    for i in range(n):
        cid = i % 24
        emb = space.content_embedding(cid % 6, cid).astype(np.float32)
        r = cache.lookup(emb, cid=cid)
        log.append((cid, r.hit, r.cid if r.hit else -1))
        if not r.hit:
            cache.admit(cid, emb, payload=[cid])
    return log, _counters(cache), events


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
@pytest.mark.parametrize("hit_mode", ["content", "semantic"])
def test_disabled_tiers_identical_to_single_tier(backend, hit_mode):
    """Both capacities 0: no tier manager, and every decision equals the
    single-tier path's (and the reference's)."""
    kw = dict(tau_hit=0.85, hit_mode=hit_mode, policy="RAC")
    plain = _caches(8, 32, backend=backend, **kw)[0]
    off, ref = _caches(8, 32, backend=backend,
                       tiers=dict(host_capacity=0, ghost_capacity=0), **kw)
    assert off.tiers is None and off.tier_stats == {}
    a, b, c = _replay(plain), _replay(off), _replay(ref)
    assert a[:2] == b[:2] == c[:2]
    assert _key(a[2]) == _key(b[2]) == _key(c[2])


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
def test_tiered_decisions_match_the_reference(backend):
    port, ref = _caches(8, 32, backend=backend, tau_hit=0.85,
                        hit_mode="semantic", policy="RAC",
                        tiers=dict(host_capacity=16, ghost_capacity=32))
    got, want = _replay(port), _replay(ref)
    assert got[:2] == want[:2]
    _assert_same_events(got[2], want[2])
    _assert_same_state(port, ref)
    assert port.tier_stats["demotions"] > 0


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
def test_checkpoint_restore_roundtrip_includes_tiers(backend):
    space = EmbeddingSpace(dim=32, seed=31)
    port, ref = _caches(4, 32, backend=backend, tau_hit=0.85, policy="RAC",
                        tiers=dict(host_capacity=12, ghost_capacity=32))
    reqs = [(i % 20, space.content_embedding(i % 5, i % 20)
             .astype(np.float32)) for i in range(70)]

    def drive(cache, chunk):
        out = []
        for cid, emb in chunk:
            r = cache.lookup(emb, cid=cid)
            out.append((cid, r.hit, r.cid if r.hit else -1))
            if not r.hit:
                cache.admit(cid, emb, payload=[cid])
        return out

    for cache in (port, ref):
        drive(cache, reqs[:40])
    snap = port.checkpoint()
    host_at_snap = sorted(c for c in range(20) if port.in_host(c))
    stats_at_snap = port.tier_stats
    tail_a = drive(port, reqs[40:])
    assert tail_a == drive(ref, reqs[40:])
    _assert_same_state(port, ref)
    stats_a, store_a = port.tier_stats, sorted(port.store.keys())
    port.restore(snap)
    assert sorted(c for c in range(20) if port.in_host(c)) == host_at_snap
    assert port.tier_stats == stats_at_snap
    assert drive(port, reqs[40:]) == tail_a  # identical continuation
    assert port.tier_stats == stats_a
    assert sorted(port.store.keys()) == store_a


def test_restore_accepts_pre_tiering_snapshots():
    cache = SemanticCache(CacheConfig(capacity=4, dim=8, policy="LRU",
                                      backend="numpy"))
    cache.admit(1, np.ones(8, np.float32), payload=["x"])
    snap = cache.checkpoint()
    del snap["tiers"]                        # an older snapshot
    cache.admit(2, np.full(8, 2, np.float32))
    cache.restore(snap)
    assert 1 in cache and 2 not in cache and cache.payloads == {1: ["x"]}


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
def test_decide_batch_reports_host_fallthrough_columns(backend):
    port, ref = _tiered(backend=backend)
    _, embs = _space_embs()
    for cache in (port, ref):
        for i in range(12):
            cache.admit(i, embs[i], payload=[i])
    demoted = [c for c in range(12) if port.in_host(c)]
    q = np.stack([embs[c] for c in demoted])
    dec, rdec = port.decide_batch(q), ref.decide_batch(q)
    np.testing.assert_array_equal(dec.host_cid, np.asarray(demoted))
    np.testing.assert_array_equal(dec.host_cid, rdec.host_cid)
    np.testing.assert_allclose(dec.host_sim, rdec.host_sim, atol=SIM_ATOL)
    assert (dec.host_sim > 0.99).all()
    np.testing.assert_array_equal(dec.hit_cid, rdec.hit_cid)
    plain = SemanticCache(CacheConfig(capacity=4, dim=32, backend=backend,
                                      device="cpu"))
    plain.admit(0, embs[0])
    dec = plain.decide_batch(embs[0][None, :])
    assert dec.host_cid is None and dec.host_sim is None


# ------------------------------------------------ asynchronous admission
def _drive_batches(mode, backend, *, capacity=16, dim=32, batch=5):
    """The engine's batch-boundary discipline: lookups, then the misses'
    admissions, then a flush."""
    space = EmbeddingSpace(dim=dim, seed=2)
    cache = SemanticCache(CacheConfig(capacity=capacity, dim=dim,
                                      policy="RAC", async_admit=mode,
                                      backend=backend, device="cpu",
                                      backend_kwargs=_bkw(backend)))
    events = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, k=kind: events.append((k, ev.cid)))
    reqs = [(i, space.content_embedding(i % 6, i // 6).astype(np.float32)
             if i < 30 else
             space.paraphrase(space.content_embedding(i % 6, (i - 30) // 6)
                              .astype(np.float32), i % 6, (i - 30) // 6, 1)
             .astype(np.float32))
            for i in range(60)]
    for start in range(0, len(reqs), batch):
        chunk = reqs[start:start + batch]
        missed = [(cid, emb) for cid, emb in chunk
                  if not cache.lookup(emb, cid=cid).hit]
        for cid, emb in missed:
            cache.admit(cid, emb, payload=[cid])
        cache.flush()
    cache.close()
    return cache, _counters(cache), events


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
def test_flush_matches_synchronous_admit(backend):
    ref_cache, ref_counters, ref_events = _drive_batches(False, "numpy")
    ref_admits = [e for e in ref_events if e[0] in ("admit", "evict")]
    for mode in (False, "sync", True):
        cache, counters, events = _drive_batches(mode, backend)
        assert sorted(cache.store.keys()) == sorted(ref_cache.store.keys())
        assert cache.payloads == ref_cache.payloads
        assert counters == ref_counters
        assert cache.clock == ref_cache.clock
        assert [e for e in events if e[0] in ("admit", "evict")] == \
            ref_admits


def test_async_admit_defers_until_flush():
    space = EmbeddingSpace(dim=16, seed=3)
    cache = SemanticCache(CacheConfig(capacity=4, dim=16, policy="LRU",
                                      backend="numpy", async_admit="sync"))
    assert isinstance(cache.admitter, AsyncAdmitter)
    e = space.content_embedding(0, 0).astype(np.float32)
    assert cache.admit(0, e, payload="r") == []
    assert cache.pending_admits == 1 and len(cache) == 0
    assert cache.metrics_snapshot()["pending_admits"] == 1
    evicted = cache.flush()
    assert evicted == [] and len(cache) == 1 and cache.pending_admits == 0
    assert cache.lookup(e, cid=0).hit
    snap = cache.metrics_snapshot()
    assert snap["admit_stall_s"] == snap["enqueue_s"] + snap["flush_s"]


def test_flush_reports_drained_evictions():
    rng = np.random.default_rng(4)
    cache = SemanticCache(CacheConfig(capacity=2, dim=8, policy="FIFO",
                                      backend="numpy", async_admit="sync"))
    embs = rng.standard_normal((4, 8)).astype(np.float32)
    for i in range(4):
        cache.admit(i, embs[i])
    assert cache.flush() == [0, 1]            # FIFO victims, in drain order


def test_checkpoint_flushes_queued_admissions():
    rng = np.random.default_rng(5)
    cache = SemanticCache(CacheConfig(capacity=8, dim=8, policy="LRU",
                                      backend="numpy", async_admit="sync"))
    cache.admit(7, rng.standard_normal(8).astype(np.float32), payload="x")
    snap = cache.checkpoint()                  # settles the queue first
    assert 7 in snap["store"].slot_of and snap["payloads"] == {7: "x"}
    cache.restore(snap)
    assert 7 in cache and cache.payloads == {7: "x"}


def test_drain_error_surfaces_at_flush_and_worker_survives():
    cache = SemanticCache(CacheConfig(capacity=4, dim=8, policy="LRU",
                                      backend="numpy", async_admit=True))
    cache.admit(1, np.ones(3, np.float32))      # wrong-shaped embedding
    with pytest.raises(ValueError):
        cache.flush()
    cache.admit(2, np.ones(8, np.float32))
    assert cache.flush() == []
    assert 2 in cache and 1 not in cache
    cache.close()


def test_close_reverts_to_inline_admission():
    cache = SemanticCache(CacheConfig(capacity=4, dim=8, policy="LRU",
                                      backend="numpy", async_admit=True))
    cache.admit(1, np.ones(8, np.float32))
    cache.close()
    assert 1 in cache and cache.admitter is None
    assert cache.admit(2, np.full(8, 2, np.float32)) == []   # inline now
    assert 2 in cache and cache.pending_admits == 0


@pytest.mark.parametrize("mode", ["sync", True])
def test_close_drains_submissions_racing_past_the_flush(mode):
    cache = SemanticCache(CacheConfig(capacity=8, dim=8, policy="LRU",
                                      backend="numpy", async_admit=mode))
    cache.admit(1, np.ones(8, np.float32), payload=["early"])
    adm = cache.admitter
    orig_flush = adm.flush

    def racing_flush():
        out = orig_flush()
        adm.submit(9, np.full(8, 2, np.float32), ["late"], cache.clock + 1,
                   None)
        return out

    adm.flush = racing_flush
    cache.close()
    assert 1 in cache and 9 in cache          # nothing dropped
    assert cache.payloads[9] == ["late"]
    assert len(adm) == 0 and adm.applied == 2


def test_capacity_zero_admit_never_leaks_payload():
    cache = SemanticCache(CacheConfig(capacity=0, dim=8, policy="LRU",
                                      backend="numpy"))
    cache.admit(1, np.ones(8, np.float32), payload=list(range(1000)))
    assert cache.payloads == {} and len(cache) == 0


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
def test_peek_rows_matches_full_peek(backend):
    space = EmbeddingSpace(dim=64, seed=6)
    cache = SemanticCache(CacheConfig(capacity=40, dim=64, policy="LRU",
                                      backend=backend, device="cpu",
                                      backend_kwargs=_bkw(backend)))
    embs = [space.content_embedding(i % 8, i).astype(np.float32)
            for i in range(32)]
    for i, e in enumerate(embs):
        cache.admit(i, e)
    queries = np.stack([space.paraphrase(embs[i], i % 8, i, 1)
                        for i in range(12)]).astype(np.float32)
    full_c, full_s = cache.peek_batch(queries)
    sub_c, sub_s = cache.peek_rows(queries, list(range(32)))
    np.testing.assert_array_equal(full_c, sub_c)
    np.testing.assert_allclose(full_s, sub_s, atol=SIM_ATOL)
    c, _ = cache.peek_rows(queries, [3, 17, 20, 999])
    assert set(c.tolist()) <= {3, 17, 20}
    c, s = cache.peek_rows(queries, [999])
    assert (c == -1).all() and (s == -np.inf).all()


def test_dirty_since_semantics_and_diverged_copies():
    store = ResidentStore(8, 4)
    v0 = store.version
    assert store.dirty_since(v0) == set()
    s1 = store.insert(1, np.ones(4, np.float32))
    v1 = store.version
    s2 = store.insert(2, np.full(4, 2, np.float32))
    assert store.dirty_since(v0) == {s1, s2}
    assert store.dirty_since(v1) == {s2}
    assert store.dirty_since(store.version + 1) is None
    store.remove(1)
    assert store.dirty_since(v1) == {s1, s2}
    twin = copy.deepcopy(store)
    store.insert(3, np.full(4, 3, np.float32))
    twin.insert(4, np.full(4, 4, np.float32))
    assert twin.dirty_since(store.version) is None
    assert store.dirty_since(twin.version) is None


# ----------------------------------------------------------- event order
def test_event_order_miss_admit_evict():
    caches = _caches(1, 4, hit_mode="content", policy="LRU")
    logs = [_recorder(c) for c in caches]
    e = np.ones(4, dtype=np.float32)
    for cache in caches:
        cache.lookup(e, cid=1, t=1)
        cache.admit(1, e, payload="p1", t=1)
        cache.lookup(e, cid=2, t=2)
        cache.admit(2, e, payload="p2", t=2)
    events = logs[0]
    assert [(ev.kind, ev.cid) for ev in events] == [
        ("miss", 1), ("admit", 1), ("miss", 2), ("admit", 2), ("evict", 1)]
    assert events[-1].payload == "p1" and events[-1].tier == "device"
    _assert_same_events(*logs)


def test_async_flush_event_order_is_submission_order():
    cache = SemanticCache(CacheConfig(capacity=8, dim=4, hit_mode="content",
                                      backend="numpy", async_admit="sync"))
    admits = []
    cache.subscribe("admit", lambda ev: admits.append(ev.cid))
    e = np.ones(4, dtype=np.float32)
    for cid in (5, 3, 9, 1):
        cache.admit(cid, e)
    assert admits == []                    # nothing applied before flush
    cache.flush()
    assert admits == [5, 3, 9, 1]
    cache.close()


def test_hit_sims_by_mode():
    caches = _caches(4, 16, tau_hit=0.85)
    logs = [_recorder(c) for c in caches]
    space = EmbeddingSpace(dim=16, seed=3)
    emb = space.content_embedding(0, 1).astype(np.float32)
    for cache in caches:
        cache.admit(1, emb, payload="y")
        assert cache.lookup(emb, cid=1).hit
        assert not cache.lookup(-emb, cid=2).hit   # cosine -1: a miss
    hit = [ev for ev in logs[0] if ev.kind == "hit"][0]
    miss = [ev for ev in logs[0] if ev.kind == "miss"][-1]
    assert hit.sim >= 0.85 and miss.sim <= 0.0
    _assert_same_events(*logs)
    content = SemanticCache(CacheConfig(capacity=4, dim=4, backend="numpy",
                                        hit_mode="content"))
    ev = _recorder(content)
    content.admit(7, np.ones(4, np.float32), payload="x")
    assert content.lookup(np.ones(4, np.float32), cid=7).hit
    assert math.isnan(ev[-1].sim) and ev[-1].payload == "x"


def test_demote_and_promote_tier_tags():
    space = EmbeddingSpace(dim=16, seed=4)
    caches = _caches(2, 16, tau_hit=0.85, hit_mode="semantic",
                     tiers=dict(host_capacity=8, ghost_capacity=8))
    logs = [_recorder(c) for c in caches]
    embs = {i: space.content_embedding(i, i).astype(np.float32)
            for i in range(4)}
    for cache, events in zip(caches, logs):
        for i in range(4):
            cache.admit(i, embs[i], payload=f"p{i}", t=i + 1)
        evicts = [ev for ev in events if ev.kind == "evict"]
        assert [ev.tier for ev in evicts] == ["host", "host"]
        assert cache.in_host(0) and 0 not in cache
        n_admits = sum(ev.kind == "admit" for ev in events)
        res = cache.lookup(embs[0], cid=0, t=10)
        assert res.hit and res.payload == "p0"
        hits = [ev for ev in events if ev.kind == "hit"]
        assert hits[-1].tier == "host" and hits[-1].cid == 0
        assert sum(ev.kind == "admit" for ev in events) == n_admits + 1
        assert 0 in cache and not cache.in_host(0)
        assert [ev for ev in events if ev.kind == "evict"][-1].tier == "host"
    _assert_same_events(*logs)


# ------------------------------------------ event streams, the full matrix
@pytest.fixture(scope="module")
def small_trace():
    return synthetic_trace(SynthConfig(trace_len=240, n_topics=6, dim=16,
                                       seed=2))


def settled(events, bounds) -> list:
    """The stream cut at flush boundaries (``bounds``: the stream length
    after each request's flush), each request's events with its host-tier
    hits first: the synchronous path emits such a hit after the promotion
    it triggers (the re-admission and its evictions run inside the
    lookup), a queued admission path before it; everything else keeps its
    order."""
    out, lo = [], 0
    for hi in bounds:
        group = _key(events[lo:hi])
        out.append([e for e in group if e[0] == "hit" and e[3] == "host"]
                   + [e for e in group if not (e[0] == "hit"
                                               and e[3] == "host")])
        lo = hi
    return out


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("async_admit", [False, "sync", True])
@pytest.mark.parametrize("hit_mode", ["content", "semantic"])
def test_event_streams_match_the_reference(small_trace, hit_mode,
                                           async_admit, backend):
    """Flushed at every request, the port's tiered stream — (kind, cid,
    t, tier), sims and payloads — equals the reference's in the same
    admission mode, and at flush boundaries the reference's synchronous
    numpy one; across a checkpoint/restore in the middle of the replay
    (the restored cache must continue exactly as the uninterrupted one)."""
    tiers = dict(host_capacity=12, ghost_capacity=24)
    refs = [RCache(RConfig(capacity=8, dim=16, hit_mode=hit_mode,
                           backend="numpy", async_admit=mode,
                           tiers=RTierConfig(**tiers)))
            for mode in (async_admit, False)]
    port = SemanticCache(CacheConfig(
        capacity=8, dim=16, hit_mode=hit_mode, backend=backend,
        device="cpu", async_admit=async_admit,
        tiers=TierConfig(**tiers)))
    (want, sync), got = [_recorder(r) for r in refs], _recorder(port)
    reqs = small_trace.requests
    half = len(reqs) // 2
    bounds = {id(c): [] for c in (*refs, port)}

    def drive(cache, chunk, log):
        for r in chunk:
            if not cache.lookup(r.emb, cid=r.cid, t=r.t).hit:
                cache.admit(r.cid, r.emb, payload=(r.cid,), t=r.t)
            cache.flush()
            bounds[id(cache)].append(len(log))

    for cache, log in zip((*refs, port), (want, sync, got)):
        drive(cache, reqs[:half], log)
    snap = port.checkpoint()
    mark = len(got)
    for cache, log in zip((*refs, port), (want, sync, got)):
        drive(cache, reqs[half:], log)
    _assert_same_events(got, want)
    for ref in refs:
        _assert_same_state(port, ref)
    assert settled(got, bounds[id(port)]) == \
        settled(sync, bounds[id(refs[1])])
    st = port.tier_stats
    assert st["demotions"] > 0 and st["host_hits"] > 0
    # the restored snapshot continues with the same events
    tail = got[mark:]
    del got[:]
    port.restore(snap)
    drive(port, reqs[half:], got)
    _assert_same_events(got, tail)
    for cache in (*refs, port):
        cache.close()


# ---------------------------------------------------------------- report
def _feed(trk):
    trk.count("cache.evictions", 3)
    trk.count("tier.demotions", 2)
    trk.gauge("cache.queue_depth", 2)
    for v in (1e-4, 2.5e-3, 0.7, 1.5):
        trk.observe("cache.lookup_s", v)
    for t in range(0, 1200, 7):
        trk.observe("cache.hit", float(t % 3 == 0), t=t)


def test_report_render_matches_the_reference(tmp_path):
    trk, rtrk = InMemoryTracker(), RInMemoryTracker()
    _feed(trk)
    _feed(rtrk)
    txt = render_text(summarize(trk), title="t")
    assert txt == r_render_text(r_summarize(rtrk), title="t")
    assert "cache.evictions" in txt and "cache.lookup_s" in txt
    assert render_text({}, title="e") == r_render_text({}, title="e")
    out = write_report(trk, str(tmp_path / "r.json"), title="t")
    doc = json.loads((tmp_path / "r.json").read_text())
    assert doc["counters"]["cache.evictions"] == 3
    assert "cache.lookup_s" in doc["histograms"]
    assert out == txt


def test_tiered_cache_telemetry_matches_the_reference_counters():
    """The facade's tracker sees the tier flow (``tier.*``) and the
    admission queue, with the reference's counter values."""
    trackers = (InMemoryTracker(), RInMemoryTracker())
    space = EmbeddingSpace(dim=32, seed=7)
    embs = [space.content_embedding(i % 6, i).astype(np.float32)
            for i in range(24)]
    caches = (SemanticCache(CacheConfig(
        capacity=4, dim=32, backend="numpy", async_admit="sync",
        tracker=trackers[0],
        tiers=TierConfig(host_capacity=8, ghost_capacity=16))),
        RCache(RConfig(capacity=4, dim=32, backend="numpy",
                       async_admit="sync", tracker=trackers[1],
                       tiers=RTierConfig(host_capacity=8,
                                         ghost_capacity=16))))
    for cache in caches:
        for i in list(range(24)) + list(range(10, 24)):
            if not cache.lookup(embs[i], cid=i).hit:
                cache.admit(i, embs[i], payload=[i])
            cache.flush()
        cache.close()
    got, want = (summarize(t)["counters"] for t in trackers)
    assert got == want
    assert got["tier.demotions"] > 0 and got["tier.promotions"] > 0


# ------------------------------------------------------------ the engine
def test_engine_async_and_tiered_matches_the_reference_engine():
    from repro.configs import get_config as r_get_config
    from repro.models import smoke_variant as r_smoke
    from repro.serving import EngineConfig as REngineConfig
    from repro.serving import ServingEngine as RServingEngine
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_reference, smoke_variant
    from repro_torch.serving import EngineConfig, ServingEngine
    engine = dict(cache_capacity=8, max_new_tokens=3, max_batch=4,
                  max_seq=64, host_capacity=16, ghost_capacity=32)
    rcfg = r_smoke(r_get_config("paper"))
    trace = synthetic_trace(SynthConfig(trace_len=60, n_topics=8, seed=4))
    rng = np.random.default_rng(4)
    reqs = [(r.cid, r.emb, [int(t) for t in rng.integers(
        2, rcfg.vocab_size, size=3)]) for r in trace.requests]

    def outcome(eng):
        done = eng.run([(c, e, list(t)) for c, e, t in reqs])
        s = eng.stats
        eng.close()
        return ([(r.rid, r.cid, r.cached, tuple(int(t) for t in r.out_tokens))
                 for r in done],
                {k: s[k] for k in ("hits", "misses", "evictions",
                                   "generated_tokens", "batches")},
                eng.cache.tier_stats)

    reng = RServingEngine(rcfg, REngineConfig(**engine),
                          rng=jax.random.PRNGKey(7))
    want = outcome(reng)
    tree = jax.tree.map(np.asarray, reng.params)
    cfg = smoke_variant(get_config("paper"))
    for backend, async_admit in (("numpy", True), ("kernel", True),
                                 ("kernel", False)):
        eng = ServingEngine(cfg, EngineConfig(
            **engine, async_admit=async_admit, cache_backend=backend,
            device="cpu"), params=params_from_reference(tree, cfg, "cpu"))
        assert (eng.cache.admitter is not None) == async_admit
        got = outcome(eng)
        assert got == want, (backend, async_admit)
    assert want[1]["hits"] > 0 and want[1]["evictions"] > 0
    assert want[2]["demotions"] > 0


def test_concurrent_producers_lose_no_admission():
    """Eight producer threads admit into one worker-drained cache under a
    tiny switch interval: after the flush every admission is applied once,
    with one logical tick each."""
    import sys
    import threading
    cache = SemanticCache(CacheConfig(capacity=1_000, dim=8, policy="LRU",
                                      backend="numpy", async_admit=True))
    rng = np.random.default_rng(8)
    embs = rng.standard_normal((400, 8)).astype(np.float32)

    def produce(lo):
        for cid in range(lo, lo + 50):
            cache.admit(cid, embs[cid], payload=[cid])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, args=(50 * k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        cache.flush()
    finally:
        sys.setswitchinterval(old)
    assert len(cache) == 400 and cache.metrics.admissions == 400
    assert cache.clock == 400 and cache.pending_admits == 0
    assert cache.payloads == {c: [c] for c in range(400)}
    cache.close()
