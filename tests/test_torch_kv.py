"""The port's KV prefix-block cache (``repro_torch.serving.KVBlockManager``
on ``repro_torch.core.radix.RadixRACPolicy``) against the reference's, on
the same token traces: request by request the same hit tokens, block ids,
topics, evictions and resident chains on the float64 host oracle (and the
same as the reference's pre-facade ``LegacyKVBlockManager``), and on the
kernel backend's plain B3 (``device="cpu"``) the decisions of the
reference's kernel backend with every masked Eq. 1 value within 1e-6
relative.  Also: the slot-indexed victim choice against the reference's
three-key lexsort on random slabs with forced ties, and the flows of
``tests/test_kv_facade.py`` and ``tests/test_serving.py``'s KV tests.
"""
import numpy as np
import pytest

from repro.cache import NumpyBackend as RNumpyBackend
from repro.core.radix import RadixRACPolicy as RRadixRACPolicy
from repro.core.store import ResidentStore as RResidentStore
from repro.serving import KVBlockManager as RKVBlockManager
from repro.serving import LegacyKVBlockManager as RLegacyKVBlockManager
from repro_torch.cache import KernelBackend, NumpyBackend
from repro_torch.core import RadixRACPolicy
from repro_torch.core.store import ResidentStore
from repro_torch.serving import KVBlockManager, LegacyKVBlockManager

VALUE_RTOL = 1e-6


def _token_trace(seed: int, n: int = 300) -> list[list[int]]:
    """Mixed workload: hot shared prefixes, extensions, and one-offs (the
    reference's ``tests/test_kv_facade.py`` generator)."""
    rng = np.random.default_rng(seed)
    hot = [list(range(16)), list(range(700, 712))]
    convs = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:        # reuse + extend a hot prefix
            h = hot[int(rng.integers(0, len(hot)))]
            convs.append(h + list(rng.integers(
                500, 600, size=int(rng.integers(0, 12)))))
        elif r < 0.4:       # partial hot prefix
            convs.append(hot[0][: 4 * int(rng.integers(1, 5))])
        else:               # one-off conversation
            base = 1000 + 40 * int(rng.integers(0, 60))
            convs.append(list(range(base, base + int(rng.integers(3, 30)))))
    return convs


def _resident_chains(mgr) -> list[tuple]:
    """Bid-independent residency fingerprint: every block's token chain."""
    def chain(bid):
        out = []
        while bid >= 0:
            b = mgr.blocks[bid]
            out.append(b.tokens)
            bid = b.parent
        return tuple(reversed(out))
    return sorted(chain(bid) for bid in mgr.blocks)


def _outcome(r: dict) -> tuple:
    return (r["hit_tokens"], list(r["hit_blocks"]), list(r["new_blocks"]),
            r["topic"], list(r["evicted"]))


def _recording(mgr) -> list:
    """Record every masked Eq. 1 call's values (wraps the wired scorer)."""
    calls = []
    pol = mgr.policy
    score = pol.masked_value_backend

    def wrapped(*a):
        out = score(*a)
        calls.append(np.asarray(out, dtype=np.float64).copy())
        return out
    pol.masked_value_backend = wrapped
    return calls


def _assert_values(got: list, want: list):
    """Per eviction, the evictable blocks' values (the finite ones): the
    port scans the slab in slot order with free slots at +inf, the
    reference its residents in dict order, so they are compared sorted."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.sort(g[np.isfinite(g)]), np.sort(w[np.isfinite(w)])
        assert g.size == w.size
        np.testing.assert_allclose(g, w, rtol=VALUE_RTOL)


@pytest.mark.parametrize("seed,n_blocks", [(0, 24), (1, 8), (2, 48), (3, 3)])
def test_host_oracle_matches_reference_and_legacy(seed, n_blocks):
    """Request by request: hit tokens, hit and new block ids, topics,
    evicted ids and ``used`` equal the reference's facade manager; hit
    tokens, allocations, topics, ``used`` and resident chains equal the
    legacy manager's (including n_blocks=3, where chains outgrow the pool
    and allocation fails like the legacy victim<0 path)."""
    port = KVBlockManager(n_blocks=n_blocks, block_tokens=4, backend="numpy")
    ref = RKVBlockManager(n_blocks=n_blocks, block_tokens=4)
    old = RLegacyKVBlockManager(n_blocks=n_blocks, block_tokens=4)
    for i, conv in enumerate(_token_trace(seed)):
        rp = port.on_request(list(conv))
        rr = ref.on_request(list(conv))
        ro = old.on_request(list(conv))
        assert _outcome(rp) == _outcome(rr), i
        assert rp["hit_tokens"] == ro["hit_tokens"], i
        assert len(rp["new_blocks"]) == len(ro["new_blocks"]), i
        assert rp["topic"] == ro["topic"], i
        assert port.used == ref.used == old.used, i
        assert _resident_chains(port) == _resident_chains(old), i
        assert set(port.blocks) == set(ref.blocks), i
    assert port.used <= n_blocks
    assert port.cache.metrics.snapshot()["evictions"] == \
        ref.cache.metrics.evictions


@pytest.mark.parametrize("seed,n_blocks", [(0, 24), (1, 8), (2, 48), (3, 3)])
def test_kernel_backend_matches_reference_kernel_backend(seed, n_blocks):
    """The port's kernel backend on the plain B3 (``device="cpu"``) makes
    the reference kernel backend's decisions (``use_pallas=False``), with
    every masked Eq. 1 value within 1e-6 relative."""
    port = KVBlockManager(n_blocks=n_blocks, block_tokens=4, device="cpu")
    ref = RKVBlockManager(n_blocks=n_blocks, block_tokens=4,
                          backend="kernel", use_pallas=False)
    got, want = _recording(port), _recording(ref)
    for i, conv in enumerate(_token_trace(seed)):
        assert _outcome(port.on_request(list(conv))) == \
            _outcome(ref.on_request(list(conv))), i
        assert port.used == ref.used, i
    _assert_values(got, want)
    assert got, "no eviction was scored"


def test_kernel_backend_matches_reference_pallas_in_interpret_mode():
    """The reference's B3 itself (Pallas in interpret mode) at one small
    size: the same decisions and values within 1e-6 relative."""
    port = KVBlockManager(n_blocks=6, block_tokens=4, device="cpu")
    ref = RKVBlockManager(n_blocks=6, block_tokens=4, backend="kernel",
                          use_pallas=True)
    got, want = _recording(port), _recording(ref)
    for i, conv in enumerate(_token_trace(4, n=24)):
        assert _outcome(port.on_request(list(conv))) == \
            _outcome(ref.on_request(list(conv))), i
    _assert_values(got, want)
    assert got


# ------------------------------------------------ slot-indexed victim
def _twin_policies(rng, n_blocks: int, n_res: int, *, n_topics: int,
                   tie_values: bool, tie_last_t: bool):
    """The port's and the reference's policy over equal random states:
    residents placed in shuffled slots (slot order != cid order), small
    integer counters and few topics so values and last accesses tie."""
    stores = (ResidentStore(n_blocks, 1), RResidentStore(n_blocks, 1))
    pols = (RadixRACPolicy(n_blocks, stores[0]),
            RRadixRACPolicy(n_blocks, stores[1]))
    pols[1].masked_value_backend = RNumpyBackend().rac_value_masked
    pols[0].masked_value_backend = NumpyBackend().rac_value_masked
    cids = rng.permutation(10 * n_res)[:n_res]
    # fill every slot with a placeholder, free them in a random order and
    # drop the residents into the freed slots, so that residents sit in
    # scattered slots
    dummies = [10**6 + j for j in range(n_blocks + 1)]
    freed = rng.permutation(n_blocks + 1)
    for store in stores:
        for d in dummies:
            store.insert(d, np.zeros(1, np.float32))
        for j in freed[:n_res]:
            store.remove(dummies[j])
        for c in cids:
            store.insert(int(c), np.zeros(1, np.float32))
        for j in freed[n_res:]:
            store.remove(dummies[j])
    tp = rng.integers(1, 4, n_topics).astype(np.float64)
    tl = (np.zeros(n_topics, np.int64) if tie_values
          else rng.integers(0, 50, n_topics))
    for pol in pols:
        pol._grow_tp(n_topics)
        pol.tp_last[:n_topics] = tp
        pol.t_last[:n_topics] = tl
        pol._next_tid = n_topics
    for c in cids:
        c = int(c)
        freq = float(rng.integers(1, 3))
        dep = float(rng.integers(0, 2))
        lt = 0 if tie_last_t else int(rng.integers(0, 60))
        tid = int(rng.integers(0, n_topics))
        for pol, store in zip(pols, stores):
            s = store.slot_of[c]
            pol.freq[s], pol.dep[s], pol.last_t[s] = freq, dep, lt
            pol.topic_of[s] = tid
    # a random forest over the residents: parents get live children
    for k, c in enumerate(cids[1:], start=1):
        if rng.random() < 0.4:
            p = int(cids[int(rng.integers(0, k))])
            for pol, store in zip(pols, stores):
                pol.parent[store.slot_of[int(c)]] = p
                pol.n_children[store.slot_of[p]] += 1
    return pols, stores, cids


def _slabs(pol, store) -> dict:
    """Per-cid policy state (slot-independent)."""
    return {c: (pol.freq[s], pol.dep[s], pol.last_t[s], pol.topic_of[s],
                pol.parent[s], pol.n_children[s])
            for c, s in store.slot_of.items()}


@pytest.mark.parametrize("case", range(24))
def test_slot_indexed_victim_equals_the_lexsort(case):
    """Random slabs with forced ties (equal values, equal last accesses),
    protected chain tips and a fresh block: the slot-indexed choice elects
    the reference's lexsort victim and leaves the same state."""
    rng = np.random.default_rng(case)
    n_blocks = int(rng.integers(3, 40))
    n_res = int(rng.integers(2, n_blocks + 2))
    pols, stores, cids = _twin_policies(
        rng, n_blocks, n_res, n_topics=int(rng.integers(1, 4)),
        tie_values=case % 2 == 0, tie_last_t=case % 4 < 2)
    fresh = int(cids[-1])
    protect = {int(c) for c in rng.choice(cids, size=min(2, n_res),
                                          replace=False)
               if rng.random() < 0.6}
    for pol in pols:
        pol._fresh = fresh
        pol.protect = set(protect)
    t = int(rng.integers(60, 200))
    got_c, got_v, got_ok = pols[0].value_scores(t)
    want_c, want_v, want_ok = pols[1].value_scores(t)
    got = dict(zip(got_c.tolist(), zip(got_v.tolist(), got_ok.tolist())))
    assert got == dict(zip(want_c.tolist(),
                           zip(want_v.tolist(), want_ok.tolist())))
    assert pols[0].victim(t) == pols[1].victim(t)
    assert _slabs(pols[0], stores[0]) == _slabs(pols[1], stores[1])
    assert pols[0]._fresh == pols[1]._fresh


def test_all_protected_elects_the_fresh_block_and_rolls_back():
    """n_blocks=3 with one chain: every resident has a live child or is
    protected, so the fresh block is elected and its parent link undone."""
    for policy_cls, store_cls in ((RadixRACPolicy, ResidentStore),
                                  (RRadixRACPolicy, RResidentStore)):
        store = store_cls(3, 1)
        pol = policy_cls(3, store)
        tid = pol.touch_topic(None, 1)
        for cid, parent in [(0, -1), (1, 0), (2, 1), (3, 2)]:
            store.insert(cid, np.zeros(1, np.float32))
            pol.stage(topic=tid, parent=parent)
            pol.on_admit(cid, None, 1)
        s2 = store.slot_of[2]
        assert pol.n_children[s2] == 1 and pol.dep[s2] == 1.0
        assert pol.victim(2) == 3
        assert pol.n_children[s2] == 0 and pol.dep[s2] == 0.0
        assert pol._fresh == -1


# ------------------------------------------- the reference's KV flows
def test_facade_manager_uses_facade_metrics_and_hooks():
    mgr = KVBlockManager(n_blocks=8, block_tokens=4, device="cpu")
    events = []
    for kind in ("hit", "miss", "admit", "evict"):
        mgr.cache.subscribe(kind, lambda ev, k=kind: events.append(k))
    mgr.on_request(list(range(16)))           # 4 new blocks
    mgr.on_request(list(range(16)))           # 4 block hits
    m = mgr.cache.metrics
    assert m.admissions == 4 and m.hits == 4 and m.misses == 4
    assert events.count("admit") == 4 and events.count("hit") == 4
    mgr.on_request(list(range(100, 120)))     # 5 more -> 1 eviction
    assert mgr.cache.metrics.evictions == 1
    assert events.count("evict") == 1


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_radix_policy_masks_children_through_backend(backend):
    """The masked Eq. 1 scan: blocks with live children (or protected)
    score +inf through the backend's rac_value_masked."""
    store = ResidentStore(4, 1)
    pol = RadixRACPolicy(4, store)
    pol.masked_value_backend = (NumpyBackend() if backend == "numpy"
                                else KernelBackend(device="cpu")
                                ).rac_value_masked
    tid = pol.touch_topic(None, 1)
    for cid, parent in [(0, -1), (1, 0), (2, 1)]:
        store.insert(cid, np.zeros(1, np.float32))
        pol.stage(topic=tid, parent=parent)
        pol.on_admit(cid, None, 1)
    pol.protect.clear()
    pol._fresh = -1
    cids, values, valid = pol.value_scores(t=2)
    by = dict(zip(cids.tolist(), values.tolist()))
    assert by[0] == np.inf and by[1] == np.inf      # live children
    assert np.isfinite(by[2])                       # leaf is evictable
    assert valid.tolist() == [False, False, True]
    assert pol.victim(2) == 2


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_manager_keeps_radix_validity(backend):
    """The children-first mask is a hard constraint on either scorer."""
    mgr = KVBlockManager(n_blocks=8, block_tokens=4, backend=backend,
                         device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(40):
        base = 100 * int(rng.integers(0, 12))
        mgr.on_request(list(range(base, base + int(rng.integers(4, 20)))))
        for bid, b in mgr.blocks.items():
            for ch in b.children:
                assert ch in mgr.blocks
            assert b.parent < 0 or b.parent in mgr.blocks, \
                f"orphan block {bid}: parent evicted first"
        assert set(mgr.blocks) == set(mgr.cache.store.keys())
    assert mgr.cache.metrics.evictions > 0


def test_checkpoint_restores_mirror_with_cache():
    """The manager's checkpoint covers the facade state and the radix
    mirror together, as the reference's does."""
    mgr = KVBlockManager(n_blocks=8, block_tokens=4, device="cpu")
    ref = RKVBlockManager(n_blocks=8, block_tokens=4)
    for m in (mgr, ref):
        m.on_request(list(range(8)))
    snaps = [m.checkpoint() for m in (mgr, ref)]
    for m in (mgr, ref):
        m.on_request(list(range(100, 120)))   # churn past capacity
    assert len(mgr.blocks) > 2
    for m, s in zip((mgr, ref), snaps):
        m.restore(s)
    assert mgr.used == 2 and len(mgr.blocks) == 2
    assert set(mgr.blocks) == set(mgr.cache.store.keys())
    for tokens, hit in ((list(range(8)), 8), (list(range(100, 108)), 0)):
        r, rr = mgr.on_request(tokens), ref.on_request(tokens)
        assert r["hit_tokens"] == hit
        assert _outcome(r) == _outcome(rr)


def test_rac_value_masked_kernel_matches_numpy():
    rng = np.random.default_rng(0)
    nb, kb = NumpyBackend(), KernelBackend(device="cpu")
    tsi = rng.random(64)
    tids = rng.integers(0, 8, 64)
    tp_last = rng.random(8) * 5
    t_last = rng.integers(0, 300, 8)
    valid = rng.random(64) < 0.6
    a = nb.rac_value_masked(tsi, tids, tp_last, t_last, 0.001, 400, valid)
    b = kb.rac_value_masked(tsi, tids, tp_last, t_last, 0.001, 400, valid)
    want = RNumpyBackend().rac_value_masked(tsi, tids, tp_last, t_last,
                                            0.001, 400, valid)
    np.testing.assert_array_equal(a, want)
    assert np.array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_allclose(a[valid], b[valid], rtol=VALUE_RTOL)


def test_kv_prefix_reuse():
    mgr = KVBlockManager(n_blocks=64, block_tokens=4, device="cpu")
    conv = list(range(20))
    r1 = mgr.on_request(conv)
    assert r1["hit_tokens"] == 0 and len(r1["new_blocks"]) == 5
    r2 = mgr.on_request(conv + [99, 98, 97, 96])   # full prefix reuse
    assert r2["hit_tokens"] == 20 and len(r2["new_blocks"]) == 1


def test_kv_eviction_respects_radix_validity():
    mgr = KVBlockManager(n_blocks=8, block_tokens=4, device="cpu")
    mgr.on_request(list(range(16)))           # 4 blocks, chain
    mgr.on_request(list(range(100, 116)))     # 4 more -> full
    mgr.on_request(list(range(200, 216)))     # needs evictions
    for bid, b in mgr.blocks.items():
        for ch in b.children:
            assert ch in mgr.blocks
        assert b.parent < 0 or b.parent in mgr.blocks, \
            f"orphan block {bid}: parent evicted first"
    assert mgr.cache.metrics.evictions > 0


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_kv_hot_prefix_survives(backend):
    mgr = KVBlockManager(n_blocks=8, block_tokens=4, backend=backend,
                         device="cpu")
    ref = RKVBlockManager(n_blocks=8, block_tokens=4)
    hot = list(range(8))                      # 2 blocks, reused often
    for m in (mgr, ref):
        for _ in range(5):
            m.on_request(hot)
    root_key = tuple(hot[:4])
    hot_root = mgr.root_index[root_key]
    for i in range(10):                       # one-offs force evictions
        conv = list(range(1000 + 16 * i, 1000 + 16 * i + 12))
        assert _outcome(mgr.on_request(conv)) == _outcome(ref.on_request(conv))
    assert mgr.root_index.get(root_key) == hot_root   # anchor retained
    assert mgr.on_request(hot)["hit_tokens"] == 8


def test_legacy_manager_matches_the_reference_legacy():
    """The port's copy of the parity oracle is the reference's."""
    port = LegacyKVBlockManager(n_blocks=8, block_tokens=4)
    ref = RLegacyKVBlockManager(n_blocks=8, block_tokens=4)
    for conv in _token_trace(6):
        assert port.on_request(list(conv)) == ref.on_request(list(conv))
        assert sorted(port.blocks) == sorted(ref.blocks)
