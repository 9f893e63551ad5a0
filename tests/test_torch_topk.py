"""The port's Top-K family against the reference's: ``sim_topk``,
``route_topics`` and ``sim_topk_q8`` (``repro_torch.kernels.ops``, whose
wrappers run the kernels' plain PyTorch versions on the CPU) against
``repro.kernels.ops`` with ``use_pallas=True`` (the Pallas kernels in
interpret mode), over the grids of ``tests/test_kernels.py``,
``tests/test_quantized.py`` and ``tests/test_pruned.py``; the int8
helpers of ``kernels/quant.py``; and ``topk_rows`` through the port's
backends.  The CUDA kernels themselves are held against the plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: fp32 scores within 1e-5 absolute (sums in another order);
indices exact wherever the score is finite and 1e-4 clear of both
neighbouring ranks; int8 scores bit-equal (exact integer dots, then the
same two float32 products in the same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.backends import NumpyBackend as RNumpyBackend
from repro.cache.pruned import NEG
from repro.core.store import ResidentStore as RStore
from repro.kernels import ops as rops
from repro.kernels import quant as rquant
from repro.kernels import ref as rref
from repro_torch.cache import KernelBackend, NumpyBackend
from repro_torch.cache.pruned import TopicBucketIndex, route_topics_host
from repro_torch.core.policy_table import PolicyTable
from repro_torch.core.store import ResidentStore
from repro_torch.kernels import ops, quant, ref, similarity_topk

SIM_ATOL = 1e-5
GAP = 1e-4


def _t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_topk(got, want):
    (gv, gi), (wv, wi) = got, want
    gv, gi = np.asarray(gv), np.asarray(gi)
    wv, wi = np.asarray(wv), np.asarray(wi)
    assert gv.shape == wv.shape == gi.shape and gi.dtype == np.int32
    np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=SIM_ATOL)
    wide = np.pad(wv.astype(np.float64), ((0, 0), (1, 1)),
                  constant_values=(np.inf, -np.inf))
    with np.errstate(invalid="ignore"):        # inf - inf at the edges
        clear = fin & (wide[:, 1:-1] - wide[:, 2:] > GAP) \
            & (wide[:, :-2] - wide[:, 1:-1] > GAP)
    np.testing.assert_array_equal(gi[clear], wi[clear])
    # each row descends
    assert (gv[:, 1:] <= gv[:, :-1]).all()


# ----------------------------------------------------------- sim_topk (B4)
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("q_n,c_n,d", [(1, 64, 32), (7, 100, 64),
                                       (37, 901, 64), (128, 512, 128)])
def test_sim_topk_matches_reference(rng, q_n, c_n, d, k):
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    c = rng.standard_normal((c_n, d)).astype(np.float32)
    got = ops.sim_topk(_t(q), _t(c), k)
    want = rops.sim_topk(jnp.asarray(q), jnp.asarray(c), k, use_pallas=True)
    _assert_topk(got, want)


@pytest.mark.parametrize("n_valid", [0, 1, 3, 97, 100])
def test_sim_topk_runtime_n_valid(rng, n_valid):
    q = rng.standard_normal((5, 64)).astype(np.float32)
    c = rng.standard_normal((100, 64)).astype(np.float32)
    gv, gi = ops.sim_topk(_t(q), _t(c), 8, n_valid=n_valid)
    wv, wi = rops.sim_topk(jnp.asarray(q), jnp.asarray(c), 8,
                           n_valid=n_valid, use_pallas=True)
    _assert_topk((gv, gi), (wv, wi))
    live = np.isfinite(np.asarray(gv))
    assert live.sum() == 5 * min(8, n_valid)
    if n_valid:
        assert np.asarray(gi)[live].max() < n_valid


def test_sim_topk_ties_break_low(rng):
    q = rng.standard_normal((3, 64)).astype(np.float32)
    row = rng.standard_normal((1, 64)).astype(np.float32)
    c = np.repeat(row, 16, axis=0)
    v, i = ops.sim_topk(_t(q), _t(c), 4)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(4), (3, 1)))
    wv, wi = rops.sim_topk(jnp.asarray(q), jnp.asarray(c), 4,
                           use_pallas=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [33, 257, 300])
def test_sim_topk_any_k_up_to_n(rng, k):
    """K is not capped: up to every candidate, in lax.top_k's order."""
    q = _unit(rng, 4, 48)
    c = _unit(rng, 300, 48)
    got = ops.sim_topk(_t(q), _t(c), k, n_valid=290)
    want = rref.sim_topk_ref(jnp.asarray(q), jnp.asarray(c), 290, k)
    _assert_topk(got, want)


def test_sim_topk_rejects_k_outside_the_candidates(rng):
    q, c = _t(_unit(rng, 2, 16)), _t(_unit(rng, 10, 16))
    for k in (0, 11):
        with pytest.raises(ValueError, match="k="):
            similarity_topk.sim_topk(q, c, 10, k)
    with pytest.raises(ValueError, match="contiguous"):
        similarity_topk.sim_topk(q, c.T, 10, 2)


# ------------------------------------------------------ route_topics (B4)
def _aug(rng, dim, n_top, n_valid):
    aug = np.zeros((n_top, dim + 1), dtype=np.float32)
    aug[:n_valid, :dim] = _unit(rng, n_valid, dim)
    aug[:n_valid, dim] = rng.uniform(0.05, 0.6, n_valid)
    aug[n_valid:, dim] = NEG
    return aug


@pytest.mark.parametrize("probes", [1, 2, 3, 256])
def test_route_topics_matches_reference(rng, probes):
    dim, n_top, n_valid = 48, 24, 19
    q = _unit(rng, 9, dim)
    aug = _aug(rng, dim, n_top, n_valid)
    got = ops.route_topics(_t(q), _t(aug), probes, n_valid=n_valid)
    want = rops.route_topics(q, aug, probes, n_valid=n_valid,
                             use_pallas=True)
    assert got[0].shape == (9, min(probes + 1, n_top))
    _assert_topk(got, want)
    # the host oracle picks the same probes (the bound columns past the
    # live topics are -inf on the device and absent on the host)
    hv, ht = route_topics_host(q, aug, n_valid, probes)
    kk = ht.shape[1]
    np.testing.assert_allclose(got[0].numpy()[:, :kk], hv, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy()[:, :kk], ht)


def test_route_topics_fewer_topics_than_probes(rng):
    q = _unit(rng, 3, 16)
    aug = np.zeros((2, 17), dtype=np.float32)
    aug[:, :16] = _unit(np.random.default_rng(5), 2, 16)
    aug[:, 16] = 0.1
    vals, tids = ops.route_topics(_t(q), _t(aug), probes=4, n_valid=2)
    assert vals.shape[1] == 2                  # k = min(P+1, T)
    assert set(tids.numpy().ravel().tolist()) == {0, 1}
    want = rops.route_topics(q, aug, probes=4, n_valid=2, use_pallas=True)
    _assert_topk((vals, tids), want)


# -------------------------------------------------------- sim_topk_q8 (B5)
@pytest.mark.parametrize("q_n,c_n,d,n_valid,k", [
    (7, 600, 128, 570, 5), (1, 64, 32, 64, 8), (37, 901, 64, 700, 16),
    (5, 100, 64, 3, 8), (4, 50, 48, 0, 4), (2, 300, 96, 300, 300)])
def test_sim_topk_q8_bit_equal_to_reference(rng, q_n, c_n, d, n_valid, k):
    q8, qs, _ = rquant.quantize_rows_int8(_unit(rng, q_n, d))
    c8, cs, _ = rquant.quantize_rows_int8(_unit(rng, c_n, d))
    gv, gi = ops.sim_topk_q8(_t(q8), _t(qs), _t(c8), _t(cs), k,
                             n_valid=n_valid)
    wv, wi = rops.sim_topk_q8(q8, qs, c8, cs, k, n_valid=n_valid,
                              use_pallas=True)
    gv, gi, wv, wi = (np.asarray(x) for x in (gv, gi, wv, wi))
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
    np.testing.assert_array_equal(gv[fin], wv[fin])      # bit-equal
    np.testing.assert_array_equal(gi[fin], wi[fin])
    # the numpy host gemm with the same multiply order gives the same bits
    if n_valid:
        host = (rquant.int8_scores(q8, c8[:n_valid]) * qs[:, None]) \
            * cs[None, :n_valid]
        kk = min(k, n_valid)
        order = np.argsort(-host, axis=1, kind="stable")[:, :kk]
        np.testing.assert_array_equal(gi[:, :kk], order)
        np.testing.assert_array_equal(gv[:, :kk],
                                      np.take_along_axis(host, order, 1))


def test_sim_topk_q8_clamps_k_to_the_candidates(rng):
    q8, qs, _ = quant.quantize_rows_int8(_unit(rng, 2, 32))
    c8, cs, _ = quant.quantize_rows_int8(_unit(rng, 5, 32))
    v, _ = ops.sim_topk_q8(_t(q8), _t(qs), _t(c8), _t(cs), 8)
    assert v.shape == (2, 5)


# ------------------------------------------------------ int8 helpers
def test_quant_helpers_are_bit_equal_to_reference(rng):
    x = rng.standard_normal((40, 96)).astype(np.float32)
    x[3] = 0.0                                   # the epsilon-scale row
    for a, b in zip(quant.quantize_rows_int8(x),
                    rquant.quantize_rows_int8(x)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    q8, qs, ql1 = quant.quantize_rows_int8(x[:7])
    c8, cs, cl1 = quant.quantize_rows_int8(x)
    np.testing.assert_array_equal(quant.int8_scores(q8, c8),
                                  rquant.int8_scores(q8, c8))
    np.testing.assert_array_equal(
        quant.scan_margin(qs, ql1, cs, cl1, 96),
        rquant.scan_margin(qs, ql1, cs, cl1, 96))


@pytest.mark.parametrize("d", [64, 1100])
def test_int8_dots_are_exact(rng, d):
    """The plain version's integer dots are exact, also past D = 1040
    where a float32 product would stop being exact."""
    q8 = rng.integers(-127, 128, (3, d)).astype(np.int8)
    c8 = rng.integers(-127, 128, (9, d)).astype(np.int8)
    exact = q8.astype(np.int64) @ c8.astype(np.int64).T
    got = ref.int8_dots(_t(q8), _t(c8)).numpy()
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    np.testing.assert_array_equal(quant.int8_scores(q8, c8),
                                  exact.astype(np.float32))


def test_sim_top1_takes_a_count_tensor(rng):
    """B1's count may be a one-element int32 tensor (read by the kernel on
    the card); on the CPU it masks exactly like the host int."""
    q, c = _t(_unit(rng, 6, 32)), _t(_unit(rng, 50, 32))
    for nv in (0, 1, 33, 50):
        dv = torch.tensor([nv], dtype=torch.int32)
        a = similarity_topk.sim_top1(q, c, dv)
        b = similarity_topk.sim_top1(q, c, nv)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="int32"):
        similarity_topk.sim_top1(q, c, torch.tensor([3]))


# ---------------------------------------------------- topk_rows (backends)
def _store_pair(rng, n_slots, dim, n_fill):
    port, refs = ResidentStore(n_slots, dim), RStore(n_slots, dim)
    for cid in range(n_fill):
        e = _unit(rng, 1, dim)[0]
        port.insert(cid, e)
        refs.insert(cid, e)
    return port, refs


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_backend_topk_rows_matches_reference(rng, backend, k):
    port, refs = _store_pair(rng, 24, 64, 18)
    rows = [port.slot_of[c] for c in (0, 3, 5, 7, 11, 16)]
    q = _unit(rng, 9, 64)
    be = NumpyBackend() if backend == "numpy" else KernelBackend("cpu")
    bc, bs = be.topk_rows(port, q, np.asarray(rows), k)
    oc, os_ = RNumpyBackend().topk_rows(refs, q, rows, k)
    assert bc.shape == bs.shape == (9, k)
    np.testing.assert_array_equal(bc, oc)
    np.testing.assert_allclose(bs, os_, atol=SIM_ATOL)
    if k > len(rows):
        assert (bc[:, len(rows):] == -1).all()
        assert np.isneginf(bs[:, len(rows):]).all()


def test_topk_rows_gathered_candidates_keep_lower_slot_tie_rule(rng):
    """Duplicate embeddings spread across interleaved buckets: the gathered
    candidate rows are ascending, so both backends list the duplicates in
    slot order."""
    dim = 16
    store = ResidentStore(40, dim)
    vecs = _unit(rng, 40, dim)
    dup = vecs[0]
    for i in range(36):
        store.insert(i, vecs[i])
    for slot in (3, 17, 29):
        store.remove(int(store.cid[slot]))
        store.insert(100 + slot, dup)
    store.remove(int(store.cid[11]))
    table = PolicyTable(store.emb.shape[0], dim)
    table.set_rep(0, dup)
    table.set_rep(1, vecs[5])
    for slot, t in ((17, 0), (3, 1), (29, 0), (5, 1)):
        table.topic_of[slot] = t
        table.touch_slot(slot)
    idx = TopicBucketIndex()
    idx.sync(store, table)
    rows = idx.candidate_rows(idx.group_key(np.array([0, 1])))
    assert (np.diff(rows) > 0).all()
    for be in (NumpyBackend(), KernelBackend("cpu")):
        cids, _ = be.topk_rows(store, dup[None, :], rows, k=3)
        assert cids[0].tolist() == [0, 103, 117]
