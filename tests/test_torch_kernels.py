"""The port's kernel-op layer (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops`` with ``use_pallas=True``: the Pallas
kernels in interpret mode on the CPU), over the shape grids of
``tests/test_kernels.py``.  On the CPU every port wrapper runs its kernel's
plain PyTorch version; the CUDA kernels themselves are held against those
plain versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: similarities within 1e-5 absolute (fp32 sums in another
order); argmax indices exact wherever the top-2 gap exceeds 1e-4; Eq. 1
values within 1e-6 relative (one exp2 and two products, each within an
ulp or two of XLA's), with identical +inf masks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import decision, ops, rac_value, ref, similarity_topk

SIM_ATOL = 1e-5
GAP = 1e-4
VALUE_RTOL = 1e-6


def _t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_top1(q, c, n_valid, got, want):
    (gv, gi), (wv, wi) = got, want
    gv, gi = np.asarray(gv), np.asarray(gi)
    wv, wi = np.asarray(wv), np.asarray(wi)
    assert gv.shape == wv.shape == gi.shape == (q.shape[0],)
    assert gi.dtype == np.int32
    np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=SIM_ATOL)
    scores = q.astype(np.float64) @ c[:n_valid].astype(np.float64).T
    if n_valid > 1:
        top2 = -np.sort(-scores, axis=1)[:, :2]
        clear = top2[:, 0] - top2[:, 1] > GAP
    else:
        clear = np.ones(q.shape[0], dtype=bool)
    np.testing.assert_array_equal(gi[clear], wi[clear])


def _assert_values(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=VALUE_RTOL, atol=0)


# ------------------------------------------------------------ sim_top1 (B1)
@pytest.mark.parametrize("q_n,c_n,d", [(1, 1, 32), (7, 100, 64),
                                       (37, 901, 64), (128, 512, 128),
                                       (130, 1500, 96)])
def test_sim_top1_matches_reference(rng, q_n, c_n, d):
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    c = rng.standard_normal((c_n, d)).astype(np.float32)
    got = ops.sim_top1(_t(q), _t(c))
    want = rops.sim_top1(jnp.asarray(q), jnp.asarray(c), use_pallas=True)
    _assert_top1(q, c, c_n, got, want)


@pytest.mark.parametrize("n_valid", [0, 1, 3, 700, 901])
def test_sim_top1_runtime_n_valid(rng, n_valid):
    q = _unit(rng, 37, 64)
    c = _unit(rng, 901, 64)
    gv, gi = ops.sim_top1(_t(q), _t(c), n_valid=n_valid)
    want = rops.sim_top1(jnp.asarray(q), jnp.asarray(c), n_valid=n_valid,
                         use_pallas=True)
    if n_valid == 0:
        # an all-masked row is (-inf, 0), as jnp.argmax and the TPU merge
        # give it (the kernel backend maps index 0 of a free row to a miss)
        assert np.isneginf(gv.numpy()).all() and (gi.numpy() == 0).all()
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want[1]))
        return
    _assert_top1(q, c, n_valid, (gv, gi), want)
    assert gi.numpy().max() < n_valid            # the free tail never wins


def test_sim_top1_ties_resolve_to_lower_index(rng):
    q = _unit(rng, 5, 64)
    row = _unit(rng, 1, 64)
    c = np.concatenate([_unit(rng, 3, 64) * -1.0, np.repeat(row, 40, 0)])
    # every query's best is the duplicated row when it faces the query
    q[:] = row
    gv, gi = ops.sim_top1(_t(q), _t(c))
    wv, wi = rops.sim_top1(jnp.asarray(q), jnp.asarray(c), use_pallas=True)
    np.testing.assert_array_equal(gi.numpy(), np.full(5, 3))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# ---------------------------------------------------- victim_value (B2)
@pytest.mark.parametrize("n,t", [(1, 1), (777, 33), (1024, 4), (2049, 100)])
def test_victim_value_matches_reference(rng, n, t):
    tsi = rng.random(n).astype(np.float32)
    tid = rng.integers(-1, t, n).astype(np.int32)
    occ = rng.integers(0, 2, n).astype(np.int32)
    tp = (rng.random(t) * 10).astype(np.float32)
    tl = rng.integers(0, 1000, t).astype(np.int32)
    for t_now in (1500, 2600):
        got = ops.victim_value(_t(tsi), _t(tid), _t(occ), _t(tp), _t(tl),
                               t_now, alpha=0.001)
        want = rops.victim_value(jnp.asarray(tsi), jnp.asarray(tid),
                                 jnp.asarray(occ), jnp.asarray(tp),
                                 jnp.asarray(tl), t_now, alpha=0.001,
                                 use_pallas=True)
        _assert_values(got, want)
        assert np.isposinf(got.numpy()[occ == 0]).all()


def test_victim_value_large_timestamps():
    """Clocks past float32's 2^24 integer range: the age is taken in int32
    before the cast, exactly as the reference's test_kernels checks."""
    base = 1 << 25
    args = (np.ones(64, np.float32), np.zeros(64, np.int32),
            np.ones(64, np.int32), np.asarray([2.0], np.float32),
            np.asarray([base + 1], np.int32))
    got = ops.victim_value(*map(_t, args), base + 10, alpha=0.1)
    want = rops.victim_value(*map(jnp.asarray, args), base + 10, alpha=0.1,
                             use_pallas=True)
    _assert_values(got, want)
    np.testing.assert_allclose(got.numpy(), 2.0 * 0.5 ** (0.1 * 9),
                               rtol=1e-5)


# -------------------------------------------------------- rac_value (B3)
@pytest.mark.parametrize("n,t", [(1, 1), (777, 33), (1024, 4), (2049, 100)])
def test_rac_value_matches_reference(rng, n, t):
    tsi = rng.random(n).astype(np.float32)
    tid = rng.integers(0, t, n).astype(np.int32)
    tp = (rng.random(t) * 10).astype(np.float32)
    tl = rng.integers(0, 1000, t).astype(np.int32)
    got = ops.rac_value(_t(tsi), _t(tid), _t(tp), _t(tl), 0.001, 1500)
    want = rops.rac_value(jnp.asarray(tsi), jnp.asarray(tid),
                          jnp.asarray(tp), jnp.asarray(tl), 0.001, 1500,
                          use_pallas=True)
    _assert_values(got, want)


def test_rac_value_masked_matches_reference(rng):
    n, t = 900, 17
    tsi = rng.random(n).astype(np.float32)
    tid = rng.integers(0, t, n).astype(np.int32)
    tp = (rng.random(t) * 10).astype(np.float32)
    tl = -rng.integers(0, 1000, t).astype(np.int32)     # shifted: t_now = 0
    valid = rng.random(n) < 0.7
    got = ops.rac_value_masked(_t(tsi), _t(tid), _t(tp), _t(tl), _t(valid),
                               0.01, 0)
    want = rops.rac_value_masked(jnp.asarray(tsi), jnp.asarray(tid),
                                 jnp.asarray(tp), jnp.asarray(tl),
                                 jnp.asarray(valid), 0.01, 0,
                                 use_pallas=True)
    _assert_values(got, want)
    assert np.isposinf(got.numpy()[~valid]).all()


# ------------------------------------------------- composed dispatches
def _decision_inputs(rng):
    return dict(
        q=_unit(rng, 13, 64), slab=_unit(rng, 300, 64),
        reps=_unit(rng, 40, 64), tsi=rng.random(300).astype(np.float32),
        tid=rng.integers(-1, 40, 300).astype(np.int32),
        occ=rng.integers(0, 2, 300).astype(np.int32),
        tp=(rng.random(40) * 5).astype(np.float32),
        tl=rng.integers(0, 500, 40).astype(np.int32))


def test_fused_decide_matches_reference(rng):
    x = _decision_inputs(rng)
    before = dict(ops.dispatch_stats)
    got = ops.fused_decide(_t(x["q"]), _t(x["slab"]), 260, _t(x["reps"]), 33,
                           _t(x["tsi"]), _t(x["tid"]), _t(x["occ"]),
                           _t(x["tp"]), _t(x["tl"]), 700, alpha=0.001)
    # one fused dispatch per call, as in the reference ledger
    assert ops.dispatch_stats["launches"] == before["launches"] + 1
    want = rops.fused_decide(*(jnp.asarray(x[k]) for k in ("q", "slab")),
                             260, jnp.asarray(x["reps"]), 33,
                             *(jnp.asarray(x[k]) for k in
                               ("tsi", "tid", "occ", "tp", "tl")),
                             700, alpha=0.001, use_pallas=True)
    _assert_top1(x["q"], x["slab"], 260, got[:2], want[:2])
    _assert_top1(x["q"], x["reps"], 33, got[2:4], want[2:4])
    _assert_values(got[4], want[4])


def test_decide_aux_matches_reference(rng):
    x = _decision_inputs(rng)
    got = ops.decide_aux(_t(x["q"]), _t(x["reps"]), 40, _t(x["tsi"]),
                         _t(x["tid"]), _t(x["occ"]), _t(x["tp"]),
                         _t(x["tl"]), 650, alpha=0.002)
    want = rops.decide_aux(jnp.asarray(x["q"]), jnp.asarray(x["reps"]), 40,
                           *(jnp.asarray(x[k]) for k in
                             ("tsi", "tid", "occ", "tp", "tl")),
                           650, alpha=0.002, use_pallas=True)
    _assert_top1(x["q"], x["reps"], 40, got[:2], want[:2])
    _assert_values(got[2], want[2])


def test_ops_accept_numpy_and_return_caller_shapes(rng):
    """numpy inputs follow the CPU; nothing is padded on the way out."""
    q, c = _unit(rng, 9, 48), _unit(rng, 70, 48)
    v, i = ops.sim_top1(q, c, n_valid=50)
    assert v.shape == i.shape == (9,) and v.dtype == torch.float32
    assert ops.to_host(i).max() < 50


# --------------------------------------------------- wrapper contract
def test_cpu_wrappers_run_plain_versions_and_launch_nothing(rng):
    counts = (similarity_topk.launches, decision.launches,
              rac_value.launches)
    q, c = _t(_unit(rng, 4, 32)), _t(_unit(rng, 20, 32))
    got = similarity_topk.sim_top1(q, c, 20)
    want = ref.sim_top1_ref(q, c, 20)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    decision.victim_value(_t(np.ones(3, np.float32)),
                          _t(np.zeros(3, np.int32)), _t(np.ones(3, np.int32)),
                          _t(np.ones(1, np.float32)),
                          _t(np.zeros(1, np.int32)), 5, 0.1)
    rac_value.rac_value(_t(np.ones(3, np.float32)), _t(np.zeros(3, np.int32)),
                        _t(np.ones(1, np.float32)),
                        _t(np.zeros(1, np.float32)), 0.1, 0)
    assert (similarity_topk.launches, decision.launches,
            rac_value.launches) == counts


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "device", "width"])
def test_sim_top1_wrapper_rejects_malformed_input(rng, bad):
    q, c = _t(_unit(rng, 4, 32)), _t(_unit(rng, 20, 32))
    if bad == "dtype":
        q = q.double()
    elif bad == "contiguity":
        c = _t(_unit(rng, 32, 20)).T
    elif bad == "device":
        q = torch.empty((4, 32), device="meta")
    else:
        q = _t(_unit(rng, 4, 16))
    with pytest.raises(ValueError):
        similarity_topk.sim_top1(q, c, 20)


def test_non_cpu_non_cuda_tensors_never_fall_back():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        similarity_topk.sim_top1(torch.empty((2, 8), **meta),
                                 torch.empty((5, 8), **meta), 5)
    with pytest.raises(ValueError, match="unsupported device"):
        decision.victim_value(torch.empty(3, **meta),
                              torch.empty(3, dtype=torch.int32, **meta),
                              torch.empty(3, dtype=torch.int32, **meta),
                              torch.empty(1, **meta),
                              torch.empty(1, dtype=torch.int32, **meta), 0,
                              0.1)


@pytest.mark.parametrize("nq,nc,small", [(8, 65_537, True),
                                         (512, 65_537, False),
                                         (512, 4_096, False), (1, 1, True),
                                         (3, 200, True)])
def test_split_plan_covers_every_candidate_tile(nq, nc, small):
    nsplit, per = similarity_topk.split_plan(nq, nc, small)
    cols = 128 if small else 64
    tiles = -(-nc // cols)
    assert 1 <= nsplit <= tiles
    assert nsplit * per >= tiles > (nsplit - 1) * per   # no empty split
