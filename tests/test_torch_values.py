"""The Eq. 1 kernels' launch plan and plain versions (B2, B3, B7) on the CPU.

The CUDA kernels (``csrc/eq1_value.cuh``) walk their entries by
:func:`repro_torch.kernels.decision.value_plan`: V-wide chunks where every
base is 16-byte aligned, the rest one at a time, in one wave of blocks.
The walk is emulated here in numpy and must cover every entry exactly
once.  The plain versions, which the wrappers take on the CPU and which
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernels to on
the card, are held to the reference's Pallas kernels (interpret mode) at
the main path's, the arena's and the serve phase's shapes.

Tolerance: rtol 1e-6 with identical +inf masks (one exp2 and two products,
each within an ulp or two of XLA's).  XLA's exp2 on the CPU drifts from the
exact value as its argument grows (about 6e-7 at -16, 2.1e-6 at -72,
measured against float64 with JAX 0.9), so the reference comparisons keep
alpha * age within 8 (the reference's own tests stay within 3); the
port's plain versions are held to float64 over the main path's whole age
range (up to 72,000 requests at alpha = 0.001) by
``test_plain_eq1_matches_float64_at_every_age``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import decision, ops, rac_value

VALUE_RTOL = 1e-6
_NS = [0, 1, 3, 4, 5, 7, 8, 255, 256, 257, 1_023, 1_024, 1_025, 6_852,
       65_537]
# the blocks the card holds at once: one SM's worth, a few, an H100's at
# 8 blocks an SM (256 threads), and a staged table's at one an SM
_SLOTS = [1, 7, 132, 1_056]


def _walk(n: int, blocks: int, n_vec: int, v: int, threads: int):
    """How many times the kernel's walk visits each entry: thread g of the
    grid takes chunks g, g + stride, ... below n_vec / v, then entries
    n_vec + g, n_vec + g + stride, ... below n."""
    stride = blocks * threads
    seen = np.zeros(n, np.int64)
    g = np.arange(stride)
    chunks = n_vec // v
    for k in range(-(-chunks // stride)):
        c = g + k * stride
        c = c[c < chunks]
        np.add.at(seen, (c[:, None] * v + np.arange(v)).ravel(), 1)
    for k in range(-(-(n - n_vec) // stride)):
        i = n_vec + g + k * stride
        np.add.at(seen, i[i < n], 1)
    return seen


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("n", _NS)
def test_value_plan_covers_every_entry_once_in_one_wave(n, off):
    """Bases ``off`` entries past a 16-byte boundary: off 0 takes the
    vector path, 1-3 the scalar walk; either way each entry once, at most
    one wave of blocks, and no block without work."""
    for v, threads in ((4, 256), (4, 64), (8, 128), (8, 32)):
        for slots in _SLOTS:
            blocks, n_vec = decision.value_plan(n, off == 0, slots, v,
                                                threads)
            assert 1 <= blocks <= slots
            assert n_vec == (n - n % v if off == 0 else 0)
            work = n_vec // v + n - n_vec
            assert blocks == max(1, min(slots, -(-work // threads)))
            # every block's first thread has work (grid.x no wider than
            # the work): no block waits for nothing
            assert (blocks - 1) * threads < max(work, 1)
            assert (_walk(n, blocks, n_vec, v, threads) == 1).all()


@pytest.mark.parametrize("n_topics,aligned,want", [
    (4_096, True, True), (256, True, True),
    (24_576, True, True),                  # 192 KB: the budget, exactly
    (24_580, True, False),                 # past it: gathered
    (131_072, True, False), (33, True, False),       # T % 4 != 0
    (4_096, False, False)])                # bases off 16 bytes
def test_stage_plan(monkeypatch, n_topics, aligned, want):
    assert decision.stage_plan(n_topics, aligned) is want
    monkeypatch.setattr(decision, "STAGE_MAX", 0)
    assert decision.stage_plan(n_topics, aligned) is False


def test_packed_arguments_fill_the_kernels_struct():
    """Eq1Args (csrc/eq1_value.cuh) is 7 pointers, 11 ints and 2 floats,
    112 bytes with its padding."""
    assert decision._ARGS.size == 112


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_values(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=VALUE_RTOL, atol=0)


def _tables(rng, shape, t, t_now=72_000, max_age=8_000):
    """Slot tables of ``shape`` (tid -1 and occ 0 included) and topic
    tables of T entries a row, last touched up to ``max_age`` before
    ``t_now``."""
    tshape = shape[:-1] + (t,)
    tsi = (rng.random(shape) * 8).astype(np.float32)
    tid = rng.integers(-1, t, shape).astype(np.int32)
    occ = (rng.random(shape) < 0.9).astype(np.int32)
    tp = (rng.random(tshape) * 20).astype(np.float32)
    tl = (t_now - rng.integers(0, max_age, tshape)).astype(np.int32)
    return tsi, tid, occ, tp, tl


# (N, T) of the main path, the arena and the serve phase (B2 at capacity
# 64 + 1 slots)
_SHAPES = [(65_537, 4_096), (6_852, 4_096), (65, 256)]


@pytest.mark.parametrize("base", [0, 1 << 25])
@pytest.mark.parametrize("n,t", _SHAPES)
def test_victim_value_plain_matches_reference(rng, n, t, base):
    """B2 with free slots (tid -1, occ 0) and clocks past 2^24 (the age is
    taken in int32 before the cast)."""
    t_now = base + 72_000
    tsi, tid, occ, tp, tl = _tables(rng, (n,), t, t_now)
    got = ops.victim_value(_t(tsi), _t(tid), _t(occ), _t(tp), _t(tl), t_now,
                           alpha=0.001)
    want = rops.victim_value(*map(jnp.asarray, (tsi, tid, occ, tp, tl)),
                             t_now, alpha=0.001, use_pallas=True)
    _assert_values(got, want)
    assert np.isposinf(got.numpy()[occ == 0]).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,t", [(65_537, 4_096), (6_852, 4_096),
                                 (64, 256)])
def test_rac_value_plain_matches_reference(rng, n, t, masked):
    """B3 as the backend calls it (``backends.py::_value_args``): t_now
    shifted to 0 and t_last - t_now as int32, cast to f32 before the
    subtraction, as the TPU kernel does; with a validity mask, the
    reference's rac_value_masked."""
    tsi, tid, occ, tp, tl = _tables(rng, (n,), t)
    tid = np.maximum(tid, 0)
    tls = (tl - 72_000).astype(np.int32)
    valid = occ > 0
    if masked:
        got = ops.rac_value_masked(_t(tsi), _t(tid), _t(tp), _t(tls),
                                   _t(valid), 0.001, 0)
        want = rops.rac_value_masked(*map(jnp.asarray, (tsi, tid, tp, tls,
                                                        valid)),
                                     0.001, 0, use_pallas=True)
        assert np.isposinf(got.numpy()[~valid]).all()
    else:
        got = ops.rac_value(_t(tsi), _t(tid), _t(tp), _t(tls), 0.001, 0)
        want = rops.rac_value(*map(jnp.asarray, (tsi, tid, tp, tls)), 0.001,
                              0, use_pallas=True)
    _assert_values(got, want)
    if not masked:
        # the f32 table the wrapper also takes gives the same bits
        f32 = ops.rac_value(_t(tsi), _t(tid), _t(tp),
                            _t(tls.astype(np.float32)), 0.001, 0)
        assert torch.equal(got, f32)


def test_victim_value_multi_plain_matches_reference(rng):
    """B7 at the arena's shape: P = 15 policies' tables in one call."""
    tsi, tid, occ, tp, tl = _tables(rng, (15, 6_852), 4_096)
    got = ops.victim_value_multi(*map(_t, (tsi, tid, occ, tp, tl)), 72_000,
                                 alpha=0.001)
    want = rops.victim_value_multi(*map(jnp.asarray, (tsi, tid, occ, tp,
                                                      tl)),
                                   72_000, alpha=0.001, use_pallas=True)
    _assert_values(got, want)


@pytest.mark.parametrize("kind", ["victim_value", "rac_value"])
def test_plain_eq1_matches_float64_at_every_age(rng, kind):
    """Ages up to the main replay's 72,000 requests (alpha 0.001: exponents
    to -72): the plain versions within 1e-6 of float64 evaluated on the
    same f32 exponent (the kernel's -alpha * age in f32) and the same f32
    operands."""
    n, t = 65_537, 4_096
    tsi, tid, occ, tp, tl = _tables(rng, (n,), t, max_age=72_000)
    tid0 = np.maximum(tid, 0)
    if kind == "victim_value":
        got = ops.victim_value(*map(_t, (tsi, tid, occ, tp, tl)), 72_000,
                               alpha=0.001).numpy()
    else:
        got = ops.rac_value(_t(tsi), _t(tid0), _t(tp),
                            _t((tl - 72_000).astype(np.int32)), 0.001,
                            0).numpy()
        occ = np.ones_like(occ)
    age = (72_000 - tl[tid0]).astype(np.float32)
    x = (np.float32(-0.001) * age).astype(np.float32)
    want = np.exp2(x.astype(np.float64)) * tp[tid0] * tsi
    want = np.where(occ > 0, want, np.inf)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isposinf(got), ~fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=VALUE_RTOL, atol=0)


@pytest.mark.parametrize("bad", ["tid", "occ", "t_last", "valid"])
def test_value_wrappers_refuse_mismatched_tables_on_the_cpu(rng, bad):
    """A table of another length raises before any kernel or plain
    version runs (a kernel would read past its end)."""
    tsi, tid, occ, tp, tl = map(_t, _tables(rng, (40,), 8))
    valid = occ > 0
    if bad == "tid":
        tid = tid[:39]
    elif bad == "occ":
        occ = occ[:39]
    elif bad == "t_last":
        tl = tl[:7]
    else:
        valid = valid[:39]
    with pytest.raises(ValueError):
        if bad == "occ":
            decision.victim_value(tsi, tid, occ, tp, tl, 5, 0.1)
        elif bad == "valid":
            rac_value.rac_value(tsi, tid.clamp(min=0), tp, tl, 0.1, 0,
                                valid)
        else:
            decision.victim_value(tsi, tid, occ, tp, tl, 5, 0.1)
            rac_value.rac_value(tsi, tid.clamp(min=0), tp, tl, 0.1, 0)
