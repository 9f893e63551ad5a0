"""The Top-1 kernel's three-way TF32 arithmetic (``csrc/sim_top1.cu``),
emulated in numpy on the CPU and held to the accuracy it must keep.

Each fp32 operand x is split into hi = x rounded to TF32 (add 2^12 to the
bits, clear the low 13) and lo = (x - hi) rounded the same way.  Per
8-deep k step the tensor core adds hi_q.hi_c, hi_q.lo_c and lo_q.hi_c
(exact products of TF32 values) into a chunk accumulator, and every
32-deep chunk is added to the score in IEEE fp32.  How the tensor core
rounds its own sums is not documented: the emulation takes the worse of
the two plausible models, rounding to nearest or toward zero after every
product group.  Against a float64 product of the same unit rows, the
largest and the mean error must stay within twice those of the IEEE fp32
fmaf chain the kernel replaced (the card test
``test_sim_top1_error_against_float64`` holds the kernel itself to the same
bound).  Without the per-chunk fold the toward-zero model misses that
bound several times over, which is why the kernel folds.
"""
import numpy as np
import pytest


def _tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32, nearest with ties away from zero (bit mask)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _round(x64: np.ndarray, toward_zero: bool) -> np.ndarray:
    f = x64.astype(np.float32)
    if toward_zero:
        over = np.abs(f.astype(np.float64)) > np.abs(x64)
        f[over] = np.nextafter(f[over], np.float32(0))
    return f


def split_tf32_scores(q, c, toward_zero: bool, fold: int = 32):
    """The kernel's scores of every (query, row) pair, emulated; ``fold``
    is the depth after which the chunk accumulator joins the score."""
    qh, ch = _tf32(q), _tf32(c)
    ql, cl = _tf32(q - qh), _tf32(c - ch)
    score = np.zeros((q.shape[0], c.shape[0]), np.float32)
    acc = np.zeros_like(score)
    d = q.shape[1]
    for k0 in range(0, d, 8):
        k = slice(k0, k0 + 8)
        for a, b in ((qh, ch), (qh, cl), (ql, ch)):
            acc = _round(acc.astype(np.float64)
                         + a[:, k].astype(np.float64)
                         @ b[:, k].astype(np.float64).T, toward_zero)
        if (k0 + 8) % fold == 0 or k0 + 8 >= d:
            score = (score.astype(np.float64)
                     + acc.astype(np.float64)).astype(np.float32)
            acc[:] = 0
    return score


def fmaf_chain(q, c):
    acc = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for k in range(q.shape[1]):
        acc = (acc.astype(np.float64) + np.outer(
            q[:, k].astype(np.float64), c[:, k])).astype(np.float32)
    return acc


def _rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(d, seed=0):
    """48 queries against 96 unit rows, the first 32 near duplicates of
    queries (cosines ~0.96, the hit regime), the rest random."""
    rng = np.random.default_rng(seed)
    q = _rows(rng, 48, d)
    c = _rows(rng, 96, d)
    c[:32] = q[:32] + 0.3 * c[:32]
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c = c.astype(np.float32)
    return q, c, q.astype(np.float64) @ c.astype(np.float64).T


@pytest.mark.parametrize("toward_zero", [False, True])
@pytest.mark.parametrize("d", [768, 770])
def test_three_way_tf32_is_within_twice_the_fmaf_chain(d, toward_zero):
    q, c, exact = _case(d)
    err = np.abs(split_tf32_scores(q, c, toward_zero) - exact)
    chain = np.abs(fmaf_chain(q, c) - exact)
    assert err.max() <= 2 * chain.max(), (err.max(), chain.max())
    assert err.mean() <= 2 * chain.mean(), (err.mean(), chain.mean())


def test_without_the_fold_a_truncating_accumulator_is_not():
    q, c, exact = _case(768)
    err = np.abs(split_tf32_scores(q, c, True, fold=10 ** 9) - exact)
    chain = np.abs(fmaf_chain(q, c) - exact)
    assert err.max() > 2 * chain.max()


@pytest.mark.parametrize("d", [768, 770])
def test_the_split_is_exact_up_to_2_to_the_minus_22(d):
    """hi and lo are TF32 values (their low 13 bits clear), x - hi is
    exact, and hi + lo is x within 2^-22 |x|."""
    x = _rows(np.random.default_rng(1), 64, d)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    for t in (hi, lo):
        assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
    resid = x.astype(np.float64) - hi.astype(np.float64)
    assert np.array_equal(resid.astype(np.float32).astype(np.float64), resid)
    gap = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                 - lo.astype(np.float64))
    assert (gap <= 2.0 ** -22 * np.abs(x)).all()
