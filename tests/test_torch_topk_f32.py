"""The fp32 Top-K (``csrc/sim_topk_f32.cu``), as far as the CPU can hold it:
the score's arithmetic, the split plan, and an emulation of the kernels'
folds and merges in plain Python.

- Arithmetic: a score is one fp32 fmaf chain from +0 in ascending depth.
  ``_fmaf`` computes fmaf exactly on the CPU (the float64 product of two
  float32 values is exact, TwoSum gives the float64 sum's error, and the
  one case where rounding that sum to float32 differs from rounding the
  exact value, a float32 midpoint, goes the way the error points).  The
  routing matrix's padded 16-byte pitch (772 floats for D + 1 = 769) and
  the kernel's 32-deep chunks only add fmaf(0, 0, acc) steps, so the chain
  gives the same bits as the unpadded ascending chain at 769 and as the
  replaced kernel's 16-deep chunks; the chain is held to the reference's
  ``route_topics`` / ``sim_topk`` (XLA's dot) within 1e-5.
- Fold and merge: the emulation follows the kernels step by step on
  tie-heavy score matrices (rows drawn from a few distinct values): the
  skinny kernel's warps over interleaved 32-row tiles, each list across a
  warp's lanes folding one 32-column step at a time (a ballot against the
  K-th score, then insertions behind every entry >= the new one), the
  block's warps merged with the merge path; K > 32 in parked rounds whose
  candidates are sorted by the bitonic network and merged in one pass;
  the wide kernel's rows over 128-column tiles; then the split merge
  (lane ladders for K <= 8, merge_lists for K > 8).  Held bit for bit to
  ``ref.sim_topk_ref``'s order on the same scores, and through the scores
  to the reference's ``sim_topk`` (Pallas in interpret mode) with its
  tolerance.  The card runs the kernels against the plain version
  (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.similarity_topk import f32_plan

NEG = float("-inf")
IMAX = 2 ** 31 - 1
ROWS, WIDE, KREG = 32, 128, 32


def _fmaf(a, b, c):
    """float32 fmaf(a, b, c), rounded once (see the module docstring)."""
    a64, b64, c64 = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a64 * b64                           # exact
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)         # p + c = s + e exactly
    r = s.astype(np.float32)
    side = np.where(s > r.astype(np.float64), np.inf, -np.inf)
    other = np.nextafter(r, side.astype(np.float32))
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2 == s
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(mid & (e > 0), up, np.where(mid & (e < 0), down, r))


def test_fmaf_rounds_once():
    # 1 + 2^-24 is a float32 midpoint; the float64 sum lands on it while the
    # exact value lies above (or below) it
    one = np.float32(1.0)
    tiny = np.float32(2.0 ** -24)
    eps = np.float32(2.0 ** -60)
    assert _fmaf(tiny, one, one) == np.float32(1.0)           # tie to even
    assert _fmaf(np.float32(1 + 2.0 ** -23), tiny, one) \
        == np.nextafter(one, np.float32(2))
    assert _fmaf(np.float32(2.0 ** -30), eps, np.float32(3.0)) \
        == np.float32(3.0)


def _chain(q, c, depth):
    """The kernel's score: fmaf in ascending depth from +0 over ``depth``
    columns (columns past D read as zeros)."""
    nq, d = q.shape
    acc = np.zeros((nq, c.shape[0]), np.float32)
    for k in range(depth):
        a = q[:, k] if k < d else np.zeros(nq, np.float32)
        b = c[:, k] if k < d else np.zeros(c.shape[0], np.float32)
        acc = _fmaf(a[:, None], b[None, :], acc)
    return acc


def _route_inputs(rng, nq, t, d):
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    aug = np.zeros((t, d + 1), np.float32)
    reps = rng.standard_normal((t, d)).astype(np.float32)
    aug[:, :d] = reps / np.linalg.norm(reps, axis=1, keepdims=True)
    aug[:, d] = rng.uniform(0.05, 0.6, t)
    qa = np.concatenate(
        [q, np.sqrt((q * q).sum(1, dtype=np.float32))[:, None]], axis=1)
    return q, aug, qa


@pytest.mark.parametrize("d", [64, 768])
def test_padded_route_pitch_gives_the_unpadded_chain_bits(rng, d):
    q, aug, qa = _route_inputs(rng, 3, 40, d)
    exact = _chain(qa, aug, d + 1)                   # the unpadded chain
    # the mirror's 16-byte pitch, the kernel's 32-deep chunks, the
    # replaced kernel's 16-deep chunks
    for depth in (-(-(d + 1) // 4) * 4, -(-(d + 1) // 32) * 32,
                  -(-(d + 1) // 16) * 16):
        np.testing.assert_array_equal(_chain(qa, aug, depth), exact)
    # the padded view the device mirror hands out takes the same path as a
    # contiguous copy, and agrees with the reference's routing
    pitch = -(-(d + 1) // 4) * 4
    padded = torch.zeros((40, pitch))
    padded[:, :d + 1] = torch.from_numpy(aug)
    view = padded[:, :d + 1]
    got = ops.route_topics(torch.from_numpy(q), view, 2, n_valid=40)
    flat = ops.route_topics(torch.from_numpy(q), torch.from_numpy(aug), 2,
                            n_valid=40)
    for g, f in zip(got, flat):
        assert torch.equal(g, f)
    want_v, want_i = rops.route_topics(jnp.asarray(q), jnp.asarray(aug), 2,
                                       use_pallas=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_v), atol=1e-5)
    top = np.sort(exact, axis=1)[:, ::-1][:, :3]
    np.testing.assert_allclose(top, np.asarray(want_v), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_i))


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("nq,limit,k,n_sm,wave,want", [
    # the pruned lookup's route: one warp a block, a tile each, 128 blocks
    (1, 4_096, 3, 132, 16 * 132, (1, 128, 1)),
    # the slab at Q = 8: four warps, one wave of two blocks an SM
    (8, 65_537, 8, 132, 264, (4, 257, 8)),
    # k = 257: one wave of one block an SM, no split below K candidates
    (8, 65_537, 257, 132, 132, (4, 129, 16)),
    (8, 2_000, 257, 132, 132, (1, 7, 9)),
    # the route at Q = 512: the wide kernel, 4 query tiles x 32 splits
    (512, 4_096, 3, 132, 132, (1, 32, 1)),
    (16, 10, 3, 132, 500, (1, 1, 1)), (3, 0, 1, 132, 500, (1, 1, 1))])
def test_f32_plan_fills_one_wave(nq, limit, k, n_sm, wave, want):
    warps, nsplit, per = f32_plan(nq, limit, k, n_sm, lambda w: wave)
    assert (warps, nsplit, per) == want
    rows = ROWS if nq <= 16 else WIDE
    tiles = max(1, -(-limit // rows))
    assert nsplit * per >= tiles > (nsplit - 1) * per
    q_tiles = 1 if nq <= 16 else -(-nq // WIDE)
    assert q_tiles * nsplit <= max(wave, q_tiles)


# ------------------------------------------------------ the fold emulation
def _ahead(a, b):
    """(value, index) a before b: value descending, index ascending."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_path(a, na, b, nb, k):
    """csrc/topk_fold.cuh::merge_path: each lane's run of outputs starts
    where a binary search along the merge path puts it, then walks."""
    nc = min(na + nb, k)
    run = -(-nc // 32)
    out = [None] * nc
    for lane in range(32):
        s0, s1 = min(nc, lane * run), min(nc, lane * run + run)
        lo, hi = max(0, s0 - nb), min(s0, na)
        while lo < hi:
            mid = (lo + hi) // 2
            if _ahead(a[mid], b[s0 - mid - 1]):
                lo = mid + 1
            else:
                hi = mid
        i, j = lo, s0 - lo
        for s in range(s0, s1):
            take_a = i < na and (j >= nb or _ahead(a[i], b[j]))
            out[s] = a[i] if take_a else b[j]
            i, j = i + take_a, j + (not take_a)
    return out


def _warp_sort(x):
    """csrc/topk_fold.cuh::warp_sort: the bitonic network, best first."""
    x = list(x)
    n2 = len(x)
    size = 2
    while size <= n2:
        stride = size // 2
        while stride > 0:
            for t in range(n2 // 2):
                lo = 2 * t - (t & (stride - 1))
                hi = lo + stride
                best_first = (lo & size) == 0
                if _ahead(x[hi], x[lo]) == best_first:
                    x[lo], x[hi] = x[hi], x[lo]
            stride //= 2
        size *= 2
    return x


def _fold_reg(lst, vals, cols, live, k):
    """sim_topk_f32.cu::fold_reg: one 32-column step into a warp's list,
    the ballot taken again after each insertion."""
    thr = lst[k - 1][0] if len(lst) == k else NEG
    m = {j for j in range(len(vals)) if live[j] and vals[j] > thr}
    while m:
        lane = min(m)
        cv = vals[lane]
        p = sum(v >= cv for v, _ in lst)
        lst.insert(p, (cv, cols[lane]))
        del lst[k:]
        thr = lst[k - 1][0] if len(lst) == k else NEG
        m = {j for j in m if j > lane and live[j] and vals[j] > thr}


def _fold_batch(lst, row, c0, col_end, k):
    """sim_topk_f32.cu::fold_batch: the round's columns that beat the K-th
    score, sorted by the network, merged in one pass."""
    thr = lst[k - 1][0] if len(lst) == k else NEG
    cand = [(float(v), c0 + j) for j, v in enumerate(row)
            if c0 + j < col_end and v > thr]
    if not cand:
        return lst
    m2 = 1
    while m2 < len(cand):
        m2 *= 2
    srt = _warp_sort(cand + [(NEG, IMAX)] * (m2 - len(cand)))
    return _merge_path(lst, len(lst), srt, len(cand), k)


def _pad(lst, k, fill):
    return lst + [fill] * (k - len(lst))


def _skinny_split(scores, split, per, tiles, limit, warps, k):
    nq = scores.shape[0]
    t_begin = split * per
    t_end = min(t_begin + per, tiles)
    col_end = min(limit, t_end * ROWS)
    span = max(0, t_end - t_begin)
    if k <= KREG:
        lists = [[[] for _ in range(nq)] for _ in range(warps)]
        for w in range(warps):
            for r in range(max(0, -(-(span - w) // warps))):
                cols = [(t_begin + r * warps + w) * ROWS + j
                        for j in range(ROWS)]
                live = [c < col_end for c in cols]
                for i in range(nq):
                    vals = [scores[i, c] if c < scores.shape[1] else 0.0
                            for c in cols]
                    _fold_reg(lists[w][i], vals, cols, live, k)
        out = []
        for i in range(nq):
            acc = _pad(lists[0][i], k, (NEG, IMAX))
            for w in range(1, warps):
                acc = _merge_path(acc, k, _pad(lists[w][i], k, (NEG, IMAX)),
                                  k, k)
            out.append([(v, c if v > NEG else 0) for v, c in acc])
        return out
    lists = [[] for _ in range(nq)]
    for r in range(-(-span // warps)):
        c0 = (t_begin + r * warps) * ROWS
        for i in range(nq):
            row = [scores[i, c] if c < col_end else NEG
                   for c in range(c0, c0 + warps * ROWS)]
            lists[i] = _fold_batch(lists[i], row, c0, col_end, k)
    return [_pad(lst, k, (NEG, 0)) for lst in lists]


def _wide_split(scores, split, per, tiles, limit, k):
    nq = scores.shape[0]
    t_begin = split * per
    t_end = min(t_begin + per, tiles)
    col_end = min(limit, t_end * WIDE)
    out = []
    for i in range(nq):
        lst = []
        for t in range(t_begin, t_end):
            c0 = t * WIDE
            row = [scores[i, c] if c < col_end else NEG
                   for c in range(c0, c0 + WIDE)]
            if k <= KREG:
                for base in range(0, WIDE, 32):
                    cols = list(range(c0 + base, c0 + base + 32))
                    _fold_reg(lst, row[base:base + 32], cols,
                              [c < col_end for c in cols], k)
            else:
                lst = _fold_batch(lst, row, c0, col_end, k)
        out.append(_pad(lst, k, (NEG, 0)))
    return out


def _merge_splits(parts, k):
    """The split merge of one row: merge_rows (K <= 8) or merge_lists."""
    if k <= 8:
        lanes = [[] for _ in range(32)]
        for lane in range(32):
            lst = [(NEG, IMAX)] * 8
            for s in range(lane, len(parts), 32):
                for v, c in parts[s]:
                    if not v > lst[7][0]:
                        break
                    p = sum(x >= v for x, _ in lst)
                    lst.insert(p, (v, c))
                    del lst[8:]
            lanes[lane] = lst
        out = []
        for _ in range(k):
            best = min((lst[0] for lst in lanes), key=lambda h: (-h[0], h[1]))
            for lst in lanes:
                if lst[0] == best:
                    lst.pop(0)
                    lst.append((NEG, IMAX))
            out.append((best[0], best[1] if best[0] > NEG else 0))
        return out
    nb = 8 if k <= 64 else 2                   # lists a batch copies
    fit = 227 * 1024 // ((2 + 2 * nb) * 8 * k)
    mw = next((w for w in (16, 8, 4, 2) if fit >= w), fit)
    own = []
    for w in range(mw):
        lst = []
        for s0 in range(w, len(parts), mw * nb):      # a batch at a time
            for s in range(s0, min(len(parts), s0 + mw * nb), mw):
                lst = _merge_path(lst, len(lst), parts[s], k, k)
        own.append(lst)
    step = 1
    while step < mw:
        for w in range(0, mw, 2 * step):
            if w + step < mw:
                own[w] = _merge_path(own[w], len(own[w]), own[w + step],
                                     len(own[w + step]), k)
        step *= 2
    lst = own[0]
    return [(v, c) if j < len(lst) and v > NEG else (NEG, 0)
            for j, (v, c) in enumerate(_pad(lst, k, (NEG, 0)))]


def _emulate(scores, n_valid, k, n_sm, wave):
    nq, nc = scores.shape
    limit = max(0, min(n_valid, nc))
    warps, nsplit, per = f32_plan(nq, limit, k, n_sm, lambda w: wave)
    skinny = nq <= 16
    tiles = -(-limit // (ROWS if skinny else WIDE))
    parts = []
    for split in range(nsplit):
        if skinny:
            parts.append(_skinny_split(scores, split, per, tiles, limit,
                                       warps, k))
        else:
            parts.append(_wide_split(scores, split, per, tiles, limit, k))
    out_v = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for i in range(nq):
        merged = _merge_splits([p[i] for p in parts], k)
        out_v[i] = [v for v, _ in merged]
        out_i[i] = [c for _, c in merged]
    return out_v, out_i, nsplit


def _tied(rng, n, d, distinct):
    """Unit rows drawn from a few distinct ones: many exactly equal
    scores."""
    base = rng.standard_normal((distinct, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    return base[rng.integers(0, distinct, n)]


@pytest.mark.parametrize("nq,nc,n_valid,k,n_sm,wave", [
    # skinny: register lists (K <= 32), one and several warps a block
    (1, 700, 700, 1, 4, 40), (3, 700, 650, 3, 4, 40),
    (8, 1_500, 1_499, 8, 4, 40), (16, 1_300, 1_300, 16, 4, 12),
    (5, 500, 33, 8, 4, 40), (2, 400, 0, 3, 4, 40), (4, 40, 40, 40, 4, 40),
    # skinny, K > 32: parked rounds and batched merges
    (8, 1_800, 1_790, 257, 4, 8), (3, 700, 700, 257, 4, 40),
    (2, 300, 280, 300, 4, 40),
    # wide (Q > 16): lists kept across tiles, and batched merges
    (20, 900, 850, 3, 4, 8), (20, 700, 700, 16, 4, 8),
    (18, 600, 600, 257, 4, 8)])
def test_emulated_fold_and_merge_match_the_plain_version(
        rng, nq, nc, n_valid, k, n_sm, wave):
    d = 32
    q = _tied(rng, nq, d, 3)
    c = _tied(rng, nc, d, 7)
    scores = _chain(q, c, d)
    got_v, got_i, _ = _emulate(scores, n_valid, min(k, nc), n_sm, wave)
    want_v, want_i = ref._topk_sorted(
        ref._mask_cols(torch.from_numpy(scores), n_valid), min(k, nc))
    fin = np.isfinite(want_v.numpy())
    np.testing.assert_array_equal(np.isneginf(got_v),
                                  np.isneginf(want_v.numpy()))
    np.testing.assert_array_equal(got_v[fin], want_v.numpy()[fin])
    np.testing.assert_array_equal(got_i[fin], want_i.numpy()[fin])
    assert (got_i[~fin] == 0).all()
    # the same rows through the reference (Pallas in interpret mode)
    if n_valid == nc:
        rv, ri = rops.sim_topk(jnp.asarray(q), jnp.asarray(c), min(k, nc),
                               use_pallas=True)
        np.testing.assert_allclose(got_v, np.asarray(rv), atol=1e-5)


def test_emulation_splits_where_the_kernel_would():
    scores = np.zeros((8, 1_800), np.float32)
    *_, nsplit = _emulate(scores, 1_800, 257, 4, 8)
    assert nsplit > 1
    *_, nsplit = _emulate(scores[:1, :700], 700, 1, 4, 40)
    assert nsplit > 1
