"""The int8 Top-K on ``wgmma`` (``csrc/sim_topk_q8.cu``), as far as the CPU
can hold it: the wrapper's route choice (a plain function of the depth and
the operands' alignment), the split plan that fills one wave of blocks,
and an emulation of the kernel's fold and merge in plain Python on
tie-heavy int8 scores, held bit for bit to ``ref.sim_topk_q8_ref`` and,
through it, to the reference's ``sim_topk_q8`` (Pallas in interpret mode).

The emulation follows the kernel step by step: per 64-row query tile and
split, each of a row's four lanes (the quad of the accumulator layout)
owns columns ``c0 + 8 i + 2 lane + {0, 1}`` of every 64-column tile and
keeps its own sorted list of 8; a column is a candidate when it beats the
lane's 8th score and reaches the row bound taken from the four lists at
the tile's start; candidates are inserted in ascending column order; at
the split's end the four lists merge by (value descending, index
ascending); the merge pass gives each of 32 lanes the splits l, l + 32, ...
and takes the best heads.  The card runs the kernel itself against the
plain version (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ref
from repro_torch.kernels.quant import quantize_rows_int8
from repro_torch.kernels.similarity_topk import q8_route, split_plan

KR, BM, BN = 8, 64, 64
NEG = float("-inf")


@pytest.mark.parametrize("d,ptrs,route", [
    (768, (0, 256), "wgmma"), (16, (16, 4096), "wgmma"),
    (96, (48, 32), "wgmma"), (1024, (0, 0), "wgmma"),
    (1040, (0, 0), "dp4a"), (130, (0, 0), "dp4a"), (61, (0, 0), "dp4a"),
    (768, (3, 0), "dp4a"), (768, (0, 8), "dp4a"), (0, (0, 0), "dp4a")])
def test_q8_route_is_a_function_of_depth_and_alignment(d, ptrs, route):
    assert q8_route(d, *ptrs) == route


@pytest.mark.parametrize("nq,nc,groups,wave,want", [
    (512, 65_537, 1, 264, (33, 32)), (1, 65_537, 1, 264, (257, 4)),
    (512, 6_852, 15, 264, (2, 54)), (16, 6_852, 15, 264, (16, 7)),
    (2_048, 4_096, 15, 264, (1, 64))])
def test_split_plan_fills_one_wave(nq, nc, groups, wave, want):
    nsplit, per = split_plan(nq, nc, False, min_cols=16, groups=groups,
                             wave=wave)
    assert (nsplit, per) == want
    q_tiles = -(-nq // BM) * groups
    assert nsplit * per >= -(-nc // BN) > (nsplit - 1) * per
    assert q_tiles * nsplit <= max(wave, q_tiles)


def _insert(v, ix, s, c):
    """The kernel's ladder: (s, c) behind every entry >= s."""
    p = sum(x >= s for x in v)
    v.insert(p, s)
    ix.insert(p, c)
    del v[KR:], ix[KR:]


def _best(heads):
    """(value descending, index ascending) among (value, index) heads."""
    return min(heads, key=lambda h: (-h[0], h[1]))


def _row_bound(lists):
    fourth = sorted((v[3] for v, _ in lists), reverse=True)
    return max(max(v[KR - 1] for v, _ in lists), fourth[1],
               min(v[1] for v, _ in lists))


def _merge_heads(lists, k):
    """K rounds of the best head among the lists, popping the winner;
    exhausted rows give (-inf, 0)."""
    out = []
    for _ in range(k):
        hv, hi = _best([(v[0], ix[0]) for v, ix in lists])
        for v, ix in lists:
            if v[0] == hv and ix[0] == hi:
                v.pop(0), ix.pop(0)
                v.append(NEG), ix.append(2 ** 31 - 1)
        out.append((hv, hi if hv > NEG else 0))
    return out


def _emulate(scores, n_valid, k, wave):
    """The kernel's fold and merge over a (Q, N) float32 score matrix."""
    nq, nc = scores.shape
    limit = max(0, min(n_valid, nc))
    nsplit, per = split_plan(nq, max(limit, 1), False, min_cols=2 * k,
                             wave=wave)
    n_tiles = -(-limit // BN)
    out_v = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for r in range(nq):
        parts = []
        for split in range(nsplit):
            lanes = [([NEG] * KR, [2 ** 31 - 1] * KR) for _ in range(4)]
            for t in range(split * per, min(split * per + per, n_tiles)):
                bound = _row_bound(lanes)
                for q, (v, ix) in enumerate(lanes):
                    cols = [t * BN + 8 * (j // 2) + 2 * q + j % 2
                            for j in range(16)]
                    cand = [(scores[r, c], c) for c in cols if c < limit
                            and scores[r, c] > v[KR - 1]
                            and scores[r, c] >= bound]
                    for s, c in cand:
                        if s > v[KR - 1]:
                            _insert(v, ix, s, c)
            parts.append(_merge_heads(lanes, k))
        lanes = [([NEG] * KR, [2 ** 31 - 1] * KR) for _ in range(32)]
        for lane, (v, ix) in enumerate(lanes):
            for s in range(lane, nsplit, 32):
                for pv, pi in parts[s]:
                    if not pv > v[KR - 1]:
                        break
                    _insert(v, ix, pv, pi)
        merged = _merge_heads(lanes, k)
        out_v[r] = [x for x, _ in merged]
        out_i[r] = [i for _, i in merged]
    return out_v, out_i


def _tied_rows(rng, n, d, distinct):
    """n int8 rows drawn from ``distinct`` rows (scales included), in a
    shuffled repeating order: every score is tied many times over."""
    q8, qs, _ = quantize_rows_int8(rng.standard_normal((distinct, d)))
    pick = rng.integers(0, distinct, n)
    return q8[pick], qs[pick]


@pytest.mark.parametrize("nq,nc,n_valid,k,wave,distinct", [
    (9, 1_500, 1_500, 8, 264, 6), (9, 1_500, 1_431, 8, 5, 6),
    (3, 2_000, 2_000, 1, 3, 4), (70, 600, 577, 3, 4, 5),
    (5, 900, 1, 8, 264, 3), (4, 700, 0, 8, 264, 3),
    (6, 3_000, 3_000, 8, 64, 3_000)])
def test_emulated_fold_and_merge_match_the_plain_version(
        rng, nq, nc, n_valid, k, wave, distinct):
    d = 48
    q8, qs, _ = quantize_rows_int8(rng.standard_normal((nq, d)))
    c8, cs = _tied_rows(rng, nc, d, distinct)
    acc = q8.astype(np.int64) @ c8.astype(np.int64).T
    scores = (acc.astype(np.float32) * qs[:, None]) * cs[None, :]
    ev, ei = _emulate(scores, n_valid, k, wave)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q8, qs, c8, cs)]
    pv, pi = (x.numpy() for x in ref.sim_topk_q8_ref(*t, n_valid, k))
    fin = np.isfinite(pv)
    np.testing.assert_array_equal(np.isneginf(ev), np.isneginf(pv))
    np.testing.assert_array_equal(ev[fin], pv[fin])
    np.testing.assert_array_equal(ei[fin], pi[fin])
    assert not ei[~fin].any()
    # ties came back ascending, as the plain stable sort has them
    tied = (ev[:, 1:] == ev[:, :-1]) & np.isfinite(ev[:, 1:])
    assert (ei[:, 1:] > ei[:, :-1])[tied].all()
    # and the plain version is the reference's kernel, bit for bit
    wv, wi = (np.asarray(x) for x in rops.sim_topk_q8(
        q8, qs, c8, cs, k, n_valid=n_valid, use_pallas=True))
    wfin = np.isfinite(wv)
    np.testing.assert_array_equal(wfin, fin)
    np.testing.assert_array_equal(wv[wfin], pv[wfin])
    np.testing.assert_array_equal(wi[wfin], pi[wfin])
