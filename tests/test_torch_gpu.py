"""Card-only checks of the hand-written CUDA kernels (marker ``gpu``; they
skip without a card).  Each kernel is held against its plain PyTorch
version on the same CUDA tensors, its launch counter must move by exactly
one per launch, and the kernel backend on the card must make the host
oracle's decisions.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(rng, n, d, dev):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("nq,nc,d,n_valid", [
    (1, 1, 32, 1), (7, 100, 64, 0), (37, 901, 64, 700), (130, 1500, 96, 1500),
    (8, 20_000, 768, 20_000), (512, 4_096, 768, 3_000),
    (64, 5_000, 770, 4_999)])
def test_sim_top1_kernel_matches_plain(cuda, rng, nq, nc, d, n_valid):
    from repro_torch.kernels import ref, similarity_topk
    q, c = _unit(rng, nq, d, cuda), _unit(rng, nc, d, cuda)
    before = similarity_topk.launches
    v, i = similarity_topk.sim_top1(q, c, n_valid)
    assert similarity_topk.launches == before + 1
    pv, pi = ref.sim_top1_ref(q, c, n_valid)
    assert torch.equal(torch.isneginf(v), torch.isneginf(pv))
    fin = torch.isfinite(pv)
    if fin.any():
        assert float((v - pv)[fin].abs().max()) <= 1e-5
    if n_valid == 0:
        assert int(i.abs().sum()) == 0          # (-inf, 0) per row
        return
    scores = q @ c[:n_valid].T
    if n_valid > 1:
        top2 = scores.topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > 1e-4
    else:
        clear = torch.ones(nq, dtype=torch.bool, device=cuda)
    assert torch.equal(i[clear], pi[clear])
    assert int(i.max()) < n_valid


def test_sim_top1_kernel_ties_go_low(cuda, rng):
    from repro_torch.kernels import similarity_topk
    row = _unit(rng, 1, 64, cuda)
    c = torch.cat([-_unit(rng, 5, 64, cuda), row.repeat(9_000, 1)])
    for nq in (3, 200):                  # one query tile and four
        v, i = similarity_topk.sim_top1(row.repeat(nq, 1), c, c.shape[0])
        assert (i == 5).all()


def test_sim_top1_pair_scores_do_not_depend_on_the_launch(cuda, rng):
    """I1: a (query, row) pair scores the same fp32 bits whatever launches
    it: Q = 512 over the slab, Q = 8 (other splits), the winner alone
    (Q = 1, N = 1), the winner at every place of an 8-row union block with
    its count on the card (the fused rescore's shape), and a slice of a
    stacked launch."""
    from repro_torch.kernels import similarity_topk as st
    q, c = _unit(rng, 512, 768, cuda), _unit(rng, 4_096, 768, cuda)
    v, i = st.sim_top1(q, c, 4_096)
    v8, i8 = st.sim_top1(q[:8].contiguous(), c, 4_096)
    assert torch.equal(v8, v[:8]) and torch.equal(i8, i[:8])
    mv, mi = st.sim_top1_multi(q, torch.stack([c.flip(0), c]),
                               _counts((4_096, 4_096), cuda))
    assert torch.equal(mv[1], v) and torch.equal(mi[1], i)
    eight = torch.tensor([8], dtype=torch.int32, device=cuda)
    for r in range(8):
        w = int(i[r])
        one, _ = st.sim_top1(q[r:r + 1].contiguous(), c[w:w + 1].contiguous(),
                             1)
        assert torch.equal(one, v[r:r + 1])
        for at in range(8):
            blk = -c[w].repeat(8, 1)     # every other row scores below
            blk[at] = c[w]
            bv, bi = st.sim_top1(q[r:r + 1].contiguous(), blk, eight)
            assert torch.equal(bv, v[r:r + 1]) and int(bi) == at


def _fmaf_chain(q: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The IEEE fp32 fmaf chain in ascending k (the kernel it replaced):
    each product is exact in float64, the sum rounds once to fp32."""
    acc = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for k in range(q.shape[1]):
        acc = (acc.astype(np.float64) + np.outer(
            q[:, k].astype(np.float64), c[:, k])).astype(np.float32)
    return acc


@pytest.mark.parametrize("d", [768, 770])
def test_sim_top1_error_against_float64(cuda, rng, d):
    """I2: against a float64 product of the same inputs, the three-way TF32
    scores err no more than twice as much as the IEEE fp32 fmaf chain, in
    the largest and in the mean error; half the rows are near duplicates
    of queries (scores near tau_hit and above)."""
    from repro_torch.kernels import similarity_topk as st
    q = _unit(rng, 256, d, cuda)
    noise = _unit(rng, 64, d, cuda)
    c = torch.cat([q[:32] + 0.3 * noise[:32], noise[32:]])
    c = (c / c.norm(dim=1, keepdim=True)).contiguous()
    # each row alone (N = 1) gives one column of pair scores (I1: the same
    # bits as in any other launch)
    got = torch.stack([st.sim_top1(q, c[j:j + 1].contiguous(), 1)[0]
                       for j in range(c.shape[0])], dim=1).cpu().numpy()
    qn, cn = q.cpu().numpy(), c.cpu().numpy()
    exact = qn.astype(np.float64) @ cn.astype(np.float64).T
    assert float(exact[:32, :32].diagonal().min()) > 0.9
    err = np.abs(got - exact)
    chain = np.abs(_fmaf_chain(qn, cn) - exact)
    assert err.max() <= 2 * chain.max(), (err.max(), chain.max())
    assert err.mean() <= 2 * chain.mean(), (err.mean(), chain.mean())


@pytest.mark.parametrize("n,t", [(1, 1), (777, 33), (65_537, 4_096)])
def test_value_kernels_match_plain(cuda, rng, n, t):
    from repro_torch.kernels import decision, rac_value, ref

    def dev(x):
        return torch.from_numpy(x).to(cuda)
    tsi = dev(rng.random(n).astype(np.float32))
    tid = dev(rng.integers(-1, t, n).astype(np.int32))
    occ = dev(rng.integers(0, 2, n).astype(np.int32))
    tp = dev((rng.random(t) * 10).astype(np.float32))
    tl = dev(rng.integers(0, 1000, t).astype(np.int32))
    before = (decision.launches, rac_value.launches)
    got = decision.victim_value(tsi, tid, occ, tp, tl, 1500, 0.001)
    want = ref.victim_value_ref(tsi, tid, occ, tp, tl, 1500, 0.001)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got[occ > 0], want[occ > 0], rtol=1e-6,
                               atol=0)
    tid0, tlf = tid.clamp(min=0), (tl - 1500).float()
    got = rac_value.rac_value(tsi, tid0, tp, tlf, 0.001, 0)
    want = ref.rac_value_ref(tsi, tid0, tp, tlf, 0.001, 0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert (decision.launches, rac_value.launches) == \
        (before[0] + 1, before[1] + 1)


def test_victim_value_kernel_large_timestamps(cuda):
    from repro_torch.kernels import decision
    base = 1 << 25
    out = decision.victim_value(
        torch.ones(64, device=cuda),
        torch.zeros(64, dtype=torch.int32, device=cuda),
        torch.ones(64, dtype=torch.int32, device=cuda),
        torch.tensor([2.0], device=cuda),
        torch.tensor([base + 1], dtype=torch.int32, device=cuda),
        base + 10, 0.1)
    torch.testing.assert_close(out.cpu(), torch.full((64,), 2.0 * 0.5 ** 0.9),
                               rtol=1e-5, atol=0)



# -------------------- the Eq. 1 kernels' Hopper design (B2, B3, B7)
# Around the vector edges (V = 4 or 8 entries a thread, 256 threads a
# block), the main path's, the arena's and the serve phase's shapes, and a
# topic table past the staging budget (gathered).
_VALUE_SHAPES = [(n, t) for n in (1, 3, 4, 5, 7, 8, 255, 256, 257, 1_023,
                                  1_024, 1_025) for t in (1, 33)] + [
    (64, 256), (65, 256), (6_852, 4_096), (65_537, 4_096),
    (65_537, 131_072)]


def _value_tables(rng, n, t, dev, shape=None):
    shape = shape or (n,)
    tshape = shape[:-1] + (t,)

    def put(x):
        return torch.from_numpy(x).to(dev)
    return (put(rng.random(shape).astype(np.float32) * 8),
            put(rng.integers(-1, t, shape).astype(np.int32)),
            put((rng.random(shape) < 0.9).astype(np.int32)),
            put(rng.random(tshape).astype(np.float32) * 20),
            put(rng.integers(0, 60_000, tshape).astype(np.int32)))


def _same_masks_within(got, want, rtol=1e-6):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=0)


@pytest.mark.parametrize("n,t", _VALUE_SHAPES)
def test_eq1_kernels_match_plain_around_the_vector_edges(cuda, rng, n, t):
    from repro_torch.kernels import decision, rac_value, ref
    tsi, tid, occ, tp, tl = _value_tables(rng, n, t, cuda)
    before = (decision.launches, decision.vec_launches, rac_value.launches,
              rac_value.vec_launches)
    got = decision.victim_value(tsi, tid, occ, tp, tl, 72_000, 0.001)
    _same_masks_within(got, ref.victim_value_ref(tsi, tid, occ, tp, tl,
                                                 72_000, 0.001))
    tid0, tli = tid.clamp(min=0), tl - 72_000
    valid = occ > 0
    for t_last in (tli.float(), tli):           # f32, and int32 cast inside
        got = rac_value.rac_value(tsi, tid0, tp, t_last, 0.001, 0)
        want = ref.rac_value_ref(tsi, tid0, tp, tli.float(), 0.001, 0)
        _same_masks_within(got, want)
        masked = rac_value.rac_value(tsi, tid0, tp, t_last, 0.001, 0, valid)
        assert torch.equal(masked, torch.where(valid, got, float("inf")))
    vec = int(n >= decision.V)       # fresh tensors: 16-byte aligned bases
    assert (decision.launches, decision.vec_launches, rac_value.launches,
            rac_value.vec_launches) == (before[0] + 1, before[1] + vec,
                                        before[2] + 4, before[3] + 4 * vec)


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("n,t", [(5, 33), (257, 33), (1_025, 256),
                                 (65_537, 4_096)])
def test_eq1_scalar_walk_of_slices_is_bit_equal_to_the_vector_path(
        cuda, rng, off, n, t):
    """Slices at 1-3 entries past an aligned base take the scalar walk;
    their values are the contiguous copies' (vector path) bit for bit."""
    from repro_torch.kernels import decision, rac_value
    big = _value_tables(rng, n + off, t, cuda)
    sl = [x[off:] for x in big[:3]] + list(big[3:])
    cp = [x.clone() for x in sl]
    vec = int(n >= decision.V)
    v0 = (decision.vec_launches, rac_value.vec_launches)
    a = decision.victim_value(*sl, 72_000, 0.001)
    assert decision.vec_launches == v0[0]
    b = decision.victim_value(*cp, 72_000, 0.001)
    assert decision.vec_launches == v0[0] + vec
    assert torch.equal(a, b)
    tl = big[4] - 72_000
    for valid in (None, sl[2] > 0):
        a = rac_value.rac_value(sl[0], sl[1].clamp(min=0), big[3], tl, 0.001,
                                0, valid)
        b = rac_value.rac_value(cp[0], cp[1].clamp(min=0), big[3], tl, 0.001,
                                0, None if valid is None else valid.clone())
        assert torch.equal(a, b)
    assert rac_value.vec_launches == v0[1] + 2 * vec


@pytest.mark.parametrize("n,t", [(1_025, 256), (65_537, 4_096),
                                 (6_852, 4_096)])
def test_eq1_staged_and_gathered_tables_give_the_same_bits(cuda, rng,
                                                          monkeypatch, n, t):
    """Topic tables staged in shared memory or gathered from L2 (where they
    do not fit, or with no staging budget): the same bits."""
    from repro_torch.kernels import decision, rac_value
    tsi, tid, occ, tp, tl = _value_tables(rng, n, t, cuda)
    tid0, tli = tid.clamp(min=0), tl - 72_000

    def run():
        return (decision.victim_value(tsi, tid, occ, tp, tl, 72_000, 0.001),
                rac_value.rac_value(tsi, tid0, tp, tli, 0.001, 0),
                rac_value.rac_value(tsi, tid0, tp, tli.float(), 0.001, 0,
                                    occ > 0))
    assert decision.stage_plan(t, True)
    base = run()
    monkeypatch.setattr(decision, "STAGE_MAX", 0)
    for i, (a, b) in enumerate(zip(run(), base)):
        assert torch.equal(a, b), (i, int((a != b).sum()))


def test_rac_value_masked_is_one_launch_bit_equal_to_select(cuda, rng):
    """ops.rac_value_masked: one B3 launch (the mask in the kernel), the
    bits of B3 followed by torch.where; the int32 table the backend
    passes needs no cast launch either."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, rac_value
    tsi, tid, occ, tp, tl = _value_tables(rng, 6_852, 4_096, cuda)
    tid0, tli, valid = tid.clamp(min=0), tl - 72_000, occ > 0
    ops.rac_value_masked(tsi, tid0, tp, tli, valid, 0.01, 0)
    torch.cuda.synchronize()
    before = rac_value.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = ops.rac_value_masked(tsi, tid0, tp, tli, valid, 0.01, 0)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    assert rac_value.launches == before + 1
    assert len(kernels) == 1 and "eq1_kernel" in kernels[0], kernels
    plain = rac_value.rac_value(tsi, tid0, tp, tli.float(), 0.01, 0)
    assert torch.equal(got, torch.where(valid, plain, float("inf")))


@pytest.mark.parametrize("p,n,t", [(2, 5, 33), (3, 1_023, 256),
                                   (15, 6_852, 4_096), (4, 6_851, 4_096),
                                   (2, 1_024, 131_072)])
def test_eq1_stacked_is_bit_equal_to_single_launches(cuda, rng, p, n, t):
    """B7 (one launch, the policy a grid axis) against P single B2
    launches; N % 4 != 0 puts the policies' rows off 16 bytes (the scalar
    walk)."""
    from repro_torch.kernels import decision, ref
    tsi, tid, occ, tp, tl = _value_tables(rng, n, t, cuda, shape=(p, n))
    v0 = (decision.multi_launches, decision.multi_vec_launches)
    got = decision.victim_value_multi(tsi, tid, occ, tp, tl, 72_000, 0.001)
    assert (decision.multi_launches, decision.multi_vec_launches) == \
        (v0[0] + 1, v0[1] + int(n % 4 == 0))
    _same_masks_within(got, ref.victim_value_multi_ref(tsi, tid, occ, tp,
                                                       tl, 72_000, 0.001))
    for j in range(p):
        one = decision.victim_value(tsi[j], tid[j], occ[j], tp[j], tl[j],
                                    72_000, 0.001)
        assert torch.equal(got[j], one)


def test_fused_decide_in_a_cuda_graph_equals_the_eager_call(cuda, rng):
    """B1, B1, B2 (B2 launched with programmatic dependent launch after
    B1) captured in a CUDA graph: each replay gives the eager call's
    outputs, also after the inputs change in place."""
    from repro_torch.kernels import ops
    q, slab, reps = (_unit(rng, 64, 128, cuda), _unit(rng, 5_000, 128, cuda),
                     _unit(rng, 300, 128, cuda))
    tsi, tid, occ, tp, tl = _value_tables(rng, 5_000, 512, cuda)

    def call():
        return ops.fused_decide(q, slab, 4_900, reps, 300, tsi, tid, occ, tp,
                                tl, 72_000, alpha=0.001)
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        graphed = call()
    for step in range(3):
        tsi.mul_(1.5)
        tl.add_(step)
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip(graphed, call()):
            assert torch.equal(a, b)


def test_eq1_wrappers_refuse_what_the_kernels_do_not_take(cuda, rng):
    from repro_torch.kernels import decision, rac_value
    tsi, tid, occ, tp, tl = _value_tables(rng, 100, 33, cuda)
    with pytest.raises(ValueError):
        decision.victim_value(tsi, tid[:99], occ, tp, tl, 5, 0.1)
    with pytest.raises(ValueError):
        decision.victim_value(tsi, tid, occ, tp, tl[:32], 5, 0.1)
    with pytest.raises(ValueError):
        decision.victim_value(tsi, tid, occ, tp, tl.float(), 5, 0.1)
    with pytest.raises(ValueError):
        decision.victim_value(tsi[::2], tid[::2], occ[::2], tp, tl, 5, 0.1)
    with pytest.raises(ValueError):
        rac_value.rac_value(tsi, tid, tp, tl, 0.1, 0, occ)      # not bool
    with pytest.raises(ValueError):
        rac_value.rac_value(tsi, tid, tp, tl, 0.1, 0, occ[:50] > 0)
    with pytest.raises(ValueError):
        rac_value.rac_value(tsi, tid, tp, tl.cpu(), 0.1, 0)

def test_kernel_backend_on_the_card_matches_the_host_oracle(cuda):
    from repro_torch.core import (OASSTConfig, make_rac, oasst_style_trace,
                                  run_policy_batched)
    from repro_torch.kernels import decision, rac_value, similarity_topk
    tr = oasst_style_trace(OASSTConfig(trace_len=2_000, dim=128, seed=4))
    mods = (similarity_topk, decision, rac_value)
    for m in mods:
        m.launches = 0
    out = {}
    for backend, device in (("kernel", "cuda"), ("numpy", "cpu")):
        st = run_policy_batched(tr, 256, make_rac(), backend=backend,
                                device=device, chunk=64)
        out[backend] = (st.hits, st.misses, st.evictions)
    assert out["kernel"] == out["numpy"] and out["numpy"][2] > 0
    assert all(m.launches > 0 for m in mods)


# ------------------------------------------- Top-K kernels (B4, B5) and B1
def _assert_topk(v, i, pv, pi, exact_values):
    """Kernel (v, i) against the plain (pv, pi): the same -inf tail,
    values equal (int8) or within 1e-5 (fp32), indices equal wherever the
    value is finite and clear of its neighbours (fp32) or finite (int8)."""
    assert v.shape == pv.shape and i.dtype == torch.int32
    assert torch.equal(torch.isneginf(v), torch.isneginf(pv))
    fin = torch.isfinite(pv)
    if exact_values:
        assert torch.equal(v[fin], pv[fin])
        assert torch.equal(i[fin], pi[fin])
        return
    if fin.any():
        assert float((v - pv)[fin].abs().max()) <= 1e-5
    # an index is pinned down when its score is 1e-4 clear of the next
    # and of the previous rank
    pad = torch.full_like(pv[:, :1], float("-inf"))
    nxt = torch.cat([pv[:, 1:], pad], dim=1)
    prv = torch.cat([-pad, pv[:, :-1]], dim=1)
    clear = fin & (pv - nxt > 1e-4) & (prv - pv > 1e-4)
    assert torch.equal(i[clear], pi[clear])


@pytest.mark.parametrize("nq,nc,d,n_valid,k", [
    (1, 1, 32, 1, 1), (7, 100, 64, 0, 4), (37, 901, 64, 700, 16),
    (130, 1500, 96, 1500, 3), (8, 20_000, 768, 20_000, 257),
    (512, 4_096, 769, 3_000, 3), (3, 700, 48, 650, 700),
    (64, 5_000, 770, 4_999, 33)])
def test_sim_topk_kernel_matches_plain(cuda, rng, nq, nc, d, n_valid, k):
    from repro_torch.kernels import ref, similarity_topk
    q, c = _unit(rng, nq, d, cuda), _unit(rng, nc, d, cuda)
    before = similarity_topk.topk_launches
    v, i = similarity_topk.sim_topk(q, c, n_valid, k)
    assert similarity_topk.topk_launches == before + 1
    pv, pi = ref.sim_topk_ref(q, c, n_valid, k)
    _assert_topk(v, i, pv, pi, exact_values=False)
    if n_valid == 0:
        assert bool(torch.isneginf(v).all())


def test_sim_topk_kernel_ties_go_low(cuda, rng):
    from repro_torch.kernels import similarity_topk
    row = _unit(rng, 1, 64, cuda)
    c = torch.cat([-_unit(rng, 5, 64, cuda), row.repeat(9_000, 1)])
    for nq in (3, 200):                  # one query tile and four
        for k in (4, 40):                        # shared and device lists
            v, i = similarity_topk.sim_topk(row.repeat(nq, 1), c,
                                            c.shape[0], k)
            want = torch.arange(5, 5 + k, device=cuda, dtype=torch.int32)
            assert torch.equal(i, want.expand(nq, k))


def _padded(x, pitch):
    """x's rows at a pitch of ``pitch`` floats (a view, as the routing
    mirror keeps them)."""
    buf = torch.zeros((x.shape[0], pitch), device=x.device)
    buf[:, :x.shape[1]] = x
    return buf[:, :x.shape[1]]


@pytest.mark.parametrize("nq,nc,d,n_valid,k,pitch", [
    # the pruned lookup's route and the staged route, at the mirror's
    # 16-byte pitch and contiguous (4-byte copies)
    (1, 4_096, 769, 4_096, 3, 772), (1, 4_096, 769, 4_096, 3, None),
    (512, 4_096, 769, 4_000, 3, 772), (16, 4_096, 769, 4_096, 3, 772),
    # the slab at Q = 8, every K of chip_smoke.py
    (8, 65_537, 768, 65_537, 1, None), (8, 65_537, 768, 65_537, 8, None),
    (8, 65_537, 768, 65_536, 16, None), (8, 65_537, 768, 65_537, 257, None),
    # D = 130, every skinny query count, K up to N, and the wide kernel's
    # device-memory lists
    (3, 1_000, 130, 990, 5, None), (5, 300, 130, 300, 300, None),
    (2, 513, 64, 513, 33, None), (4, 777, 96, 700, 32, None),
    (16, 2_000, 768, 1_999, 40, None), (17, 600, 64, 600, 600, None),
    (200, 3_000, 130, 2_950, 64, None), (9, 129, 32, 129, 129, 36)])
def test_sim_topk_f32_matches_plain_at_every_shape(cuda, rng, nq, nc, d,
                                                   n_valid, k, pitch):
    from repro_torch.kernels import ref, similarity_topk as st
    q, c = _unit(rng, nq, d, cuda), _unit(rng, nc, d, cuda)
    if pitch:
        q, c = _padded(q, pitch), _padded(c, pitch)
    before = st.topk_launches, st.topk_f32_launches
    v, i = st.sim_topk(q, c, n_valid, k)
    assert (st.topk_launches, st.topk_f32_launches) == \
        (before[0] + 1, before[1] + 1)
    pv, pi = ref.sim_topk_ref(q, c, n_valid, k)
    _assert_topk(v, i, pv, pi, exact_values=False)


def test_sim_topk_f32_scores_the_same_bits_in_every_launch(cuda, rng):
    """One fmaf chain a pair: the padded pitch or a contiguous copy, one
    query or 8 or 512 (skinny and wide kernels), a few candidates or many,
    give a (query, candidate) pair the same bits."""
    from repro_torch.kernels import similarity_topk as st
    q, c = _unit(rng, 512, 769, cuda), _unit(rng, 4_096, 769, cuda)
    want_v, want_i = st.sim_topk(q, c, 4_096, 3)
    for nq in (1, 8, 512):
        for qq, cc in ((q[:nq], c), (_padded(q[:nq], 772), _padded(c, 772))):
            v, i = st.sim_topk(qq, cc, 4_096, 3)
            assert torch.equal(v, want_v[:nq]) and torch.equal(i, want_i[:nq])
    # each query's best row among the 8 queries' best rows: the same bits
    v, _ = st.sim_topk(q[:8], c[want_i[:8, 0].long()], 8, 1)
    assert torch.equal(v[:, 0], want_v[:8, 0])


@pytest.mark.parametrize("nq,k", [(1, 3), (8, 8), (8, 16), (8, 257),
                                  (200, 8), (200, 40)])
def test_sim_topk_f32_ties_come_back_ascending(cuda, rng, nq, k):
    from repro_torch.kernels import similarity_topk as st
    row = _unit(rng, 1, 128, cuda)
    c = torch.cat([-_unit(rng, 7, 128, cuda), row.repeat(20_000, 1)])
    v, i = st.sim_topk(row.repeat(nq, 1), c, c.shape[0], k)
    want = torch.arange(7, 7 + k, device=cuda, dtype=torch.int32)
    assert torch.equal(i, want.expand(nq, k))


@pytest.mark.parametrize("nq,nc,d,n_valid,k", [
    (1, 65_537, 768, 65_537, 8), (512, 9_000, 768, 8_500, 8),
    (5, 1_311, 768, 1_300, 8), (9, 600, 130, 570, 5), (4, 300, 64, 0, 3),
    (16, 2_000, 96, 2_000, 257)])
def test_sim_topk_q8_kernel_is_bit_equal_to_plain(cuda, rng, nq, nc, d,
                                                  n_valid, k):
    from repro_torch.kernels import ref, similarity_topk
    from repro_torch.kernels.quant import quantize_rows_int8
    q8, qs, _ = quantize_rows_int8(rng.standard_normal((nq, d)))
    c8, cs, _ = quantize_rows_int8(rng.standard_normal((nc, d)))
    args = [torch.from_numpy(x).to(cuda) for x in (q8, qs, c8, cs)]
    before = similarity_topk.topk_q8_launches
    v, i = similarity_topk.sim_topk_q8(*args, n_valid, k)
    assert similarity_topk.topk_q8_launches == before + 1
    pv, pi = ref.sim_topk_q8_ref(*args, n_valid, k)
    _assert_topk(v, i, pv, pi, exact_values=True)
    # and the host gemm of the reference's numpy helper gives the same bits
    from repro_torch.kernels.quant import int8_scores
    host = (int8_scores(q8, c8[:n_valid]) * qs[:, None]) * cs[None, :n_valid]
    if n_valid:
        kk = min(k, n_valid)
        order = np.argsort(-host, axis=1, kind="stable")[:, :kk]
        np.testing.assert_array_equal(v[:, :kk].cpu().numpy(),
                                      np.take_along_axis(host, order, 1))


def test_sim_topk_q8_kernel_unaligned_rows(cuda, rng):
    """Rows that are not 16-byte aligned take the byte-wise loads."""
    from repro_torch.kernels import ref, similarity_topk
    from repro_torch.kernels.quant import quantize_rows_int8
    c8, cs, _ = quantize_rows_int8(rng.standard_normal((401, 64)))
    q8, qs, _ = quantize_rows_int8(rng.standard_normal((6, 64)))
    c = torch.from_numpy(np.ascontiguousarray(c8[:, 3:])).to(cuda)
    args = (torch.from_numpy(np.ascontiguousarray(q8[:, 3:])).to(cuda),
            torch.from_numpy(qs).to(cuda), c, torch.from_numpy(cs).to(cuda))
    v, i = similarity_topk.sim_topk_q8(*args, 401, 6)
    pv, pi = ref.sim_topk_q8_ref(*args, 401, 6)
    _assert_topk(v, i, pv, pi, exact_values=True)


# B5 on the int8 wgmma kernel (csrc/sim_topk_q8.cu): bit-equal to the plain
# version across the query-tile edges (64), the candidate-tile edges (64)
# and the split edges, every k path (register lists for k <= 8, the
# parked fold beyond), counts 0, 1 and N
_Q8_EDGES = [
    (1, 1, 1, 1), (1, 64, 64, 64), (1, 65_537, 65_537, 8),
    (8, 129, 129, 1), (8, 65_537, 65_537, 257), (16, 128, 0, 8),
    (16, 4_097, 4_097, 257), (17, 65, 65, 65), (17, 4_096, 1, 8),
    (63, 127, 127, 8), (64, 1_000, 1_000, 1), (64, 4_097, 4_096, 8),
    (65, 129, 129, 129), (65, 20_000, 19_999, 8), (512, 65_537, 65_537, 8),
    (512, 4_096, 0, 257), (513, 8_193, 8_193, 8), (513, 300, 1, 257)]


def _q8_rows(rng, n, d, dev):
    from repro_torch.kernels.quant import quantize_rows_int8
    q8, qs, _ = quantize_rows_int8(rng.standard_normal((n, d)))
    return torch.from_numpy(q8).to(dev), torch.from_numpy(qs).to(dev)


def _assert_q8_exact(v, i, pv, pi):
    """Bit-equal values and equal indices wherever the plain value is
    finite; the kernel's -inf tail carries index 0."""
    _assert_topk(v, i, pv, pi, exact_values=True)
    assert int(i[torch.isneginf(v)].abs().sum()) == 0


def _q8_launch(args, n_valid, k, route):
    from repro_torch.kernels import ref, similarity_topk as st
    before = (st.topk_q8_launches, st.topk_q8_wgmma_launches)
    v, i = st.sim_topk_q8(*args, n_valid, k)
    assert st.topk_q8_launches == before[0] + 1
    assert st.topk_q8_wgmma_launches == before[1] + (route == "wgmma")
    pv, pi = ref.sim_topk_q8_ref(*args, n_valid, k)
    _assert_q8_exact(v, i, pv, pi)
    return v, i


@pytest.mark.parametrize("nq,nc,n_valid,k", _Q8_EDGES)
def test_sim_topk_q8_wgmma_bit_equal_at_the_edges(cuda, rng, nq, nc,
                                                  n_valid, k):
    q8, qs = _q8_rows(rng, nq, 768, cuda)
    c8, cs = _q8_rows(rng, nc, 768, cuda)
    _q8_launch((q8, qs, c8, cs), n_valid, k, "wgmma")


@pytest.mark.parametrize("d", [16, 32, 64, 96, 768, 1_024])
@pytest.mark.parametrize("nq,nc,k", [(37, 1_000, 8), (5, 300, 40)])
def test_sim_topk_q8_wgmma_takes_every_depth_in_16s(cuda, rng, d, nq, nc,
                                                   k):
    _q8_launch((*_q8_rows(rng, nq, d, cuda), *_q8_rows(rng, nc, d, cuda)),
               nc - 3, k, "wgmma")


def test_sim_topk_q8_other_rows_stay_on_dp4a(cuda, rng):
    """D = 130, D past the resident query tile and rows off 16-byte
    boundaries take the __dp4a kernel, with the same bits."""
    for d in (130, 1_040):
        _q8_launch((*_q8_rows(rng, 9, d, cuda), *_q8_rows(rng, 600, d, cuda)),
                   570, 5, "dp4a")
    q8, qs = _q8_rows(rng, 6, 64, cuda)
    c8, cs = _q8_rows(rng, 401, 64, cuda)
    _q8_launch((q8[:, 3:].contiguous(), qs, c8[:, 3:].contiguous(), cs), 401,
               6, "dp4a")
    # whole 64-byte rows whose base sits 3 bytes past a 16-byte boundary
    buf = torch.empty(401 * 64 + 3, dtype=torch.int8, device=cuda)
    off = buf[3:].view(401, 64)
    off.copy_(c8)
    _q8_launch((q8, qs, off, cs), 401, 6, "dp4a")


@pytest.mark.parametrize("nq,k", [(3, 8), (64, 1), (70, 8), (200, 40)])
def test_sim_topk_q8_wgmma_ties_come_back_ascending(cuda, rng, nq, k):
    """A slab of a few rows repeated (every score tied many times over):
    equal scores come back in ascending index order, as the plain stable
    sort has them, across lanes, tiles and splits."""
    q8, qs = _q8_rows(rng, nq, 768, cuda)
    c8, cs = _q8_rows(rng, 7, 768, cuda)
    c8, cs = c8.repeat(1_300, 1), cs.repeat(1_300)
    v, i = _q8_launch((q8, qs, c8, cs), c8.shape[0], k, "wgmma")
    assert bool((i[:, 0] < 7).all())        # the first copy of the best row
    tied = v[:, 1:] == v[:, :-1]
    assert bool((i[:, 1:] > i[:, :-1])[tied].all())
    assert k == 1 or bool(tied.any())


def test_sim_topk_q8_wgmma_largest_sums(cuda, rng):
    """All-+-127 rows: |q8 . c8| reaches D * 127^2, the largest int32 sum
    (exact in fp32 below 2^24 at D = 768)."""
    sign = torch.from_numpy(rng.integers(0, 2, (40, 768))).to(cuda)
    q8 = (sign * 254 - 127).to(torch.int8)
    c8 = torch.cat([q8, -q8, q8.flip(1)]).repeat(30, 1)
    qs = torch.ones(40, device=cuda)
    cs = torch.from_numpy(rng.uniform(0.5, 1, c8.shape[0]).astype(
        np.float32)).to(cuda)
    v, _ = _q8_launch((q8, qs, c8, cs), c8.shape[0], 8, "wgmma")
    assert float(v[:, 0].max()) >= 768 * 127 ** 2 * 0.5


@pytest.mark.parametrize("s,nv,k", [
    (65, (0, 65, 1, 64), 8), (4_097, (4_097, 0, 4_096), 1),
    (700, (700, 699, 0, 1, 350), 40), (6_852, (6_852,) * 3, 8)])
def test_sim_topk_q8_multi_wgmma_slices_equal_single_launches(cuda, rng, s,
                                                              nv, k):
    from repro_torch.kernels import ref, similarity_topk as st
    n_pol = len(nv)
    q8, qs = _q8_rows(rng, 70, 768, cuda)
    c8, cs = _q8_rows(rng, 5, 768, cuda)      # few rows: many ties
    c8 = c8.repeat(-(-n_pol * s // 5), 1)[:n_pol * s].view(n_pol, s, 768)
    cs = cs.repeat(-(-n_pol * s // 5))[:n_pol * s].view(n_pol, s)
    counts = _counts(nv, cuda)
    before = st.topk_q8_multi_wgmma_launches
    v, i = st.sim_topk_q8_multi(q8, qs, c8, cs, counts, k)
    assert st.topk_q8_multi_wgmma_launches == before + 1
    pv, pi = ref.sim_topk_q8_multi_ref(q8, qs, c8, cs, counts, k)
    for p, n in enumerate(nv):
        _assert_q8_exact(v[p], i[p], pv[p], pi[p])
        sv, si = st.sim_topk_q8(q8, qs, c8[p].contiguous(),
                                cs[p].contiguous(), n, k)
        assert torch.equal(v[p], sv) and torch.equal(i[p], si)


def test_sim_top1_device_n_valid_matches_host_int(cuda, rng):
    from repro_torch.kernels import similarity_topk
    q, c = _unit(rng, 9, 96, cuda), _unit(rng, 3_000, 96, cuda)
    for nv in (0, 1, 1_777, 3_000):
        dn = torch.tensor([nv], dtype=torch.int32, device=cuda)
        v, i = similarity_topk.sim_top1(q, c, dn)
        hv, hi = similarity_topk.sim_top1(q, c, nv)
        assert torch.equal(v, hv) and torch.equal(i, hi)


def test_wrappers_never_take_the_plain_version_on_the_card(cuda, rng,
                                                          monkeypatch):
    from repro_torch.kernels import ref, similarity_topk

    def refuse(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")
    for name in ("sim_top1_ref", "sim_topk_ref", "sim_topk_q8_ref"):
        monkeypatch.setattr(ref, name, refuse)
    q, c = _unit(rng, 4, 64, cuda), _unit(rng, 300, 64, cuda)
    similarity_topk.sim_top1(q, c, 300)
    similarity_topk.sim_topk(q, c, 300, 5)
    q8 = torch.zeros((4, 64), dtype=torch.int8, device=cuda)
    s = torch.ones(300, device=cuda)
    similarity_topk.sim_topk_q8(q8, s[:4].contiguous(),
                                torch.zeros((300, 64), dtype=torch.int8,
                                            device=cuda), s, 300, 5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("quant,pruned", [
    (True, False), (False, True), (True, True),
    ({"fused": False}, {"fused": False})])
def test_approximate_lookups_on_the_card_match_the_host_oracle(
        cuda, quant, pruned):
    from repro_torch.cache import CacheConfig, SemanticCache
    from repro_torch.core import OASSTConfig, oasst_style_trace
    from repro_torch.kernels import similarity_topk
    tr = oasst_style_trace(OASSTConfig(trace_len=1_500, dim=128, seed=4))
    out = {}
    before = (similarity_topk.topk_launches,
              similarity_topk.topk_q8_launches)
    for backend, device in (("kernel", "cuda"), ("numpy", "cpu")):
        cache = SemanticCache(CacheConfig(
            capacity=200, dim=128, backend=backend, device=device,
            quantized_lookup=quant, pruned_lookup=pruned))
        ev = []
        for kind in ("hit", "miss", "admit", "evict"):
            cache.subscribe(kind, lambda e, k=kind: ev.append((k, e.cid)))
        for r in tr.requests:
            if not cache.lookup(r.emb, cid=r.cid, t=r.t).hit:
                cache.admit(r.cid, r.emb, t=r.t)
        out[backend] = ev
    assert out["kernel"] == out["numpy"]
    assert any(k == "evict" for k, _ in out["numpy"])
    if pruned:
        assert similarity_topk.topk_launches > before[0]
    if quant is not False and pruned is not True:
        assert similarity_topk.topk_q8_launches > before[1]


# ------------------------------- policy-stacked kernels (B1/B5/B2 multi)
def _counts(ns, dev):
    return torch.tensor(ns, dtype=torch.int32, device=dev)


# (Q, S, D, per-policy counts): P = 1, a policy with nothing resident,
# one with every slot, Q off the tile multiples, D = 770 (not a multiple
# of 16: the int8 kernel takes byte loads)
_STACKED = [(1, 50, 32, (50,)), (7, 300, 64, (0, 300, 171)),
            (37, 901, 96, (901, 0, 1, 450, 900)),
            (130, 1_200, 770, (1_200, 7, 0)),
            (512, 2_000, 768, (2_000, 1_999, 1_000, 0))]


@pytest.mark.parametrize("nq,s,d,nv", _STACKED)
def test_sim_top1_multi_matches_plain_and_single_launches(cuda, rng, nq, s,
                                                          d, nv):
    from repro_torch.kernels import ref, similarity_topk
    q = _unit(rng, nq, d, cuda)
    slabs = _unit(rng, len(nv) * s, d, cuda).view(len(nv), s, d)
    counts = _counts(nv, cuda)
    before = (similarity_topk.multi_launches, similarity_topk.launches)
    v, i = similarity_topk.sim_top1_multi(q, slabs, counts)
    assert (similarity_topk.multi_launches, similarity_topk.launches) == \
        (before[0] + 1, before[1])
    assert v.shape == i.shape == (len(nv), nq)
    pv, pi = ref.sim_top1_multi_ref(q, slabs, counts)
    assert torch.equal(torch.isneginf(v), torch.isneginf(pv))
    fin = torch.isfinite(pv)
    if fin.any():
        assert float((v - pv)[fin].abs().max()) <= 1e-5
    for p, n in enumerate(nv):
        # each slice is bit-equal to a single-slab launch on that slab
        sv, si = similarity_topk.sim_top1(q, slabs[p].contiguous(), n)
        assert torch.equal(v[p], sv) and torch.equal(i[p], si)
        if n == 0:
            assert int(i[p].abs().sum()) == 0       # (-inf, 0) per row
        elif n > 1:
            top2 = (q @ slabs[p, :n].T).topk(2, dim=1).values
            clear = top2[:, 0] - top2[:, 1] > 1e-4
            assert torch.equal(i[p][clear], pi[p][clear])


@pytest.mark.parametrize("nq,s,d,nv", _STACKED)
def test_sim_topk_q8_multi_matches_plain_and_single_launches(cuda, rng, nq,
                                                             s, d, nv):
    from repro_torch.kernels import ref, similarity_topk
    from repro_torch.kernels.quant import quantize_rows_int8
    n_pol, k = len(nv), 8
    q8n, qsn, _ = quantize_rows_int8(_unit(rng, nq, d, cuda).cpu().numpy())
    c8n, csn, _ = quantize_rows_int8(
        _unit(rng, n_pol * s, d, cuda).cpu().numpy())
    q8, qs = torch.from_numpy(q8n).to(cuda), torch.from_numpy(qsn).to(cuda)
    c8 = torch.from_numpy(c8n).to(cuda).view(n_pol, s, d)
    cs = torch.from_numpy(csn).to(cuda).view(n_pol, s)
    counts = _counts(nv, cuda)
    before = (similarity_topk.topk_q8_multi_launches,
              similarity_topk.topk_q8_launches)
    v, i = similarity_topk.sim_topk_q8_multi(q8, qs, c8, cs, counts, k)
    assert (similarity_topk.topk_q8_multi_launches,
            similarity_topk.topk_q8_launches) == (before[0] + 1, before[1])
    assert v.shape == i.shape == (n_pol, nq, k)
    pv, pi = ref.sim_topk_q8_multi_ref(q8, qs, c8, cs, counts, k)
    for p, n in enumerate(nv):
        _assert_topk(v[p], i[p], pv[p], pi[p], exact_values=True)
        sv, si = similarity_topk.sim_topk_q8(q8, qs, c8[p].contiguous(),
                                             cs[p].contiguous(), n, k)
        assert torch.equal(v[p], sv) and torch.equal(i[p], si)


@pytest.mark.parametrize("p,n,t", [(1, 1, 1), (3, 777, 33), (15, 6_852,
                                                             4_096)])
def test_victim_value_multi_matches_plain_and_single_launches(cuda, rng, p,
                                                              n, t):
    from repro_torch.kernels import decision, ref

    def dev(x):
        return torch.from_numpy(x).to(cuda)
    tsi = dev(rng.random((p, n)).astype(np.float32))
    tid = dev(rng.integers(-1, t, (p, n)).astype(np.int32))
    occ = dev(rng.integers(0, 2, (p, n)).astype(np.int32))
    tp = dev((rng.random((p, t)) * 10).astype(np.float32))
    tl = dev(rng.integers(0, 1000, (p, t)).astype(np.int32))
    before = (decision.multi_launches, decision.launches)
    got = decision.victim_value_multi(tsi, tid, occ, tp, tl, 1500, 0.001)
    assert (decision.multi_launches, decision.launches) == \
        (before[0] + 1, before[1])
    want = ref.victim_value_multi_ref(tsi, tid, occ, tp, tl, 1500, 0.001)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got[occ > 0], want[occ > 0], rtol=1e-6,
                               atol=0)
    for j in range(p):
        one = decision.victim_value(tsi[j], tid[j], occ[j], tp[j], tl[j],
                                    1500, 0.001)
        assert torch.equal(got[j], one)


def test_stacked_wrappers_never_take_the_plain_version_on_the_card(
        cuda, rng, monkeypatch):
    from repro_torch.kernels import decision, ref, similarity_topk

    def refuse(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")
    for name in ("sim_top1_multi_ref", "sim_topk_q8_multi_ref",
                 "victim_value_multi_ref", "sim_top1_ref", "sim_topk_q8_ref",
                 "victim_value_ref"):
        monkeypatch.setattr(ref, name, refuse)
    counts = _counts((30, 0), cuda)
    similarity_topk.sim_top1_multi(_unit(rng, 4, 64, cuda),
                                   _unit(rng, 60, 64, cuda).view(2, 30, 64),
                                   counts)
    similarity_topk.sim_topk_q8_multi(
        torch.zeros((4, 64), dtype=torch.int8, device=cuda),
        torch.ones(4, device=cuda),
        torch.zeros((2, 30, 64), dtype=torch.int8, device=cuda),
        torch.ones((2, 30), device=cuda), counts, 5)
    z = torch.zeros((2, 30), dtype=torch.int32, device=cuda)
    decision.victim_value_multi(torch.ones((2, 30), device=cuda), z, z,
                                torch.ones((2, 4), device=cuda),
                                torch.zeros((2, 4), dtype=torch.int32,
                                            device=cuda), 3, 0.1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("approx", [{}, {"quantized": True},
                                    {"pruned": True},
                                    {"quantized": True, "pruned": True}])
def test_arena_on_the_card_matches_the_host_oracle(cuda, approx):
    from repro_torch.core import (OASSTConfig, default_factories,
                                  oasst_style_trace, run_arena)
    from repro_torch.kernels import similarity_topk
    tr = oasst_style_trace(OASSTConfig(trace_len=1_500, dim=128, seed=4))
    similarity_topk.multi_launches = 0
    similarity_topk.topk_q8_multi_launches = 0
    out = {}
    for backend, device in (("kernel", "cuda"), ("numpy", "cpu")):
        stats = run_arena(tr, 120, default_factories(seed=0),
                          hit_mode="semantic", backend=backend,
                          device=device, chunk=128, **approx)
        out[backend] = [(s.policy, s.hits, s.misses, s.evictions)
                        for s in stats]
    assert out["kernel"] == out["numpy"]
    assert len(out["kernel"]) == 15
    assert all(e > 0 for *_, e in out["numpy"])
    n_chunks = -(-1_500 // 128)
    if not approx:
        assert similarity_topk.multi_launches == n_chunks
    elif approx == {"quantized": True}:
        assert similarity_topk.topk_q8_multi_launches == n_chunks


# ---------------------------------------------------------------- attention
# fp32 outputs: within 2e-5 of the plain version (fp32 sums in another
# order); bf16 outputs: within one bf16 ulp of it (both round an fp32 value
# that agrees to ~1e-6; 2^-7 |x| bounds one ulp of x), plus 1e-6 of that
# fp32 noise near zero.
def _attn_close(out, plain):
    err = (out.float() - plain.float()).abs()
    if out.dtype == torch.bfloat16:
        ok = err <= 2.0 ** -7 * plain.float().abs() + 1e-6
    else:
        ok = err <= 2e-5
    assert bool(ok.all()), f"max |err| {float(err.max())}"


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 1, 1, 1, 64), (1, 3, 1, 63, 64), (2, 15, 5, 200, 64),
    (1, 8, 2, 513, 128), (2, 4, 1, 65, 128), (1, 12, 3, 1000, 64),
    (3, 4, 4, 130, 64),
    # the ring and the tiles: the model's heads at S = 4,096 (32 query
    # tiles, 32 key stages), ragged S around D = 128's 64-key stages and
    # the 128-row query tile, and G = 3 at B = 2
    (1, 15, 5, 4096, 64), (1, 4, 2, 127, 128), (2, 4, 2, 129, 128),
    (1, 6, 3, 255, 128), (2, 6, 2, 300, 64),
    # the other head dims of configs/: the smoke variants' 32 (64-byte
    # rows), nemotron's 192 (three column blocks, G = 12) and gemma's 256
    # (two column blocks, three stages), S ragged around the 64-key
    # stages and the 128-row query tiles
    (1, 4, 2, 63, 32), (2, 4, 2, 129, 32), (1, 4, 4, 1000, 32),
    (1, 24, 2, 65, 192), (2, 4, 2, 191, 192), (1, 12, 1, 257, 192),
    (1, 4, 4, 127, 256), (2, 2, 1, 129, 256), (1, 16, 16, 600, 256)])
def test_flash_attention_kernel_matches_plain(cuda, rng, b, h, hkv, s, d,
                                              dtype):
    from repro_torch.kernels import flash_attention, ref
    q = _randn(rng, (b, h, s, d), dtype, cuda)
    k = _randn(rng, (b, hkv, s, d), dtype, cuda)
    v = _randn(rng, (b, hkv, s, d), dtype, cuda)
    before = flash_attention.launches
    wgmma = flash_attention.wgmma_launches
    out = flash_attention.flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    # every bf16 call takes the Hopper kernel, no fp32 call does
    assert flash_attention.wgmma_launches == wgmma + (dtype == torch.bfloat16)
    assert out.shape == q.shape and out.dtype == dtype
    _attn_close(out, ref.attention_ref(q, k, v))


def test_flash_attention_kernel_takes_the_model_layout(cuda, rng):
    """(B,S,H,D) projections passed as transpose(1, 2) views: the same
    result as contiguous inputs, and the output keeps q's strides."""
    from repro_torch.kernels import flash_attention
    b, s, h, hkv, d = 2, 150, 6, 2, 64
    q = _randn(rng, (b, s, h, d), torch.bfloat16, cuda)
    k = _randn(rng, (b, s, hkv, d), torch.bfloat16, cuda)
    v = _randn(rng, (b, s, hkv, d), torch.bfloat16, cuda)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = flash_attention.flash_attention(qt, kt, vt)
    assert out.stride() == qt.stride()
    assert out.transpose(1, 2).is_contiguous()
    want = flash_attention.flash_attention(
        *(x.contiguous() for x in (qt, kt, vt)))
    assert torch.equal(out, want)


def test_flash_attention_refuses_strides_tma_cannot_take(cuda, rng):
    """A bf16 view whose sequence stride is 130 bytes (65 elements) is
    refused, not copied; the fp32 (SIMT) kernel takes the same view."""
    from repro_torch.kernels import flash_attention, ref
    b, h, s, d = 1, 4, 40, 64
    wide = _randn(rng, (b, h, s, d + 1), torch.bfloat16, cuda)
    q = wide[..., :d]
    assert q.stride(2) * q.element_size() % 16 != 0
    kv = _randn(rng, (b, 2, s, d), torch.bfloat16, cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        flash_attention.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention.flash_attention(kv.repeat(1, 2, 1, 1), q[:, :2],
                                        kv)
    assert flash_attention.launches == before
    q32, kv32 = q.float(), kv.float()
    out = flash_attention.flash_attention(wide.float()[..., :d], kv32, kv32)
    _attn_close(out, ref.attention_ref(q32, kv32, kv32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 1, 1, 1, 64), (8, 15, 5, 512, 64), (3, 4, 1, 257, 128),
    (2, 8, 2, 33, 128), (5, 12, 3, 2048, 64), (128, 15, 5, 300, 64),
    (4, 4, 4, 100, 64),
    # the smoke variants' 32, nemotron's 192 at its G = 12 and gemma's 256
    # at G = 1 (the merge kernel launches D threads)
    (3, 4, 2, 33, 32), (8, 4, 4, 2048, 32), (2, 24, 2, 257, 192),
    (4, 12, 1, 1000, 192), (8, 16, 16, 512, 256), (1, 2, 1, 31, 256)])
def test_decode_attention_kernel_matches_plain(cuda, rng, b, h, hkv, s, d,
                                               dtype):
    from repro_torch.kernels import decode_attention, ref
    q = _randn(rng, (b, h, d), dtype, cuda)
    k = _randn(rng, (b, s, hkv, d), dtype, cuda)
    v = _randn(rng, (b, s, hkv, d), dtype, cuda)
    pos = rng.integers(0, s, b).astype(np.int32)
    pos[0] = 0
    pos[-1] = s - 1
    pos = torch.from_numpy(pos).to(cuda)
    before = decode_attention.launches
    out = decode_attention.decode_attention(q, k, v, pos)
    assert decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _attn_close(out, ref.decode_attention_ref(q, k, v, pos))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("g", [1, 3, 12])
@pytest.mark.parametrize("splits", ["one", "most"])
def test_decode_attention_every_head_dim_group_and_pos_edge(
        cuda, rng, monkeypatch, dtype, d, g, splits):
    """pos < 0 gives 0; pos = 0, a stage's last key and the next one,
    S_max - 1 and past the cache match the plain version, with the split
    count forced to one and to a stage a split."""
    from repro_torch.kernels import decode_attention as da, ref
    s_max, hkv = 300, 2
    keys = da.stage_keys(d, dtype)
    monkeypatch.setattr(da, "split_plan", lambda rows, s, ks, wave:
                        1 if splits == "one" else -(-s // ks))
    pos = torch.tensor([-1, 0, keys - 1, keys, 2 * keys, s_max - 1,
                        s_max + 7], dtype=torch.int32, device=cuda)
    b = pos.shape[0]
    q = _randn(rng, (b, hkv * g, d), dtype, cuda)
    k = _randn(rng, (b, s_max, hkv, d), dtype, cuda)
    v = _randn(rng, (b, s_max, hkv, d), dtype, cuda)
    out = da.decode_attention(q, k, v, pos)
    assert bool((out[0] == 0).all())
    _attn_close(out[1:], ref.decode_attention_ref(q, k, v, pos)[1:])


def test_decode_attention_refuses_a_group_the_kernel_cannot_hold(cuda, rng):
    from repro_torch.kernels import decode_attention as da
    q = _randn(rng, (1, 17, 256), torch.bfloat16, cuda)
    kv = _randn(rng, (1, 8, 1, 256), torch.bfloat16, cuda)
    before = da.launches
    with pytest.raises(ValueError, match="do not fit"):
        da.decode_attention(q, kv, kv, torch.zeros(1, dtype=torch.int32,
                                                   device=cuda))
    assert da.launches == before


def test_decode_attention_reads_only_up_to_pos(cuda, rng):
    """Keys past pos never reach the output: NaN there changes nothing."""
    from repro_torch.kernels import decode_attention
    b, s, hkv, h, d = 4, 700, 5, 15, 64
    q = _randn(rng, (b, h, d), torch.bfloat16, cuda)
    k = _randn(rng, (b, s, hkv, d), torch.bfloat16, cuda)
    v = _randn(rng, (b, s, hkv, d), torch.bfloat16, cuda)
    pos = torch.tensor([0, 5, 333, 698], dtype=torch.int32, device=cuda)
    want = decode_attention.decode_attention(q, k, v, pos)
    for i, p in enumerate(pos.tolist()):
        k[i, p + 1:] = float("nan")
        v[i, p + 1:] = float("nan")
    assert torch.equal(decode_attention.decode_attention(q, k, v, pos), want)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda, rng):
    from repro_torch.kernels import decode_attention, flash_attention
    fa, da = flash_attention.flash_attention, decode_attention.decode_attention
    q = _randn(rng, (1, 4, 10, 64), torch.float32, cuda)
    kv = _randn(rng, (1, 2, 10, 64), torch.float32, cuda)
    with pytest.raises(ValueError):                     # dtype
        fa(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):                     # head dim
        fa(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(ValueError):                     # H % Hkv
        fa(q[:, :3], kv, kv)
    with pytest.raises(ValueError):                     # mixed dtypes
        fa(q, kv.to(torch.bfloat16), kv)
    qd = _randn(rng, (2, 4, 64), torch.float32, cuda)
    cache = _randn(rng, (2, 16, 2, 64), torch.float32, cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                     # pos dtype
        da(qd, cache, cache, pos.long())
    with pytest.raises(ValueError):                     # contiguity
        da(qd, cache.transpose(0, 1).contiguous().transpose(0, 1), cache,
           pos)
    with pytest.raises(ValueError):                     # head dim
        da(qd[..., :48].contiguous(), cache[..., :48].contiguous(),
           cache[..., :48].contiguous(), pos)
    with pytest.raises(ValueError):                     # pos on the host
        da(qd, cache, cache, pos.cpu())


def test_attention_wrappers_never_take_the_plain_version_on_the_card(
        cuda, rng, monkeypatch):
    from repro_torch.kernels import ops, ref

    def refuse(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")
    for name in ("attention_ref", "decode_attention_ref"):
        monkeypatch.setattr(ref, name, refuse)
    ops.flash_attention(*(_randn(rng, (1, 2, 9, 64), torch.bfloat16, cuda)
                          for _ in range(3)))
    ops.decode_attention(_randn(rng, (1, 2, 64), torch.bfloat16, cuda),
                         _randn(rng, (1, 9, 2, 64), torch.bfloat16, cuda),
                         _randn(rng, (1, 9, 2, 64), torch.bfloat16, cuda),
                         torch.tensor([4], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()


# MLA's (Q/K, V) head dims (deepseek-v2-lite-16b's 192/128, its smoke
# variant's 48/32) and sliding windows (hymba-1.5b's 2,048 at G = 5, D =
# 64; its smoke variant's 64 at D = 32; windows narrower than a 64-key
# tile, and of one key); S ragged around the stages and the query tiles
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,dv,window", [
    (1, 16, 16, 300, 192, 128, 0), (2, 4, 4, 129, 48, 32, 0),
    (1, 4, 4, 1000, 48, 32, 0), (2, 16, 16, 130, 192, 128, 0),
    (1, 25, 5, 2300, 64, 64, 2048), (1, 10, 2, 600, 64, 64, 256),
    (2, 4, 2, 300, 32, 32, 64), (1, 4, 2, 200, 32, 32, 40),
    (1, 6, 3, 257, 64, 64, 17), (1, 4, 2, 150, 64, 64, 1),
    (1, 4, 4, 257, 192, 128, 100), (2, 4, 4, 130, 48, 32, 33),
    (1, 8, 2, 700, 128, 128, 129), (1, 4, 1, 300, 256, 256, 65)])
def test_flash_attention_mla_heads_and_windows_match_plain(
        cuda, rng, b, h, hkv, s, d, dv, window, dtype):
    from repro_torch.kernels import flash_attention, ref
    q = _randn(rng, (b, h, s, d), dtype, cuda)
    k = _randn(rng, (b, hkv, s, d), dtype, cuda)
    v = _randn(rng, (b, hkv, s, dv), dtype, cuda)
    before = flash_attention.launches
    wgmma = flash_attention.wgmma_launches
    out = flash_attention.flash_attention(q, k, v, window)
    assert flash_attention.launches == before + 1
    assert flash_attention.wgmma_launches == wgmma + (dtype == torch.bfloat16)
    assert out.shape == (b, h, s, dv) and out.dtype == dtype
    _attn_close(out, ref.attention_ref(q, k, v, window=window))


def test_flash_attention_mla_output_follows_the_model_layout(cuda, rng):
    """MLA's (B,S,H,192) q/k and (B,S,H,128) v as transpose(1, 2) views:
    the (B,H,S,128) output is a transposed view of a dense (B,S,H,128)."""
    from repro_torch.kernels import flash_attention, ref
    b, s, h, d, dv = 2, 200, 16, 192, 128
    q, k = (_randn(rng, (b, s, h, d), torch.bfloat16, cuda) for _ in "qk")
    v = _randn(rng, (b, s, h, dv), torch.bfloat16, cuda)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = flash_attention.flash_attention(qt, kt, vt)
    assert out.shape == (b, h, s, dv) and out.transpose(1, 2).is_contiguous()
    _attn_close(out, ref.attention_ref(qt, kt, vt))


# MLA's absorbed decode: one kv head, V the first Dv columns of each K row
# (a view, read once), the scale 1/sqrt(hd + rh) (deepseek: 192, its
# smoke variant: 48), G = 16 and G = 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,s,d,dv,scale", [
    (3, 16, 300, 576, 512, 192 ** -0.5), (4, 16, 2100, 576, 512, 192 ** -0.5),
    (2, 4, 257, 576, 512, 192 ** -0.5), (8, 16, 40, 576, 512, 0.3),
    (2, 4, 100, 80, 64, 48 ** -0.5), (5, 4, 2049, 80, 64, 48 ** -0.5),
    (3, 16, 129, 80, 64, 48 ** -0.5)])
def test_decode_attention_v_as_a_view_of_k_matches_plain(
        cuda, rng, b, g, s, d, dv, scale, dtype):
    from repro_torch.kernels import decode_attention as da, ref
    q = _randn(rng, (b, g, d), dtype, cuda)
    rows = _randn(rng, (b, s, 1, d), dtype, cuda)
    v = rows[..., :dv]
    assert da.v_in_k(rows, v) and not v.is_contiguous()
    pos = rng.integers(0, s, b).astype(np.int32)
    pos[0], pos[-1] = 0, s - 1
    pos = torch.from_numpy(pos).to(cuda)
    before = da.launches
    out = da.decode_attention(q, rows, v, pos, scale)
    assert da.launches == before + 1
    assert out.shape == (b, g, dv) and out.dtype == dtype
    want = ref.decode_attention_ref(q, rows, v, pos, scale)
    _attn_close(out, want)
    # V in a tensor of its own: the same function through the second map
    _attn_close(da.decode_attention(q, rows, v.contiguous(), pos, scale),
                want)


def test_attention_wrappers_raise_on_unsupported_head_dims(cuda, rng):
    """Shapes the kernels are not built for raise on the card rather than
    take the plain version."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    q = _randn(rng, (1, 4, 64, 192), torch.bfloat16, cuda)
    v = _randn(rng, (1, 4, 64, 64), torch.bfloat16, cuda)
    n8, n9 = fa.launches, da.launches
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, v)                     # (192, 64)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, -1)
    rows = _randn(rng, (2, 50, 1, 576), torch.bfloat16, cuda)
    qd = _randn(rng, (2, 16, 576), torch.bfloat16, cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        da.decode_attention(qd, rows, rows[..., :256], pos)   # (576, 256)
    with pytest.raises(ValueError, match="column-prefix"):
        da.decode_attention(qd, rows, rows[..., 64:], pos)    # not a prefix
    with pytest.raises(ValueError, match="do not fit"):
        da.decode_attention(_randn(rng, (2, 17, 576), torch.bfloat16, cuda),
                            rows, rows[..., :512], pos)
    assert (fa.launches, da.launches) == (n8, n9)


# non-causal B8: every query over all T keys, T free of S (whisper's
# encoder, S = T = 1,500 frames, and its cross attention, 448 text rows over
# 1,500 frames; T around the 64-key stages, and one key)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 1500])
@pytest.mark.parametrize("s", [1, 448, 1500])
def test_flash_attention_non_causal_matches_plain(cuda, rng, s, t, dtype):
    from repro_torch.kernels import flash_attention, ref
    b, h, hkv, d = 1, 4, 2, 64
    q = _randn(rng, (b, h, s, d), dtype, cuda)
    k = _randn(rng, (b, hkv, t, d), dtype, cuda)
    v = _randn(rng, (b, hkv, t, d), dtype, cuda)
    before = flash_attention.launches
    wgmma = flash_attention.wgmma_launches
    out = flash_attention.flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    assert flash_attention.wgmma_launches == wgmma + (dtype == torch.bfloat16)
    assert out.shape == (b, h, s, d) and out.dtype == dtype
    _attn_close(out, ref.attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,t,d,dv", [
    (1, 16, 16, 1500, 1500, 64, 64), (1, 16, 16, 448, 1500, 64, 64),
    (2, 6, 2, 130, 77, 128, 128), (1, 4, 4, 200, 300, 32, 32),
    (1, 4, 4, 129, 40, 192, 128), (1, 2, 1, 70, 130, 256, 256)])
def test_flash_attention_non_causal_heads_match_plain(cuda, rng, b, h, hkv,
                                                      s, t, d, dv, dtype):
    """whisper's two shapes at its 16 heads (passed as the model passes
    them: transposed (B,S,H,D) projections), and the other head dims."""
    from repro_torch.kernels import flash_attention, ref
    q = _randn(rng, (b, s, h, d), dtype, cuda).transpose(1, 2)
    k = _randn(rng, (b, t, hkv, d), dtype, cuda).transpose(1, 2)
    v = _randn(rng, (b, t, hkv, dv), dtype, cuda).transpose(1, 2)
    out = flash_attention.flash_attention(q, k, v, causal=False)
    assert out.shape == (b, h, s, dv)
    if dv == d:
        assert out.stride() == q.stride()
    _attn_close(out, ref.attention_ref(q, k, v, causal=False))


def test_flash_attention_non_causal_refuses_what_it_does_not_take(cuda,
                                                                   rng):
    """A causal pass needs T == S; a window only with the causal mask; the
    card never takes the plain version for a non-causal call."""
    from repro_torch.kernels import flash_attention as fa
    q = _randn(rng, (1, 4, 30, 64), torch.bfloat16, cuda)
    kv = _randn(rng, (1, 2, 20, 64), torch.bfloat16, cuda)
    n8 = fa.launches
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, kv, kv, 8, causal=False)
    assert fa.launches == n8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t", [(8, 16, 1500), (3, 4, 1), (2, 4, 65),
                                   (1, 16, 1499)])
def test_decode_attention_cross_decode_matches_plain(cuda, rng, b, h, t,
                                                     dtype):
    """B9 as whisper's cross-attention decode: one query row over all T
    encoder positions (pos = T - 1 for every row; T = 1,500 is no multiple
    of a stage), K/V the (B,T,H,D) projections of the encoder's output."""
    from repro_torch.kernels import decode_attention as da, ref
    q = _randn(rng, (b, h, 64), dtype, cuda)
    k = _randn(rng, (b, t, h, 64), dtype, cuda)
    v = _randn(rng, (b, t, h, 64), dtype, cuda)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=cuda)
    before = da.launches
    out = da.decode_attention(q, k, v, pos)
    assert da.launches == before + 1
    _attn_close(out, ref.decode_attention_ref(q, k, v, pos))
    # the same function as non-causal B8 of one query row
    full = ref.attention_ref(q[:, :, None], k.transpose(1, 2),
                             v.transpose(1, 2), causal=False)[:, :, 0]
    _attn_close(out, full)


@pytest.mark.parametrize("arch", ["whisper-medium", "xlstm-125m",
                                  "internvl2-26b"])
def test_the_last_families_run_on_the_card(cuda, arch):
    """The encoder-decoder, xLSTM (with an sLSTM layer) and VLM smoke
    variants, fp32: forward on the card within 1e-4 of the same parameters
    on the host (whisper: B8 non-causal in its encoder and its cross
    attention, causal in its decoder: 3 launches a layer), teacher-forced
    decode within 1e-4 of the host's decode (whisper with the encoder's
    output: B9 twice a layer, self and cross)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import Model, smoke_variant
    cfg = smoke_variant(get_config(arch))
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, slstm_at=(1,))
    host, card = Model(cfg, "cpu"), Model(cfg, "cuda")
    params = host.init(torch.Generator().manual_seed(7))
    cparams = _move(params, cuda)
    rng = np.random.default_rng(1)
    s = 24
    batch = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                                     (2, s)))}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    per_layer = {"encdec": 3, "ssm": 0}.get(cfg.family, 1)
    f0 = flash_attention.launches
    full = card.forward(cparams, batch)
    assert flash_attention.launches == f0 + per_layer * cfg.n_layers
    want = host.forward(params, batch)
    assert float((full.cpu() - want).abs().max()) <= 1e-4
    extra = {}
    if cfg.family == "encdec":
        extra["enc_out"] = card._encode(cparams, batch["audio_embeds"])
    hcache, cache = host.init_cache(2, s), card.init_cache(2, s)
    d0 = decode_attention.launches
    for p in range(s):
        step = {"tokens": batch["tokens"][:, p:p + 1],
                "pos": torch.full((2,), p, dtype=torch.int32)}
        logits, cache = card.decode_step(cparams, cache, {**step, **extra})
        hlogits, hcache = host.decode_step(params, hcache, {
            **step, **{k: v.cpu() for k, v in extra.items()}})
        assert float((logits.cpu() - hlogits).abs().max()) <= 1e-4
        if cfg.family != "vlm":
            assert float((logits - full[:, p]).abs().max()) <= 1e-4
    per_step = {"encdec": 2, "ssm": 0}.get(cfg.family, 1)
    assert decode_attention.launches == d0 + s * per_step * cfg.n_layers


_FAMILIES = ["deepseek-v2-lite-16b", "grok-1-314b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", _FAMILIES)
def test_every_family_runs_on_the_card(cuda, arch):
    """The MoE/MLA and hybrid smoke variants, fp32: forward on the card
    (B8 at 48/32 for deepseek, windowed for hymba) within 1e-4 of the same
    parameters on the host, and teacher-forced decode (B9 at 80/64 with V
    a view of the latent rows; hymba past its window of 64, through the
    ring) within 1e-4 of forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import Model, smoke_variant
    cfg = smoke_variant(get_config(arch))
    host = Model(cfg, "cpu")
    params = host.init(torch.Generator().manual_seed(7))
    card = Model(cfg, "cuda")
    cparams = _move(params, cuda)
    s = 90 if cfg.family == "hybrid" else 24
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, s)))
    f0 = flash_attention.launches
    full = card.forward(cparams, {"tokens": tokens})
    assert flash_attention.launches == f0 + cfg.n_layers
    want = host.forward(params, {"tokens": tokens})
    assert float((full.cpu() - want).abs().max()) <= 1e-4
    cache = card.init_cache(2, s + 8)
    d0 = decode_attention.launches
    for p in range(s):
        logits, cache = card.decode_step(cparams, cache, {
            "tokens": tokens[:, p:p + 1],
            "pos": torch.full((2,), p, dtype=torch.int32)})
        assert float((logits - full[:, p]).abs().max()) <= 1e-4
    assert decode_attention.launches == d0 + s * cfg.n_layers


def _card_model_cfg():
    """A small dense config the card's kernels take (head dim 64, G = 3),
    in fp32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import smoke_variant
    return dataclasses.replace(smoke_variant(get_config("paper")),
                               n_heads=6, n_kv_heads=2, head_dim=64)


def _move(tree, device):
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_move(v, device) for v in tree]
    return tree.to(device)


def test_model_on_the_card_matches_the_host(cuda):
    """forward and teacher-forced decode_step on the card (B8, B9) against
    the same parameters on the host (plain versions), fp32: logits within
    1e-4; decode against forward at every position within 1e-4."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import Model
    cfg = _card_model_cfg()
    host = Model(cfg, "cpu")
    params = host.init(torch.Generator().manual_seed(3))
    card = Model(cfg, "cuda")
    cparams = _move(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 40)))
    f0 = flash_attention.launches
    full = card.forward(cparams, {"tokens": tokens})
    assert flash_attention.launches == f0 + cfg.n_layers
    want = host.forward(params, {"tokens": tokens})
    assert float((full.cpu() - want).abs().max()) <= 1e-4
    cache = card.init_cache(2, 48)
    d0 = decode_attention.launches
    for p in range(40):
        logits, cache = card.decode_step(cparams, cache, {
            "tokens": tokens[:, p:p + 1],
            "pos": torch.full((2,), p, dtype=torch.int32)})
        assert float((logits - full[:, p]).abs().max()) <= 1e-4
    assert decode_attention.launches == d0 + 40 * cfg.n_layers


_DENSE = ["paper", "smollm-360m", "gemma-7b", "qwen1.5-110b",
          "nemotron-4-340b"]


@pytest.mark.parametrize("own_head_dim", [False, True])
@pytest.mark.parametrize("arch", _DENSE)
def test_every_dense_arch_runs_on_the_card(cuda, arch, own_head_dim):
    """Each dense arch at its smoke variant (head dim 32) and at the smoke
    variant with the arch's own head dim (64 to 256), fp32: forward on the
    card (B8) within 1e-4 of the same parameters on the host, and
    teacher-forced decode (B9) within 1e-4 of forward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import Model, smoke_variant
    cfg = smoke_variant(get_config(arch))
    if own_head_dim:
        cfg = dataclasses.replace(cfg, head_dim=get_config(arch).head_dim)
    host = Model(cfg, "cpu")
    params = host.init(torch.Generator().manual_seed(7))
    card = Model(cfg, "cuda")
    cparams = _move(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, 24)))
    f0 = flash_attention.launches
    full = card.forward(cparams, {"tokens": tokens})
    assert flash_attention.launches == f0 + cfg.n_layers
    want = host.forward(params, {"tokens": tokens})
    assert float((full.cpu() - want).abs().max()) <= 1e-4
    cache = card.init_cache(2, 32)
    d0 = decode_attention.launches
    for p in range(24):
        logits, cache = card.decode_step(cparams, cache, {
            "tokens": tokens[:, p:p + 1],
            "pos": torch.full((2,), p, dtype=torch.int32)})
        assert float((logits - full[:, p]).abs().max()) <= 1e-4
    assert decode_attention.launches == d0 + 24 * cfg.n_layers


def test_engine_on_the_card_matches_the_host(cuda):
    """The serving engine on the card (kernel backend, B1-B3 and B9) makes
    the host engine's decisions and tokens (numpy backend, plain
    versions), from the same fp32 parameters."""
    from repro_torch.core import SynthConfig, synthetic_trace
    from repro_torch.kernels import decision, decode_attention, similarity_topk
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = _card_model_cfg()
    trace = synthetic_trace(SynthConfig(trace_len=40, n_topics=6, seed=2))
    rng = np.random.default_rng(2)
    reqs = [(r.cid, r.emb, list(rng.integers(2, cfg.vocab_size,
                                             size=int(rng.integers(2, 9)))))
            for r in trace.requests]
    out = {}
    params = None
    for backend, device in (("numpy", "cpu"), ("kernel", "cuda")):
        # the card's run takes EngineConfig's defaults: the kernel backend
        # on the card
        ecfg = (EngineConfig(cache_capacity=12, max_new_tokens=4,
                             max_batch=4, max_seq=32, cache_backend=backend,
                             device=device) if device == "cpu" else
                EngineConfig(cache_capacity=12, max_new_tokens=4,
                             max_batch=4, max_seq=32))
        eng = ServingEngine(cfg, ecfg,
                            params=None if params is None
                            else _move(params, device),
                            generator=torch.Generator().manual_seed(5))
        params = params or eng.params
        d0 = decode_attention.launches
        b0 = similarity_topk.launches, decision.launches
        done = eng.run(reqs)
        s = eng.stats
        out[backend] = ([(r.rid, r.cached, tuple(r.out_tokens))
                         for r in done],
                        {k: s[k] for k in ("hits", "misses", "evictions",
                                           "generated_tokens", "batches")})
        if device == "cuda":
            assert decode_attention.launches - d0 == \
                s["batches"] * cfg.n_layers
            assert similarity_topk.launches > b0[0]      # B1
            assert decision.launches > b0[1]             # B2
    assert out["kernel"] == out["numpy"]
    assert out["numpy"][1]["hits"] > 0 and out["numpy"][1]["evictions"] > 0


def _kv_trace(seed: int, n: int) -> list[list[int]]:
    """Hot shared prefixes, extensions and one-off conversations."""
    rng = np.random.default_rng(seed)
    hot = [list(range(16)), list(range(700, 712))]
    convs = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            h = hot[int(rng.integers(0, len(hot)))]
            convs.append(h + [int(x) for x in rng.integers(
                500, 600, size=int(rng.integers(0, 12)))])
        elif r < 0.4:
            convs.append(hot[0][: 4 * int(rng.integers(1, 5))])
        else:
            base = 1000 + 40 * int(rng.integers(0, 60))
            convs.append(list(range(base, base + int(rng.integers(3, 30)))))
    return convs


@pytest.mark.parametrize("n_blocks", [3, 24, 200])
def test_kv_manager_on_the_card_matches_its_cpu_run(cuda, n_blocks):
    """KVBlockManager on the card (B3 through rac_value_masked, one launch
    an eviction, the mask in the kernel) makes its device="cpu" run's
    decisions request by request; content lookups never launch B1."""
    from repro_torch.kernels import rac_value, similarity_topk
    from repro_torch.serving import KVBlockManager
    out = {}
    for device in ("cpu", "cuda"):
        mgr = KVBlockManager(n_blocks=n_blocks, block_tokens=4,
                             device=device)
        b3, b1 = rac_value.launches, similarity_topk.launches
        out[device] = [
            (r["hit_tokens"], r["hit_blocks"], r["new_blocks"], r["topic"],
             r["evicted"])
            for r in (mgr.on_request(c) for c in _kv_trace(n_blocks, 400))]
        if device == "cuda":
            assert rac_value.launches - b3 == mgr.cache.metrics.evictions > 0
            assert similarity_topk.launches == b1
            assert set(mgr.blocks) == set(mgr.cache.store.keys())
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("async_admit", [False, "sync", True])
@pytest.mark.parametrize("hit_mode", ["content", "semantic"])
def test_tiered_async_cache_on_the_card_matches_numpy(cuda, hit_mode,
                                                      async_admit):
    """The tiered facade on the card (B1 lookups, B3 evictions, the host
    tier scanned on the host) gives NumpyBackend's event stream, flushed
    at every request, in each admission mode."""
    from repro_torch.cache import CacheConfig, SemanticCache, TierConfig
    from repro_torch.core import SynthConfig, synthetic_trace
    trace = synthetic_trace(SynthConfig(trace_len=400, n_topics=6, dim=64,
                                        seed=2))
    out = {}
    for backend, device in (("numpy", "cpu"), ("kernel", "cuda")):
        cache = SemanticCache(CacheConfig(
            capacity=16, dim=64, hit_mode=hit_mode, backend=backend,
            device=device, async_admit=async_admit,
            tiers=TierConfig(host_capacity=24, ghost_capacity=64)))
        log = []
        for kind in ("hit", "miss", "admit", "evict"):
            cache.subscribe(kind, lambda ev, _l=log: _l.append(
                (ev.kind, int(ev.cid), int(ev.t), ev.tier)))
        for r in trace.requests:
            if not cache.lookup(r.emb, cid=r.cid, t=r.t).hit:
                cache.admit(r.cid, r.emb, payload=(r.cid,), t=r.t)
            cache.flush()
        cache.close()
        out[backend] = (log, cache.tier_stats)
    assert out["kernel"] == out["numpy"]
    assert out["numpy"][1]["host_hits"] > 0


def test_engine_async_on_the_card_matches_its_synchronous_run(cuda):
    """The engine on the card with async_admit=True and the tiers makes the
    synchronous run's outputs (tokens, cached flags, counters)."""
    from repro_torch.core import SynthConfig, synthetic_trace
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = _card_model_cfg()
    trace = synthetic_trace(SynthConfig(trace_len=60, n_topics=8, seed=4))
    rng = np.random.default_rng(4)
    reqs = [(r.cid, r.emb, [int(t) for t in rng.integers(
        2, cfg.vocab_size, size=3)]) for r in trace.requests]
    out = {}
    params = None
    for async_admit in (False, True):
        eng = ServingEngine(cfg, EngineConfig(
            cache_capacity=8, max_new_tokens=3, max_batch=4, max_seq=32,
            host_capacity=16, ghost_capacity=32, async_admit=async_admit),
            params=params, generator=torch.Generator("cuda").manual_seed(5))
        params = params or eng.params
        done = eng.run(reqs)
        s = eng.stats
        eng.close()
        out[async_admit] = ([(r.rid, r.cached, tuple(r.out_tokens))
                             for r in done],
                            {k: s[k] for k in ("hits", "misses", "evictions",
                                               "generated_tokens",
                                               "batches")},
                            eng.cache.tier_stats)
    assert out[True] == out[False]
    assert out[False][1]["hits"] > 0 and out[False][2]["demotions"] > 0


# ------------------------------------------------------ the sharded backend
def _sharded_pair(rng, n_shards, capacity, n, d, dev):
    """A ShardedStore filled with ``n`` seeded unit rows, and a dense
    ResidentStore holding the same rows in the same slots."""
    from repro_torch.cache import ShardedStore
    from repro_torch.core.store import ResidentStore
    rows = _unit(rng, n, d, "cpu").numpy()
    sh = ShardedStore(capacity, d, n_shards)
    for i, e in enumerate(rows):
        sh.insert(i, e)
    for c in range(0, n, 7):                 # freed rows inside shards
        sh.remove(c)
    dense = ResidentStore(capacity, d, n_slots=sh.emb.shape[0])
    dense.emb[:], dense.occ[:], dense.cid[:] = sh.emb, sh.occ, sh.cid
    dense.slot_of, dense.hwm = dict(sh.slot_of), sh.hwm
    dense._free = [s for s in range(sh.emb.shape[0] - 1, -1, -1)
                   if not sh.occ[s]]
    near = rows[::3] + 0.1 * _unit(rng, len(rows[::3]), d, "cpu").numpy()
    q = np.concatenate([near / np.linalg.norm(near, axis=1, keepdims=True),
                        _unit(rng, 40, d, "cpu").numpy()])
    return sh, dense, q.astype(np.float32)


@pytest.fixture(params=["loop", "mesh"])
def shard_path(request, monkeypatch):
    """The one-card loop, or the multi-card code path with every shard's
    card patched to ``cuda:0``."""
    if request.param == "mesh":
        from repro_torch.launch import mesh
        monkeypatch.setattr(mesh, "make_cache_mesh",
                            lambda n, device="cuda": [torch.device(
                                "cuda", 0)] * n)
    return request.param


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_top1_is_bit_equal_to_the_kernel_backend(cuda, rng,
                                                         shard_path,
                                                         n_shards):
    from repro_torch.cache import KernelBackend, ShardedKernelBackend
    from repro_torch.kernels import similarity_topk as st
    sh, dense, q = _sharded_pair(rng, n_shards, 6_000, 5_000, 768, cuda)
    be = ShardedKernelBackend(n_shards=n_shards)
    assert (be.mesh() is not None) == (shard_path == "mesh")
    before = st.launches
    got = be.top1_batch(sh, q)
    assert st.launches == before + n_shards       # one B1 a shard
    want = KernelBackend().top1_batch(dense, q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])   # the same fp32 bits
    assert (got[0] >= 0).sum() > 100


def test_sharded_shards_as_one_multi_launch_give_the_loops_bits(cuda, rng):
    """The shards scored by one B1-multi (the shard as the policy axis,
    per-shard counts on the card) give the B1 loop's bits: one tile shape,
    one arithmetic."""
    from repro_torch.kernels import similarity_topk as st
    sh, _, q = _sharded_pair(rng, 4, 6_000, 5_000, 768, cuda)
    slab = torch.from_numpy(sh.shard_view().copy()).to(cuda)
    qd = torch.from_numpy(q).to(cuda)
    mv, mi = st.sim_top1_multi(qd, slab, _counts(
        tuple(int(x) for x in sh.local_hwm), cuda))
    for s in range(4):
        v, i = st.sim_top1(qd, slab[s], int(sh.local_hwm[s]))
        assert torch.equal(v, mv[s]) and torch.equal(i, mi[s])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_decide_batch_equals_the_kernel_backend(cuda, shard_path,
                                                        n_shards):
    """A RAC replay through decide_batch on the sharded backend makes the
    kernel backend's decisions; the last pass's columns agree cid by cid
    (hit sims and victim values in the same bits)."""
    from repro_torch.cache import CacheConfig, SemanticCache
    from repro_torch.core import OASSTConfig, oasst_style_trace
    from repro_torch.core.simulator import replay_batched
    tr = oasst_style_trace(OASSTConfig(trace_len=3_000, dim=128, seed=4))
    caches = {}
    for backend, kw in (("sharded", {"n_shards": n_shards}),
                        ("kernel", {})):
        cache = SemanticCache(CacheConfig(capacity=300, dim=128,
                                          backend=backend,
                                          backend_kwargs=kw))
        ev = []
        for kind in ("hit", "miss", "admit", "evict"):
            cache.subscribe(kind, lambda e, k=kind: ev.append((k, e.cid)))
        replay_batched(cache, tr.requests, chunk=256)
        caches[backend] = (cache, ev)
    (sc, sev), (kc, kev) = caches["sharded"], caches["kernel"]
    assert sev == kev and any(k == "evict" for k, _ in kev)
    q = np.stack([r.emb for r in tr.requests[:256]]).astype(np.float32)
    ds, dk = sc.decide_batch(q), kc.decide_batch(q)
    np.testing.assert_array_equal(ds.hit_cid, dk.hit_cid)
    np.testing.assert_array_equal(ds.hit_sim, dk.hit_sim)
    np.testing.assert_array_equal(ds.route_tid, dk.route_tid)
    np.testing.assert_array_equal(ds.route_sim, dk.route_sim)
    cids = sorted(kc.store.slot_of)
    assert cids == sorted(sc.store.slot_of)
    np.testing.assert_array_equal(
        [ds.victim_value[sc.store.slot_of[c]] for c in cids],
        [dk.victim_value[kc.store.slot_of[c]] for c in cids])
    assert np.isposinf(ds.victim_value[~sc.store.occ]).all()


def test_sharded_rac_value_in_chunks_is_bit_equal_to_one_launch(cuda, rng):
    from repro_torch.cache import KernelBackend, ShardedKernelBackend
    from repro_torch.kernels import rac_value
    from repro_torch.launch import mesh
    n, t = 65_537, 4_096
    args = (rng.random(n), rng.integers(0, t, n), rng.random(t),
            rng.integers(0, 10_000, t), 0.001, 12_000)
    valid = rng.random(n) < 0.9
    want = KernelBackend().rac_value(*args)
    want_m = KernelBackend().rac_value_masked(*args, valid)
    orig = mesh.make_cache_mesh
    try:
        mesh.make_cache_mesh = lambda s, device="cuda": [
            torch.device("cuda", 0)] * s
        be = ShardedKernelBackend(n_shards=4)
        before = rac_value.launches
        got = be.rac_value(*args)
        assert rac_value.launches == before + 4
        got_m = be.rac_value_masked(*args, valid)
    finally:
        mesh.make_cache_mesh = orig
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("n_shards,k", [(2, 8), (4, 8), (4, 300)])
def test_sharded_quantized_merge_is_bit_equal_to_plain(cuda, rng,
                                                       shard_path,
                                                       n_shards, k):
    """The merged int8 shortlist on the card (one B5 a shard, the stable
    sort) against the same merge over the plain versions on the CPU: the
    same values and rows; the certified lookups equal the exact scan's."""
    from repro_torch.cache import ShardedKernelBackend
    from repro_torch.kernels import similarity_topk as st
    sh, _, q = _sharded_pair(rng, n_shards, 1_200, 1_000, 768, cuda)
    card = ShardedKernelBackend(n_shards=n_shards, quantized={"k": k})
    plain = ShardedKernelBackend(n_shards=n_shards, device="cpu",
                                 quantized={"k": k})
    plain._mesh, plain._mesh_built = None, True
    before = st.topk_q8_launches
    v, r, *_ = card._quantized_candidates(sh, q)
    assert st.topk_q8_launches == before + n_shards
    pv, pr, *_ = plain._quantized_candidates(sh, q)
    np.testing.assert_array_equal(np.isfinite(v), np.isfinite(pv))
    fin = np.isfinite(pv)
    np.testing.assert_array_equal(v[fin], pv[fin])
    np.testing.assert_array_equal(r[fin], pr[fin])
    exact = ShardedKernelBackend(n_shards=n_shards).top1_batch(sh, q)
    for a, b in zip(card.top1_batch(sh, q), exact):
        np.testing.assert_array_equal(a, b)


def test_sharded_arena_on_the_card_matches_the_host_oracle(cuda,
                                                           shard_path):
    from repro_torch.cache import ShardedKernelBackend
    from repro_torch.core import (OASSTConfig, default_factories,
                                  oasst_style_trace, run_arena)
    from repro_torch.kernels import similarity_topk
    tr = oasst_style_trace(OASSTConfig(trace_len=1_500, dim=128, seed=4))
    similarity_topk.multi_launches = 0
    out = {}
    for name, backend in (("sharded", ShardedKernelBackend(n_shards=2)),
                          ("numpy", "numpy")):
        stats = run_arena(tr, 120, default_factories(seed=0),
                          hit_mode="semantic", backend=backend, chunk=128)
        out[name] = [(s.policy, s.hits, s.misses, s.evictions)
                     for s in stats]
    assert out["sharded"] == out["numpy"]
    # one B1-multi a shard for every chunk but the first: an empty arena
    # answers without a launch
    assert similarity_topk.multi_launches == 2 * (-(-1_500 // 128) - 1)


# ------------------------------------------------------- B8's gradient
# B8's gradient on the card: the forward launches the kernel, the backward
# recomputes the plain version on the saved inputs (attention_grad).  The
# plain reference here is torch.autograd.grad of attention_ref.  fp32:
# within 1e-5 of the gradient's max |g| (fp32 sums in another order where
# the backward chunks the queries); bf16: within one bf16 ulp (2^-7 |g|)
# plus 1e-5 of max |g| (both round fp32 values that agree to ~1e-6).
def _grad_close(got, want):
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    if got.dtype == torch.bfloat16:
        ok = err <= 2.0 ** -7 * want.float().abs() + 1e-5 * scale
    else:
        ok = err <= 1e-5 * scale
    assert bool(ok.all()), f"max |err| {float(err.max())} of {scale}"


def _b8_grads(rng, dev, dtype, b, h, hkv, s, t, d, dv, causal, window):
    """The model's layout: (B,S,H,D) projections as transpose(1, 2)
    views; returns (kernel grads, plain grads, launches of the forward)."""
    from repro_torch.kernels import flash_attention as fa, ref
    q = _randn(rng, (b, s, h, d), dtype, dev).transpose(1, 2)
    k = _randn(rng, (b, t, hkv, d), dtype, dev).transpose(1, 2)
    v = _randn(rng, (b, t, hkv, dv), dtype, dev).transpose(1, 2)
    dout = _randn(rng, (b, h, s, dv), dtype, dev)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = fa.launches
    out = fa.flash_attention(*leaves, window=window, causal=causal)
    launched = fa.launches - before
    got = torch.autograd.grad(out, leaves, dout)
    assert fa.launches == before + launched      # the backward launches none
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        ref.attention_ref(*leaves, causal=causal, window=window), leaves,
        dout)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _grad_close(g, w)
    return launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradient_at_the_train_shape(cuda, rng, dtype):
    """smollm-360m's training attention: B=8, 15/5 heads of 64, S=1,024,
    one B8 launch (on wgmma in bf16) and the plain version's gradient."""
    from repro_torch.kernels import flash_attention as fa
    w0 = fa.wgmma_launches
    assert _b8_grads(rng, cuda, dtype, 8, 15, 5, 1024, 1024, 64, 64,
                     True, 0) == 1
    assert fa.wgmma_launches == w0 + (dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(32, 32), (64, 64), (128, 128),
                                  (192, 192), (256, 256), (192, 128),
                                  (48, 32)])
def test_flash_attention_gradient_at_every_head_dim(cuda, rng, d, dv, dtype):
    """Every (D, Dv) of flash_attention.SHAPES, G = 2, S ragged."""
    assert _b8_grads(rng, cuda, dtype, 2, 4, 2, 137, 137, d, dv, True,
                     0) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,causal,window", [
    (1100, 1100, True, 0),          # the backward's query chunks
    (1300, 1300, True, 256),        # chunked, banded
    (300, 300, True, 64),
    (200, 333, False, 0),           # non-causal, T != S
    (1100, 70, False, 0)])
def test_flash_attention_gradient_windows_and_chunks(cuda, rng, s, t,
                                                     causal, window, dtype):
    assert _b8_grads(rng, cuda, dtype, 1, 6, 2, s, t, 64, 64, causal,
                     window) == 1


@pytest.mark.parametrize("t,k,e,cf", [
    (32_768, 6, 64, 10.7),    # deepseek's prefill of 32 x 1,024, dropless
    (32_768, 6, 64, 0.5),     # the same pairs at a capacity below the load
    (32, 6, 64, 10.7),        # a decode step of 32 sequences
    (4_096, 2, 8, 0.75)])     # grok's routing, pairs dropped
def test_moe_slots_on_the_card_match_the_running_count_without_a_sync(
        cuda, rng, t, k, e, cf):
    """The MoE's capacity slots on the card: no host synchronisation (the
    sync debug mode raises on one), and the running count's integers."""
    from repro_torch.models import layers
    topi = torch.from_numpy(np.argsort(rng.random((t, e)), axis=-1)[:, :k]
                            .astype(np.int64)).to(cuda)
    cap = max(1, -(-int(t * k * cf) // e))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = layers.moe_slots(topi, e, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    e_flat = topi.reshape(-1)
    onehot = torch.nn.functional.one_hot(e_flat, e)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    for g, w in zip(got, (e_flat, pos, pos < cap)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_train_step_on_the_card_matches_the_host(cuda):
    """One train step of the card model (fp32, B8 forward and its remat
    recompute) against the same step on the host: loss within 1e-5
    relative, each gradient leaf within 1e-4 of its max |g|, B8 launched
    twice a layer (forward, recompute) and never in the backward's plain
    gradient."""
    import dataclasses

    from repro_torch.kernels import flash_attention
    from repro_torch.models import Model, make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(_card_model_cfg(), remat=True)
    host = Model(cfg, "cpu")
    params = host.init(torch.Generator().manual_seed(3))
    card = Model(cfg, "cuda")
    rng = np.random.default_rng(2)
    tok = rng.integers(2, cfg.vocab_size, (2, 65))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    f0 = flash_attention.launches
    loss, grads = value_and_grad(make_loss_fn(card))(
        _move(params, cuda), _move(batch, cuda))
    assert flash_attention.launches == f0 + 2 * cfg.n_layers
    want_loss, want = value_and_grad(make_loss_fn(host))(params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale
