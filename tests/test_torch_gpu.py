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
    for nq in (3, 200):                          # both tile shapes
        v, i = similarity_topk.sim_top1(row.repeat(nq, 1), c, c.shape[0])
        assert (i == 5).all()


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
