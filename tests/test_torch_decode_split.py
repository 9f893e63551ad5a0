"""The decode attention kernel (``csrc/decode_attention.cu``), as far as the
CPU can hold it: its split plan, and an emulation of its order of
operations in plain PyTorch (fp32), held to the plain version
(``ref.decode_attention_ref``) and to the reference's ``decode_attention``
(Pallas in interpret mode) within 2e-5 (fp32 sums in another order; the
card's fp32 tolerance).

The emulation follows the kernel: a block per (batch, kv head) and split,
the split's keys an even share of [0, pos] in whole stages of 128 keys
(64 for key rows past 128 bytes, 32 past 512); four warps that split
each stage's keys (and the group's heads past four a warp: G = 12 takes
four groups of three); each (head, key) dot of a row past 128 bytes split
over L lanes (at most 8), a lane's 16-byte
slices, then the lanes' butterfly sum; a lane a key for the online
softmax (the -1e30 start, masked keys skipped); each warp's (m, l, acc)
merged once at the block's end; the split merge; max(l, 1e-30); 0 for
pos < 0.  The card runs the kernel against the plain version
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import split_plan, stage_keys

NEG = -1e30


def _lanes(d: int, es: int) -> tuple[int, int]:
    """(L, slices a lane) of a key row of d values of es bytes: one lane up
    to 128 bytes, else the largest power of two up to 8 that divides its
    16-byte slices."""
    nsl = d * es // 16
    lanes = 1 if d * es <= 128 else next(x for x in (8, 4, 2, 1)
                                          if nsl % x == 0)
    return lanes, nsl // lanes


def _dots(qs, keys, d, es):
    """(heads, keys) scores: lane p of L sums its slices p + L t, then the
    lanes' butterfly."""
    lanes, spl = _lanes(d, es)
    eps = 16 // es
    own = torch.tensor([[(p + lanes * t) * eps + e for t in range(spl)
                         for e in range(eps)] for p in range(lanes)])
    part = (qs[:, None, own] * keys[None, :, own]).sum(-1)
    o = lanes // 2
    while o:
        part = part + part[:, :, torch.arange(lanes) ^ o]
        o //= 2
    return part[:, :, 0]


def _emulate(q, k, v, pos, n_split, es):
    b, h, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    ks = stage_keys(d, torch.bfloat16 if es == 2 else torch.float32)
    hmax = 4
    wg = 1 if g <= hmax else 2 if g <= 2 * hmax else 4
    hw, wk = -(-g // wg), 4 // wg
    kw = ks // wk
    out = torch.zeros(b, h, d)
    for bi in range(b):
        n_keys = min(max(int(pos[bi]) + 1, 0), s_max)
        per = -(-(-(-n_keys // n_split)) // ks) * ks
        for kh in range(hkv):
            qs = q[bi, kh * g:(kh + 1) * g].float() * d ** -0.5
            parts = []
            for split in range(n_split):
                lo = split * per
                hi = min(lo + per, n_keys)
                n_st = -(-(hi - lo) // ks) if hi > lo else 0
                m = torch.full((4, hw), NEG)
                l_ = torch.zeros(4, hw)
                acc = torch.zeros(4, hw, d)
                for s in range(n_st):
                    for w in range(4):
                        hg, kg = w % wg, w // wg
                        heads = list(range(hg * hw, min(g, hg * hw + hw)))
                        t0 = lo + s * ks + kg * kw
                        nk = max(0, min(kw, hi - t0))
                        if nk == 0 or not heads:
                            continue
                        keys = k[bi, t0:t0 + nk, kh].float()
                        sc = _dots(qs[heads], keys, d, es)
                        for r, _ in enumerate(heads):
                            m_new = max(float(m[w, r]), float(sc[r].max()))
                            p = torch.exp(sc[r] - m_new)
                            alpha = float(np.exp(np.float32(m[w, r] - m_new)))
                            l_[w, r] = alpha * l_[w, r] + p.sum()
                            m[w, r] = m_new
                            acc[w, r] = acc[w, r] * alpha \
                                + (p[:, None] * v[bi, t0:t0 + nk, kh].float()
                                   ).sum(0)
                # the block's merge of the warps sharing each head
                mm = torch.full((g,), NEG)
                num = torch.zeros(g, d)
                den = torch.zeros(g)
                for hh in range(g):
                    hg, r = hh // hw, hh % hw
                    ws = [kg * wg + hg for kg in range(wk)]
                    mm[hh] = max(float(m[w, r]) for w in ws)
                    for w in ws:
                        a = torch.exp(m[w, r] - mm[hh])
                        num[hh] += acc[w, r] * a
                        den[hh] += l_[w, r] * a
                parts.append((mm, den, num))
            if n_split == 1:
                mm, den, num = parts[0]
            else:                                   # the merge kernel
                mm = torch.stack([p[0] for p in parts]).max(0).values
                ws = [torch.exp(p[0] - mm) for p in parts]
                num = sum(p[2] * w[:, None] for p, w in zip(parts, ws))
                den = sum(p[1] * w for p, w in zip(parts, ws))
            out[bi, kh * g:(kh + 1) * g] = num / den.clamp(min=1e-30)[:, None]
    return out


def _inputs(rng, b, g, hkv, s, d, dtype):
    shape = {"q": (b, hkv * g, d), "k": (b, s, hkv, d), "v": (b, s, hkv, d)}
    out = {}
    for name, sh in shape.items():
        x = torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
        out[name] = x.to(dtype).float()     # the values a bf16 cache holds
    return out["q"], out["k"], out["v"]


@pytest.mark.parametrize("d", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("g", [1, 3, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernel_matches_the_plain_version(rng, d, g, dtype):
    s_max = 140
    es = 2 if dtype == torch.bfloat16 else 4
    ks = stage_keys(d, dtype)
    # pos < 0, 0, a stage's last key and the next one, S_max - 1 and past it
    pos = torch.tensor([-1, 0, ks - 1, ks, s_max - 1, s_max + 5],
                       dtype=torch.int32)
    q, k, v = _inputs(rng, len(pos), g, 2, s_max, d, dtype)
    want = ref.decode_attention_ref(q, k, v, pos)
    rq, rk, rv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    jax_want = np.asarray(rops.decode_attention(rq, rk, rv,
                                                jnp.asarray(pos.numpy())))
    for n_split in (1, 3, -(-s_max // ks)):
        got = _emulate(q, k, v, pos, n_split, es)
        assert bool((got[0] == 0).all())            # pos < 0: no keys
        np.testing.assert_allclose(got[1:].numpy(), want[1:].numpy(),
                                   atol=2e-5)
        # the reference's kernel gives a pos past the cache another
        # meaning: it is held on the rows inside the cache
        np.testing.assert_allclose(got[1:-1].numpy(), jax_want[1:-1],
                                   atol=2e-5)


def test_stage_keys_follow_the_row_bytes():
    assert [stage_keys(d, torch.bfloat16) for d in (32, 64, 128, 192, 256)] \
        == [128, 128, 64, 64, 64]
    assert [stage_keys(d, torch.float32) for d in (32, 64, 128, 192, 256)] \
        == [128, 64, 64, 32, 32]


@pytest.mark.parametrize("rows,s_max,wave,want", [
    (640, 32_768, 396, 16),     # decode_32k: no split past 2,048 keys
    (128, 2_048, 132, 5),       # gemma-7b's heads: four waves
    (40, 512, 396, 8),          # the engine's 8 slots: a stage a split
    (40, 2_048, 396, 32),
    (8, 10, 1_000, 1), (1, 64, 1_000, 1)])
def test_split_plan_from_the_resident_blocks(rows, s_max, wave, want):
    n = split_plan(rows, s_max, 64, wave)
    assert n == want
    assert 1 <= n <= max(1, -(-s_max // 64))
    # no split longer than 2,048 keys, unless a stage is all there is
    assert -(-s_max // n) <= max(2_048, 64)
