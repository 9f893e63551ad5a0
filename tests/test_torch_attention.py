"""The port's attention plain versions and ``ops`` entries on CPU tensors
against the JAX package: ``repro.kernels.ops.flash_attention`` /
``decode_attention`` (the Pallas kernels in interpret mode, at
``tests/test_kernels.py``'s shapes and tolerances: atol 2e-3 in fp32,
3e-2 in bf16) and ``repro.kernels.ref`` at head dims 32 and 64 with
G = 3 (atol 1e-5 in fp32, both fp32 softmaxes; one bf16 ulp, 2^-7 of the
value, in bf16, where the two fp32 results may round to neighbours).
Inputs come from a numpy seed and are handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """One numpy draw as a JAX array and a torch tensor of ``dtype`` (the
    bf16 roundings agree: both round the same fp32 values to nearest)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 2, 1, 64, 128),
                                         (2, 4, 2, 200, 128),
                                         (1, 8, 2, 300, 128),
                                         (2, 2, 2, 513, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_pallas_kernel(rng, b, h, hkv, s, d,
                                                   dtype):
    qn = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (qn, kn, vn))
    want = _np(rops.flash_attention(qj, kj, vj))
    atol = 3e-2 if dtype == "bfloat16" else 2e-3
    before = dict(tops.dispatch_stats), tfa.launches
    got = tops.flash_attention(qt, kt, vt)
    assert tops.dispatch_stats["launches"] == before[0]["launches"] + 1
    assert tfa.launches == before[1]            # the CPU takes the plain one
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, atol=atol)
    np.testing.assert_allclose(_np(tref.attention_ref(qt, kt, vt)), want,
                               atol=atol)


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 2, 1, 128, 128),
                                         (2, 4, 2, 1024, 128),
                                         (2, 8, 2, 768, 128),
                                         (3, 4, 4, 257, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_the_pallas_kernel(rng, b, h, hkv, s, d,
                                                    dtype):
    qn = rng.standard_normal((b, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = rng.integers(0, s, size=b).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (qn, kn, vn))
    want = _np(rops.decode_attention(qj, kj, vj, jnp.asarray(pos)))
    atol = 3e-2 if dtype == "bfloat16" else 2e-3
    before = tda.launches
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(pos))
    assert tda.launches == before
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, atol=atol)


def _close_to_ref(got: torch.Tensor, want: np.ndarray, dtype: str):
    g = _np(got)
    if dtype == "bfloat16":
        assert (np.abs(g - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()
    else:
        np.testing.assert_allclose(g, want, atol=1e-5)


@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 6, 2, 77, 32),
                                         (1, 15, 5, 130, 64),
                                         (2, 3, 1, 1, 64),
                                         (1, 12, 4, 300, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_the_reference_oracle(rng, b, h, hkv, s, d,
                                                    dtype):
    qn = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (qn, kn, vn))
    want = _np(rref.attention_ref(qj, kj, vj, causal=True))
    _close_to_ref(tref.attention_ref(qt, kt, vt), want, dtype)
    # the (B,S,H,D) layout by strides, as the model passes it
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (qt, kt, vt))
    _close_to_ref(tops.flash_attention(qs, ks, vs), want, dtype)


@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 6, 2, 77, 32),
                                         (8, 15, 5, 512, 64),
                                         (3, 3, 1, 1, 64),
                                         (4, 12, 4, 300, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_matches_the_reference_oracle(rng, b, h, hkv,
                                                           s, d, dtype):
    qn = rng.standard_normal((b, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = rng.integers(0, s, size=b).astype(np.int32)
    pos[0], pos[-1] = 0, s - 1
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (qn, kn, vn))
    want = _np(rref.decode_attention_ref(qj, kj, vj, jnp.asarray(pos)))
    _close_to_ref(tref.decode_attention_ref(qt, kt, vt,
                                            torch.from_numpy(pos)),
                  want, dtype)


def test_attention_wrappers_check_their_inputs():
    q = torch.zeros((1, 4, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError):
        tops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):
        tops.flash_attention(q[:, :3], kv, kv)
    with pytest.raises(ValueError):
        tops.flash_attention(q, kv[:, :, :5], kv[:, :, :5])
    qd, cache = torch.zeros((2, 4, 32)), torch.zeros((2, 8, 2, 32))
    with pytest.raises(ValueError):
        tops.decode_attention(qd, cache, cache, torch.zeros(2))
    with pytest.raises(ValueError):
        tops.decode_attention(qd, cache, cache,
                              torch.zeros(3, dtype=torch.int32))
    out = tops.decode_attention(qd, cache, cache,
                                torch.zeros(2, dtype=torch.int32))
    assert out.shape == qd.shape


# The Hopper kernel's TMA loads, checked on the host before a launch: the
# model's (B, S, H, D) projections seen as (B, H, S, D), a dense bf16
# tensor, and views TMA cannot take (strides and base in bytes).
_B, _S, _H, _D = 2, 1000, 15, 64
_MODEL = (_S * _H * _D, _D, _H * _D, 1)          # transpose(1, 2) of BSHD
_DENSE = (_H * _S * _D, _S * _D, _D, 1)


@pytest.mark.parametrize("d,strides,ptr", [
    (64, _MODEL, 0), (64, _DENSE, 4096), (128, (4 * 9 * 128, 9 * 128, 128,
                                               1), 256),
    (64, (_S * _H * _D, _D, _H * _D, 1), 1920),       # k after q in one buffer
    # the other head dims of configs/ and the smoke variants
    (32, (4 * 9 * 32, 9 * 32, 32, 1), 64), (192, (4 * 9 * 192, 9 * 192,
                                                   192, 1), 0),
    (256, (4 * 9 * 256, 9 * 256, 256, 1), 512)])
def test_check_tma_takes_aligned_layouts(d, strides, ptr):
    tfa.check_tma(d, [(n, strides, ptr) for n in ("q", "k", "v")])


@pytest.mark.parametrize("d,strides,ptr,match", [
    (40, _DENSE, 0, "head dim"),
    (96, _DENSE, 0, "head dim"),
    (64, (_H * _S * 65, _S * 65, 65, 1), 0, "sequence stride of 130"),
    (64, (_H * _S * _D, 36, _D, 1), 0, "head stride of 72"),
    (64, (_S * _D + 1, _S * _D, _D, 1), 0, "batch stride"),
    (64, (_H * _S * _D, _S * _D, _D, 2), 0, "contiguous"),
    (64, _DENSE, 8, "base address"),
    (64, (2 ** 40, _S * _D, _D, 1), 0, "2\\^40")])
def test_check_tma_refuses_what_tma_cannot_take(d, strides, ptr, match):
    with pytest.raises(ValueError, match=match):
        tfa.check_tma(d, [("q", _DENSE, 0), ("k", strides, ptr)])


def test_check_tma_size_one_axes_take_their_dense_stride():
    """TMA reads only index 0 of a size-1 axis but checks its stride: the
    wrapper gives such an axis its dense stride."""
    t = torch.zeros(512, dtype=torch.bfloat16).as_strided((1, 2, 1, 64),
                                                          (7, 64, 5, 1))
    with pytest.raises(ValueError, match="TMA"):
        tfa.check_tma(64, [("q", t.stride(), 0)])
    assert tfa._tma_strides(t) == (128, 64, 64, 1)
    tfa.check_tma(64, [("q", tfa._tma_strides(t), 0)])
