"""The frozen yardstick: FLOP and byte counts held to totals worked out by
hand from the configurations, the token corpus held to the port's
pipeline token for token, and the seeds."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import counts, seeds, spec, traffic, weights

BENCH = spec.benchmark()


def cfg(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


SMOL, DS = cfg("smollm-360m"), cfg("deepseek-v2-lite-16b")


def test_parameters():
    # 32 layers of 9,830,400 weights and two norms, the final norm, and one
    # tied table of 49,152 x 960
    assert weights.n_params(SMOL) == 361_821_120
    # 27 MoE layers (MLA 13.76 M, 64 routed and 2 shared experts of 1,408,
    # the router, two norms: 584.3 M) and the embedding and unembedding of
    # 102,400 x 2,048: 16.2 B as the port builds it (all layers MoE)
    assert weights.n_params(DS) == 16_210_311_168


def test_train_step_flops():
    """6 x (314.57 M of the stack + 47.19 M of the tied unembedding) x
    32,768 = 71.13 TFLOP, plus 32 layers of causal attention at 15 heads
    of 64, three times: 6.19 TFLOP."""
    assert counts.matmul_params_per_token(SMOL) == 361_758_720
    assert counts.train_flops(SMOL, 32, 1024) == pytest.approx(77.32e12,
                                                               rel=1e-3)
    assert 3 * counts.attention_flops(SMOL, 32, 1024) == pytest.approx(
        6.190e12, rel=1e-3)


@pytest.mark.parametrize("c,b,s,total,attn", [
    # every position through the stack plus the unembedding of every
    # position: the totals worked out by hand (309 / 165 / 56 TFLOP)
    (DS, 1, 32768, 309.1e12, 148.44e12),
    (DS, 32, 1024, 165.3e12, 4.64e12),
    (SMOL, 32, 2048, 55.7e12, 8.25e12),
    # one 32,768-token prompt: 20.62 TFLOP of projections and MLP, 65.96 of
    # attention, 3.09 of the unembedding of every position
    (SMOL, 1, 32768, 89.67e12, 65.96e12),
])
def test_prefill_flops(c, b, s, total, attn):
    assert counts.attention_flops(c, b, s) == pytest.approx(attn, rel=2e-3)
    last = 2.0 * b * c["hidden_size"] * weights.padded_vocab(c)
    every = counts.prefill_flops(c, b, s) + (s - 1) * last
    assert every == pytest.approx(total, rel=3e-3)


def test_b8_bound():
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    # deepseek's heads at 32k: 5.50 TFLOP, 5.56 ms at 989 TFLOP/s; 671 MB
    a = counts.attention_shape(DS)
    assert (a["h"], a["hkv"], a["d"], a["dv"]) == (16, 16, 192, 128)
    assert counts.b8_flops(1, 16, 32768, 192, 128) == pytest.approx(
        5.4976e12, rel=1e-4)
    assert counts.b8_bytes(1, 16, 16, 32768, 192, 128) == 2 * 32768 * 16 * (
        192 + 192 + 128 + 128)
    assert counts.b8_bound_s(1, 16, 16, 32768, 192, 128, peaks) == \
        pytest.approx(counts.b8_flops(1, 16, 32768, 192, 128) / 989e12)
    # a tiny call is bound by its bytes
    assert counts.b8_bound_s(1, 1, 1, 64, 64, 64, peaks) == pytest.approx(
        counts.b8_bytes(1, 1, 1, 64, 64, 64) / 3.35e12)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_corpus_is_the_port_pipeline(seed):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    tf = spec.load_json(spec.traffic_file("train-b32-s1k"))
    mine = traffic.TokenCorpus(512, 64, 3, seed, tf["corpus"])
    port = TokenPipeline(DataConfig(vocab_size=512, seq_len=64,
                                    global_batch=3, seed=seed))
    for step in (0, 5):
        a, b = mine.batch_at(step), port.batch_at(step)
        assert np.array_equal(a["tokens"], b["tokens"])
        assert np.array_equal(a["labels"], b["labels"])


def test_seeds():
    big = 2 ** 31 + 12345
    assert seeds.derive(big, 1) == seeds.derive(big, 1)
    assert len({seeds.derive(big, t) for t in range(1, 6)}) == 5
    assert seeds.derive(-3, 2) != seeds.derive(3, 2)
    assert 0 <= seeds.derive(2 ** 70, 1) < 2 ** 63


def test_prompts_and_weights_are_the_seeds():
    a = traffic.prompt_tokens(100, 2, 8, seeds.derive(5, 3, 0), "cpu")
    b = traffic.prompt_tokens(100, 2, 8, seeds.derive(5, 3, 0), "cpu")
    c = traffic.prompt_tokens(100, 2, 8, seeds.derive(5, 3, 1), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 100
    small = dict(SMOL, hidden_size=32, intermediate_size=64, head_dim=8,
                 num_attention_heads=4, num_key_value_heads=2,
                 num_hidden_layers=1, vocab_size=100)
    w1, w2 = (weights.draw(small, 9, "cpu") for _ in range(2))
    for p in weights.paths(small):
        x, y = weights.get(w1, p), weights.get(w2, p)
        assert torch.equal(x, y) and x.dtype == torch.bfloat16
    assert torch.all(weights.get(w1, ("emb", "norm_f", "scale")) == 1)
    assert 0.015 < float(weights.get(w1, ("emb", "tok")).float().std()) \
        < 0.025
