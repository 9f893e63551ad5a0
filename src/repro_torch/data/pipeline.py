"""Deterministic sharded token pipeline with an explicit restart cursor.

Production shape: each data-parallel host owns a disjoint shard of the
corpus and derives every batch purely from (seed, cursor) — no hidden
iterator state — so a restart from a checkpointed cursor replays the exact
same batch stream on any surviving host layout (elastic restart re-shards
by recomputing ``host_slice`` from the new topology).

Offline we synthesize a corpus (mixture of Zipf unigrams + repeated n-gram
'phrases' so the LM has learnable structure); swapping in a real tokenized
corpus only replaces ``_token_block``.

A host module: the port's own numpy copy of ``repro/data/pipeline.py``,
whose ``batch_at`` it reproduces bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host: int = 0
    corpus_tokens: int = 1 << 24     # synthetic corpus size


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # synthetic corpus structure: phrase table + unigram dist
        rng = np.random.default_rng(cfg.seed)
        self._phrases = rng.integers(
            2, cfg.vocab_size, size=(256, 8)).astype(np.int32)
        w = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
        self._probs = w / w.sum()

    # -- deterministic content ---------------------------------------
    def _token_block(self, block_idx: int) -> np.ndarray:
        """seq_len+1 tokens for global block ``block_idx`` (pure function)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 7, block_idx]))
        out = np.empty(cfg.seq_len + 1, np.int32)
        i = 0
        while i < cfg.seq_len + 1:
            if rng.random() < 0.3:          # repeated phrase (learnable)
                ph = self._phrases[rng.integers(0, len(self._phrases))]
                n = min(len(ph), cfg.seq_len + 1 - i)
                out[i:i + n] = ph[:n]
                i += n
            else:
                n = min(int(rng.integers(4, 16)), cfg.seq_len + 1 - i)
                out[i:i + n] = rng.choice(
                    cfg.vocab_size, size=n, p=self._probs)
                i += n
        return out

    def batch_at(self, cursor: int) -> dict[str, np.ndarray]:
        """Global step ``cursor`` -> this host's {tokens, labels} slice."""
        cfg = self.cfg
        base = cursor * cfg.global_batch + self.cfg.host * self.local_batch
        blocks = np.stack([self._token_block(base + i)
                           for i in range(self.local_batch)])
        return {"tokens": blocks[:, :-1], "labels": blocks[:, 1:]}

    def __iter__(self):
        c = 0
        while True:
            yield c, self.batch_at(c)
            c += 1
