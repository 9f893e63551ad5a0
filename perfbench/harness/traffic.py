"""The traffic generators, frozen here so that a change to the program
cannot change what it is measured on.

:class:`TokenCorpus` is a copy of the port's training token pipeline
(``repro_torch/data/pipeline.py``, itself the reference's): a synthetic
corpus of Zipf unigrams with repeated n-gram phrases, every sequence of
``seq + 1`` tokens a pure function of (seed, block index).  It gives the
same tokens as that pipeline, with the draws by probability done on a
precomputed cumulative table (what ``Generator.choice`` computes on every
call), so that a batch of 32 x 1,025 tokens takes milliseconds.  Its
parameters come from the traffic file.

:func:`prompt_tokens` draws a prefill call's prompts on the device:
uniform token ids, one generator a call."""
from __future__ import annotations

import numpy as np
import torch


class TokenCorpus:
    def __init__(self, vocab: int, seq: int, batch: int, seed: int,
                 corpus: dict):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq, batch, seed
        self.share = corpus["phrase_share"]
        self.run = (corpus["run_min"], corpus["run_max"])
        rng = np.random.default_rng(seed)
        self._phrases = rng.integers(
            2, vocab, size=(corpus["phrases"], corpus["phrase_len"])
        ).astype(np.int32)
        w = 1.0 / np.arange(1, vocab + 1) ** corpus["zipf"]
        probs = w / w.sum()
        cdf = probs.cumsum()
        self._cdf = cdf / cdf[-1]

    def block(self, idx: int) -> np.ndarray:
        """``seq + 1`` tokens of global block ``idx``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7, idx]))
        n_out = self.seq + 1
        out = np.empty(n_out, np.int32)
        i = 0
        while i < n_out:
            if rng.random() < self.share:          # a repeated phrase
                ph = self._phrases[rng.integers(0, len(self._phrases))]
                n = min(len(ph), n_out - i)
                out[i:i + n] = ph[:n]
            else:                                  # a run of unigrams
                n = min(int(rng.integers(*self.run)), n_out - i)
                out[i:i + n] = self._cdf.searchsorted(rng.random(n),
                                                      side="right")
            i += n
        return out

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Step ``step``'s ``{"tokens", "labels"}`` (batch, seq) int32."""
        blocks = np.stack([self.block(step * self.batch + i)
                           for i in range(self.batch)])
        return {"tokens": blocks[:, :-1], "labels": blocks[:, 1:]}

    def on_device(self, step: int, device) -> dict[str, torch.Tensor]:
        """:meth:`batch_at` copied to ``device`` from pinned memory, without
        waiting for the device."""
        out = {}
        for k, v in self.batch_at(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if torch.device(device).type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out


def prompt_tokens(vocab: int, batch: int, seq: int, seed: int,
                  device) -> torch.Tensor:
    """(batch, seq) int64 token ids in ``[0, vocab)`` drawn from ``seed``
    on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)
