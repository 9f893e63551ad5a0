"""Every random stream of a run derives from ``--seed`` and a tag, so that a
seed gives the same weights, batches, prompts and sample in every run, and
the streams of one seed do not overlap."""
from __future__ import annotations

import numpy as np

WEIGHTS, DATA, PROMPTS, WARMUP, SAMPLE = 1, 2, 3, 4, 5


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` or numpy, from any
    whole ``seed`` (negative or past 64 bits included) and non-negative
    integer tags."""
    words = [int(seed) % (1 << 64), *map(int, tags)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])
