"""Serving driver: RAC-fronted engine over a trace of requests.

Replays a synthetic dialogue trace against the serving engine:
semantic-cache hits skip generation entirely; misses run batched decode
and admit their responses under RAC eviction.  Reports hit ratio +
generation savings.  The same flags as ``repro/launch/serve.py``, plus
``--device`` (the card by default; ``cpu`` runs on the host):

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200 \\
        --capacity 64 --arch paper [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SynthConfig, synthetic_trace
from repro_torch.models import smoke_variant
from repro_torch.serving import EngineConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mcfg = smoke_variant(get_config(args.arch))
    ecfg = EngineConfig(cache_capacity=args.capacity,
                        max_new_tokens=args.max_new, device=args.device)
    engine = ServingEngine(mcfg, ecfg)

    trace = synthetic_trace(SynthConfig(trace_len=args.requests,
                                        n_topics=24, seed=args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = []
    for r in trace.requests:
        prompt = list(rng.integers(2, mcfg.vocab_size,
                                   size=int(rng.integers(4, 12))))
        reqs.append((r.cid, r.emb, prompt))

    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    s = engine.stats
    hr = s["hits"] / max(1, s["hits"] + s["misses"])
    print(f"[serve] {len(done)} requests in {dt:.1f}s | hit_ratio {hr:.3f} "
          f"| generated {s['generated_tokens']} tokens in {s['batches']} "
          f"batched steps | hits {s['hits']} misses {s['misses']}")
    saved = s["hits"] * ecfg.max_new_tokens
    print(f"[serve] generation saved by cache ≈ {saved} tokens "
          f"({saved / max(1, saved + s['generated_tokens']):.1%} of total)")
    return s


if __name__ == "__main__":
    main()
