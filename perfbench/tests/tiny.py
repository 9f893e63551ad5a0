"""Tiny configurations of the benchmark's two families and a context on
the CPU, for the tests."""
from __future__ import annotations

import time

from harness import runner, spec


def config(name: str, dtype: str = "bfloat16") -> dict:
    """``configs/<name>.json`` cut to a tiny size of its family."""
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    if cfg["model_type"] == "llama":
        # wide and deep enough that fp8 products (the control) show
        small = dict(hidden_size=256, intermediate_size=512,
                     num_attention_heads=4, num_key_value_heads=2,
                     head_dim=64, num_hidden_layers=4, vocab_size=512)
    else:
        small = dict(hidden_size=64, moe_intermediate_size=32,
                     num_attention_heads=4, num_key_value_heads=4,
                     qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                     kv_lora_rank=32, n_routed_experts=8,
                     num_experts_per_tok=2, n_shared_experts=1,
                     num_hidden_layers=2, vocab_size=512)
    return dict(cfg, dtype=dtype, **small)


def context(cell: str, dtype: str = "bfloat16", seed: int = 2 ** 31 + 5,
            config_name: str | None = None, **kw) -> runner.Context:
    """``cell``'s context on the CPU at a tiny size: its configuration's
    family (or ``config_name``'s) cut down, its traffic at batch 4 and 32
    to 64 tokens, a window of 0.3 s, the cell's own limits."""
    bench = spec.benchmark()
    c = spec.cell(bench, cell)
    tf = spec.load_json(spec.traffic_file(c["traffic"]))
    tf.update(batch=4, seq=32 if tf["driver"] == "train" else 64)
    wl = spec.load_json(spec.workload_file(cell))
    if "check_calls" in wl:
        wl["check_calls"] = 2
    return runner.Context(cell=c, config=config(config_name or c["config"],
                                                dtype),
                          traffic=tf, workload=wl, seed=seed, seconds=0.3,
                          trace=False, t_start=time.perf_counter(),
                          device="cpu", **kw)
