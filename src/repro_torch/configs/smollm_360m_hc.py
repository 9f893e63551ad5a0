"""Hillclimb variant of smollm-360m (§Perf iteration): q heads padded
15→16 and kv heads 5→8 so attention shards over the 16-way TP axis
(baseline replicates all attention compute per device).  +4.5% params.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m-hc", family="dense",
    n_layers=32, d_model=960, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=2560, vocab_size=49_152, mlp="swiglu",
)
