"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads
[arXiv:2411.13676; hf].  Sliding-window attention (2048) on all layers +
parallel Mamba heads (the paper keeps 3 global-attn layers; we use the
sliding form everywhere so the arch is long_500k capable — noted in
DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32_001, mlp="swiglu",
    attention="sliding", sliding_window=2048,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)
