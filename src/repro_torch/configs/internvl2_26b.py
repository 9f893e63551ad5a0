"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT STUB (input_specs provides pre-projected patch
embeddings, 256 tokens) + InternLM2 backbone [arXiv:2404.16821; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92_553, mlp="swiglu",
    frontend="vision", n_frontend_tokens=256,
)
