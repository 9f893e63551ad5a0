"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024 16H d_ff=4096
vocab=51865 — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings, 1500 frames = 30 s) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51_865, mlp="gelu",
    n_enc_layers=24, frontend="audio", n_frontend_tokens=1500,
)
