"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MoE 64e top-6, MLA kv_lora=512 [arXiv:2405.04434; hf].

Assignment header says "MoE 64e top-6"; the note mentions "2 shared+160
routed" (the full V2).  We follow the header: 64 routed + 2 shared, top-6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102_400, mlp="swiglu",
    attention="mla", kv_lora_rank=512, rope_head_dim=64,
    n_experts=64, n_shared_experts=2, top_k=6, expert_d_ff=1408,
)
