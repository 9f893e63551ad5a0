"""xlstm-125m [ssm]: 12L d_model=768 4H vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517; unverified].  sLSTM at block positions (5, 7),
mLSTM elsewhere (xLSTM[7:1]-style mix).  12 layers -> unrolled stack."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50_304, attention="none",
    slstm_at=(5, 7), xlstm_expand=2,
    scan_layers=True,
)
