"""The paper's own serving configuration: RAC semantic-cache front-end over
a small production LM (we use the smollm-360m backbone as the served model
in examples/serve_semantic_cache.py) plus the RAC hyperparameters of §4.2.
"""
from repro_torch.models.config import ModelConfig

RAC_DEFAULTS = dict(
    tau_route=0.65,     # topic routing gate (paper couples hit/route at 0.85;
                        # see DESIGN.md §6 on decoupling)
    tau_edge=0.60,      # edge-pruning threshold (paper §4.2)
    alpha=0.001,        # TP decay
    lam=2.0,            # structural weight
    lookback=64,        # DetectParent window T
    shortlist_k=8,      # ANN shortlist (Alg. 4)
)
TAU_HIT = 0.85          # semantic-equivalence hit threshold (paper §4.2)

CONFIG = ModelConfig(
    name="paper-served-lm", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49_152, mlp="swiglu",
)
