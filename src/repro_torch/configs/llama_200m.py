"""llama-200m: the paper's own ablation family (Table 3, largest size).
10L d_model=1280 10H swiglu."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-200m", family="dense",
    n_layers=10, d_model=1280, n_heads=10, n_kv_heads=10, d_ff=3456, vocab=32000,
    attn="gqa", mlp="swiglu",
    source="paper Table 3",
)
