"""recurrentgemma-9b [hybrid]: RG-LRU + local attention (MQA kv=1), 1:2 pattern.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig, GriffinConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000,
    attn="gqa", mlp="swiglu",
    griffin=GriffinConfig(lru_width=4096, conv_width=4, window=2048,
                          pattern=("rec", "rec", "attn")),
    source="arXiv:2402.19427",
)
