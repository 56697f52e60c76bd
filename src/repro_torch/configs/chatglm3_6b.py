"""chatglm3-6b [dense]: GQA kv=2, 2d (half-dim) RoPE. [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024,
    attn="gqa", rope_fraction=0.5, mlp="swiglu",
    source="arXiv:2406.12793",
)
