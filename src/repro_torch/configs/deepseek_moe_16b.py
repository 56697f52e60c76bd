"""deepseek-moe-16b [moe]: fine-grained 64 routed top-6 + 2 shared experts.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    attn="gqa", mlp="swiglu",
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
                  score="softmax"),
    source="arXiv:2401.06066",
)
