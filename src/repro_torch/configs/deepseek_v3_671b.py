"""deepseek-v3-671b [moe]: MLA attention, 1 shared + 256 routed top-8 experts.
Assignment simplification: all 61 layers are MoE (official v3 keeps the first
3 dense); MTP head omitted (not in the assigned config line).
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, attn="mla", mlp="swiglu",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, d_ff_expert=2048,
                  score="sigmoid", route_scale=2.5),
    source="arXiv:2412.19437",
)
