"""llava-next-mistral-7b [vlm]: mistral-7b backbone; anyres patch frontend is
stubbed (input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
    attn="gqa", mlp="swiglu", input_mode="embeds",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
