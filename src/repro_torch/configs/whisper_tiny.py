"""whisper-tiny [audio]: enc-dec, conv frontend stubbed to frame embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    attn="gqa", mlp="gelu", norm="layernorm", enc_dec=True, input_mode="embeds",
    rope_fraction=0.0,  # whisper uses absolute positions; stub embeds carry them
    source="arXiv:2212.04356",
)
