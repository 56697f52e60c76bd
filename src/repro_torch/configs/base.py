"""Architecture configuration dataclasses.

One `ArchConfig` fully specifies a model; `reduced()` derives the CPU smoke
variant of the same family (small width/depth/experts/vocab) used by tests.
A copy of the JAX package's `configs/base.py`: the port keeps its own so that
it never imports the reference package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    score: str = "softmax"        # "softmax" | "sigmoid" (deepseek-v3)
    capacity_factor: float = 1.25
    route_scale: float = 1.0


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_rank: int = 32           # data-dependent token-shift / decay LoRA
    chunk: int = 16               # chunked-WKV block length


@dataclass(frozen=True)
class GriffinConfig:
    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    window: int = 2048            # local-attention window
    pattern: tuple[str, ...] = ("rec", "rec", "attn")  # 1 attn : 2 rec


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention flavour
    attn: str = "gqa"             # gqa | mla | none
    rope_fraction: float = 1.0    # chatglm3 "RoPE 2d": rotary on half the dims
    rope_theta: float = 10000.0
    qk_norm: bool = False
    # mlp flavour
    mlp: str = "swiglu"           # swiglu | relu2 | gelu
    # sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    rwkv: RWKVConfig | None = None
    griffin: GriffinConfig | None = None
    # structure
    enc_dec: bool = False         # whisper: n_layers encoder + n_layers decoder
    input_mode: str = "tokens"    # tokens | embeds (stubbed modality frontend)
    tie_embeddings: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # which layers the NVFP4 scheme touches (paper keeps head in BF16)
    quantize_lm_head: bool = False
    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ArchConfig":
        """Same-family CPU smoke config: small dims, few experts, tiny vocab."""
        changes: dict = dict(
            # hybrids keep one full layer pattern so the smoke covers all types
            n_layers=min(self.n_layers, 3 if self.griffin else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab=512,
            head_dim=32,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_routed=8, top_k=2, d_ff_expert=64)
        if self.mla:
            changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                       qk_nope_head_dim=32, qk_rope_head_dim=16,
                                       v_head_dim=32)
            changes["n_kv_heads"] = 4
        if self.rwkv:
            changes["rwkv"] = RWKVConfig(head_dim=32, lora_rank=8, chunk=8)
        if self.griffin:
            changes["griffin"] = dataclasses.replace(
                self.griffin, lru_width=128, window=32)
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)
