"""Architecture registry: `get("llama-200m")`, `names()`.

The port carries every model of the JAX registry, in its order: whisper's
encoder-decoder (stub frame embeddings into the encoder, tokens into the
decoder), the dense GQA configurations, llava's embeds-input backbone, both
MoE models (deepseek-moe-16b on GQA, deepseek-v3 on MLA) and the two
recurrent families (rwkv6's time-mix, recurrentgemma's RG-LRU with local
attention).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = [
    "whisper_tiny",
    "chatglm3_6b",
    "nemotron_4_15b",
    "granite_8b",
    "yi_9b",
    "deepseek_moe_16b",
    "deepseek_v3_671b",
    "llava_next_mistral_7b",
    "rwkv6_7b",
    "recurrentgemma_9b",
    "llama_200m",  # the paper's own ablation family (Table 3)
]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str) -> ArchConfig:
    norm = _norm(name)
    if norm not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{norm}")
    return mod.CONFIG


def names() -> list[str]:
    return list(ARCH_IDS)
