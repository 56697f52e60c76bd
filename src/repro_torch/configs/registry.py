"""Architecture registry: `get("llama-200m")`, `names()`.

The port carries every decoder-only model of the JAX registry: the dense GQA
configurations, llava's embeds-input backbone, both MoE models
(deepseek-moe-16b on GQA, deepseek-v3 on MLA) and the two recurrent
families (rwkv6's time-mix, recurrentgemma's RG-LRU with local attention).
Still to come: whisper, whose encoder-decoder path comes with a slice of its
own; `get("whisper_tiny")` raises NotImplementedError naming it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = [
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

# reference ids the port does not carry yet, with the slice that brings each
LATER = {"whisper_tiny": "the encoder-decoder family (whisper) comes with the "
                         "whisper slice (ROADMAP.md, Queue 1)"}


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str) -> ArchConfig:
    norm = _norm(name)
    if norm in LATER:
        raise NotImplementedError(f"{name}: {LATER[norm]}")
    if norm not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{norm}")
    return mod.CONFIG


def names() -> list[str]:
    return list(ARCH_IDS)
