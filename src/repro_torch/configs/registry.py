"""Architecture registry: `get("llama-200m")`, `names()`.

The port carries the dense GQA configurations of its first slice; the other
families of the JAX registry come with the slices that port their mixers.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = [
    "yi_9b",
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
