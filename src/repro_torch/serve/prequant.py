"""Quantize-once NVFP4 weight cache.

Counterpart of `repro/serve/prequant.py`. The forward quantizers are
deterministic, so a weight's NVFP4 image is a pure function of the weight:
serving quantizes and packs every linear weight the decode path feeds
through `qlinear` ONCE (on the card through the 4/6 quantization kernel)
and reuses the packed tensors. Unpacking round-trips exactly, so prequant
logits are IDENTICAL to per-step quantization.

Selection is by leaf name. Stacked (layers, N, K) leaves pack per matrix,
matching the per-layer scale granularity of the per-step path. The LM head
is packed only when cfg.quantize_lm_head (the paper keeps it bf16).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import linear as L
from repro_torch.core import schemes as S

# leaf names that flow through qlinear on the dense decode path
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "wi", "wg"})


def _pack_stacked(leaf: torch.Tensor, kind: str) -> L.PackedQWeight:
    """Pack a (..., N, K) stack as independent 2-D matrices."""
    lead = leaf.shape[:-2]
    flat = leaf.reshape(-1, *leaf.shape[-2:])
    packs = [L.pack_weight(flat[i], kind) for i in range(flat.shape[0])]
    return L.PackedQWeight(*(torch.stack(a).reshape(*lead, *a[0].shape)
                             for a in zip(*packs)))


def _map_leaves(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, key) for v in tree]
    return fn(key, tree)


def prequantize(params, cfg: ArchConfig, scheme: str):
    """Params with decode-path weights replaced by PackedQWeight stacks.
    No-op for schemes that do not quantize weights."""
    sch = S.get(scheme)
    if sch.fwd_w == "none":
        return params
    kind = sch.fwd_w

    def maybe_pack(key, leaf):
        if isinstance(leaf, L.PackedQWeight):
            raise ValueError("params already prequantized")
        if leaf.dim() < 2 or key not in QUANT_KEYS:
            return leaf
        return _pack_stacked(leaf, kind)

    out = dict(params)
    out["stages"] = _map_leaves(params["stages"], maybe_pack)
    if cfg.quantize_lm_head and "head" in params:
        out["head"] = L.pack_weight(params["head"], kind)
    return out
