"""Quantize-once NVFP4 weight cache.

Counterpart of `repro/serve/prequant.py`. The forward quantizers are
deterministic, so a weight's NVFP4 image is a pure function of the weight:
serving quantizes and packs every linear weight the decode path feeds
through `qlinear` ONCE (on the card through the 4/6 quantization kernel)
and reuses the packed tensors. Unpacking round-trips exactly, so prequant
logits are IDENTICAL to per-step quantization.

Selection is by leaf name. Deliberately excluded: `wkv_b` (MLA), which the
absorbed decode consumes as a raw matrix, `router` (MoE), and the f32
matmuls of rwkv6's LoRAs (`mix_w1`, `mix_w2`, `ww1`, `ww2`) and griffin's
gates (`wa`, `wx`), which never pass through qlinear; embeddings and norms
are no GEMM weights. Stacked leaves,
(layers, N, K) and (layers, E, f, d) expert stacks, pack per matrix, matching
the per-layer / per-expert scale granularity of the per-step path. The LM
head is packed only when cfg.quantize_lm_head (the paper keeps it bf16).

`init_packed` draws seeded random weights and packs each decode-path weight
as it is drawn, a chunk of matrices at a time, so no f32 copy of a whole
stack is ever alive: what lets full-width deepseek-v3 layers (a 15 GB f32
expert stack each) be built on one card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import linear as L
from repro_torch.core import schemes as S
from repro_torch.models import lm
from repro_torch.models.blocks import linear_init

# leaf names that flow through qlinear on the decode path
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo",            # gqa / lattn projections, rwkv r/k/v/o
    "wi", "wg",                        # mlp / moe experts, rwkv gate
    "wr",                              # rwkv receptance
    "wq_a", "wq_b", "wkv_a",           # MLA down/up projections (not wkv_b!)
    "w_in", "w_gate", "w_out",         # griffin recurrent block
    "cm_wr", "cm_wk", "cm_wv",         # rwkv channel-mix
})


def _pack_chunks(lead: tuple, chunks, kind: str) -> L.PackedQWeight:
    """Pack (c, N, K) chunks, matrix by matrix in order, into one (*lead, ...)
    PackedQWeight whose tensors are allocated once. Each chunk is released
    before the next is drawn, so one chunk of f32 is alive at a time."""
    out, i = None, 0
    for chunk in chunks:
        for w in chunk:
            packed = L.pack_weight(w, kind)
            if out is None:
                out = [torch.empty((math.prod(lead), *a.shape), dtype=a.dtype,
                                   device=a.device) for a in packed]
            for dst, a in zip(out, packed):
                dst[i] = a
            i += 1
        chunk = w = None  # w is a view: it would keep the chunk's storage
    return L.PackedQWeight(*(a.reshape(*lead, *a.shape[1:]) for a in out))


def _pack_stacked(leaf: torch.Tensor, kind: str) -> L.PackedQWeight:
    """Pack a (..., N, K) stack as independent 2-D matrices."""
    return _pack_chunks(leaf.shape[:-2], [leaf.reshape(-1, *leaf.shape[-2:])],
                        kind)


def _map_leaves(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, key) for v in tree]
    return fn(key, tree)


def prequantize(params, cfg: ArchConfig, scheme: str, probe=None):
    """Params with decode-path weights replaced by PackedQWeight stacks.
    No-op for schemes that do not quantize weights.

    `probe` (obs/quant_probe.py QuantProbe, optional) samples the RAW
    weights' quantization health (per-site MSE, scale saturation, clip
    fraction) before packing, so the one weight quantization every serving
    run depends on is observed, not assumed."""
    sch = S.get(scheme)
    if sch.fwd_w == "none":
        return params
    if probe is not None:
        probe.probe_params(params, phase="prequant")
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


def init_packed(cfg: ArchConfig, gen: torch.Generator, scheme: str,
                device="cuda", chunk: int = 32):
    """`lm.init` with every weight that `prequantize` would pack drawn and
    packed `chunk` matrices at a time (one expert chunk of f32 alive at
    once): the params a prequantized engine serves, built without their f32
    stacks. Pass them with `EngineConfig(prequant=False)`: they are packed
    already. For schemes that quantize no weight this is `lm.init`."""
    kind = S.get(scheme).fwd_w

    def draw(key, shape, n_in, scale=None):
        packs = kind != "none" and (
            (key in QUANT_KEYS and len(shape) >= 3)
            or (key == "head" and cfg.quantize_lm_head))
        if not packs:
            return linear_init(gen, shape, n_in, scale, device)
        lead, n = shape[:-2], math.prod(shape[:-2])
        chunks = (linear_init(gen, (min(chunk, n - s), *shape[-2:]), n_in,
                              scale, device) for s in range(0, n, chunk))
        return _pack_chunks(lead, chunks, kind)

    return lm.init(cfg, gen, device, draw=draw)
