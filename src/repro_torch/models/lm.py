"""The language model, dense family, decode mode (serving slice).

Counterpart of `repro/models/lm.py`. A model is a list of STAGES; each stage
is `count` structurally identical layers whose parameters are stacked on a
leading axis, as in the reference, so converted parameters keep their
layout. The reference's stacked-stage scan becomes a Python loop over layers
that takes each layer's slice as a view. Decode caches are the paged pool's
stage-aligned leaves, updated in place.

Only the dense family (gqa + swiglu) is ported; the other families and the
train/prefill modes raise NotImplementedError and come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import PackedQWeight
from repro_torch.models import attention as A
from repro_torch.models.blocks import (embed_init, embed_lookup, linear_init,
                                       lm_head, mlp_apply, mlp_init, norm,
                                       norm_init)


def _check_family(cfg: ArchConfig) -> None:
    if (cfg.family != "dense" or cfg.attn != "gqa" or cfg.moe or cfg.enc_dec
            or cfg.griffin or cfg.rwkv):
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' (attn '{cfg.attn}') is not "
            "ported yet; this slice serves the dense gqa family")


def layer_specs(cfg: ArchConfig) -> list[tuple[tuple[tuple[str, str], ...], int]]:
    """[(pattern, repeats)] — pattern is a tuple of (mixer, ff) layer specs."""
    _check_family(cfg)
    return [((("gqa", "mlp"),), cfg.n_layers)]


def init(cfg: ArchConfig, gen: torch.Generator, device="cuda") -> dict:
    """Seeded random parameters in the reference's layout (stacked stages).

    Draws from `gen`, which must live on `device`; the numbers differ from
    the reference's threefry init (tests convert reference parameters with
    `repro_torch.convert` instead)."""
    params: dict[str, Any] = {"embed": embed_init(gen, cfg.vocab, cfg.d_model,
                                                  device)}
    stages = []
    for pattern, count in layer_specs(cfg):
        stage = {}
        for i, (mixer, ff) in enumerate(pattern):
            stage[f"l{i}"] = {
                "mix": A.gqa_init(gen, count, cfg, device),
                "n1": _stacked_norm(cfg, count, device),
                "ff": mlp_init(gen, count, cfg.d_model, cfg.d_ff, cfg.mlp,
                               device),
                "n2": _stacked_norm(cfg, count, device)}
        stages.append(stage)
    params["stages"] = stages
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, device)
    if not cfg.tie_embeddings:
        params["head"] = linear_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model,
                                     scale=0.02, device=device)
    return params


def _stacked_norm(cfg, count: int, device) -> dict:
    return {k: v.expand(count, *v.shape).clone()
            for k, v in norm_init(cfg.d_model, cfg.norm, device).items()}


def layer_params(tree, i: int):
    """Layer i of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, PackedQWeight):
        return tree.layer(i)
    return tree[i]


def head_weight(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _apply_layer(p, x, cfg, scheme, seed, layer_id, *, cache, pos, active,
                 block_table):
    """One (gqa, mlp) layer in decode mode; the cache updates in place."""
    h = norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    o, _ = A.gqa_decode(p["mix"], h, cfg, scheme, seed, layer_id, cache, pos,
                        active=active, block_table=block_table)
    x = x + o
    h = norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    return x + mlp_apply(p["ff"], h, cfg.mlp, scheme, seed, layer_id)


def forward(params, cfg: ArchConfig, inputs, scheme: str, seed, *,
            caches=None, mode: str = "decode", pos=None, active=None,
            block_table=None):
    """Full model in decode mode. inputs: {"tokens": (B, S)}; `pos` (B,)
    int32 per-row start positions (S > 1 is a chunked-prefill step);
    `active` (B,) bool gates cache writes per row; `block_table` (B, MAXB)
    int32 indexes the paged pool `caches` (`serve.kv_pool.init_cache`).
    Returns (logits, caches); the caches come back updated in place (the
    reference's third output, the MoE aux loss, has no dense counterpart)."""
    if mode != "decode":
        raise NotImplementedError(
            f"mode '{mode}' comes with the training slice; serving decodes")
    x = embed_lookup(params["embed"], inputs["tokens"])
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    off = 0
    for si, (pattern, count) in enumerate(layer_specs(cfg)):
        sp = params["stages"][si]
        for idx in range(count):
            lp = layer_params(sp, idx)
            for li in range(len(pattern)):
                kc, vc = caches[si][f"l{li}"]["kv"]
                x = _apply_layer(lp[f"l{li}"], x, cfg, scheme, seed,
                                 off + idx * len(pattern) + li,
                                 cache=(kc[idx], vc[idx]), pos=pos,
                                 active=active, block_table=block_table)
        off += count * len(pattern)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = lm_head(x, head_weight(params, cfg), cfg.quantize_lm_head, scheme,
                     seed)
    return logits, caches
