"""The language model, dense family: train and decode modes.

Counterpart of `repro/models/lm.py`. A model is a list of STAGES; each stage
is `count` structurally identical layers whose parameters are stacked on a
leading axis, as in the reference, so converted parameters keep their
layout. The reference's stacked-stage scan becomes a Python loop over layers
that takes each layer's slice as a view (gradients flow into the stacked
leaves). Decode caches are the paged pool's stage-aligned leaves, updated in
place. The reference's REMAT is off, so training recomputes nothing.

Only the dense family (gqa + swiglu) is ported; the other families and the
prefill/encode modes raise NotImplementedError and come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import PackedQWeight
from repro_torch.models import attention as A
from repro_torch.models.blocks import (chunked_head_ce, embed_init,
                                       embed_lookup, linear_init, lm_head,
                                       mlp_apply, mlp_init, norm, norm_init)


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


def _apply_layer(p, x, cfg, scheme, seed, layer_id, *, mode, cache, pos,
                 positions, active, block_table):
    """One (gqa, mlp) layer; in decode mode the cache updates in place."""
    h = norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    if mode == "train":
        o, _ = A.gqa_apply(p["mix"], h, cfg, scheme, seed, layer_id,
                           causal=True, positions=positions)
    else:
        o, _ = A.gqa_decode(p["mix"], h, cfg, scheme, seed, layer_id, cache,
                            pos, active=active, block_table=block_table)
    x = x + o
    h = norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    return x + mlp_apply(p["ff"], h, cfg.mlp, scheme, seed, layer_id)


def forward(params, cfg: ArchConfig, inputs, scheme: str, seed, *,
            caches=None, mode: str = "decode", pos=None, active=None,
            block_table=None, head: bool = True):
    """Full model. inputs: {"tokens": (B, S)}.

    mode="train": causal full-sequence forward from position 0 (no caches);
    with head=False the final normed hidden states are returned (`lm_loss`
    fuses the head with a chunked CE).
    mode="decode": `pos` (B,) int32 per-row start positions (S > 1 is a
    chunked-prefill step); `active` (B,) bool gates cache writes per row;
    `block_table` (B, MAXB) int32 indexes the paged pool `caches`
    (`serve.kv_pool.init_cache`), which come back updated in place.
    Returns (logits_or_hidden, caches); the reference's third output, the MoE
    aux loss, has no dense counterpart."""
    if mode not in ("train", "decode"):
        raise NotImplementedError(
            f"mode '{mode}' comes with a later slice (train and decode are "
            "ported)")
    x = embed_lookup(params["embed"], inputs["tokens"])
    b, s = x.shape[:2]
    positions = None
    if mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    off = 0
    for si, (pattern, count) in enumerate(layer_specs(cfg)):
        sp = params["stages"][si]
        for idx in range(count):
            lp = layer_params(sp, idx)
            for li in range(len(pattern)):
                cache = None
                if mode == "decode":
                    kc, vc = caches[si][f"l{li}"]["kv"]
                    cache = (kc[idx], vc[idx])
                x = _apply_layer(lp[f"l{li}"], x, cfg, scheme, seed,
                                 off + idx * len(pattern) + li, mode=mode,
                                 cache=cache, pos=pos, positions=positions,
                                 active=active, block_table=block_table)
        off += count * len(pattern)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if not head:
        return x, caches
    logits = lm_head(x, head_weight(params, cfg), cfg.quantize_lm_head, scheme,
                     seed)
    return logits, caches


def lm_loss(params, cfg: ArchConfig, batch, scheme: str, seed) -> torch.Tensor:
    """Fused chunked head + CE (never materializes (tokens, vocab) logits).
    The reference adds aux_weight * the MoE aux loss, 0 for the dense family."""
    hidden, _ = forward(params, cfg, batch, scheme, seed, mode="train",
                        head=False)
    return chunked_head_ce(hidden, head_weight(params, cfg), batch["labels"],
                           cfg.quantize_lm_head, scheme, seed)
