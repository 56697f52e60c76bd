"""The language model: the dense family (train and decode modes) and the
MLA + MoE family (deepseek-v3, decode mode).

Counterpart of `repro/models/lm.py`. A model is a list of STAGES; each stage
is `count` structurally identical layers whose parameters are stacked on a
leading axis, as in the reference, so converted parameters keep their
layout. The reference's stacked-stage scan becomes a Python loop over layers
that takes each layer's slice as a view (gradients flow into the stacked
leaves). Decode caches are the paged pool's stage-aligned leaves, updated in
place. The reference's REMAT is off, so training recomputes nothing.

Ported: (gqa, mlp) layers in train and decode mode, (mla, moe) layers in
decode mode. The other families, MLA/MoE training and the prefill/encode
modes raise NotImplementedError and come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import PackedQWeight
from repro_torch.models import attention as A
from repro_torch.models import mla as M
from repro_torch.models import moe as X
from repro_torch.models.blocks import (chunked_head_ce, embed_init,
                                       embed_lookup, lm_head, mlp_apply,
                                       mlp_init, norm, norm_init,
                                       weight_drawer)


def _check_family(cfg: ArchConfig, mode: str = "decode") -> None:
    """Raise for what the port does not run yet: families other than dense
    gqa and MLA + MoE, and MLA + MoE outside decode mode."""
    dense = cfg.family == "dense" and cfg.attn == "gqa" and not cfg.moe
    mla_moe = (cfg.family == "moe" and cfg.attn == "mla"
               and cfg.moe is not None and cfg.mla is not None)
    if cfg.enc_dec or cfg.griffin or cfg.rwkv or not (dense or mla_moe):
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' (attn '{cfg.attn}') is not "
            "ported yet; the port runs the dense gqa family and serves MLA + "
            "MoE")
    if mla_moe and mode != "decode":
        raise NotImplementedError(
            f"{cfg.name}: MLA + MoE {mode} comes with the MLA/MoE training "
            "slice; this slice serves it (decode mode)")


def layer_specs(cfg: ArchConfig) -> list[tuple[tuple[tuple[str, str], ...], int]]:
    """[(pattern, repeats)] — pattern is a tuple of (mixer, ff) layer specs."""
    _check_family(cfg)
    mixer = "mla" if cfg.attn == "mla" else "gqa"
    ff = "moe" if cfg.moe else "mlp"
    return [(((mixer, ff),), cfg.n_layers)]


def init(cfg: ArchConfig, gen: torch.Generator, device="cuda",
         draw=None) -> dict:
    """Seeded random parameters in the reference's layout (stacked stages).

    Draws from `gen`, which must live on `device`; the numbers differ from
    the reference's threefry init (tests convert reference parameters with
    `repro_torch.convert` instead). `draw(key, shape, n_in, scale=None)`
    makes each weight leaf (default `blocks.weight_drawer(gen, device)`;
    `serve.prequant.init_packed` packs as it draws)."""
    draw = draw or weight_drawer(gen, device)
    params: dict[str, Any] = {"embed": embed_init(draw, cfg.vocab, cfg.d_model)}
    stages = []
    for pattern, count in layer_specs(cfg):
        stage = {}
        for i, (mixer, ff) in enumerate(pattern):
            mix = (M.mla_init(draw, count, cfg, device) if mixer == "mla"
                   else A.gqa_init(draw, count, cfg, device))
            n1 = _stacked_norm(cfg, count, device)
            fp = (X.moe_init(draw, count, cfg) if ff == "moe"
                  else mlp_init(draw, count, cfg.d_model, cfg.d_ff, cfg.mlp))
            stage[f"l{i}"] = {"mix": mix, "n1": n1, "ff": fp,
                              "n2": _stacked_norm(cfg, count, device)}
        stages.append(stage)
    params["stages"] = stages
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, device)
    if not cfg.tie_embeddings:
        params["head"] = draw("head", (cfg.vocab, cfg.d_model), cfg.d_model,
                              0.02)
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


def _apply_layer(spec, p, x, cfg, scheme, seed, layer_id, *, mode, cache,
                 pos, positions, active, block_table):
    """One (mixer, ff) layer; in decode mode the cache updates in place. The
    MoE aux loss is dropped (no ported path trains the MoE family yet)."""
    mixer, ff = spec
    h = norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    if mode == "train":
        o, _ = A.gqa_apply(p["mix"], h, cfg, scheme, seed, layer_id,
                           causal=True, positions=positions)
    elif mixer == "mla":
        o, _ = M.mla_decode(p["mix"], h, cfg, scheme, seed, layer_id, cache,
                            pos, active=active, block_table=block_table)
    else:
        o, _ = A.gqa_decode(p["mix"], h, cfg, scheme, seed, layer_id, cache,
                            pos, active=active, block_table=block_table)
    x = x + o
    h = norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    if ff == "moe":
        o, _aux = X.moe_apply(p["ff"], h, cfg, scheme, seed, layer_id)
        return x + o
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
    aux loss, is dropped (serving does not use it; training of the MoE family
    comes with a later slice)."""
    if mode not in ("train", "decode"):
        raise NotImplementedError(
            f"mode '{mode}' comes with a later slice (train and decode are "
            "ported)")
    _check_family(cfg, mode)
    from repro_torch.serve.kv_pool import index_leaf  # kv_pool imports lm
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
            for li, spec in enumerate(pattern):
                cache = None
                if mode == "decode":
                    kind = "mla" if spec[0] == "mla" else "kv"
                    cache = tuple(index_leaf(leaf, idx)
                                  for leaf in caches[si][f"l{li}"][kind])
                x = _apply_layer(spec, lp[f"l{li}"], x, cfg, scheme, seed,
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
