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
decode mode. `forward_prefix` runs the first n layers of the same stack with
the same head (the self-speculative draft). The other families, MLA/MoE
training and the prefill/encode modes raise NotImplementedError and come
with later slices.
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


def total_layers(cfg: ArchConfig) -> int:
    return sum(count * len(pattern) for pattern, count in layer_specs(cfg))


def _prefix_plan(cfg: ArchConfig, n_prefix: int):
    """Cut layer_specs after the first `n_prefix` layers.

    Returns (specs, plan) where plan entries (si, rep_start, reps, pat_len)
    select `reps` repetitions of stage `si` starting at repetition
    `rep_start`, truncated to the first `pat_len` layers of the pattern. A
    cut inside a multi-layer pattern yields a trailing partial entry (reps =
    1), so any 0 < n_prefix < total_layers is a valid draft depth."""
    specs = layer_specs(cfg)
    total = total_layers(cfg)
    if not 0 < n_prefix < total:
        raise ValueError(
            f"prefix depth must satisfy 0 < n < {total}, got {n_prefix}")
    plan, left = [], n_prefix
    for si, (pattern, count) in enumerate(specs):
        if left <= 0:
            break
        per = len(pattern)
        reps = min(count, left // per)
        if reps:
            plan.append((si, 0, reps, per))
            left -= reps * per
        if left and reps < count:
            plan.append((si, reps, 1, left))
            left = 0
    return specs, plan


def prefix_specs(cfg: ArchConfig, n_prefix: int):
    """layer_specs truncated to the first n_prefix layers (the draft stack)."""
    specs, plan = _prefix_plan(cfg, n_prefix)
    return [(specs[si][0][:plen], reps) for si, _, reps, plen in plan]


def _slice_layers(tree, sl: slice):
    """`tree` with every stacked leaf cut to the layers `sl` (views)."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, sl) for k, v in tree.items()}
    if isinstance(tree, PackedQWeight):
        return PackedQWeight(*(t[sl] for t in tree))
    return tree[sl]


def prefix_stage_params(params, cfg: ArchConfig, n_prefix: int):
    """Stage parameters aligned with prefix_specs: views of the stacked
    leaves (PackedQWeight stacks included), so the draft owns no weights and
    its layers keep the full model's layer ids and site seeds."""
    specs, plan = _prefix_plan(cfg, n_prefix)
    out = []
    for si, r0, reps, plen in plan:
        sp = params["stages"][si]
        sub = {f"l{i}": sp[f"l{i}"] for i in range(plen)}
        if r0 == 0 and reps == specs[si][1] and plen == len(specs[si][0]):
            out.append(sub)
        else:
            out.append(_slice_layers(sub, slice(r0, r0 + reps)))
    return out


def _run_stages(stage_params, x, cfg, scheme, seed, *, stages, mode, caches,
                pos, positions, active, block_table):
    """The layers of `stages` ([(pattern, count)], aligned with
    `stage_params` and, in decode mode, with the pool-shaped `caches`). A
    layer's id, hence its quantization site seeds, is its index in the full
    stack: stages cut by `prefix_specs` start where the full model's do."""
    from repro_torch.serve.kv_pool import index_leaf  # kv_pool imports lm
    off = 0
    for si, (pattern, count) in enumerate(stages):
        sp = stage_params[si]
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
    return x


def _forward(params, stage_params, stages, cfg, inputs, scheme, seed, *,
             caches, mode, pos, active, block_table, head):
    if mode not in ("train", "decode"):
        raise NotImplementedError(
            f"mode '{mode}' comes with a later slice (train and decode are "
            "ported)")
    _check_family(cfg, mode)
    x = embed_lookup(params["embed"], inputs["tokens"])
    b, s = x.shape[:2]
    positions = None
    if mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    x = _run_stages(stage_params, x, cfg, scheme, seed, stages=stages,
                    mode=mode, caches=caches, pos=pos, positions=positions,
                    active=active, block_table=block_table)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if not head:
        return x, caches
    logits = lm_head(x, head_weight(params, cfg), cfg.quantize_lm_head, scheme,
                     seed)
    return logits, caches


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
    return _forward(params, params["stages"], layer_specs(cfg), cfg, inputs,
                    scheme, seed, caches=caches, mode=mode, pos=pos,
                    active=active, block_table=block_table, head=head)


def forward_prefix(params, cfg: ArchConfig, inputs, scheme: str, seed, *,
                   n_prefix: int, caches=None, mode: str = "decode", pos=None,
                   active=None, block_table=None):
    """Early-exit forward: the first `n_prefix` layers, the final norm and
    the shared head. This is the self-speculative DRAFT stack
    (`serve/spec_decode.py`): it reuses the full model's (possibly packed)
    parameters, and each of its layers computes bit for bit what the same
    layer computes inside the full stack at the same step shape. `caches`
    must be prefix-shaped (`kv_pool.init_cache(specs=prefix_specs(cfg,
    n_prefix))`). Returns (logits, caches), as `forward`."""
    return _forward(params, prefix_stage_params(params, cfg, n_prefix),
                    prefix_specs(cfg, n_prefix), cfg, inputs, scheme, seed,
                    caches=caches, mode=mode, pos=pos, active=active,
                    block_table=block_table, head=True)


def lm_loss(params, cfg: ArchConfig, batch, scheme: str, seed) -> torch.Tensor:
    """Fused chunked head + CE (never materializes (tokens, vocab) logits).
    The reference adds aux_weight * the MoE aux loss, 0 for the dense family."""
    hidden, _ = forward(params, cfg, batch, scheme, seed, mode="train",
                        head=False)
    return chunked_head_ce(hidden, head_weight(params, cfg), batch["labels"],
                           cfg.quantize_lm_head, scheme, seed)
