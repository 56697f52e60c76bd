"""The language model: every family of the reference in train, prefill and
decode modes (and the encode mode). Dense GQA (llama, yi, granite, chatglm3
with its half-dim rope, nemotron with relu2), the vision backbone (llava:
GQA fed precomputed embeddings), GQA + MoE (deepseek-moe-16b), MLA + MoE
(deepseek-v3), RWKV-6 (rwkv6: time-mix + channel-mix, `models/rwkv6.py`),
Griffin (recurrentgemma: RG-LRU blocks and sliding-window local attention,
`models/griffin.py`) and whisper's encoder-decoder (layernorm, gelu MLP,
cross-attention).

Counterpart of `repro/models/lm.py`. A model is a list of STAGES; each stage
is `count` structurally identical layers whose parameters are stacked on a
leading axis, as in the reference, so converted parameters keep their
layout. A layer is (mixer, ff): mixer gqa | lattn (sliding window) | mla |
rwkv_tm | rec, ff mlp | moe | rwkv_cm; a hybrid pattern (rec, rec, attn)
is one stage whose layer spec is the whole pattern, a remainder a trailing
stage. The reference's stacked-stage scan becomes a Python loop over layers
that takes each layer's slice as a view (gradients flow into the stacked
leaves). Decode caches are stage-aligned leaves updated in place: the paged
pool's (`serve.kv_pool.init_cache`, addressed through a block table) or
dense per-slot caches (`init_cache` here), which prefill fills and decode
extends. Token kinds ("kv", "mla") gate their writes per row; the recurrent
state kinds ("wkv", "tm_prev", "cm_prev", "lru") update every row, so a
decode step with an `active` mask restores the inactive rows
(`_merge_state`). Sliding-window layers of dense caches may be ring
buffers of `window` positions (`init_cache(lattn_ring=True)`). The
reference's REMAT is off, so training recomputes nothing.

MLA runs the expanded form (`mla.mla_apply`) in train and prefill mode and
the absorbed form in decode mode. Train and prefill read `inputs["embeds"]`
(cast to bf16) in place of the token embedding whenever the batch carries
it; decode always embeds tokens, as the reference does. The MoE layers'
load-balance aux losses are summed over the stack, as the reference's scan
carry does; `lm_loss` adds `aux_weight` times that sum to the CE, and
`forward` keeps returning (logits, caches), since serving reads no aux.
`forward_prefix` runs the first n layers of the same stack with the same
head (the self-speculative draft).

Whisper (`cfg.enc_dec`): `stages` hold the encoder (n_layers x (gqa, mlp),
bidirectional: the "encode" mode), `dec_stages` the decoder, whose layers
put a cross-attention over the encoder's output between the mixer and the
ff (`_cross_attend`, norm `nx`). The encoder reads stub frame embeddings
(`inputs["embeds"]`), the decoder tokens (`dec_embed`); `dec_head` is the
LM head, and the reference's `head` leaf is drawn but never read. Three
reference behaviours are kept as they are: the encoder's and the decoder's
layer ids both start at 0 (encoder layer i and decoder layer i share their
site seeds, hence the backward's RHT signs and SR draws); decode recomputes
the cross K/V from `enc_out` at every step; and the decoder has no position
signal (`rope_fraction` 0, no position table). Prefill fills the dense
caches of `init_encdec_cache`; the engine and `greedy_generate` do not
serve enc-dec, as the reference's do not.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import ModelShard, PackedQWeight, qlinear
from repro_torch.models import attention as A
from repro_torch.models import griffin as G
from repro_torch.models import mla as M
from repro_torch.models import moe as X
from repro_torch.models import rwkv6 as W
from repro_torch.models.blocks import (chunked_head_ce, embed_init,
                                       embed_lookup, lm_head, mlp_apply,
                                       mlp_init, norm, norm_init, site_seed,
                                       weight_drawer)


def _check_family(cfg: ArchConfig) -> None:
    """Raise for a configuration none of the reference's families covers."""
    dense = (cfg.family in ("dense", "vlm") and cfg.attn == "gqa"
             and not cfg.moe)
    moe = (cfg.family == "moe" and cfg.moe is not None
           and (cfg.attn == "gqa" or (cfg.attn == "mla"
                                      and cfg.mla is not None)))
    ssm = cfg.family == "ssm" and cfg.rwkv is not None
    hybrid = (cfg.family == "hybrid" and cfg.griffin is not None
              and cfg.attn == "gqa")
    encdec = cfg.family == "audio" and cfg.attn == "gqa" and not cfg.moe
    if not (encdec if cfg.enc_dec else (dense or moe or ssm or hybrid)):
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' (attn '{cfg.attn}', enc_dec "
            f"{cfg.enc_dec}) is none of the reference's: dense, vlm, MoE, "
            "ssm (rwkv6), hybrid (griffin) and the audio encoder-decoder "
            "(whisper)")


def layer_specs(cfg: ArchConfig) -> list[tuple[tuple[tuple[str, str], ...], int]]:
    """[(pattern, repeats)] — pattern is a tuple of (mixer, ff) layer specs."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return [((("rwkv_tm", "rwkv_cm"),), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = tuple(("rec", "mlp") if t == "rec" else ("lattn", "mlp")
                    for t in cfg.griffin.pattern)
        reps, rem = divmod(cfg.n_layers, len(pat))
        stages = [(pat, reps)] if reps else []
        if rem:
            stages.append((pat[:rem], 1))
        return stages
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
    params: dict[str, Any] = {}
    if cfg.input_mode == "tokens" or not cfg.enc_dec:
        params["embed"] = embed_init(draw, cfg.vocab, cfg.d_model)
    stages = []
    for pattern, count in layer_specs(cfg):
        stage = {}
        for i, (mixer, ff) in enumerate(pattern):
            if mixer == "mla":
                mix = M.mla_init(draw, count, cfg, device)
            elif mixer == "rwkv_tm":  # carries the channel-mix's leaves too
                mix = W.rwkv_init(draw, gen, count, cfg, device)
            elif mixer == "rec":
                mix = G.rglru_init(draw, count, cfg, device)
            else:
                mix = A.gqa_init(draw, count, cfg, device)
            layer = {"mix": mix, "n1": _stacked_norm(cfg, count, device)}
            if ff == "moe":
                layer["ff"] = X.moe_init(draw, count, cfg)
            elif ff == "mlp":
                layer["ff"] = mlp_init(draw, count, cfg.d_model, cfg.d_ff,
                                       cfg.mlp)
            layer["n2"] = _stacked_norm(cfg, count, device)
            stage[f"l{i}"] = layer
        stages.append(stage)
    params["stages"] = stages
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, device)
    if not cfg.tie_embeddings:
        params["head"] = draw("head", (cfg.vocab, cfg.d_model), cfg.d_model,
                              0.02)
    if cfg.enc_dec:
        params.update(_encdec_extra_init(cfg, draw, device))
    return params


def _stacked_norm(cfg, count: int, device) -> dict:
    return {k: v.expand(count, *v.shape).clone()
            for k, v in norm_init(cfg.d_model, cfg.norm, device).items()}


def layer_params(tree, i: int):
    """Layer i of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, (PackedQWeight, ModelShard)):
        return tree.layer(i)
    return tree[i]


def head_weight(params, cfg):
    if cfg.enc_dec:
        return params["dec_head"]
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _merge_state(active, new: torch.Tensor, old: torch.Tensor) -> None:
    """Write `new` into the state leaf `old` IN PLACE, keeping `old`'s rows
    where `active` is False (every row with active None).

    Token kinds gate their writes inside the mixer; the recurrent kinds
    (wkv / tm_prev / cm_prev / lru) update every row of a step, so a
    serving batch must restore its inactive rows here, or a slot mid-prefill
    would be corrupted by the interleaved decode steps."""
    if active is None:
        old.copy_(new)
        return
    m = active.reshape(active.shape[0], *([1] * (new.dim() - 1)))
    old.copy_(torch.where(m, new, old.to(new.dtype)))


def _apply_layer(spec, p, x, cfg, scheme, seed, layer_id, *, mode, cache,
                 pos, positions, active, block_table, enc_out=None):
    """One (mixer, ff) layer: (x, aux). `cache` is the layer's {kind: leaf or
    leaf pair} (views of the stacked cache leaves), or None. In prefill
    mode the layer's K/V (or latents) fill positions [0, S) of its dense
    cache and the recurrent state kinds take the prefill's final state; in
    decode mode every kind updates in place (state kinds of active rows
    only); encode mode attends without the causal mask. A layer with an
    `xattn` subtree (whisper's decoder) attends over `enc_out` between the
    mixer and the ff. aux is the MoE layer's load-balance loss (f32
    scalar), None for every other layer."""
    mixer, ff = spec
    window = cfg.griffin.window if (cfg.griffin and mixer == "lattn") else None
    decode = mode == "decode"
    gate = active if decode else None
    h = norm(x, p["n1"], cfg.norm, cfg.norm_eps)
    if mixer in ("gqa", "lattn", "mla"):
        kind = "mla" if mixer == "mla" else "kv"
        if decode:
            if mixer == "mla":
                o, _ = M.mla_decode(p["mix"], h, cfg, scheme, seed, layer_id,
                                    cache[kind], pos, active=active,
                                    block_table=block_table)
            else:
                o, _ = A.gqa_decode(p["mix"], h, cfg, scheme, seed, layer_id,
                                    cache[kind], pos, window=window,
                                    active=active, block_table=block_table)
        else:
            if mixer == "mla":
                o, new = M.mla_apply(p["mix"], h, cfg, scheme, seed, layer_id,
                                     positions=positions)
            else:
                o, new = A.gqa_apply(p["mix"], h, cfg, scheme, seed, layer_id,
                                     causal=mode != "encode", window=window,
                                     positions=positions)
            if cache is not None:
                _fill_cache(cache[kind], new, window)
    elif mixer == "rwkv_tm":
        st = cache["wkv"] if cache is not None else None
        pv = cache["tm_prev"] if cache is not None else None
        o, st, last = W.timemix_apply(p["mix"], h, cfg, scheme, seed,
                                      layer_id, state=st, prev=pv)
        if cache is not None:
            _merge_state(gate, st, cache["wkv"])
            _merge_state(gate, last, cache["tm_prev"])
    elif mixer == "rec":
        st = cache["lru"] if cache is not None else None
        o, st = G.recurrent_block_apply(p["mix"], h, cfg, scheme, seed,
                                        layer_id, state=st)
        if cache is not None:
            for new, old in zip(st, cache["lru"]):
                _merge_state(gate, new, old)
    else:
        raise ValueError(mixer)
    x = x + o
    if enc_out is not None and "xattn" in p:
        h = norm(x, p["nx"], cfg.norm, cfg.norm_eps)
        x = x + _cross_attend(p["xattn"], h, enc_out, cfg, scheme, seed,
                              layer_id)
    h = norm(x, p["n2"], cfg.norm, cfg.norm_eps)
    if ff == "moe":
        o, aux = X.moe_apply(p["ff"], h, cfg, scheme, seed, layer_id)
        return x + o, aux
    if ff == "rwkv_cm":
        pv = cache["cm_prev"] if cache is not None else None
        o, last = W.channelmix_apply(p["mix"], h, cfg, scheme, seed, layer_id,
                                     prev=pv)
        if cache is not None:
            _merge_state(gate, last, cache["cm_prev"])
        return x + o, None
    return x + mlp_apply(p["ff"], h, cfg.mlp, scheme, seed, layer_id), None


def _cross_attend(p, h, enc_out, cfg, scheme, seed, layer_id):
    """Whisper's cross-attention (sites 30-33): queries from the decoder's
    `h`, keys and values projected from `enc_out` (B, S_enc, D), or taken
    from a precomputed `(k, v)` pair; no mask."""
    b, s, _ = h.shape
    hd = cfg.hd
    q = qlinear(h, p["wq"], site_seed(seed, layer_id, 30),
                scheme).reshape(b, s, cfg.n_heads, hd)
    if isinstance(enc_out, tuple):  # precomputed cross K/V
        k, v = enc_out
    else:
        k = qlinear(enc_out, p["wk"], site_seed(seed, layer_id, 31), scheme)
        v = qlinear(enc_out, p["wv"], site_seed(seed, layer_id, 32), scheme)
        k = k.reshape(b, -1, cfg.n_kv_heads, hd)
        v = v.reshape(b, -1, cfg.n_kv_heads, hd)
    o = A.attend(q, k, v, causal=False)
    return qlinear(o.reshape(b, s, -1), p["wo"], site_seed(seed, layer_id, 33),
                   scheme)


def _fill_cache(cache, new, window) -> None:
    """Write prefill K/V (or latents) (B, S, ...) into the dense cache
    leaves (B, cap + 1, ...), IN PLACE: positions [0, S), or for a ring
    (a sliding-window layer whose cap < S) the last cap positions rolled so
    that position p sits at slot p % cap, where decode (`attention.
    ring_abs_pos`) expects it."""
    for leaf, n in zip(cache, new):
        s, cap = n.shape[1], leaf.shape[1] - 1
        if window is not None and s > cap:
            n = torch.roll(n[:, -cap:], s % cap, dims=1)
        leaf[:, : n.shape[1]] = n.to(leaf.dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda",
               specs=None, lattn_ring: bool = True) -> list:
    """Dense per-slot decode caches aligned with layer_specs(cfg) (or
    `specs`, e.g. a draft stack's `prefix_specs`), zero-initialized, per
    stage {"l<i>": {kind: leaf or leaf pair}}, each leaf stacked (count,
    batch, ...):
      - "kv" (gqa, lattn): (k, v), each (count, batch, cap + 1, KV, hd)
        bf16; cap = max_len, or for lattn with `lattn_ring` a ring of
        min(max_len, window) positions;
      - "mla": (c, k_rope), (count, batch, max_len + 1, kv_lora | rope)
        bf16;
      - "wkv" (rwkv_tm): (count, batch, H, d, d) f32 and "tm_prev" (count,
        batch, 1, D) bf16; "cm_prev" (rwkv_cm) the same;
      - "lru" (rec): (h (count, batch, W) f32, conv tail (count, batch,
        K - 1, W) bf16).
    Position cap of each token leaf's row is a write-only scratch position
    that takes every dropped write (PyTorch indexing raises where the
    reference's scatter drops); readers see [:, :cap]. Prefill fills [0, S)
    and decode mode extends it when the forward gets no block table.
    Ragged batches need lattn_ring=False: the ring roll assumes one shared
    prompt length."""
    def leaf(cap, *feat):
        return torch.zeros((count, batch, cap + 1, *feat),
                           dtype=torch.bfloat16, device=device)

    stages = []
    for pattern, count in (specs if specs is not None else layer_specs(cfg)):
        one = {}
        for i, (mixer, ff) in enumerate(pattern):
            c: dict[str, Any] = {}
            if mixer == "mla":
                m = cfg.mla
                c["mla"] = (leaf(max_len, m.kv_lora_rank),
                            leaf(max_len, m.qk_rope_head_dim))
            elif mixer in ("gqa", "lattn"):
                cap = max_len
                if mixer == "lattn" and cfg.griffin and lattn_ring:
                    cap = min(max_len, cfg.griffin.window)
                c["kv"] = (leaf(cap, cfg.n_kv_heads, cfg.hd),
                           leaf(cap, cfg.n_kv_heads, cfg.hd))
            c.update(state_cache(mixer, ff, cfg, batch, device, (count,)))
            one[f"l{i}"] = c
        stages.append(one)
    return stages


def state_cache(mixer: str, ff: str, cfg: ArchConfig, batch: int, device,
                lead=()) -> dict:
    """The zero recurrent state kinds of one (mixer, ff) layer, leaves
    (*lead, batch, ...): {} for the attention-only layers."""
    c: dict[str, Any] = {}
    if mixer == "rwkv_tm":
        hd = cfg.rwkv.head_dim
        c["wkv"] = torch.zeros((*lead, batch, cfg.d_model // hd, hd, hd),
                               dtype=torch.float32, device=device)
        c["tm_prev"] = torch.zeros((*lead, batch, 1, cfg.d_model),
                                   dtype=torch.bfloat16, device=device)
    elif mixer == "rec":
        c["lru"] = G.recurrent_state_init(cfg, batch, device, lead)
    if ff == "rwkv_cm":
        c["cm_prev"] = torch.zeros((*lead, batch, 1, cfg.d_model),
                                   dtype=torch.bfloat16, device=device)
    return c


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
    if isinstance(tree, ModelShard):
        return ModelShard(tuple(_slice_layers(p, sl) for p in tree.parts),
                          tree.dim)
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
                pos, positions, active, block_table, enc_out=None):
    """The layers of `stages` ([(pattern, count)], aligned with
    `stage_params` and with `caches`, paged or dense, when given). A layer's
    id, hence its quantization site seeds, is its index in the full stack:
    stages cut by `prefix_specs` start where the full model's do, and
    whisper's encoder and decoder stacks both start at 0. Returns
    (x, aux): aux the f32 sum of the MoE layers' aux losses in layer order
    (None without MoE layers; the reference's 0 + a_0 + a_1 + ... is the
    same sum, since 0 + a_0 is exactly a_0)."""
    from repro_torch.serve.kv_pool import index_leaf  # kv_pool imports lm
    aux_total = None
    off = 0
    for si, (pattern, count) in enumerate(stages):
        sp = stage_params[si]
        for idx in range(count):
            lp = layer_params(sp, idx)
            for li, spec in enumerate(pattern):
                cache = None
                if caches is not None and mode != "train":
                    cache = {kind: (tuple(index_leaf(t, idx) for t in v)
                                    if isinstance(v, tuple) else v[idx])
                             for kind, v in caches[si][f"l{li}"].items()}
                x, aux = _apply_layer(
                    spec, lp[f"l{li}"], x, cfg, scheme, seed,
                    off + idx * len(pattern) + li, mode=mode, cache=cache,
                    pos=pos, positions=positions, active=active,
                    block_table=block_table, enc_out=enc_out)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
        off += count * len(pattern)
    return x, aux_total


def _forward(params, stage_params, stages, cfg, inputs, scheme, seed, *,
             caches, mode, pos, active, block_table, head):
    """The model's forward: (out, caches, aux), aux the summed MoE aux loss
    (None without MoE layers; only `lm_loss` reads it)."""
    if mode not in ("train", "prefill", "decode", "encode"):
        raise ValueError(f"mode '{mode}': train, prefill, decode or encode")
    _check_family(cfg)
    if cfg.enc_dec:
        return _encdec_forward(params, cfg, inputs, scheme, seed,
                               caches=caches, mode=mode, pos=pos, head=head)
    if "embeds" in inputs and mode != "decode":
        x = inputs["embeds"].to(torch.bfloat16)
    else:
        x = embed_lookup(params["embed"], inputs["tokens"])
    b, s = x.shape[:2]
    positions = None
    if mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    x, aux = _run_stages(stage_params, x, cfg, scheme, seed, stages=stages,
                         mode=mode, caches=caches, pos=pos,
                         positions=positions, active=active,
                         block_table=block_table)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if head:
        x = lm_head(x, head_weight(params, cfg), cfg.quantize_lm_head, scheme,
                    seed)
    return x, caches, aux


def forward(params, cfg: ArchConfig, inputs, scheme: str, seed, *,
            caches=None, mode: str = "decode", pos=None, active=None,
            block_table=None, head: bool = True):
    """Full model. inputs: {"tokens": (B, S)}, or {"embeds": (B, S, D)}
in train and prefill mode (llava's stubbed frontend; decode embeds tokens);
whisper takes both in train and prefill mode (the encoder's frames and the
decoder's tokens) and tokens in decode mode, its `caches` those of
`init_encdec_cache`.

    mode="train": causal full-sequence forward from position 0 (no caches);
    with head=False the final normed hidden states are returned (`lm_loss`
    fuses the head with a chunked CE).
    mode="prefill": the same forward from position 0, writing each layer's
    K/V (or MLA latents) into positions [0, S) of the dense `caches`
    (`init_cache`) when given; whisper also writes the encoder's output
    into `caches["enc_out"]`.
    mode="encode": the train-mode forward without the causal mask.
    mode="decode": `pos` (B,) int32 per-row start positions (S > 1 is a
    chunked-prefill step); `active` (B,) bool gates cache writes per row;
    `block_table` (B, MAXB) int32 indexes the paged pool `caches`
    (`serve.kv_pool.init_cache`); without one the `caches` are dense
    (`init_cache`). They come back updated in place. Whisper's decode step
    attends over `caches["enc_out"]`, its cross K/V projected anew.
    Returns (logits_or_hidden, caches); the reference's third output, the MoE
    aux loss, is left out (serving reads none; `lm_loss` adds it)."""
    return _forward(params, params["stages"], layer_specs(cfg), cfg, inputs,
                    scheme, seed, caches=caches, mode=mode, pos=pos,
                    active=active, block_table=block_table, head=head)[:2]


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
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec draft stacks are not supported")
    return _forward(params, prefix_stage_params(params, cfg, n_prefix),
                    prefix_specs(cfg, n_prefix), cfg, inputs, scheme, seed,
                    caches=caches, mode=mode, pos=pos, active=active,
                    block_table=block_table, head=True)[:2]


def lm_loss(params, cfg: ArchConfig, batch, scheme: str, seed,
            aux_weight: float = 0.01):
    """Fused chunked head + CE (never materializes (tokens, vocab) logits)
    plus `aux_weight` times the summed MoE aux loss (0 for the dense
    family): ce + aux_weight * aux, as the reference."""
    hidden, _, aux = _forward(params, params["stages"], layer_specs(cfg), cfg,
                              batch, scheme, seed, caches=None, mode="train",
                              pos=None, active=None, block_table=None,
                              head=False)
    ce = chunked_head_ce(hidden, head_weight(params, cfg), batch["labels"],
                         cfg.quantize_lm_head, scheme, seed)
    if aux is None:  # no MoE layer: the reference adds aux_weight * 0 to ce
        return ce
    return ce + aux_weight * aux


# --------------------------------------------------------------------------
# whisper-style encoder-decoder
# --------------------------------------------------------------------------

def _encdec_extra_init(cfg: ArchConfig, draw, device) -> dict:
    """The decoder stack and its cross-attention; `stages` hold the
    encoder. Paths and shapes are the reference's: `dec_embed`,
    `dec_stages` [{"l0": {mix, n1, ff, n2, xattn, nx}}] stacked over
    n_layers, `dec_final_norm`, `dec_head`."""
    count = cfg.n_layers
    layer = {"mix": A.gqa_init(draw, count, cfg, device),
             "n1": _stacked_norm(cfg, count, device),
             "ff": mlp_init(draw, count, cfg.d_model, cfg.d_ff, cfg.mlp),
             "n2": _stacked_norm(cfg, count, device),
             "xattn": A.gqa_init(draw, count, cfg, device),
             "nx": _stacked_norm(cfg, count, device)}
    return {
        "dec_embed": draw("dec_embed", (cfg.vocab, cfg.d_model), cfg.d_model,
                          0.02),
        "dec_stages": [{"l0": layer}],
        "dec_final_norm": norm_init(cfg.d_model, cfg.norm, device),
        "dec_head": draw("dec_head", (cfg.vocab, cfg.d_model), cfg.d_model,
                         0.02),
    }


def DEC_STAGES(cfg: ArchConfig):  # the reference's name
    """The decoder's layer specs: n_layers x (gqa, mlp), each layer with its
    cross-attention."""
    return [((("gqa", "mlp"),), cfg.n_layers)]


def _encdec_forward(params, cfg, inputs, scheme, seed, *, caches, mode, pos,
                    head):
    """Whisper's forward: (out, caches, None). Decode mode runs the decoder
    alone over `caches["enc_out"]`; every other mode runs the encoder
    (bidirectional) over `inputs["embeds"]`, its final norm, then the
    decoder over `inputs["tokens"]` in `mode` (prefill fills
    `caches["dec"]` and copies the encoder's output into
    `caches["enc_out"]`)."""
    dec = DEC_STAGES(cfg)
    if mode == "decode":
        enc_out = caches["enc_out"]
        x = embed_lookup(params["dec_embed"], inputs["tokens"])
        b, s = x.shape[:2]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
        positions = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                                device=x.device)[None, :]
        x, _ = _run_stages(params["dec_stages"], x, cfg, scheme, seed,
                           stages=dec, mode="decode", caches=caches["dec"],
                           pos=pos, positions=positions, active=None,
                           block_table=None, enc_out=enc_out)
        x = norm(x, params["dec_final_norm"], cfg.norm, cfg.norm_eps)
        return (lm_head(x, params["dec_head"], cfg.quantize_lm_head, scheme,
                        seed), caches, None)
    xe = inputs["embeds"].to(torch.bfloat16)
    enc_x, _ = _run_stages(
        params["stages"], xe, cfg, scheme, seed, stages=layer_specs(cfg),
        mode="encode", caches=None, pos=None,
        positions=torch.arange(xe.shape[1], device=xe.device)[None, :],
        active=None, block_table=None)
    enc_out = norm(enc_x, params["final_norm"], cfg.norm, cfg.norm_eps)
    x = embed_lookup(params["dec_embed"], inputs["tokens"])
    x, _ = _run_stages(
        params["dec_stages"], x, cfg, scheme, seed, stages=dec, mode=mode,
        caches=caches["dec"] if caches else None, pos=None,
        positions=torch.arange(x.shape[1], device=x.device)[None, :],
        active=None, block_table=None, enc_out=enc_out)
    x = norm(x, params["dec_final_norm"], cfg.norm, cfg.norm_eps)
    if caches:
        caches["enc_out"].copy_(enc_out)
    if head:
        x = lm_head(x, params["dec_head"], cfg.quantize_lm_head, scheme, seed)
    return x, caches, None


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      enc_len: int, *, device="cuda") -> dict:
    """Whisper's decode caches: {"enc_out": (batch, enc_len, D) bf16 zeros,
    which prefill overwrites with the encoder's output, "dec": the
    decoder's dense caches (`init_cache` over `DEC_STAGES`: (n_layers,
    batch, max_len + 1, KV, hd) K and V, position max_len the write-only
    scratch position)}."""
    return {"enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=torch.bfloat16, device=device),
            "dec": init_cache(cfg, batch, max_len, device=device,
                              specs=DEC_STAGES(cfg))}
