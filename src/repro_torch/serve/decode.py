"""Serving step builders: the engine's step (paged pool or dense caches),
its mesh-sharded form, and the fixed-batch seed loop over dense caches.

Counterpart of `repro/serve/decode.py`. `make_paged_serve_step` is THE
engine step (serve/engine.py): with a block table it runs on the paged pool,
with `table=None` on dense per-slot caches. `make_sharded_serve_step` is its
form over a serving mesh (`shard_serve_step`), the counterpart of the
reference's manual-"data" `shard_map` with GSPMD over "model": once a data
shard, its split linears running each weight part on its model device.
`make_prefill_step`,
`make_serve_step` and `greedy_generate` are the legacy fixed-batch path over
dense caches (`lm.init_cache`): the seed baseline of the reference's
benchmarks and its simple examples. Forward quantization (RTN + 4/6) is
deterministic, so serving needs no per-step randomness: the seed below is a
fixed constant (it feeds only the backward of the training slice).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.dist.sharding import mesh_sizes
from repro_torch.models import lm

SEED = np.array([7, 7], np.uint32)


def make_prefill_step(cfg, scheme: str):
    """(params, cache, {"tokens": (B, S)}) -> (logits (B, S, V), cache): the
    prefill forward from position 0, filling positions [0, S) of the dense
    caches in place."""
    def prefill_step(params, cache, batch):
        return lm.forward(params, cfg, batch, scheme, SEED, caches=cache,
                          mode="prefill")
    return prefill_step


def make_serve_step(cfg, scheme: str):
    """(params, cache, tokens (B, S), pos) -> (logits, cache): one decode
    step over the dense caches, `pos` the per-row (or shared) position of
    the first token."""
    def serve_step(params, cache, tokens, pos):
        return lm.forward(params, cfg, {"tokens": tokens}, scheme, SEED,
                          caches=cache, mode="decode", pos=pos)
    return serve_step


def make_paged_serve_step(cfg, scheme: str):
    """The engine's step: per-slot position vector, active mask, block table
    (None for dense caches) and caches updated in place. Returns (logits,
    caches). It builds no autograd graph, whatever the parameters need, so
    its bf16 GEMMs take the order-fixed kernel (`core.linear._serving`)."""
    def paged_serve_step(params, cache, table, tokens, pos, active):
        with torch.no_grad():
            return lm.forward(params, cfg, {"tokens": tokens}, scheme, SEED,
                              caches=cache, mode="decode", pos=pos,
                              active=active, block_table=table)
    return paged_serve_step


def make_sharded_serve_step(cfg, scheme: str, mesh, *, out_device=None):
    """The engine's step over a serving mesh: decode slots, the slot-affine
    pool (`KVPool(n_shards=...)`, one cache tree a shard), its shard-local
    tables and the per-slot inputs split over "data", the unchanged step
    run on each shard's own slice on the shard's device, no collective
    touching the pool (`shard_serve_step`). Over "model" (model > 1, the
    dense GQA families: `check_model_axis`) the shard's weights are split
    over its model devices (`dist.sharding.split_serve_params`): each split
    linear runs each part on its device and concatenates the outputs in
    model order, so the shard computes the unsharded step over its rows.

    Each shard's forward runs on its LOCAL batch, as the reference's
    `shard_map` body does: under bf16 the decode forward is row-local, so
    a row's arithmetic is the unsharded step's (on the card its GEMMs sum in
    an order fixed by K alone, not by the row count); under quartet2 the
    activation absmax spans a shard's slots alone, so the streams are
    deterministic but not bit-comparable to the unsharded batch. A model
    split changes no bit: each part quantizes the whole activation."""
    check_model_axis(cfg, mesh)
    return shard_serve_step(make_paged_serve_step(cfg, scheme), mesh,
                            out_device=out_device)


def data_shards(mesh) -> int:
    """The "data" size of a serving mesh."""
    return mesh_sizes(mesh)[1]


MODEL_AXIS_ITEM = "ROADMAP.md's Queue 1 item 4.6"


def check_model_axis(cfg, mesh) -> None:
    """Raise for what serving over a "model" axis > 1 does not cover: MLA,
    MoE (whose experts `param_spec` puts on "model": expert parallelism)
    and the recurrent families, each named with the ROADMAP item that will
    port it. The dense GQA families (dense, vlm) pass."""
    model, _ = mesh_sizes(mesh)
    if model <= 1:
        return
    what = ("MLA" if cfg.attn == "mla" else
            "MoE (experts on 'model': expert parallelism)" if cfg.moe else
            f"the recurrent family '{cfg.family}'"
            if cfg.family in ("ssm", "hybrid") else None)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: serving {what} over a 'model' axis of {model} comes "
            f"with {MODEL_AXIS_ITEM}; the dense GQA families serve over "
            "'model' now")


def _on(device: torch.device):
    """Make `device` current while a shard's step launches its kernels
    (they launch on the current card's stream); a no-op on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else \
        contextlib.nullcontext()


def shard_serve_step(step, mesh, *, out_batch_axis: int = 0, out_device=None):
    """Run a function of the engine step's signature `(params, cache,
    table, tokens, pos, active) -> (out, cache)` once a data shard.

    The wrapped function takes `params`, `caches` and `tables` as one entry
    a shard (the shard's parameters and cache tree on its device, its
    (slots_per_shard, 2, max_blocks) shard-local tables or None for dense
    caches) and the per-slot `tokens`, `pos`, `active` whole: shard s gets
    rows [s*B/data, (s+1)*B/data) of each, moved to its device. Each
    shard's `out` is moved to `out_device` (default: the mesh's first
    device) and the shards' outputs are concatenated on `out_batch_axis`
    (0 for (B, S, V) logits, 1 for the draft's (K, B) proposals). Caches
    update in place; the list of shard trees is returned as the cache.
    Over "model" `params[s]` holds shard s's split weights
    (`split_serve_params`), whose linears launch on the shard's model
    devices."""
    devices = mesh.devices
    dst = torch.device(out_device) if out_device is not None else devices[0]

    def sharded(params, caches, tables, tokens, pos, active):
        if isinstance(tables, torch.Tensor):  # one data shard's pool
            tables = (tables,)
        n = tokens.shape[0] // len(devices)
        outs = []
        for s, dev in enumerate(devices):
            rows = slice(s * n, (s + 1) * n)
            with _on(dev):
                out, _ = step(params[s], caches[s],
                              None if tables is None else tables[s],
                              tokens[rows].to(dev), pos[rows].to(dev),
                              active[rows].to(dev))
            outs.append(out.to(dst))
        return torch.cat(outs, dim=out_batch_axis), caches
    return sharded


def greedy_generate(params, cfg, scheme, prompt_tokens, max_new: int,
                    max_len: int | None = None, prompt_lens=None, *,
                    device="cuda") -> torch.Tensor:
    """The fixed-batch greedy loop: one prefill over the whole batch, then
    `max_new - 1` single-token decode steps over dense caches.

    `prompt_tokens` (B, S) is right-padded; `prompt_lens` (B,) gives each
    row's true prompt length (default: all S). Each row's first token comes
    from the logits of its last real position, and decode runs with a
    per-row position vector, so ragged rows attend only their own keys (pad
    keys written at positions >= a row's length are overwritten before any
    query reaches them). `params` live on `device` (raw weights are
    re-quantized at every step, as the reference does; a packed tree from
    `serve.prequant` is taken too). Tokens stay on the device between steps.
    Returns the generated tokens (B, max_new) int64 on `device`.

    Sliding-window layers decode over ring caches of `window` positions
    when all prompts share one length (`lm.init_cache(lattn_ring=True)`),
    over full-capacity caches for ragged prompts. Refused, as in the
    reference: enc-dec models, and ragged prompts on recurrent-state
    families (the full-width prefill would feed pad tokens into their
    state)."""
    device = torch.device(device)
    tokens = torch.as_tensor(prompt_tokens, device=device)
    b, s = tokens.shape
    max_len = max_len or (s + max_new + 8)
    if cfg.enc_dec:
        raise NotImplementedError("use explicit enc-dec path in examples")
    has_recurrent_state = cfg.family == "ssm" or (
        cfg.family == "hybrid" and any(t == "rec" for t in cfg.griffin.pattern))
    if prompt_lens is not None and has_recurrent_state:
        raise NotImplementedError(
            "ragged prompts on recurrent-state archs: the full-width prefill "
            "would feed pad tokens into their state; use serve.engine."
            "ServeEngine, which prefills each sequence at its true length")
    lens = (torch.full((b,), s, dtype=torch.int32, device=device)
            if prompt_lens is None else
            torch.as_tensor(prompt_lens, dtype=torch.int32, device=device))
    # ragged batches need full-capacity sliding-window caches: the ring
    # prefill roll keeps the last `window` positions of the SHARED padded
    # width, which for a short row would evict real keys for pads
    cache = lm.init_cache(cfg, b, max_len, device=device,
                          lattn_ring=prompt_lens is None)
    prefill = make_prefill_step(cfg, scheme)
    step = make_serve_step(cfg, scheme)
    with torch.no_grad():
        logits, cache = prefill(params, cache, {"tokens": tokens})
        last = logits[torch.arange(b, device=device), lens.long() - 1]
        tok = last.argmax(dim=-1)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = step(params, cache, tok, lens + i)
            tok = logits[:, -1:].argmax(dim=-1)
            out.append(tok)
    return torch.cat(out, dim=1)
