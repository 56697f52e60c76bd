"""Serving step builders: the engine's step (paged pool or dense caches),
and the fixed-batch seed loop over dense caches.

Counterpart of `repro/serve/decode.py`. `make_paged_serve_step` is THE
engine step (serve/engine.py): with a block table it runs on the paged pool,
with `table=None` on dense per-slot caches. `make_prefill_step`,
`make_serve_step` and `greedy_generate` are the legacy fixed-batch path over
dense caches (`lm.init_cache`): the seed baseline of the reference's
benchmarks and its simple examples. Forward quantization (RTN + 4/6) is
deterministic, so serving needs no per-step randomness: the seed below is a
fixed constant (it feeds only the backward of the training slice).
"""

from __future__ import annotations

import numpy as np
import torch

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
    caches)."""
    def paged_serve_step(params, cache, table, tokens, pos, active):
        return lm.forward(params, cfg, {"tokens": tokens}, scheme, SEED,
                          caches=cache, mode="decode", pos=pos,
                          active=active, block_table=table)
    return paged_serve_step


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
