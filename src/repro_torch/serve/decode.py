"""The engine's paged serving step.

Counterpart of `repro/serve/decode.py:make_paged_serve_step`. Forward
quantization (RTN + 4/6) is deterministic, so serving needs no per-step
randomness: the seed below is a fixed constant (it feeds only the backward
of the training slice).
"""

from __future__ import annotations

import numpy as np

from repro_torch.models import lm

SEED = np.array([7, 7], np.uint32)


def make_paged_serve_step(cfg, scheme: str):
    """The engine's step: per-slot position vector, active mask, block table
    and pool-shaped caches (updated in place). Returns (logits, caches)."""
    def paged_serve_step(params, cache, table, tokens, pos, active):
        logits, cache = lm.forward(params, cfg, {"tokens": tokens}, scheme,
                                      SEED, caches=cache, mode="decode",
                                      pos=pos, active=active,
                                      block_table=table)
        return logits, cache
    return paged_serve_step
