"""Token sampling for the serving engine: greedy / temperature / top-k.

Counterpart of `repro/serve/sampling.py`. One batched call handles the whole
slot batch with PER-SLOT parameters: temperature == 0 selects greedy argmax
for that row; top_k == 0 disables the top-k filter. Stochastic rows use the
Gumbel-max trick with noise drawn from an explicit `torch.Generator` (the
reference draws from a threefry key, so the two agree in law, not in bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (greedy by default)."""
    temperature: float = 0.0
    top_k: int = 0


def _topk_mask(lf: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k logit filter: entries below the k-th highest logit go to
    -inf; k == 0 keeps everything. lf (B, V) f32, top_k (B,) int."""
    v = lf.shape[1]
    srt = torch.sort(lf, dim=-1, descending=True).values
    kidx = (torch.where(top_k > 0, top_k, v) - 1).clamp(0, v - 1).long()
    thresh = srt.gather(1, kidx[:, None])
    return torch.where(lf >= thresh, lf, float("-inf"))


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64 under per-row sampling params.

    temperature (B,) f32: 0 => greedy argmax for that row; top_k (B,) int:
    0 => no filter. Noise comes from `gen` (on the logits' device)."""
    lf = logits.float()
    masked = _topk_mask(lf, top_k)
    u = torch.rand(lf.shape, generator=gen, device=lf.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    t = temperature.clamp_min(1e-6)[:, None]
    stoch = masked / t + g
    z = torch.where(temperature[:, None] > 0, stoch, lf)  # greedy rows
    return z.argmax(dim=-1)
