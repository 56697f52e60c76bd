"""Token sampling for the serving engine: greedy / temperature / top-k.

Counterpart of `repro/serve/sampling.py`. One batched call handles the whole
slot batch with PER-SLOT parameters: temperature == 0 selects greedy argmax
for that row; top_k == 0 disables the top-k filter. Stochastic rows use the
Gumbel-max trick with noise drawn from an explicit `torch.Generator` (the
reference draws from a threefry key, so the two agree in law, not in bits).
The speculative half (`greedy_targets`, `accept_greedy`,
`speculative_resample`) decides which drafted tokens a verify chunk keeps
(`serve/spec_decode.py`).
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


def sampling_probs(logits: torch.Tensor, temperature, top_k) -> torch.Tensor:
    """The engine's per-token sampling DISTRIBUTION q (B, V): softmax of the
    top-k-filtered logits at `temperature` (a float or a (B,) tensor; top_k
    likewise). It is the law `sample_tokens` draws from on stochastic rows,
    so speculation that preserves q token by token preserves the engine's
    sampling. Meaningful for temperature > 0 only."""
    lf = logits.float()
    b = lf.shape[0]
    tk = torch.as_tensor(top_k, dtype=torch.int64, device=lf.device).expand(b)
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=lf.device).expand(b).clamp_min(1e-6)
    return torch.softmax(_topk_mask(lf, tk) / t[:, None], dim=-1)


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


# --------------------------------------------------------------------------
# speculative acceptance (serve/spec_decode.py)
# --------------------------------------------------------------------------

def greedy_targets(logits: torch.Tensor) -> torch.Tensor:
    """Verify-chunk logits (B, S, V) -> greedy target ids (B, S). Chunk
    index j holds the model's prediction for position pos + j + 1; the cast
    to f32 that `sample_tokens` applies preserves order, so this is the
    token it would pick at temperature 0."""
    return logits.argmax(dim=-1)


def accept_greedy(drafts, targets) -> int:
    """Longest accepted prefix: the count of leading j with drafts[j] ==
    targets[j]. The round emits targets[:accepted + 1], the accepted drafts
    and the model's own correction or bonus token, so the stream is exactly
    the full model's greedy output."""
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(targets[a]):
        a += 1
    return a


def speculative_resample(draft_tokens: torch.Tensor, draft_logits,
                         target_logits: torch.Tensor, gen: torch.Generator, *,
                         temperature=1.0, top_k=0):
    """Stochastic speculative acceptance: rejection-sample the drafts so the
    emitted stream follows the target distribution EXACTLY (Leviathan et
    al.'s guarantee).

    draft_tokens (K,) int: the proposals. draft_logits (K, V): the draft's
    logits for them, or None for a deterministic draft (the engine's greedy
    truncated-stack proposals), a point mass, so position j accepts d_j
    with probability q_j(d_j) and else resamples from q_j without d_j.
    target_logits (K + 1, V): row j holds the full model's logits for the
    position draft j fills; row K the bonus position. q applies the same
    temperature and top-k as `sample_tokens`.

    Position j accepts d_j when u * p_j(d_j) < q_j(d_j) (u < min(1, q/p)
    without a division); the first rejection emits one token from the
    renormalized residual max(q_j - p_j, 0) and stops; K acceptances emit a
    bonus token from q_K. Uniforms and the final draw come from `gen`.
    Returns (tokens (K + 1,) int64, count): tokens[:count] are the round's
    emissions, count - 1 accepted drafts and the resampled or bonus token.
    """
    k = draft_tokens.shape[0]
    dev = target_logits.device
    q = sampling_probs(target_logits, temperature, top_k)          # (K+1, V)
    if draft_logits is None:
        p = torch.nn.functional.one_hot(draft_tokens.long(),
                                        q.shape[-1]).float()
    else:
        p = sampling_probs(draft_logits, temperature, top_k)
    idx = torch.arange(k, device=dev)
    d = draft_tokens.long()
    qd, pd = q[idx, d], p[idx, d]
    u = torch.rand((k,), generator=gen, device=dev)
    accept = u * pd < qd
    rejected = (~accept).nonzero()
    a = int(rejected[0]) if len(rejected) else k                    # host sync
    if a == k:
        final_p = q[k]
    else:
        # a rejection means q(d) < p(d) <= 1, so the residual has mass
        resid = (q[a] - p[a]).clamp_min(0.0)
        z = resid.sum()
        final_p = torch.where(z > 0, resid / z.clamp_min(1e-38), q[a])
    final = torch.multinomial(final_p, 1, generator=gen)
    toks = torch.cat([d, torch.zeros((1,), dtype=torch.int64, device=dev)])
    toks[a] = final[0]
    return toks, a + 1
