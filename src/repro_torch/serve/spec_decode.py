"""Self-speculative decoding with exact verification.

Counterpart of `repro/serve/spec_decode.py`. The Quartet II NVFP4 forward is
deterministic (quantize-once packed weights, RTN and 4/6 activation
quantizers, a fixed seed), so a truncated stack of the SAME model can draft
and the full model can verify exactly: the draft is the first
`draft_layers` layers plus the shared final norm and head, reusing the
engine's parameters (no second model), and one (n_slots, spec_k + 1) chunk
through the engine's decode step verifies every drafted position.

A round over the slots in DECODE state (`spec_round`):

  1. CATCH-UP — the draft consumes committed tokens it has not seen (after a
                fully accepted round it trails the model by one token).
  2. PROPOSE  — K single-token draft steps; each argmax stays on the device
                and feeds the next step, and the (K, n_slots) proposals
                reach the host once per round.
  3. VERIFY   — one full-model chunk over [last_tok, d_1 .. d_K]: chunk
                index j predicts position pos + j + 1, so target t_{j+1} =
                argmax(logits[:, j]).
  4. ACCEPT   — greedy requests keep the longest prefix with d_j == t_j and
                emit one more model token (the correction or bonus);
                stochastic requests rejection-sample each draft against the
                verify chunk's target distribution
                (`sampling.speculative_resample`), which keeps the engine's
                sampling law exactly.
  5. ROLLBACK — rejected positions are truncated logically
                (`KVPool.truncate`): stale K/V sits behind the position
                mask until overwritten. Every ported family holds token
                caches only; recurrent state, which would need a snapshot
                and a replay, comes with the rwkv and griffin families.

Inactive rows carry token 0 at position 0 (their proposals feed back as
for active rows), as in the reference: under quartet2 their rows enter the
per-tensor activation absmax, and CPU parity with the reference depends on
it.

Numerics: a spec stream equals the non-speculative one bit for bit only
where the per-row forward does not depend on the step shape. Under bf16 on
the CPU rows are independent; on the card cuBLAS may pick another
algorithm for the verify chunk's n_slots * (K + 1) rows, so streams agree up
to near-ties. Quartet2 shares one activation absmax across the chunk's
rows, so its spec streams are deterministic run to run but may differ from
the S = 1 engine at near-tie argmaxes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve.decode import SEED
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.sampling import (accept_greedy, greedy_targets,
                                        speculative_resample)


def _blank(n_slots: int, size: int = 1):
    return (np.zeros((n_slots, size), np.int32),
            np.zeros((n_slots,), np.int32),
            np.zeros((n_slots,), bool))


class DraftStack:
    """The truncated-stack draft: `lm.forward_prefix` over the engine's own
    parameters (views of its stacked, possibly packed, leaves) and a KV pool
    of its own over `lm.prefix_specs`, with the main pool's slot count and
    block geometry so slot indices line up. The draft pool never aliases
    the prefix cache."""

    def __init__(self, cfg, params, econf, device: torch.device):
        self.cfg = cfg
        self.scheme = econf.scheme
        self.n_prefix = econf.draft_layers
        self.specs = lm.prefix_specs(cfg, econf.draft_layers)  # validates
        self.params = params
        self.device = device
        self.pool = KVPool(cfg, econf.n_slots, econf.max_len,
                           block_size=econf.block_size,
                           n_blocks=econf.n_blocks, device=device,
                           specs=self.specs)

    def _step(self, tokens: torch.Tensor, pos: torch.Tensor,
              active: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        logits, _ = lm.forward_prefix(
            self.params, self.cfg, {"tokens": tokens}, self.scheme, SEED,
            n_prefix=self.n_prefix, caches=self.pool.caches, mode="decode",
            pos=pos, active=active, block_table=table)
        return logits

    def forward(self, tokens, pos, active) -> torch.Tensor:
        """One (n_slots, S) draft step from host arrays; the draft pool
        updates in place. Returns the logits (n_slots, S, V)."""
        dev = self.device
        return self._step(torch.from_numpy(tokens).to(dev),
                          torch.from_numpy(pos).to(dev),
                          torch.from_numpy(active).to(dev),
                          self.pool.tables_device())

    def propose(self, k: int, tok0, pos, active) -> np.ndarray:
        """K greedy proposals: K (n_slots, 1) draft steps, each argmax fed
        to the next on the device. tok0, pos, active: (n_slots,) host
        arrays, each active row starting from its last emitted token at its
        own position. Returns the (k, n_slots) proposals, read on the host
        once; the draft pool advances k positions for active rows."""
        dev = self.device
        cur = torch.from_numpy(tok0).to(dev)[:, None]
        pos_t = torch.from_numpy(pos).to(dev)
        act = torch.from_numpy(active).to(dev)
        table = self.pool.tables_device()
        out = []
        for t in range(k):
            logits = self._step(cur, pos_t + t, act, table)
            cur = logits[:, -1].argmax(dim=-1)[:, None]
            out.append(cur[:, 0])
        return torch.stack(out).cpu().numpy()


def spec_round(eng, dec: list[int]) -> int:
    """One speculative tick over the DECODE slots `dec`; returns the tokens
    emitted. Mutates the engine's slots, both pools and its stats. Step
    shapes are fixed per engine: the draft's (n_slots, 1) and the full
    model's (n_slots, spec_k + 1)."""
    e, k = eng.econf, eng.econf.spec_k
    slots, draft, pool = eng.slots, eng.draft, eng.pool

    # ---- 1. catch-up: feed the draft every committed token it has not seen
    while True:
        lag = [i for i in dec if slots[i].draft_len < slots[i].length]
        if not lag:
            break
        tokens, pos, active = _blank(e.n_slots)
        for i in lag:
            s = slots[i]
            tokens[i, 0] = (s.req.prompt + s.generated)[s.draft_len]
            pos[i] = s.draft_len
            active[i] = True
            draft.pool.ensure(i, s.draft_len + 1)
        draft.forward(tokens, pos, active)
        for i in lag:
            slots[i].draft_len += 1

    # ---- 2. propose: K draft tokens, one host read ----------------------
    tok0 = np.zeros((e.n_slots,), np.int32)
    pos = np.zeros((e.n_slots,), np.int32)
    active = np.zeros((e.n_slots,), bool)
    for i in dec:
        tok0[i] = slots[i].last_tok
        pos[i] = slots[i].length
        active[i] = True
        draft.pool.ensure(i, slots[i].length + k)
    toks = draft.propose(k, tok0, pos, active)               # (K, n_slots)
    proposals = {i: [int(toks[t, i]) for t in range(k)] for i in dec}

    # ---- 3. verify: one (n_slots, K + 1) full-model chunk ---------------
    tokens, pos, active = _blank(e.n_slots, k + 1)
    for i in dec:
        s = slots[i]
        tokens[i] = [s.last_tok] + proposals[i]
        pos[i] = s.length
        active[i] = True
        pool.ensure(i, s.length + k + 1)
    logits = eng._forward(tokens, pos, active)
    targets = greedy_targets(logits).cpu().numpy()

    # ---- 4. accept (greedy or rejection-sampled), commit, roll back -----
    emitted = 0
    for i in dec:
        s = slots[i]
        length0 = s.length
        sp = s.req.sampling
        if sp.temperature == 0.0:
            a = accept_greedy(proposals[i], targets[i])
            emit = [int(t) for t in targets[i, :a + 1]]
        else:
            # the emitted tokens follow the law the non-speculative sampler
            # draws from, though the realized stream differs (the generator
            # is consumed differently)
            out, cnt = speculative_resample(
                torch.tensor(proposals[i], device=logits.device), None,
                logits[i].float(), eng._gen, temperature=sp.temperature,
                top_k=sp.top_k)
            emit = out[:cnt].tolist()
            a = cnt - 1  # accepted drafts; the last emission is resampled
        remaining = s.req.max_new - len(s.generated)
        emit = emit[:remaining]
        nacc = len(emit)
        # only drafts the verifier could use count: a request's final round
        # caps them at remaining - 1
        eng.stats["draft_tokens"] += min(k, remaining - 1)
        eng.stats["accepted_tokens"] += nacc - 1
        emitted += nacc
        s.generated.extend(emit)
        s.length = length0 + nacc
        s.last_tok = emit[-1]
        pool.truncate(i, s.length)
        if len(s.generated) >= s.req.max_new:
            continue  # retires next tick, releasing its draft slot there
        if a >= k - 1:
            # every input the draft consumed (t0, d_1 .. d_{K-1}) committed
            s.draft_len = length0 + k
        else:
            # the draft keeps the committed prefix (inputs t0, d_1 .. d_a
            # are the emitted stream): next round needs no catch-up
            s.draft_len = length0 + a + 1
            draft.pool.truncate(i, s.draft_len)
    eng.stats["spec_rounds"] += 1
    return emitted
