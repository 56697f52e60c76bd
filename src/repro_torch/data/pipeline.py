"""Deterministic, resumable synthetic corpus.

Counterpart of `repro/data/pipeline.py`, with the same generative process: a
Zipfian unigram draw mixed with a fixed random bigram permutation (with
p = 0.5, token t+1 = perm[token t]), which gives training curves with
meaningful structure. Randomness comes from explicit `torch.Generator`s, so
the stream differs from the reference's threefry stream; tests that compare
the two packages feed both the reference corpus's batches.

`batch_at(step)` is a pure function of (seed, step): resuming at step k
reproduces the exact stream with no iterator state. Batches are made on the
CPU; the caller moves them to its device. Left out until a slice needs them:
the reference's stub "embeds" (audio and vision families) and its
per-host sharding of the batch (`dist/`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return (p / p.sum()).astype(np.float32)


def _generator(*key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


class SyntheticCorpus:
    """Stateless batch generator; all randomness derives from (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = torch.from_numpy(_zipf_probs(cfg.vocab, cfg.zipf_a))
        self._perm = torch.randperm(cfg.vocab, generator=_generator(cfg.seed, 1))

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        b = cfg.global_batch
        g = _generator(cfg.seed, 0, step)
        n = cfg.seq_len + 1
        uni = torch.multinomial(self._probs, b * n, replacement=True,
                                generator=g).reshape(b, n)
        use_bigram = torch.rand((b, n), generator=g) < 0.5
        toks = uni.clone()
        for t in range(1, n):
            toks[:, t] = torch.where(use_bigram[:, t], self._perm[toks[:, t - 1]],
                                     uni[:, t])
        return {"tokens": toks[:, :-1].to(torch.int32),
                "labels": toks[:, 1:].to(torch.int32)}
