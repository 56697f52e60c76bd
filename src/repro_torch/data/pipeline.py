"""Deterministic, resumable synthetic corpus.

Counterpart of `repro/data/pipeline.py`, with the same generative process: a
Zipfian unigram draw mixed with a fixed random bigram permutation (with
p = 0.5, token t+1 = perm[token t]), which gives training curves with
meaningful structure. Randomness comes from explicit `torch.Generator`s, so
the stream differs from the reference's threefry stream; tests that compare
the two packages feed both the reference corpus's batches.

`batch_at(step, shard_id, num_shards)` is a pure function of (seed, step,
shard): resuming at step k reproduces the exact stream with no iterator
state. A shard of `num_shards` holds global_batch / num_shards rows from
its own generator, keyed by (seed, step, shard, num_shards), so shards are
independent draws of the same process (held in law, as the whole corpus
is); `num_shards=1` is the unsharded stream, bitwise. Batches are made on
the CPU; the caller moves them to its device. With `emit_embeds` a batch also
carries stub "embeds" (the vision family's precomputed patch embeddings,
or whisper's frame embeddings for its encoder, whose decoder reads the
tokens): bf16 normals times 0.3, drawn from the step's generator after the
tokens.
`byte_corpus_from_text` is the reference's tiny real-data corpus and gives
its batches bitwise, shard for shard.
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
    d_model: int = 0         # > 0 with emit_embeds: stub "embeds" (vlm, audio)
    emit_embeds: bool = False


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return (p / p.sum()).astype(np.float32)


def _shard_rows(global_batch: int, shard_id: int, num_shards: int) -> int:
    if num_shards < 1 or not 0 <= shard_id < num_shards:
        raise ValueError(f"shard {shard_id} of {num_shards} does not exist")
    if global_batch % num_shards:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split into {num_shards} shards")
    return global_batch // num_shards


def _generator(*key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


class SyntheticCorpus:
    """Stateless batch generator; all randomness derives from (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = torch.from_numpy(_zipf_probs(cfg.vocab, cfg.zipf_a))
        self._perm = torch.randperm(cfg.vocab, generator=_generator(cfg.seed, 1))

    def batch_at(self, step: int, shard_id: int = 0,
                 num_shards: int = 1) -> dict:
        cfg = self.cfg
        b = _shard_rows(cfg.global_batch, shard_id, num_shards)
        g = (_generator(cfg.seed, 0, step) if num_shards == 1 else
             _generator(cfg.seed, 0, step, shard_id, num_shards))
        n = cfg.seq_len + 1
        uni = torch.multinomial(self._probs, b * n, replacement=True,
                                generator=g).reshape(b, n)
        use_bigram = torch.rand((b, n), generator=g) < 0.5
        toks = uni.clone()
        for t in range(1, n):
            toks[:, t] = torch.where(use_bigram[:, t], self._perm[toks[:, t - 1]],
                                     uni[:, t])
        batch = {"tokens": toks[:, :-1].to(torch.int32),
                 "labels": toks[:, 1:].to(torch.int32)}
        if cfg.emit_embeds:
            batch["embeds"] = torch.randn(
                (b, cfg.seq_len, cfg.d_model), generator=g).to(
                    torch.bfloat16) * 0.3
        return batch


def byte_corpus_from_text(text: str, cfg: DataConfig):
    """Tiny real-data corpus: the UTF-8 bytes of `text`, global_batch /
    num_shards windows of seq_len + 1 bytes at offsets from a numpy
    RandomState seeded by hash((seed, step, shard_id)) % 2**31, as the
    reference's (a tuple of ints hashes the same in every Python process).
    int32 tensors on the CPU."""
    raw = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)

    class _ByteCorpus:
        def batch_at(self, step: int, shard_id: int = 0,
                     num_shards: int = 1) -> dict:
            b = _shard_rows(cfg.global_batch, shard_id, num_shards)
            rng = np.random.RandomState(hash((cfg.seed, step, shard_id)) % 2**31)
            idx = rng.randint(0, len(raw) - cfg.seq_len - 1, size=b)
            toks = np.stack([raw[i: i + cfg.seq_len + 1] for i in idx])
            return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                    "labels": torch.from_numpy(toks[:, 1:].copy())}

    return _ByteCorpus()
