"""Data-parallel Quartet II training in the port, on the CPU: the sharded
corpus, the train step's `grad_transform` hook, `group` and `compress`, the trainer's
ranks and `launch.train --dp`. Ranks are gloo processes spawned by
`repro_torch.dist.spawn`; their bodies live in tests/_torch_dist_workers.py
(jax-free).

Tolerances: none. `batch_at(step)` is BITWISE the unsharded stream of
before; two ranks of one microbatch each are BITWISE one process with two
microbatches over the two shards laid end to end (losses, grad norms, every
param after every step), under quartet2 and bf16: a sum of two f32 values
does not depend on its order, and rank r seeds its microbatch as the one
process seeds microbatch r. Ranks hold bitwise equal params after every
step (a 64-bit checksum of every bit, `dist.checksum`), compressed or not.
The hook gets the reference's seed, `step_seed(base ^ 0x5555, step)`,
equal to the reference's value.

Each test has a 60 s SIGALRM guard of this file's own; the spawned groups
meet at a file store under the test's tmp_path (`launch.train --dp`'s at
one of its own), have a collective timeout under 60 s, and `spawn` joins
or kills every rank it started.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import byte_corpus_from_text as jbyte_corpus
from repro.train import train_step as jts
from repro_torch import dist as D
from repro_torch.data import pipeline as P
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

import _torch_dist_workers as W

TEST_TIMEOUT_S = 60
STEPS = 2


@pytest.fixture(autouse=True)
def _guard():
    torch.set_num_threads(1)

    def fail(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT_S} s (a hung "
                           "collective?)")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# --------------------------------------------------------------------------
# the sharded corpus
# --------------------------------------------------------------------------

def _seed_stream_batch(corpus: SyntheticCorpus, step: int) -> dict:
    """`SyntheticCorpus.batch_at(step)` as it was before shards existed."""
    cfg = corpus.cfg
    b = cfg.global_batch
    g = P._generator(cfg.seed, 0, step)
    n = cfg.seq_len + 1
    uni = torch.multinomial(corpus._probs, b * n, replacement=True,
                            generator=g).reshape(b, n)
    use_bigram = torch.rand((b, n), generator=g) < 0.5
    toks = uni.clone()
    for t in range(1, n):
        toks[:, t] = torch.where(use_bigram[:, t], corpus._perm[toks[:, t - 1]],
                                 uni[:, t])
    batch = {"tokens": toks[:, :-1].to(torch.int32),
             "labels": toks[:, 1:].to(torch.int32)}
    if cfg.emit_embeds:
        batch["embeds"] = torch.randn((b, cfg.seq_len, cfg.d_model),
                                      generator=g).to(torch.bfloat16) * 0.3
    return batch


@pytest.mark.parametrize("embeds", [False, True])
def test_unsharded_batch_is_bitwise_the_old_stream(embeds):
    c = SyntheticCorpus(DataConfig(vocab=300, seq_len=12, global_batch=6,
                                   seed=4, d_model=16, emit_embeds=embeds))
    for step in range(3):
        want = _seed_stream_batch(c, step)
        for got in (c.batch_at(step), c.batch_at(step, 0, 1)):
            assert set(got) == set(want)
            assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_shards_deterministic_distinct_and_sized(num_shards):
    c = SyntheticCorpus(DataConfig(vocab=300, seq_len=12, global_batch=8))
    shards = [c.batch_at(5, i, num_shards) for i in range(num_shards)]
    for i, s in enumerate(shards):
        assert s["tokens"].shape == (8 // num_shards, 12)
        assert torch.equal(s["tokens"], c.batch_at(5, i, num_shards)["tokens"])
        assert torch.equal(s["tokens"][:, 1:], s["labels"][:, :-1])
    rows = {r.numpy().tobytes() for s in shards for r in s["tokens"]}
    rows |= {r.numpy().tobytes() for r in c.batch_at(5)["tokens"]}
    assert len(rows) == 8 + 8  # no shard repeats another's rows or the stream's
    assert not torch.equal(shards[0]["tokens"],
                           c.batch_at(6, 0, num_shards)["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        c.batch_at(0, 0, 3)
    with pytest.raises(ValueError, match="does not exist"):
        c.batch_at(0, num_shards, num_shards)


def test_byte_corpus_shards_bitwise_the_reference():
    text = "Quartet II: NVFP4 training with unbiased gradients. " * 20
    cfg = dict(vocab=256, seq_len=16, global_batch=4, seed=3)
    jc = jbyte_corpus(text, JDataConfig(**cfg))
    tc = P.byte_corpus_from_text(text, DataConfig(**cfg))
    for shard in range(2):
        want = jax.tree.map(np.asarray, jc.batch_at(1, shard, 2))
        got = tc.batch_at(1, shard, 2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert torch.equal(tc.batch_at(1)["tokens"], tc.batch_at(1, 0, 1)["tokens"])


# --------------------------------------------------------------------------
# the hook and the ranks
# --------------------------------------------------------------------------

def test_grad_transform_after_accumulation_before_clipping():
    """Called once a step with the params-shaped tree of the accumulated
    grads and the reference's seed; what it returns is clipped."""
    calls = []

    def record(grads, seed):
        calls.append((grads, np.asarray(seed)))
        return grads

    kw = dict(base_lr=2e-3, total_steps=STEPS, base_seed=7, microbatches=2,
              grad_clip=1e-3)
    init, step = ts.make_train_step(W.CFG, "quartet2", grad_transform=record,
                                    **kw)
    init0, step0 = ts.make_train_step(W.CFG, "quartet2", **kw)
    state, state0 = W.fresh_state(init), W.fresh_state(init0)
    data = W.corpus()
    for i in range(STEPS):
        state, m = step(state, data.batch_at(i))
        state0, m0 = step0(state0, data.batch_at(i))
        assert len(calls) == i + 1
        grads, seed = calls[-1]
        np.testing.assert_array_equal(seed, np.asarray(jts.step_seed(
            7 ^ 0x5555, i)))
        np.testing.assert_array_equal(seed, ts.step_seed(7 ^ 0x5555, i))
        leaves = adamw.leaves(grads)
        assert list(grads) == list(state.params)
        # the hook saw the unclipped mean: its norm is the step's grad_norm
        assert float(adamw.global_norm(leaves)) == float(m["grad_norm"]) > 1e-3
        assert float(m["loss"]) == float(m0["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        adamw.leaves(state.params), adamw.leaves(state0.params)))


def _one_process(scheme: str, hook=None):
    """STEPS steps of one process with 2 microbatches over the 2 ranks'
    shards laid end to end (`hook`: the step's grad_transform)."""
    init, step = ts.make_train_step(W.CFG, scheme, base_lr=2e-3,
                                    total_steps=STEPS, microbatches=2,
                                    grad_transform=hook)
    state = W.fresh_state(init)
    data = W.corpus()
    out = {"loss": [], "grad_norm": [], "checksums": []}
    for i in range(STEPS):
        shards = [data.batch_at(i, r, 2) for r in range(2)]
        batch = {k: torch.cat([s[k] for s in shards]) for k in shards[0]}
        state, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["checksums"].append(D.checksum(adamw.leaves(state.params)))
    out["params"] = adamw.leaves(state.params)
    return out


@pytest.mark.parametrize("scheme", ["quartet2", "bf16"])
def test_two_ranks_bitwise_one_process_with_two_microbatches(scheme,
                                                            tmp_path):
    ranks = D.spawn(W.dp_body, 2, (scheme, STEPS, False), backend="gloo",
                    timeout_s=55, pg_timeout_s=50,
                    init_method=f"file://{tmp_path}/store")
    want = _one_process(scheme)
    for r in ranks:
        assert r["loss"] == want["loss"]
        assert r["grad_norm"] == want["grad_norm"]
        assert r["checksums"] == want["checksums"]
        assert all(torch.equal(a, b) for a, b in zip(r["params"],
                                                     want["params"]))


def test_grad_transform_under_a_group_gets_the_mean(tmp_path):
    """The step owns the reduction: a hook that does not reduce (here it
    halves every grad) gets the mean over the ranks, so the ranks stay
    identical and bitwise one process running the same hook."""
    ranks = D.spawn(W.dp_body, 2, ("quartet2", STEPS, False, W.halve),
                    backend="gloo", timeout_s=55, pg_timeout_s=50,
                    init_method=f"file://{tmp_path}/store")
    want = _one_process("quartet2", W.halve)
    plain = _one_process("quartet2")
    for r in ranks:
        assert r["grad_norm"] == want["grad_norm"]
        assert r["checksums"] == want["checksums"]
    assert want["grad_norm"][0] == plain["grad_norm"][0] / 2


def test_compress_needs_a_group():
    with pytest.raises(ValueError, match="pass group"):
        ts.make_train_step(W.CFG, "quartet2", compress=True)


def test_compressed_ranks_stay_identical(tmp_path):
    ranks = D.spawn(W.dp_body, 2, ("quartet2", STEPS, True), backend="gloo",
                    timeout_s=55, pg_timeout_s=50,
                    init_method=f"file://{tmp_path}/store")
    exact = _one_process("quartet2")
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    assert all(np.isfinite(ranks[0]["loss"]))
    # the first loss precedes any update; the compressed update of the
    # last step (step 0's warmup lr is 0) moved the params elsewhere than
    # the exact mean did
    assert ranks[0]["loss"][0] == exact["loss"][0]
    assert ranks[0]["checksums"][-1] != exact["checksums"][-1]
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                                 ranks[1]["params"]))


# --------------------------------------------------------------------------
# the trainer's ranks and the launcher
# --------------------------------------------------------------------------

class _Corpus:
    def __init__(self):
        self.calls = []

    def batch_at(self, *args):
        self.calls.append(args)
        return {"tokens": torch.zeros(1, 2, dtype=torch.int32)}


def _fake_step(state, batch):
    return (ts.TrainState(state.params, state.opt, state.step + 1),
            {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.5)})


@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_zero_writes_and_logs(rank, tmp_path, capsys):
    corpus = _Corpus()
    params = {"w": torch.ones(3)}
    state = ts.TrainState(params, adamw.init(params), 0)
    tr = Trainer(TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path),
                               ckpt_every=1, log_every=1, async_ckpt=False),
                 _fake_step, corpus, device=torch.device("cpu"), rank=rank,
                 world=2)
    tr.run(state)
    assert corpus.calls == [(s, rank, 2) for s in range(3)]
    written = sorted(os.listdir(tmp_path))
    printed = capsys.readouterr().out
    if rank == 0:
        assert written and "[trainer] step 0" in printed
    else:
        assert written == [] and printed == ""


def test_launch_train_dp_two_ranks(tmp_path, capfd):
    out = launch_train.main(["--device", "cpu", "--reduced", "--dp", "2",
                             "--backend", "gloo", "--steps", "2", "--seq",
                             "16", "--batch", "4", "--log-every", "1",
                             "--ckpt", str(tmp_path), "--ckpt-every", "1"])
    assert out["dp"] == 2 and out["rank"] == 0 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert len(set(out["ranks_checksums"])) == 1
    # the save after step index 1 holds 2 steps; the final one finds it
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002"]
    printed = capfd.readouterr().out
    assert printed.count("[trainer] step 0 ") == 1
    assert "2 ranks" in printed


def test_launch_train_backend_rules():
    assert launch_train.parse(["--dp", "2"]).backend == "nccl"
    assert launch_train.parse(["--device", "cpu", "--dp", "2"]).backend == "gloo"
    assert launch_train.parse([]).dp == 1
    for bad in (["--backend", "gloo"], ["--compress"],
                ["--dp", "3", "--batch", "8"], ["--dp", "0"]):
        with pytest.raises(SystemExit):
            launch_train.parse(bad)
    with pytest.raises(ValueError, match="nccl runs CUDA ranks only"):
        launch_train.main(["--device", "cpu", "--reduced", "--dp", "2",
                           "--backend", "nccl", "--steps", "1"])
