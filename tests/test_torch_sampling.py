"""The port's batched sampler: per-row greedy / temperature / top-k.

Greedy rows equal the reference's greedy pick (argmax, first index on ties);
stochastic rows draw from an explicit torch.Generator, so the same seed gives
the same tokens, and a top-k row never leaves its k highest logits. (The
reference draws Gumbel noise from threefry, so stochastic rows agree with it
in law, not in bits.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as jsampling
from repro_torch.serve.sampling import sample_tokens


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _logits(b=6, v=64, seed=0):
    x = np.random.RandomState(seed).randn(b, v).astype(np.float32)
    x[0, 5] = x[0, 9] = x[0].max() + 1  # a tie: the first index wins
    return torch.from_numpy(x).bfloat16()


def test_greedy_rows_match_jax():
    lg = _logits()
    zeros = torch.zeros(6)
    got = sample_tokens(lg, zeros, torch.zeros(6, dtype=torch.int32),
                        torch.Generator().manual_seed(0))
    want = jsampling.sample_tokens(
        jnp.asarray(lg.float().numpy()).astype(jnp.bfloat16), jnp.zeros(6),
        jnp.zeros(6, jnp.int32), jax.random.PRNGKey(0))
    assert got.tolist() == np.asarray(want).tolist() and int(got[0]) == 5


def test_stochastic_rows_seeded_and_within_top_k():
    lg = _logits(b=4, v=64, seed=1)
    temp = torch.tensor([0.0, 1.0, 0.7, 2.0])
    topk = torch.tensor([0, 3, 0, 1], dtype=torch.int32)
    draws = [sample_tokens(lg, temp, topk, torch.Generator().manual_seed(s))
             for s in range(40)]
    again = sample_tokens(lg, temp, topk, torch.Generator().manual_seed(0))
    assert torch.equal(draws[0], again)
    top3 = set(torch.topk(lg[1].float(), 3).indices.tolist())
    assert {int(d[1]) for d in draws} <= top3
    assert len({int(d[2]) for d in draws}) > 1        # temperature: random
    assert {int(d[3]) for d in draws} == {int(lg[3].float().argmax())}  # top-1
    assert {int(d[0]) for d in draws} == {int(lg[0].float().argmax())}  # greedy
