"""The port's plain paged GQA decode against the reference kernel, and the
pool primitives it reads through.

`ops.paged_gqa` on CPU tensors is the plain version (gather_view +
decode_sdpa); it is held against `repro.kernels.ops.paged_attention` (the
Pallas kernel in interpret mode) at ATOL, RTOL = 5e-6, 1e-5, the bar of
tests/test_paged_attention.py. Cases: ragged rows, trailing sentinel entries,
a fully unallocated row (exact zeros), a sliding window, Sq in {1, 4}, and
grouped heads rep in {1, 2}. Pools hold garbage outside the written
positions, so a masked lane that leaked would show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serve import kv_pool as jkv
from repro_torch.kernels import ops
from repro_torch.serve import kv_pool as kv

ATOL, RTOL = 5e-6, 1e-5
BS, MAXB, N_BLOCKS = 4, 4, 10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(rng, lens, h, kvh, hd, sq, dead=()):
    table = np.full((len(lens), MAXB), N_BLOCKS, np.int32)
    free = list(rng.permutation(N_BLOCKS))
    for i, n in enumerate(lens):
        if i not in dead:
            for j in range(-(-n // BS)):
                table[i, j] = free.pop()
    pool_k = (rng.randn(N_BLOCKS, BS, kvh, hd) * 7).astype(np.float32)
    pool_v = (rng.randn(N_BLOCKS, BS, kvh, hd) * 7).astype(np.float32)
    q = rng.randn(len(lens), sq, h, hd).astype(np.float32)
    pos = np.asarray([max(n - sq, 0) for n in lens], np.int32)
    return q, pool_k, pool_v, table, pos


@pytest.mark.parametrize("sq,window", [(1, None), (1, 6), (4, None), (4, 5)])
@pytest.mark.parametrize("rep", [1, 2])
def test_plain_paged_gqa_matches_jax_kernel(sq, window, rep):
    rng = np.random.RandomState(10 * sq + rep)
    q, pk, pv, table, pos = _case(rng, [13, 5, 12, 7], 2 * rep, 2, 16, sq,
                                  dead=(1,))
    jpk, jpv = (jnp.asarray(p).astype(jnp.bfloat16) for p in (pk, pv))
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jpk, jpv, jnp.asarray(table), jnp.asarray(pos),
        window=window, interpret=True))
    got = ops.paged_gqa(torch.from_numpy(q),
                        torch.from_numpy(pk).bfloat16(),
                        torch.from_numpy(pv).bfloat16(),
                        torch.from_numpy(table), torch.from_numpy(pos),
                        window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert not got[1].any()  # fully unallocated row: exact zeros
    assert ops.LAUNCHES["paged_gqa"] == 0  # CPU: the plain version


def test_scatter_and_gather_match_jax():
    """scatter_tokens drops what the reference drops (inactive rows, negative
    positions, positions past the table, sentinel entries) into the scratch
    block, and gather_view fills sentinel entries with zeros."""
    rng = np.random.RandomState(0)
    table = np.array([[3, 1, N_BLOCKS, N_BLOCKS], [0, 2, 4, 5],
                      [N_BLOCKS] * 4], np.int32)
    pool = (rng.randn(N_BLOCKS, BS, 2, 8)).astype(np.float32)
    positions = np.array([[6, 7, 8, 9], [-1, 0, 15, 16], [0, 1, 2, 3]], np.int32)
    vals = rng.randn(3, 4, 2, 8).astype(np.float32)
    valid = np.array([[True] * 4, [True] * 4, [False] * 4])
    want = np.asarray(jkv.scatter_tokens(
        jnp.asarray(pool).astype(jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(vals), jnp.asarray(valid)
    ).astype(jnp.float32))
    full = torch.cat([torch.from_numpy(pool), torch.zeros(1, BS, 2, 8)]).bfloat16()
    kv.scatter_tokens(full, torch.from_numpy(table), torch.from_numpy(positions),
                      torch.from_numpy(vals), torch.from_numpy(valid))
    assert np.array_equal(full[:N_BLOCKS].float().numpy(), want)
    view = kv.gather_view(full[:N_BLOCKS], torch.from_numpy(table))
    jview = jkv.gather_view(jnp.asarray(want).astype(jnp.bfloat16),
                            jnp.asarray(table))
    assert np.array_equal(view.float().numpy(),
                          np.asarray(jview.astype(jnp.float32)))
