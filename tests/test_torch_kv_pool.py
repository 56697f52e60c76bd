"""The port's host-side block allocator (KVPool): admission accounting,
lazy allocation, release, misuse errors, and sliding-window reclamation.
Mirrors the allocator rules of repro/serve/kv_pool.py (single shard, no
prefix sharing)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.serve.kv_pool import KVPool, OutOfBlocks, SlotError

CFG = registry.get("llama_200m").reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pool(**kw):
    return KVPool(CFG, kw.pop("n_slots", 2), kw.pop("max_len", 32),
                  block_size=4, device="cpu", **kw)


def test_pool_leaves_carry_a_scratch_block():
    pool = _pool()
    k, v = pool.caches[0]["l0"]["kv"]
    assert k.shape == (CFG.n_layers, pool.n_blocks + 1, 4, CFG.n_kv_heads,
                       CFG.hd)
    assert k.dtype == torch.bfloat16 and k.data_ptr() != v.data_ptr()


def test_ensure_allocates_lowest_blocks_and_release_frees_all():
    pool = _pool()
    pool.commit(0, 10)
    pool.ensure(0, 5)
    assert list(pool.tables_device()[0, :2]) == [0, 1]
    assert pool.free_block_count == pool.n_blocks - 2
    pool.ensure(0, 10)
    assert pool.length(0) == 10 and pool.free_block_count == pool.n_blocks - 3
    t = pool.tables_device()
    assert t.dtype == torch.int32 and int(t[1].min()) == pool.sentinel
    pool.release(0)
    assert pool.free_block_count == pool.n_blocks
    assert (pool.tables_device() == pool.sentinel).all()


def test_admission_counts_outstanding_commitments():
    pool = _pool(n_blocks=6)
    assert pool.can_admit(16)               # 4 blocks of 6
    pool.commit(0, 16)                      # reserved, none allocated yet
    assert not pool.can_admit(12)           # 3 more would overcommit
    assert pool.can_admit(8)
    assert not pool.can_ever_admit(40)      # past max_len
    pool.release(0)
    assert pool.can_admit(12)


def test_misuse_raises():
    pool = _pool()
    with pytest.raises(SlotError):
        pool.ensure(0, 4)
    with pytest.raises(SlotError):
        pool.release(0)
    pool.commit(0, 8)
    with pytest.raises(SlotError):
        pool.commit(0, 8)
    with pytest.raises(OutOfBlocks):
        pool.ensure(0, 33)                  # past the 8-entry table


def test_window_reclaim_frees_blocks_behind_the_window():
    pool = _pool(max_len=32)
    pool.window = 6                         # as a pure sliding-window stack
    pool.commit(0, 32, max_growth=4)
    pool.ensure(0, 16)
    owned = list(pool.tables_device()[0, :4])
    pool.ensure(0, 20)                      # reclaims before growing
    t = pool.tables_device()[0]
    assert list(t[:2]) == [pool.sentinel] * 2   # keys 0..7 left the window
    assert list(t[2:4]) == owned[2:] and int(t[4]) != pool.sentinel
    assert pool.free_block_count == pool.n_blocks - 3
    pool.release(0)
    assert pool.free_block_count == pool.n_blocks
    assert np.all(pool.tables_device().numpy() == pool.sentinel)
