"""The port's host-side block allocator (KVPool): admission accounting,
lazy allocation, release, misuse errors, sliding-window reclamation, and
the prefix cache's refcounted sharing (adopt, COW, the write
table), block copies and host round trips. Held against the allocator of
repro/serve/kv_pool.py (one shard) by a seeded random walk that drives both
pools through the same operations."""

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
    assert list(pool.tables_device()[0, 0, :2]) == [0, 1]
    assert pool.free_block_count == pool.n_blocks - 2
    pool.ensure(0, 10)
    assert pool.length(0) == 10 and pool.free_block_count == pool.n_blocks - 3
    t = pool.tables_device()
    assert t.dtype == torch.int32 and t.shape == (2, 2, pool.max_blocks)
    assert torch.equal(t[:, 0], t[:, 1])   # nothing adopted: one view
    assert int(t[1].min()) == pool.sentinel
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
    owned = list(pool.tables_device()[0, 0, :4])
    pool.ensure(0, 20)                      # reclaims before growing
    t = pool.tables_device()[0, 0]
    assert list(t[:2]) == [pool.sentinel] * 2   # keys 0..7 left the window
    assert list(t[2:4]) == owned[2:] and int(t[4]) != pool.sentinel
    assert pool.free_block_count == pool.n_blocks - 3
    pool.release(0)
    assert pool.free_block_count == pool.n_blocks
    assert np.all(pool.tables_device().numpy() == pool.sentinel)


def test_truncate_moves_only_the_length_above_the_reclaim_floor():
    """A speculative rollback keeps every block and moves the length; it
    may not go below what reclaimed windows still need, nor past the
    length, nor touch an unbound slot."""
    pool = _pool(max_len=32)
    pool.commit(0, 32)
    pool.ensure(0, 13)
    table = pool.tables_device().clone()
    pool.truncate(0, 9)
    assert pool.length(0) == 9 and torch.equal(pool.tables_device(), table)
    assert pool.free_block_count == pool.n_blocks - 4
    for bad in (-1, 10):
        with pytest.raises(SlotError):
            pool.truncate(0, bad)
    with pytest.raises(SlotError):
        pool.truncate(1, 0)
    pool.release(0)
    win = _pool(max_len=32)
    win.window = 6                          # as a pure sliding-window stack
    win.commit(0, 32, max_growth=4)
    win.ensure(0, 16)
    win.ensure(0, 20)                       # frees blocks 0, 1 (keys 0..7)
    assert win._floor[0] == 2 * 4 + 6 - 1   # newest freed key + window
    win.truncate(0, 13)
    with pytest.raises(SlotError):
        win.truncate(0, 12)


# --------------------------------------------------------------------------
# refcounted sharing, against the reference allocator
# --------------------------------------------------------------------------

def _pair(**kw):
    """The reference's KVPool and the port's, same geometry (one shard)."""
    from repro.configs import registry as jregistry
    from repro.serve.kv_pool import KVPool as JPool
    n_slots, max_len = kw.pop("n_slots", 3), kw.pop("max_len", 32)
    ref = JPool(jregistry.get("llama_200m").reduced(), n_slots, max_len,
                block_size=4, **kw)
    return ref, _pool(n_slots=n_slots, max_len=max_len, **kw)


def _assert_same(ref, port, what):
    assert np.array_equal(ref._table, port._table), what
    assert np.array_equal(ref._ref, port._ref), what
    assert ref._free == port._free, what
    assert ref._owned == port._owned, what
    assert ref._lengths == port._lengths, what
    assert ref._shared_upto == port._shared_upto, what
    assert np.array_equal(np.asarray(ref.tables_device()),
                          port.tables_device().numpy()), what
    assert ref.effective_free_blocks(0) == (port.free_block_count
                                            - port._outstanding()), what
    for total in (4, 13, 32):
        for cached in (0, 2):
            assert (ref.can_admit(total, cached_blocks=cached),
                    ref.admission_shortfall(total, cached_blocks=cached)) == (
                port.can_admit(total, cached_blocks=cached),
                port.admission_shortfall(total, cached_blocks=cached)), what


def _both(ref, port, name, *args):
    """Apply one operation to both pools: the same result or the same
    exception type."""
    outs = []
    for pool in (ref, port):
        try:
            outs.append(getattr(pool, name)(*args))
        except RuntimeError as e:  # SlotError, OutOfBlocks of either package
            outs.append(type(e).__name__)
    assert outs[0] == outs[1], (name, args, outs)
    return outs[1]


def _walk(ref, port, n_slots, steps, check, seed=0, alloc=0):
    """A seeded walk of commit, grow, adopt, COW, a cache insert + release,
    release, a cache eviction, a truncate (one past the length too) and,
    with `alloc` > 0, a cache-owned allocation on a shard, applied to both
    pools; `check(step, op)` after every operation. On a sharded pool most
    adopt and COW sources come from the slot's own shard (the rest must be
    refused alike). Returns the count of each operation done."""
    rng = np.random.RandomState(seed)
    cached: list[int] = []          # blocks the walk holds as "the cache"
    weights = {"commit": 3, "grow": 2, "adopt": 4, "cow": 2,
               "insert_release": 3, "release": 1, "evict": 1, "truncate": 1,
               "alloc": alloc}
    kinds = [k for k, w in weights.items() if w]
    p = np.array([weights[k] for k in kinds], float)
    p /= p.sum()
    counts = dict.fromkeys(kinds, 0)

    def sources(s):
        own = [b for b in cached
               if port.shard_of_block(b) == port.shard_of_slot(s)]
        return own if own and rng.rand() < 0.8 else cached

    for step in range(steps):
        op = kinds[rng.choice(len(kinds), p=p)]
        s = int(rng.randint(n_slots))
        bound = port._bound[s]
        if op == "commit" and not bound:
            _both(ref, port, "commit", s, int(rng.randint(1, 33)))
        elif op == "grow" and bound:
            _both(ref, port, "ensure", s,
                  min(32, port.length(s) + int(rng.randint(1, 9))))
        elif op == "adopt" and bound and not port._owned[s] and cached:
            src = sources(s)
            k = int(rng.randint(1, min(len(src), 4) + 1))
            blocks = [src[int(i)] for i in rng.choice(len(src), k,
                                                      replace=False)]
            _both(ref, port, "adopt_prefix", s, blocks,
                  int(rng.randint(1, 4 * k + 1)))
        elif op == "cow" and bound and cached:
            src = sources(s)
            _both(ref, port, "cow_block", s, src[rng.randint(len(src))])
        elif op == "alloc":
            blk = _both(ref, port, "alloc_cache_block",
                        int(rng.randint(port.n_shards)))
            if isinstance(blk, int):
                cached.append(blk)
        elif op == "insert_release" and bound:
            for b in port._owned[s][:int(rng.randint(0, 4))]:
                if b not in cached:
                    _both(ref, port, "incref", b)
                    cached.append(b)
            _both(ref, port, "release", s)
        elif op == "release" and bound:
            _both(ref, port, "release", s)
        elif op == "evict" and cached:
            _both(ref, port, "_decref", cached.pop(rng.randint(len(cached))))
        elif op == "truncate" and bound:
            _both(ref, port, "truncate", s,
                  int(rng.randint(0, port.length(s) + 2)))
        else:
            continue
        counts[op] += 1
        check(step, op)
    return counts


def test_pool_random_walk_matches_reference():
    """One seeded sequence of commit, grow, adopt, COW, a cache
    insert + release, release, a cache eviction and a truncate (one past
    the length too) drives the reference
    pool and the port's; tables (read and write views), refcounts, free
    lists, owners and lengths agree after every operation."""
    ref, port = _pair(n_slots=3, max_len=32, n_blocks=14)
    counts = _walk(ref, port, 3, 1000,
                   lambda step, op: _assert_same(ref, port, (step, op)))
    assert all(n >= 10 for n in counts.values()), counts


def _assert_same_sharded(ref, port, what):
    """The two-shard pools agree: host table, refcounts, owners, lengths,
    each shard's free list, free and effective free blocks, per-slot
    admission and shortfall, the shard-local tables (host, the
    reference's stacked device tables against the port's per-shard ones),
    and slot affinity."""
    assert np.array_equal(ref._table, port._table), what
    assert np.array_equal(ref._ref, port._ref), what
    assert ref._frees == port._frees and ref._free == port._free, what
    assert ref._owned == port._owned, what
    assert ref._lengths == port._lengths, what
    assert ref._shared_upto == port._shared_upto, what
    for sh in range(2):
        assert (ref.free_blocks_in_shard(sh), ref.effective_free_blocks(sh)) \
            == (port.free_blocks_in_shard(sh),
                port.effective_free_blocks(sh)), what
    assert np.array_equal(ref._local_table_np(), port._local_table_np()), what
    assert np.array_equal(np.asarray(ref.table_device()),
                          port._local_table_np()), what
    assert np.array_equal(np.asarray(ref.tables_device()), np.concatenate(
        [t.numpy() for t in port.tables_device()])), what
    assert all(t.device == d for t, d in zip(port.tables_device(),
                                             port.devices)), what
    for total in (4, 13, 24):
        for cached in (0, 2):
            for slot in range(port.n_slots):
                assert (ref.can_admit(total, slot=slot, cached_blocks=cached),
                        ref.admission_shortfall(total, slot=slot,
                                                cached_blocks=cached)) == (
                    port.can_admit(total, slot=slot, cached_blocks=cached),
                    port.admission_shortfall(total, slot=slot,
                                             cached_blocks=cached)), what
    bps = port.blocks_per_shard
    for slot in range(port.n_slots):
        assert all(b // bps == port.shard_of_slot(slot)
                   for b in port._owned[slot]), what


def test_sharded_pool_random_walk_matches_reference():
    """The walk above, plus cache-owned allocations on either shard, over
    the reference's slot-affine KVPool(n_shards=2) and the port's (4 slots,
    12 blocks of which 6 a shard): the same block ids, per-shard free
    lists, effective free blocks, admissions and tables after every
    operation; off-shard adopts and COWs refused alike."""
    from repro.configs import registry as jregistry
    from repro.serve.kv_pool import KVPool as JPool
    ref = JPool(jregistry.get("llama_200m").reduced(), 4, 32, block_size=4,
                n_blocks=12, n_shards=2)
    port = _pool(n_slots=4, max_len=32, n_blocks=12, n_shards=2)
    counts = _walk(ref, port, 4, 600,
                   lambda step, op: _assert_same_sharded(ref, port,
                                                         (step, op)),
                   seed=1, alloc=1)
    assert all(n >= 10 for n in counts.values()), counts


def _assert_slotless_admission(ref, port, what):
    """Slot-less admission on the two-shard pools: the port's `can_admit`
    is the reference's "can any shard take it" (which asks each shard
    without cached blocks); the port's `admission_shortfall` is the least
    per-shard shortfall (the reference's raises a TypeError there), 0
    exactly when `can_admit` passes (up to max_len)."""
    for total in (4, 13, 24, 28, 40):
        for cached in (0, 2):
            want = ref.can_admit(total, cached_blocks=cached)
            assert port.can_admit(total, cached_blocks=cached) == want, what
            short = port.admission_shortfall(total, cached_blocks=cached)
            assert short == min(ref.admission_shortfall(
                total, slot=sh * port.slots_per_shard) for sh in range(2)), what
            if total <= port.max_len:   # beyond it: refused, shortfall 0
                assert (short == 0) == want, what


def test_sharded_pool_slotless_admission_matches_reference():
    """`can_admit(slot=None)` / `admission_shortfall(slot=None)` on a
    two-shard pool held against the reference's KVPool after every
    operation of one seeded block history (the sharded walk's)."""
    from repro.configs import registry as jregistry
    from repro.serve.kv_pool import KVPool as JPool
    ref = JPool(jregistry.get("llama_200m").reduced(), 4, 32, block_size=4,
                n_blocks=12, n_shards=2)
    port = _pool(n_slots=4, max_len=32, n_blocks=12, n_shards=2)
    seen = set()

    def check(step, op):
        _assert_slotless_admission(ref, port, (step, op))
        seen.add(tuple(port.can_admit(t) for t in (13, 24)))

    counts = _walk(ref, port, 4, 300, check, seed=2, alloc=1)
    assert all(n >= 5 for n in counts.values()), counts
    assert len(seen) >= 2, seen   # the answers moved with the history


def test_sharded_pool_layout_guards_and_routing():
    """Each shard owns a tree of blocks_per_shard + 1 blocks (its own
    scratch block at the local sentinel) and slots_per_shard slots; the
    divisibility error names n_shards, as the reference's; a write through
    the local sentinel lands in that shard's scratch block alone; COW and
    host round trips route to the block's shard; admission without a slot
    answers for any shard (the reference's "can ANY shard take it")."""
    from repro_torch.serve import kv_pool as KV
    with pytest.raises(ValueError, match="n_shards"):
        _pool(n_slots=3, n_shards=2)
    with pytest.raises(ValueError, match="n_shards"):
        _pool(n_slots=4, n_blocks=9, n_shards=2)
    pool = _pool(n_slots=4, max_len=32, n_blocks=12, n_shards=2)
    assert pool.caches is None and len(pool.shard_caches) == 2
    for tree in pool.shard_caches:
        k, _ = tree[0]["l0"]["kv"]
        assert k.shape[1] == pool.blocks_per_shard + 1 == 7
    g = torch.Generator().manual_seed(5)
    for tree in pool.shard_caches:
        for leaf in KV.token_leaves(tree):
            leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
    before = [[t.clone() for t in KV.token_leaves(tree)]
              for tree in pool.shard_caches]
    pool.commit(2, 8)
    pool.ensure(2, 8)                       # shard 1: global 6, 7
    assert list(pool._table[2, :2]) == [6, 7]
    table = KV.split_tables(pool.tables_device()[1])[1]   # shard 1's rows
    k1 = KV.index_leaf(pool.shard_caches[1][0]["l0"]["kv"][0], 0)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12).contiguous()
    vals = torch.full((2, 12, CFG.n_kv_heads, CFG.hd), 7.0,
                      dtype=torch.bfloat16)
    KV.scatter_tokens(k1, table, pos, vals, torch.ones(2, 12, dtype=torch.bool))
    # slot 2 wrote local blocks 0, 1; slot 3 (all sentinel) and slot 2's
    # positions past its 2 blocks landed in local block 6, the scratch
    changed = {b for b in range(7)
               if not torch.equal(k1[b], before[1][0][0, b])}
    assert changed == {0, 1, 6}
    assert all(torch.equal(a, b) for a, b in zip(
        KV.token_leaves(pool.shard_caches[0]), before[0]))
    pool.incref(6)
    pool.release(2)
    pool.commit(3, 8)
    dst = pool.cow_block(3, 6)               # shard 1 to shard 1
    assert dst == 7 and torch.equal(k1[1], k1[0])
    payload, _ = pool.read_block_host(6)
    pool.write_block_host(2, payload)        # into shard 0's local block 2
    k0 = pool.shard_caches[0][0]["l0"]["kv"][0]
    assert torch.equal(k0[:, 2], pool.shard_caches[1][0]["l0"]["kv"][0][:, 0])
    # no whole-pool answer: a slot-less ask answers for the best shard
    assert pool.can_admit(24) and pool.admission_shortfall(24) == 0
    assert not pool.can_admit(28) and pool.admission_shortfall(28) == 1
    assert pool.admission_shortfall(28, slot=2) == 4   # 7 of 3 effective
    assert pool.utilization()["free_by_shard"] == [6, 4]


def test_sharing_guards():
    """adopt only on a freshly committed slot and within its blocks; COW
    only from a held block; a COW on a full table raises before taking a
    block (nothing leaks); refcounts never go below zero."""
    pool = _pool(n_slots=2, max_len=16)
    pool.commit(0, 16)
    pool.ensure(0, 16)
    held = [int(b) for b in pool._table[0]]
    for b in held:
        pool.incref(b)
    pool.release(0)
    with pytest.raises(SlotError):
        pool.adopt_prefix(1, held[:2], 8)          # unbound
    pool.commit(1, 16)
    with pytest.raises(SlotError):
        pool.adopt_prefix(1, held[:2], 9)          # 9 tokens > 2 blocks
    with pytest.raises(SlotError):
        pool.cow_block(1, pool._free[-1])          # a free block
    pool.adopt_prefix(1, held, 16)                 # the whole 4-entry table
    free, refs = pool.free_block_count, pool._ref.copy()
    with pytest.raises(OutOfBlocks):
        pool.cow_block(1, held[0])                 # table full
    assert pool.free_block_count == free and np.array_equal(pool._ref, refs)
    pool.release(1)
    with pytest.raises(SlotError):
        pool.adopt_prefix(0, held, 16)             # unbound again
    pool.commit(0, 16)
    pool.ensure(0, 4)
    with pytest.raises(SlotError):
        pool.adopt_prefix(0, held, 16)             # after allocation
    with pytest.raises(SlotError):
        pool.incref(pool._free[-1])
    for b in held:
        pool._decref(b)
    with pytest.raises(SlotError):
        pool._decref(held[0])                      # below zero
    pool.release(0)
    assert pool.free_block_count == pool.n_blocks


def test_write_table_masks_only_the_adopted_prefix():
    pool = _pool(n_slots=2, max_len=32)
    pool.commit(0, 12)
    pool.ensure(0, 12)
    shared = [int(b) for b in pool._table[0, :2]]
    for b in shared:
        pool.incref(b)
    pool.release(0)
    pool.commit(1, 20)
    pool.adopt_prefix(1, shared, 8)
    tail = pool.cow_block(1, int(shared[1]))
    pool.ensure(1, 20)
    t = pool.tables_device()
    rt, wt = t[:, 0], t[:, 1]
    assert rt.is_contiguous() and wt.is_contiguous()
    assert list(rt[1, :3]) == [*shared, tail]
    assert list(wt[1, :2]) == [pool.sentinel] * 2
    assert torch.equal(wt[1, 2:], rt[1, 2:]) and torch.equal(wt[0], rt[0])
    assert pool.refcount(shared[0]) == 2 and pool.refcount(tail) == 1


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "nvfp4"])
def test_scatter_through_adopted_blocks_lands_in_scratch(quantized):
    """Rows writing through an adopted (shared) block, and inactive rows,
    write only the scratch block: block 0 and the shared blocks keep their
    bytes, the slot's own block gets its tokens."""
    from repro_torch.serve import kv_pool as KV
    pool = _pool(n_slots=2, max_len=32, quantized=quantized)
    g = torch.Generator().manual_seed(3)
    for leaf in KV.token_leaves(pool.caches):
        leaf.copy_(torch.randint(0, 256, leaf.shape, generator=g)
                   .to(leaf.dtype))
    pool.commit(0, 8)
    pool.ensure(0, 8)
    shared = [int(b) for b in pool._table[0, :2]]
    for b in shared:
        pool.incref(b)
    pool.release(0)
    pool.commit(1, 12)
    pool.adopt_prefix(1, shared, 8)
    pool.ensure(1, 12)
    own = int(pool._table[1, 2])

    def blocks():
        return {b: [t[:, b].clone() for t in KV.token_leaves(pool.caches)]
                for b in range(pool.n_blocks + 1)}

    before = blocks()
    k = pool.caches[0]["l0"]["kv"][0]
    k0 = KV.index_leaf(k, 0)                        # layer 0
    lead = k0.codes.shape[2:-1] if quantized else k0.shape[2:-1]
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12).contiguous()
    vals = torch.full((2, 12, *lead, CFG.hd), 3.0, dtype=torch.bfloat16)
    valid = torch.tensor([[True] * 12, [True] * 12])
    valid[0] = False
    KV.scatter_tokens(k0, KV.split_tables(pool.tables_device())[1], pos, vals,
                      valid)
    after = blocks()
    changed = {b for b in before
               if not all(torch.equal(x, y) for x, y in zip(before[b], after[b]))}
    assert changed == {own, pool.n_blocks}


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "nvfp4"])
def test_host_round_trip_and_reference_payload(quantized):
    """read_block_host -> write_block_host -> read_block_host is the
    identity; the payload mirrors the reference's (same leaves, shapes,
    dtypes and byte count; a PackedKV pool's stays packed uint8)."""
    from repro.configs import registry as jregistry
    from repro.serve.kv_pool import KVPool as JPool
    from repro_torch.serve import kv_pool as KV
    import jax
    pool = _pool(n_slots=2, max_len=32, quantized=quantized)
    g = torch.Generator().manual_seed(4)
    for leaf in KV.token_leaves(pool.caches):
        leaf.copy_(torch.randint(0, 256, leaf.shape, generator=g)
                   .to(leaf.dtype))
    p1, n1 = pool.read_block_host(5)
    pool.write_block_host(11, p1)
    p2, n2 = pool.read_block_host(11)
    assert n1 == n2 and torch.equal(p1.buf, p2.buf)
    for x, y in zip(KV.token_leaves(pool.caches), KV.token_leaves(p1.stages)):
        assert torch.equal(x[:, 5], y) and torch.equal(x[:, 11], y)
    ref = JPool(jregistry.get("llama_200m").reduced(), 2, 32, block_size=4,
                quantized=quantized)
    jp, jn = ref.read_block_host(5)
    jleaves = jax.tree_util.tree_leaves(jp)
    pleaves = KV.token_leaves(p1.stages)
    assert jn == n1 and len(jleaves) == len(pleaves)
    for a, b in zip(jleaves, pleaves):
        assert a.shape == tuple(b.shape) and a.nbytes == b.numel() * b.element_size()
        assert (a.dtype == np.uint8) == (b.dtype == torch.uint8)
    if quantized:
        assert isinstance(p1.stages[0]["l0"]["kv"][0], KV.PackedKV)
    pool.release_host(p1)
    pool.release_host(p2)
    assert len(pool._host_free) == 2          # CPU copies are synchronous
    p3, _ = pool.read_block_host(0)
    assert pool.host_allocs == 2 and len(pool._host_free) == 1   # reused
