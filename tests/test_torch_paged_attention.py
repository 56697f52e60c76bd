"""The port's plain paged GQA decode against the reference kernel, and the
pool primitives it reads through.

`ops.paged_gqa` on CPU tensors is the plain version (gather_view +
decode_sdpa); it is held against `repro.kernels.ops.paged_attention` (the
Pallas kernel in interpret mode) at ATOL, RTOL = 5e-6, 1e-5, the bar of
tests/test_paged_attention.py. Cases: ragged rows, trailing sentinel entries,
a fully unallocated row (exact zeros), a sliding window, Sq in {1, 4}, and
grouped heads rep in {1, 2}. Pools hold garbage outside the written
positions, so a masked lane that leaked would show.

The card's split-KV kernels are held here by their geometry and arithmetic:
`PA.plan` (GQA, #5/#6) and `PA.plan_mla` (packed MLA, #8) tile every row's
logical blocks exactly once, in order, and a PyTorch model of the per-split
partials and their fixed-order merge equals `PA.paged_gqa_plain` and
`PA.paged_mla_q_plain` within the same bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serve import kv_pool as jkv
from repro_torch.core import formats as F
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
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


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_plan_covers_every_block_once_in_order(bs):
    """PA.plan's splits tile each row's logical blocks exactly once, in
    order, within the kernel's limits (<= 64 keys and <= 16 blocks a split),
    and its grid, row groups and scratch follow from the shapes alone."""
    for b, sq, h, kv, maxb, vd in [(1, 1, 1, 1, 1, 16), (4, 1, 10, 10, 16, 128),
                                   (4, 16, 32, 4, 16, 128), (3, 4, 8, 2, 64, 64),
                                   (2, 3, 6, 3, 7, 32), (5, 1, 32, 4, 257, 128)]:
        p = PA.plan(b, sq, h, kv, maxb, bs, vd)
        assert p == PA.plan(b, sq, h, kv, maxb, bs, vd)
        covered = [j for s in range(p.splits) for j in p.blocks(s)]
        assert covered == list(range(maxb))
        assert all(len(p.blocks(s)) > 0 for s in range(p.splits))
        assert p.blocks_per_split * bs <= 64 and p.blocks_per_split <= 16
        assert p.grid == b * kv * p.splits
        rows = sq * (h // kv)
        assert p.row_groups in (1, 2, 4)
        assert rows <= PA.ROW_CHUNK * p.row_groups or p.row_groups == 4
        assert p.scratch == (0 if p.splits == 1
                             else b * sq * h * p.splits * (vd + 2))


def _split_merge(q, k_pool, v_pool, table, pos, window):
    """The split-KV kernels' arithmetic over the gathered view: for each of
    PA.plan's splits, the kernel's block-skip rules and per-key masks give a
    partial (m, l, acc) (m = NEG_INF, l = 0 with no live key); the partials
    merge in split order, skipping splits with l == 0."""
    b, sq, h, hd = q.shape
    n_blocks, bs, kvh = k_pool.shape[:3]
    vd, maxb = v_pool.shape[3], table.shape[1]
    p = PA.plan(b, sq, h, kvh, maxb, bs, vd)
    kg = kv.gather_view(k_pool, table).float()      # (B, T, KV, hd)
    vg = kv.gather_view(v_pool, table).float()
    qf = q.float().reshape(b, sq, kvh, h // kvh, hd)
    s = (torch.einsum("bqgrd,btgd->bqgrt", qf, kg)
         / torch.tensor(PA.sqrt_hd(hd), dtype=torch.float32))
    p0 = pos.long()
    qpos = p0[:, None] + torch.arange(sq)[None]                     # (B, Sq)
    j = torch.arange(maxb)
    live = ((table >= 0) & (table < n_blocks)
            & (j[None] * bs <= (p0 + sq - 1)[:, None]))              # (B, MAXB)
    if window is not None:
        live &= (j[None] + 1) * bs - 1 > (p0 - window)[:, None]
    t = torch.arange(maxb * bs)
    ok = live[:, t // bs][:, None] & (t[None, None] <= qpos[..., None])
    if window is not None:
        ok &= t[None, None] > qpos[..., None] - window                # (B, Sq, T)
    ok = ok[:, :, None, None]
    parts = []
    for split in range(p.splits):
        blk = p.blocks(split)
        keys = slice(blk.start * bs, blk.stop * bs)
        ks = torch.where(ok[..., keys], s[..., keys], PA.NEG_INF)
        m = ks.amax(-1)
        e = torch.where(ok[..., keys], torch.exp(ks - m[..., None]), 0.0)
        parts.append((m, e.sum(-1),
                      torch.einsum("bqgrt,btgv->bqgrv", e, vg[:, keys])))
    mm = torch.full_like(parts[0][0], PA.NEG_INF)
    for m, l, _ in parts:
        mm = torch.where(l > 0, torch.maximum(mm, m), mm)
    ll = torch.zeros_like(mm)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        f = torch.where(l > 0, torch.exp(m - mm), 0.0)
        ll = ll + l * f
        acc = acc + a * f[..., None]
    return (acc / ll.clamp(min=1e-30)[..., None]).reshape(b, sq, h, vd)


@pytest.mark.parametrize("sq,window,bs,rep", [(1, None, 16, 1), (1, None, 4, 4),
                                              (16, None, 8, 2), (1, 20, 8, 4),
                                              (3, 45, 16, 2), (4, 9, 32, 1),
                                              # nemotron's 6 and chatglm3's 16
                                              # heads a KV head, decode and
                                              # Sq 16 chunks
                                              (1, None, 16, 6), (16, None, 16, 6),
                                              (1, None, 16, 16), (16, None, 16, 16)])
def test_split_merge_model_matches_plain(sq, window, bs, rep):
    """The fixed-order split merge the kernels do, modelled in PyTorch over
    the gathered view with PA.plan's splits, equals PA.paged_gqa_plain
    within the bar: ragged rows spanning several splits, splits past a
    row's end and splits a window leaves dead (all-masked), and an
    unallocated row (exact zeros)."""
    rng = np.random.RandomState(sq * 100 + bs + rep)
    maxb, kvh, hd = 256 // bs, 2, 16
    lens = [256, 33, 100, 64]
    n_blocks = len(lens) * maxb + 2
    table = np.full((len(lens), maxb), n_blocks, np.int32)
    free = list(rng.permutation(n_blocks))
    for i, n in enumerate(lens):
        if i != 2:  # row 2 holds only the sentinel
            for j in range(-(-n // bs)):
                table[i, j] = free.pop()
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    q = torch.from_numpy(rng.randn(len(lens), sq, kvh * rep, hd).astype(np.float32))
    pk, pv = (torch.from_numpy(rng.randn(n_blocks, bs, kvh, hd).astype(np.float32)
                               * 3).bfloat16() for _ in range(2))
    table = torch.from_numpy(table)
    assert PA.plan(len(lens), sq, kvh * rep, kvh, maxb, bs, hd).splits >= 8
    got = _split_merge(q, pk, pv, table, pos, window)
    want = PA.paged_gqa_plain(q, pk, pv, table, pos, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    assert not got[2].any() and not want[2].any()


MLA_PLAN_SHAPES = [(1, 1, 1, 1, 16), (4, 1, 128, 16, 512), (4, 16, 128, 16, 512),
                   (4, 1, 128, 256, 512), (4, 16, 128, 256, 512), (3, 3, 4, 9, 32),
                   (64, 1, 128, 64, 512), (2, 2, 8, 1000, 512), (1, 1, 128, 4096, 512)]


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_plan_mla_covers_every_block_once_in_order(bs):
    """PA.plan_mla's splits tile each row's logical blocks exactly once, in
    order, at most `mla_split_cap` of them (the partials within
    MLA_SCRATCH_BYTES); splits are MLA_SPLIT_KEYS long unless the cap
    lengthens them; tiles, grid and scratch follow from the shapes alone."""
    for b, sq, h, maxb, lora in MLA_PLAN_SHAPES:
        p = PA.plan_mla(b, sq, h, maxb, bs, lora)
        assert p == PA.plan_mla(b, sq, h, maxb, bs, lora)
        covered = [j for s in range(p.splits) for j in p.blocks(s)]
        assert covered == list(range(maxb))
        assert all(len(p.blocks(s)) > 0 for s in range(p.splits))
        cap = PA.mla_split_cap(b, sq, h, lora)
        base = max(1, PA.MLA_SPLIT_KEYS // bs)
        assert p.splits <= cap
        assert p.blocks_per_split == (base if -(-maxb // base) <= cap
                                      else -(-maxb // cap))
        assert p.tiles == -(-(sq * h) // PA.MLA_PAIRS)
        assert p.grid == b * p.tiles * p.splits
        assert p.scratch == (0 if p.splits == 1
                             else b * sq * h * p.splits * (lora + 2))
        assert p.scratch * 4 <= max(PA.MLA_SCRATCH_BYTES, b * sq * h * (lora + 2) * 4)


def test_plan_mla_at_deepseek_v3_shapes():
    """The geometry the kernel's head note states: H 128, lora 512, BS 16."""
    decode = PA.plan_mla(4, 1, 128, 16, 16, 512)   # the engine's 256-token table
    assert (decode.blocks_per_split, decode.splits, decode.tiles) == (1, 16, 8)
    long = PA.plan_mla(4, 1, 128, 256, 16, 512)    # 4 rows x 4,096 tokens
    assert (long.blocks_per_split, long.splits) == (9, 29)
    chunk = PA.plan_mla(4, 16, 128, 16, 16, 512)   # 16-token prefill chunks
    assert (chunk.splits, chunk.scratch, chunk.tiles) == (1, 0, 128)


def _mla_split_merge(q_abs, q_rope, cc, kc, table, pos, qk_dim):
    """#8's arithmetic over the gathered view: for each of PA.plan_mla's
    splits, the kernel's block-skip rules (sentinel entries, blocks past the
    newest query) and causal masks give a partial (m, l, acc) per (query,
    head) (m = NEG_INF, l = 0 with no live key); the partials merge in split
    order, skipping splits with l == 0."""
    b, sq, h, lora = q_abs.shape
    maxb = table.shape[1]
    n_blocks, bs = cc.codes.shape[:2]
    p = PA.plan_mla(b, sq, h, maxb, bs, lora)
    cv = kv.gather_view(cc, table).float()                        # (B, T, lora)
    kr = kv.gather_view(kc, table).float()
    s = ((torch.einsum("bqhl,btl->bqht", q_abs, cv)
          + torch.einsum("bqhr,btr->bqht", q_rope.float(), kr)) * PA.mla_scale(qk_dim))
    p0 = pos.long()
    qpos = p0[:, None] + torch.arange(sq)[None]                     # (B, Sq)
    j = torch.arange(maxb)
    live = ((table >= 0) & (table < n_blocks)
            & (j[None] * bs <= (p0 + sq - 1)[:, None]))              # (B, MAXB)
    t = torch.arange(maxb * bs)
    ok = (live[:, t // bs][:, None] & (t[None, None] <= qpos[..., None]))[:, :, None]
    parts = []
    for split in range(p.splits):
        blk = p.blocks(split)
        keys = slice(blk.start * bs, blk.stop * bs)
        ks = torch.where(ok[..., keys], s[..., keys], PA.NEG_INF)
        m = ks.amax(-1)
        e = torch.where(ok[..., keys], torch.exp(ks - m[..., None]), 0.0)
        parts.append((m, e.sum(-1), torch.einsum("bqht,btl->bqhl", e, cv[:, keys])))
    mm = torch.full_like(parts[0][0], PA.NEG_INF)
    for m, l, _ in parts:
        mm = torch.where(l > 0, torch.maximum(mm, m), mm)
    ll = torch.zeros_like(mm)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        f = torch.where(l > 0, torch.exp(m - mm), 0.0)
        ll = ll + l * f
        acc = acc + a * f[..., None]
    return acc / ll.clamp(min=1e-30)[..., None], p


@pytest.mark.parametrize("sq,bs,scratch_bytes", [(1, 16, None), (1, 4, None),
                                                 (16, 8, None), (3, 32, None),
                                                 (1, 4, 4 * 8 * 34 * 4 * 5),
                                                 (16, 16, 4 * 16 * 8 * 34 * 4 * 3)])
def test_mla_split_merge_model_matches_plain(monkeypatch, sq, bs, scratch_bytes):
    """#8's split-KV arithmetic (PA.plan_mla's splits, the fixed-order merge)
    modelled in PyTorch over the gathered NVFP4 view equals
    PA.paged_mla_q_plain within the bar: ragged rows over several splits,
    splits past a row's end, Sq 16, an all-sentinel row (exact zeros), and
    (with a smaller scratch cap) splits the cap lengthens to several blocks,
    the last one shorter."""
    if scratch_bytes is not None:
        monkeypatch.setattr(PA, "MLA_SCRATCH_BYTES", scratch_bytes)
    rng = np.random.RandomState(sq * 100 + bs)
    h, lora, rope, maxb = 8, 32, 16, 256 // bs
    lens = [256, 33, 100, 64]
    n_blocks = len(lens) * maxb + 2
    table = np.full((len(lens), maxb), n_blocks, np.int32)
    free = list(rng.permutation(n_blocks))
    for i, n in enumerate(lens):
        if i != 2:  # row 2 holds only the sentinel
            for j in range(-(-n // bs)):
                table[i, j] = free.pop()
    table = torch.from_numpy(table)
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    qa = torch.from_numpy(rng.randn(len(lens), sq, h, lora).astype(np.float32) * 0.3)
    qr = torch.from_numpy(rng.randn(len(lens), sq, h, rope).astype(np.float32)).bfloat16()
    cc = kv.PackedKV(*F.nvfp4_cache_encode(torch.from_numpy(
        rng.randn(n_blocks, bs, lora).astype(np.float32)).bfloat16()))
    kc = kv.PackedKV(*F.nvfp4_cache_encode(torch.from_numpy(
        rng.randn(n_blocks, bs, rope).astype(np.float32) * 2).bfloat16()))
    got, p = _mla_split_merge(qa, qr, cc, kc, table, pos, 16 + rope)
    assert p.splits >= 2
    if scratch_bytes is not None:
        assert p.blocks_per_split > max(1, PA.MLA_SPLIT_KEYS // bs)
        assert len(p.blocks(p.splits - 1)) < p.blocks_per_split
    want = PA.paged_mla_q_plain(qa, qr, cc.codes, cc.scales, kc.codes, kc.scales,
                                table, pos, 16 + rope)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    assert not got[2].any() and not want[2].any()


def test_split_bf16x3_is_exact():
    """#7's three-term split: hi + mid + lo == x bitwise in f32, each term a
    bf16, for random values over many binades and for edge values (large
    magnitudes below bf16's overflow, the smallest normals, the smallest x
    whose residuals stay normal, +-0)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    edges = np.array([1e38, 3e38, 3.3e38, 2.0 ** -126, 2.0 ** -110 * 1.7364502,
                      1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24, 0.0], np.float32)
    x = torch.from_numpy(np.concatenate([x, edges, -edges]))
    hi, mid, lo = PA.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    zero = x == 0
    assert not mid[zero].any() and not lo[zero].any()  # +-0: one term


def test_plan_mla_tc_at_deepseek_v3_shapes():
    """#7's geometry (wave = MLA_TC_WAVE) as its head note states it: the
    most splits that keep the grid within one wave of 264 CTAs; #8's plan
    at the same shapes is pinned above."""
    w = PA.MLA_TC_WAVE
    decode = PA.plan_mla(4, 1, 128, 16, 16, 512, wave=w)
    assert (decode.blocks_per_split, decode.splits, decode.tiles, decode.grid) == (2, 8, 8, 256)
    long = PA.plan_mla(4, 1, 128, 256, 16, 512, wave=w)
    assert (long.blocks_per_split, long.splits, long.grid) == (32, 8, 256)
    assert long.scratch * 4 == 4 * 128 * 8 * 514 * 4   # 8.4 MB of partials
    assert PA.plan_mla(4, 1, 128, 256, 16, 512).scratch == 4 * 128 * 29 * 514
    chunk = PA.plan_mla(4, 16, 128, 16, 16, 512, wave=w)
    assert (chunk.splits, chunk.scratch, chunk.tiles, chunk.grid) == (1, 0, 128, 512)


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_plan_mla_wave_covers_every_block_once_in_order(bs):
    """With a wave (#7) plan_mla's splits still tile each row's logical
    blocks exactly once, in order; there are as many as keep b x tiles x
    splits within the wave (at least one, at most one a block)."""
    w = PA.MLA_TC_WAVE
    for b, sq, h, maxb, lora in MLA_PLAN_SHAPES:
        p = PA.plan_mla(b, sq, h, maxb, bs, lora, wave=w)
        assert p == PA.plan_mla(b, sq, h, maxb, bs, lora, wave=w)
        covered = [j for s in range(p.splits) for j in p.blocks(s)]
        assert covered == list(range(maxb))
        assert all(len(p.blocks(s)) > 0 for s in range(p.splits))
        want = max(1, min(maxb, w // (b * p.tiles)))
        assert p.blocks_per_split == -(-maxb // want) and p.splits <= want
        assert p.tiles == -(-(sq * h) // PA.MLA_PAIRS)
        assert p.grid == b * p.tiles * p.splits <= max(w, b * p.tiles)
        assert p.scratch == (0 if p.splits == 1
                             else b * sq * h * p.splits * (lora + 2))


def _mla_inputs(seed, b, sq, bs, maxb, lens, dead=(), q_scale=1.0,
                rope_dtype=torch.bfloat16, h=128, lora=512, rope=64):
    """(q_abs, q_rope, cc, kc, table, pos) at deepseek-v3's widths from a
    numpy seed: bf16 pools over a shuffled table, dead rows all sentinel."""
    rng = np.random.RandomState(seed)
    n_blocks = b * maxb + 2
    table = np.full((b, maxb), n_blocks, np.int32)
    free = list(rng.permutation(n_blocks))
    for i, n in enumerate(lens):
        if i not in dead:
            for j in range(-(-n // bs)):
                table[i, j] = free.pop()
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    qa = torch.from_numpy(rng.randn(b, sq, h, lora).astype(np.float32) * (0.1 * q_scale))
    qr = torch.from_numpy(rng.randn(b, sq, h, rope).astype(np.float32)).to(rope_dtype)
    cc = torch.from_numpy(rng.randn(n_blocks, bs, lora).astype(np.float32)).bfloat16()
    kc = torch.from_numpy(rng.randn(n_blocks, bs, rope).astype(np.float32) * 2).bfloat16()
    return qa, qr, cc, kc, torch.from_numpy(table), pos


def _terms(x):
    """x's three bf16 terms as float64, stacked: (3, *x.shape)."""
    return torch.stack([t.double() for t in PA.split_bf16x3(x)])


def _mla_tc_model(q_abs, q_rope, cc, kc, table, pos, qk_dim):
    """#7's tensor-core arithmetic over the gathered view. Operands: q_abs,
    q_rope and the probabilities as their three bf16 terms, the pools' bf16
    values; products exact, each 16-wide k step's sum over its 3 x 16
    products rounded once to f32 (what one chain of three m16n8k16 mmas from
    zero gives, up to the tensor cores' own rounding). Scores: warp w's
    latent partial sums k steps w, w + 8, w + 16, w + 24 in f32, the
    partials add in warp order, the rope k steps likewise, then (lat + rope)
    * scale. Per split of plan_mla(..., wave=MLA_TC_WAVE), steps of 16 keys
    (sentinel blocks and keys past the newest query masked) run the online
    softmax o = o * corr + P.cc; the partials merge in split order."""
    b, sq, h, lora = q_abs.shape
    rope, maxb = q_rope.shape[3], table.shape[1]
    n_blocks, bs = cc.shape[:2]
    n, nks, nrs, warps = sq * h, lora // 16, rope // 16, 8
    p = PA.plan_mla(b, sq, h, maxb, bs, lora, wave=PA.MLA_TC_WAVE)
    cv = kv.gather_view(cc, table).double()                       # (B, T, lora)
    kr = kv.gather_view(kc, table).double()
    steps_lat = torch.einsum("zbnkd,btkd->bntk",
                             _terms(q_abs.reshape(b, n, nks, 16)),
                             cv.reshape(b, -1, nks, 16)).float()  # (B, N, T, nks)
    steps_rope = torch.einsum("zbnkd,btkd->bntk",
                              _terms(q_rope.float().reshape(b, n, nrs, 16)),
                              kr.reshape(b, -1, nrs, 16)).float()
    parts = []
    for w in range(warps):
        part = torch.zeros(steps_lat.shape[:3])
        for ks in range(w, nks, warps):
            part = part + steps_lat[..., ks]
        parts.append(part)
    lat, rp = parts[0], steps_rope[..., 0]
    for part in parts[1:]:
        lat = lat + part
    for ks in range(1, nrs):
        rp = rp + steps_rope[..., ks]
    s = (lat + rp) * PA.mla_scale(qk_dim)                         # (B, N, T) f32
    t_all = maxb * bs
    live = (table >= 0) & (table < n_blocks)                      # (B, MAXB)
    qpos = (pos.long()[:, None] + torch.arange(n)[None] // h)     # (B, N)
    pmax = pos.long() + sq - 1
    splits = []
    for split in range(p.splits):
        blk = p.blocks(split)
        kbeg, kend = blk.start * bs, torch.clamp(pmax + 1, max=blk.stop * bs)
        m = torch.full((b, n), PA.NEG_INF)
        l = torch.zeros(b, n)
        o = torch.zeros(b, n, lora)
        for k0 in range(kbeg, blk.stop * bs, 16):
            keys = torch.arange(k0, k0 + 16)
            idx = keys.clamp(max=t_all - 1)
            ok = ((keys[None] < kend[:, None]) & live[:, idx // bs])[:, None] \
                & (keys[None, None] <= qpos[..., None])           # (B, N, 16)
            sk = torch.where(ok, s[..., idx], PA.NEG_INF)
            m_new = torch.maximum(m, sk.amax(-1))
            corr = torch.exp(m - m_new)
            pk = torch.where(ok, torch.exp(sk - m_new[..., None]), 0.0)
            l = l * corr + pk.sum(-1)
            m = m_new
            d = torch.einsum("zbnk,bkl->bnl", _terms(pk), cv[:, idx]).float()
            o = (o.double() * corr.double()[..., None] + d.double()).float()
        splits.append((m, l, o))
    mm = torch.full((b, n), PA.NEG_INF)
    for m, l, _ in splits:
        mm = torch.where(l > 0, torch.maximum(mm, m), mm)
    ll, acc = torch.zeros(b, n), torch.zeros(b, n, lora)
    for m, l, o in splits:
        f = torch.where(l > 0, torch.exp(m - mm), 0.0)
        ll = ll + l * f
        acc = acc + o * f[..., None]
    return (acc / ll.clamp(min=1e-30)[..., None]).reshape(b, sq, h, lora), p


@pytest.mark.parametrize("sq,bs,maxb,lens,rope_dtype", [
    (1, 16, 8, [40, 57, 0, 125], torch.bfloat16),
    (1, 4, 16, [37, 64, 5, 0], torch.float32),
    (3, 8, 8, [20, 64, 3, 0], torch.bfloat16),
    (16, 32, 2, [16, 64, 40, 0], torch.float32)])
def test_mla_tc_model_matches_plain(sq, bs, maxb, lens, rope_dtype):
    """#7's tensor-core arithmetic (three-term bf16 operands, exact
    products, f32 sums per 16-wide k step, the kernel's splits and the
    fixed-order merge), modelled in PyTorch at deepseek-v3's widths, equals
    PA.paged_mla_plain within the bar: ragged rows, several splits (one at
    Sq 16), an all-sentinel row (exact zeros), bf16 and f32 q_rope."""
    qa, qr, cc, kc, table, pos = _mla_inputs(sq * 10 + bs, 4, sq, bs, maxb, lens,
                                             dead=(3,), rope_dtype=rope_dtype)
    got, p = _mla_tc_model(qa, qr, cc, kc, table, pos, 192)
    assert p.splits == (1 if sq == 16 else min(maxb, PA.MLA_TC_WAVE // (4 * p.tiles)))
    want = PA.paged_mla_plain(qa, qr, cc, kc, table, pos, 192)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    assert not got[3].any() and not want[3].any()


@pytest.mark.parametrize("q_scale", [10.0, 1e-4])
def test_plain_mla_within_bar_of_float64(q_scale):
    """The q_abs scales of the card's stressed #7 cases keep the plain f32
    version itself within the bar of the same function in float64 (past
    about 10, near-tied scores in the hundreds move any f32 summation order's
    output out of it)."""
    qa, qr, cc, kc, table, pos = _mla_inputs(5, 4, 1, 16, 32, [500, 37, 0, 300],
                                             dead=(2,), q_scale=q_scale,
                                             rope_dtype=torch.float32)
    got = PA.paged_mla_plain(qa, qr, cc, kc, table, pos, 192)
    cv = kv.gather_view(cc, table).double()
    s = (torch.einsum("bqhl,btl->bhqt", qa.double(), cv)
         + torch.einsum("bqhr,btr->bhqt", qr.double(), kv.gather_view(kc, table).double())
         ) * PA.mla_scale(192)
    ok = torch.arange(cv.shape[1])[None, None] <= pos.long()[:, None, None]
    s = torch.where(ok[:, None], s, PA.NEG_INF)
    prob = torch.softmax(s, -1)
    want = torch.einsum("bhqt,btl->bqhl", prob, cv)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
