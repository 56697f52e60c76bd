"""The launch geometry of the port's bf16 GEMM (`kernels/bf16_matmul.py`).

`plan(m, n, k)` picks the kernel's activation width, warpgroups, chain
split and grid; none of them may change an output's summation order, which
K alone fixes. `chain_chunks`, `chain_stages` and `block_work` below mirror
the indexing of `csrc/bf16_matmul.cu` (its `chain_stages`, the producer's
cursor, a block's n0, m0 and cluster rank); keep them in step with it. On
the CPU (no card), for a sweep of shapes:

- the grid covers every output exactly once: each weight tile and each
  activation tile once, the blocks of one cluster on the same outputs;
- the chain -> chunk map puts every 32-value chunk of K in exactly one
  chain, chain j taking j, j + 8, ... in increasing order, walked in pairs
  (c, c + 8) of one chain;
- that map is the same for every m and n at one k: each output's 8 chains
  are summed in chain order by one block, or by the 8 blocks of a cluster
  in rank order, whatever the plan;
- the geometry stays inside what the kernel takes (widths, two warpgroups
  only at 128, at most 65,535 weight tiles x splits on the grid's y) and
  fills the card at decode.

The card tests (`tests/test_torch_cuda.py`) hold the kernel itself to these
claims: its row splits and N / 2 slices bitwise the whole call.
"""

import pytest
import torch

from repro_torch.kernels import bf16_matmul as BM
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def chain_chunks(k: int) -> list[list[int]]:
    """The 32-value chunks of K each chain sums, in its order."""
    nch = -(-k // BM.CHUNK)
    return [list(range(j, nch, BM.CHAINS)) for j in range(BM.CHAINS)]


def chain_stages(k: int, j: int) -> list[tuple]:
    """The stages of chain j as the kernel walks them: chunk pairs (c, c + 8),
    the second None at an odd chain's end (the block then issues the first
    chunk's two k16 steps alone)."""
    chunks = chain_chunks(k)[j]
    return [(chunks[i], chunks[i + 1] if i + 1 < len(chunks) else None)
            for i in range(0, len(chunks), 2)]


def block_work(p: BM.Plan, m: int, n: int, x: int, y: int):
    """What block (x, y) of plan p computes: (activation rows, weight rows,
    the chains it runs, the cluster that sums them: (x, weight tile)). The
    activation tiles of a weight tile are neighbours in x, so the blocks on
    the card at once share weight tiles in L2."""
    tile, rank = divmod(y, p.splits)
    rows = range(x * p.width, min(m, (x + 1) * p.width))
    cols = range(tile * p.rows, min(n, (tile + 1) * p.rows))
    chains = list(range(BM.CHAINS)) if p.splits == 1 else [rank]
    return rows, cols, chains, (x, tile)


MS = (1, 2, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 200, 300, 352, 16384)
NS = (1, 8, 40, 64, 65, 1280, 1728, 3456, 8192, 10240, 32000, 256000)
KS = (1, 31, 32, 52, 72, 256, 257, 1000, 1280, 3456, 6144)


@pytest.mark.parametrize("m", MS)
def test_plan_grid_covers_every_output_once(m):
    for n in NS:
        p = BM.plan(m, n, 1280)
        gx, gy = p.grid
        assert p.width in BM.WIDTHS and p.groups == (2 if p.width == 128 else 1)
        assert p.splits in (1, BM.CHAINS) and gy % p.splits == 0
        assert p.width >= min(m, BM.WIDTHS[-1]) and gy <= 65535
        rows = torch.zeros(m, dtype=torch.int64)
        for x in range(gx):
            r, _, _, _ = block_work(p, m, n, x, 0)
            assert len(r) > 0
            rows[r.start:r.stop] += 1
        cols = torch.zeros(n, dtype=torch.int64)
        clusters = {}
        for y in range(gy):
            _, c, chains, (_, tile) = block_work(p, m, n, 0, y)
            assert len(c) > 0
            if tile not in clusters:   # a cluster's blocks share their outputs
                cols[c.start:c.stop] += 1
            clusters.setdefault(tile, []).append((c, chains))
        assert (rows == 1).all() and (cols == 1).all(), (m, n, p)
        for blocks in clusters.values():
            assert len({c for c, _ in blocks}) == 1
            # the cluster's blocks in rank order run the chains in chain order
            assert [j for _, ch in blocks for j in ch] == list(range(BM.CHAINS))


@pytest.mark.parametrize("k", KS)
def test_chain_map_partitions_k_in_fixed_order(k):
    nch = -(-k // BM.CHUNK)
    chains = chain_chunks(k)
    assert len(chains) == BM.CHAINS
    assert sorted(c for ch in chains for c in ch) == list(range(nch))
    for j, ch in enumerate(chains):
        assert ch == list(range(j, nch, BM.CHAINS))
        stages = chain_stages(k, j)
        assert [c for st in stages for c in st if c is not None] == ch
        assert all(b is None or b == a + BM.CHAINS for a, b in stages)
        assert all(b is not None for _, b in stages[:-1])


@pytest.mark.parametrize("k", KS)
def test_chain_map_is_the_same_for_every_m_and_n(k):
    """What each output's sum walks, read off the plan of every (m, n): its
    chains in fold order and each chain's stages, the same at one k."""
    want = [chain_stages(k, j) for j in range(BM.CHAINS)]
    for m in MS:
        for n in NS:
            p = BM.plan(m, n, k)
            for tile in (0, p.grid[1] // p.splits - 1):
                walk = []
                for rank in range(p.splits):
                    _, _, chains, _ = block_work(p, m, n, 0, tile * p.splits + rank)
                    walk += [chain_stages(k, j) for j in chains]
                assert walk == want, (m, n, k, p)


def test_plan_fills_the_card_at_decode():
    """llama-200m's 1,280- and 3,456-row weights at a decode step's 4 rows
    split their chains over clusters (20 and 54 tiles); the 32,000-row head
    and nemotron-4-15b's 256,000-row one run one block a tile."""
    assert BM.plan(4, 1280, 1280).splits == BM.CHAINS
    assert BM.plan(4, 3456, 1280).grid == (1, 54 * BM.CHAINS)
    assert BM.plan(4, 32000, 1280) == BM.Plan(8, 1, 1, (1, 500))
    assert BM.plan(4, 256000, 6144) == BM.Plan(8, 1, 1, (1, 4000))
    assert BM.plan(16384, 32000, 1280) == BM.Plan(128, 2, 1, (128, 250))


@pytest.mark.parametrize("shape", [(0, 8, 8), (4, 0, 8), (4, 8, 0)])
def test_plan_refuses_an_empty_gemm(shape):
    with pytest.raises(ValueError, match="empty"):
        BM.plan(*shape)


def test_cpu_tensors_take_the_plain_version():
    g = torch.Generator().manual_seed(0)
    a = torch.randn((5, 72), generator=g)
    b = torch.randn((40, 72), generator=g).bfloat16()
    before = ops.LAUNCHES["bf16_matmul"]
    assert torch.equal(ops.bf16_matmul(a, b), BM.bf16_matmul_plain(a, b))
    assert ops.LAUNCHES["bf16_matmul"] == before
