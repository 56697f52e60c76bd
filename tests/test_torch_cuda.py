"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and the CUDA toolkit (the repo's
tests/conftest.py imports jax, which that machine does not need, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test skips where no CUDA device is present; the decision is made in a
fixture, never at import. Tolerances are the kernel bars of the port:
  - nvfp4_fos_quant: scales and gscale equal; codes may differ only on
    rounding ties, for < 1e-4 of elements and by at most one grid step;
  - fp4_matmul (both kernels: M <= 16 and M > 16): |C_kernel - C_plain|
    <= 1e-5 * max|C_plain| (exact block values; only the fp32 summation
    order differs); the bf16 output is bitwise the f32 output rounded to
    bf16, so against the plain f32 result it is within that bar plus one
    bf16 rounding (2^-8 |C|); two calls bitwise equal;
  - paged_gqa, paged_gqa_q, paged_mla, paged_mla_q: |o_kernel - o_plain|
    <= 5e-6 + 1e-5 |o_plain|, the bar of tests/test_paged_attention.py and
    tests/test_kv_quant.py (the packed kernels decode exactly, so only the
    online softmax's fp32 order differs, and the split-KV merges only
    re-order those sums); #5 and #6 also at head dim 256 (recurrentgemma's
    MQA lattn, windows 2,048 and 64 over 4,096-token tables, unit-scale
    K/V) and 136, refusing 272; at hd 256 with 3x K/V, #5 within the same
    bar of float64 attention. paged_mla runs both of its products on the tensor
    cores with its f32 operands (q_abs, an f32 q_rope, the probabilities)
    split into three bf16 terms each, hi + mid + lo == x exactly, and a
    bf16 x bf16 product is exact in f32: every product equals the plain
    version's and only the f32 sums' order differs, so the bar is the same;
    the cases with q_abs scaled by 1e4 and 1e-4 and an f32 q_rope stress
    that split. Inactive rows exactly 0; all four: two calls bitwise equal;
  - ms_eden_phase1 and ms_eden_phase2: BITWISE equal to their plain versions
    (the butterfly RHT, the group sums and every rounding run in one fixed
    order in both); phase 2 so with uniforms hashed in the kernel from a
    key pair and with a uniforms tensor, one or two operands a launch;
  - quartet2_backward_gemm: |C_kernel - C_plain| <= 1e-3 * max|C_plain| with
    identical signs and uniforms (only fp4_matmul's fp32 order differs);
  - qlinear forward and backward on the card against the CPU, same hashed
    draws: y and dx (bf16) within one bf16 rounding of each other after fp32
    sums taken in another order, |d| <= 2^-7 |ref| + 1e-5 max|ref|; dw (f32)
    within 1e-5 max|dw|;
  - the reduced paged step on the card against the CPU: llama-200m under
    quartet2 within atol = rtol = 5e-2; deepseek-v3 with the bf16 and the
    NVFP4 pool, bf16 logits within 2e-2 (fp32 summation order through two
    layers) and quartet2 logits within 0.3 relative RMS (an ulp of an
    absmax can move a whole tensor's codes);
  - the checkpointer on card tensors (pinned staging buffers, async write):
    bitwise, an in-place update right after `save` not in the checkpoint;
  - the quantization-health probe on the card against the CPU, same
    weights and hashed draws: every metric within 1e-5 relative (its 4/6
    and MS-EDEN codes come from kernels bitwise their plain versions; only
    the f32 means sum in another order), one #1, #3 and #4 launch a site;
  - the prefix cache's block copies and host tier: bitwise (a COW'd block
    in every leaf, PackedKV codes and scales alike; a host round trip; a
    swap-in whose snapshot is dropped right after dispatch), and a scatter
    through an adopted block's write-table sentinel lands in scratch only;
  - prefix-cache streams under scheme bf16 (reduced llama, both pools):
    hot and spill-hot streams of a block-aligned match bitwise the cold
    one; a COW stream's matched K/V byte-identical to the cold run's, its
    spill-hot repeat bitwise, and its tokens bitwise cold or equal up to
    the first token whose cold top-2 logit margin is within 2 bf16 ulps of
    the top logit, at least half compared (the rest of the prompt runs in
    other step shapes than the cold run's);
  - self-speculative decoding: `forward_prefix` (the draft stack) bitwise
    `forward` of the config cut to its layers, logits and K/V, at Sq 1 and
    4; the spec engine's streams bitwise repeatable, both pools freed.
    The kernels' cases above include the verify chunk's shapes: #2 at M =
    16 and 20, #5 and #7 at Sq 4 from mid-sequence positions;
  - threads (the HTTP frontend ticks the engine on a thread of its own):
    #1, #2 (both kernels) and #5 launched from a non-main thread bitwise
    the same launches from the main thread; SSE streams of the reduced
    llama under scheme bf16, over the bf16 and the NVFP4 pool, bitwise the
    engine's `run()` streams, every step on the bridge's thread;
  - dense per-slot caches: the engine's step without a block table, reduced
    llama under bf16, card against CPU: logits within 2e-2, argmax equal
    off 2-ulp near-ties (the tie rule), the caches within one bf16 ulp;
    `chunked_sdpa` at its own 1,024 blocks over 2,048 f32 tokens against
    plain sdpa on the card within 2e-3 (the reference's bar), two calls
    bitwise;
  - the distribution layer on one card: the compression's SR round trip
    (plain PyTorch) bitwise the CPU's for the same hashed uniforms; at
    world size 1 over NCCL, `gpipe` bitwise its stage (quartet2 qlinear:
    #1 twice and #2 once a tick), `compressed_psum_mean` bitwise
    `_sr_roundtrip`, and the DP train step bitwise the plain step;
  - mesh-sharded serving (both shards on the one card): #5-#8 on a
    two-shard pool's shard-local tables (the local sentinel
    blocks_per_shard, an all-sentinel row) and shard leaves of
    blocks_per_shard + 1 blocks within the attention bar of their plain
    versions, inactive rows exactly 0; one reduced llama step under bf16
    through `make_sharded_serve_step` against the unsharded step over the
    same slots: each shard's rows within the bf16 bar of the paged step
    above (2e-2; the card's f32 GEMMs may sum 2 rows in another order than
    4) and argmax equal, and its K/V writes landing in the shard's blocks;
  - bf16_matmul (the port's own kernel, no TPU counterpart): |C_kernel -
    C_plain| <= 1e-5 * max|C_plain| (only the f32 summation order differs)
    at M from 1 to 200, and at nemotron-4-15b's head (256,000 x 6,144, M =
    4); two calls bitwise; an f32 operand bitwise its bf16 rounding; a
    row-pitched view and a K off the vector loads (the scalar loader)
    bitwise the contiguous, zero-padded call;
  - row-count and column-slice independence, bitwise: the rows of an M
    call equal those of calls over parts of its rows (BF16_SPLITS: a whole
    call and its parts on either side of every activation width, warpgroup
    count, chain split and grid-row count `kernels/bf16_matmul.py:plan`
    picks), and an N / 2 call the matching half of the full call, for
    `_mm` and `dense` (through bf16_matmul) at llama-200m's shapes and at
    ragged and split-straddling N (1,728, 40, 8,192, 10,240); a 128-row
    call (m64n128k16) bitwise its 64-row halves (m64n8k16), and 129 rows
    bitwise 128 + 1, on operands of wide range and cancellation; #2 at 4
    against 2 + 2 and 64 against 32 + 32, and at N / 2; #1 given the whole
    weight's absmax bitwise the whole weight's quantization on each half
    of its rows;
  - rmsnorm outside autograd (`sum_last_fixed`): a call's rows bitwise
    those of calls over parts of them, within one bf16 ulp of the CPU;
  - rwkv6-7b's 4-token verify chunk (2 layers at full width, bf16) bitwise
    the 4 decode steps it stands for;
  - streams on the card: the data-sharded bf16 engine (2 shards of 2
    slots, and of 4 slots at 128-row prefill chunks, llama-200m's first 4
    layers at full width) bitwise the unsharded engine's over both pools,
    and the model-sharded engine
    (`make_serve_mesh(1, 2)`, both model devices on the one card) bitwise
    too, under bf16 and under quartet2 with prequantized and raw weights.
"""

import asyncio
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.core import formats as F
from repro_torch.core import linear as L
from repro_torch.core import rng
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import ms_eden_requant as MR
from repro_torch.kernels import nvfp4_quant as NQ
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import lm
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.quant_probe import QuantProbe
from repro_torch.serve import decode as serve_decode
from repro_torch.serve import kv_pool as KV
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.prequant import prequantize

pytestmark = pytest.mark.cuda

ATOL, RTOL = 5e-6, 1e-5


@pytest.fixture(autouse=True)
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.manual_seed(0)
    return torch.device("cuda")


def _signed_ordinal(codes: torch.Tensor) -> torch.Tensor:
    c = F.unpack_fp4(codes).long()
    idx = c & 7
    return torch.where((c & 8) > 0, -idx, idx)


def assert_quant_close(kern, plain):
    pk, sk, gk = kern
    pr, sr, gr = plain
    assert torch.equal(gk.cpu(), gr.cpu())
    assert torch.equal(sk.cpu(), sr.cpu())
    ok, orr = _signed_ordinal(pk.cpu()), _signed_ordinal(pr.cpu())
    diff = ok != orr
    assert diff.double().mean().item() < 1e-4
    assert ((ok - orr).abs()[diff] <= 1).all()


@pytest.mark.parametrize("m,k", [(4, 1280), (64, 1280), (4, 3456), (64, 3456),
                                 (3, 64), (1280, 3456)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nvfp4_fos_quant_matches_plain(dev, m, k, dtype):
    g = torch.Generator(device=dev).manual_seed(m * k)
    x = (torch.randn((m, k), generator=g, device=dev)
         * torch.exp(torch.randn((m, k), generator=g, device=dev))).to(dtype)
    kern = ops.nvfp4_fos_quant(x)
    torch.cuda.synchronize()
    assert_quant_close(kern, NQ.nvfp4_fos_quant_plain(x))


def test_nvfp4_fos_quant_zero_and_counts(dev):
    ops.reset_launches()
    p, s, gs = ops.nvfp4_fos_quant(torch.zeros((4, 64), device=dev))
    assert int(p.abs().sum()) == 0 and int(s.sum()) == 0 and float(gs) == 1.0
    ops.nvfp4_fos_quant(torch.zeros((4, 64)))  # plain version: not counted
    assert ops.LAUNCHES["nvfp4_fos_quant"] == 1


# both plan regimes at their boundary (the last cluster shape) and one past
# it, in chunks of 8; deepseek-v3's decode shapes
QUANT_REGIME_SHAPES = [(4, 2 * NQ.SMALL_MAX_CHUNKS), (4, 2 * NQ.SMALL_MAX_CHUNKS + 16),
                       (8, 7168), (4, 7168), (4, 1536), (8, 2048)]


@pytest.mark.parametrize("m,k", QUANT_REGIME_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nvfp4_fos_quant_regimes_match_plain(dev, m, k, dtype):
    """Either regime against the plain version, and the other regime forced
    on the same input: bitwise the same outputs (max and encode commute)."""
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = (torch.randn((m, k), generator=g, device=dev)
         * torch.exp(torch.randn((m, k), generator=g, device=dev))).to(dtype)
    kern = ops.nvfp4_fos_quant(x)
    torch.cuda.synchronize()
    assert_quant_close(kern, NQ.nvfp4_fos_quant_plain(x))
    chunks = m * k // NQ.CHUNK
    if chunks <= NQ.SMALL_MAX_CHUNKS:  # a cluster holds it
        other = (NQ.two_pass_plan(chunks) if NQ.plan(m, k).regime == "cluster"
                 else NQ.cluster_plan(chunks))
        out = tuple(torch.empty_like(t) for t in kern)
        NQ.launch(x, *out, p=other)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(kern, out))


def _threshold_tensor(dev, m, k, dtype):
    """x whose non-maximal elements of each 16-group sit at +-t * d for the
    FP4 rounding thresholds t (0.25 ... 3.5) and d the group's kept denom
    (scale * gscale, from the plain version), so x / d lands on a threshold
    or one rounding away from it."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype).float()
    _, sb, gs = NQ.nvfp4_fos_quant_plain(x.to(dtype))
    d = torch.repeat_interleave(F.bits_to_e4m3(sb) * gs, 16, dim=-1)
    t = torch.tensor([0.25, 0.75, 1.25, 1.75, 2.5, 3.5], device=dev)
    t = t[torch.arange(k, device=dev) % 6] * torch.where(
        torch.arange(k, device=dev) % 4 < 2, 1.0, -1.0)
    grp = x.reshape(m, k // 16, 16).abs()
    is_max = (grp == grp.amax(-1, keepdim=True)).reshape(m, k)
    return torch.where(is_max, x, t * d).to(dtype)


@pytest.mark.parametrize("m,k", [(4, 1280), (2048, 1280)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["zero", "huge_last", "denormal", "thresholds"])
def test_nvfp4_fos_quant_edge_inputs(dev, m, k, dtype, case):
    """All zeros; one huge element in the last chunk (the last CTA of either
    regime); denormal values only; values on the FP4 rounding thresholds."""
    g = torch.Generator(device=dev).manual_seed(3)
    if case == "zero":
        x = torch.zeros((m, k), device=dev, dtype=dtype)
    elif case == "huge_last":
        x = torch.randn((m, k), generator=g, device=dev).to(dtype)
        x[-1, -1] = 3e4
    elif case == "denormal":
        x = (torch.randn((m, k), generator=g, device=dev) * 1e-39).to(dtype)
    else:
        x = _threshold_tensor(dev, m, k, dtype)
    kern = ops.nvfp4_fos_quant(x)
    torch.cuda.synchronize()
    assert_quant_close(kern, NQ.nvfp4_fos_quant_plain(x))
    if case == "zero":
        assert float(kern[2]) == 1.0 and int(kern[0].sum()) == 0


@pytest.mark.parametrize("m,k", [(4, 1280), (4, 3456), (8, 7168), (4, 16384),
                                 (2048, 1280)])
def test_nvfp4_fos_quant_launches_only_its_kernels(dev, m, k):
    """No PyTorch kernel (no abs, no amax) in a call: one cluster kernel at
    decode sizes, the absmax and encode kernels above them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((m, k), device=dev).bfloat16()
    ops.nvfp4_fos_quant(x)  # build and warm up outside the window
    torch.cuda.synchronize()
    ops.reset_launches()
    NQ.REGIME_LAUNCHES.update(cluster=0, two_pass=0)
    want = (["nvfp4_fos_quant_cluster_kernel"] if NQ.plan(m, k).regime == "cluster"
            else ["nvfp4_fos_quant_absmax_kernel", "nvfp4_fos_quant_encode_kernel"])

    def profiled_names():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.nvfp4_fos_quant(x)
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA for _ in range(e.count)]

    # the profiler has once missed a kernel of a two-kernel call: the
    # profiled call is retried once before the names are judged (the
    # launch counters below count both calls)
    names = profiled_names()
    calls = 1
    if sorted(w for n in names for w in want if w in n) != sorted(want):
        names = profiled_names()
        calls = 2
    assert sorted(w for n in names for w in want if w in n) == sorted(want), names
    assert len(names) == len(want), names
    assert ops.LAUNCHES["nvfp4_fos_quant"] == calls
    regime = NQ.plan(m, k).regime
    assert NQ.REGIME_LAUNCHES == {"cluster": calls * (regime == "cluster"),
                                  "two_pass": calls * (regime == "two_pass"),
                                  "given_absmax": 0}


FP4_MATMUL_NK = [(1280, 1280), (3456, 1280), (1280, 3456), (576, 16), (576, 48),
                 (576, 2048), (576, 7168)]


def _fp4_operands(dev, m, n, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = ops.nvfp4_fos_quant(torch.randn((m, k), generator=g, device=dev))
    b = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device=dev))
    return a[0], a[1], b[0], b[1], a[2], b[2]


# both regimes and their boundary (M <= 16: the weight-streaming kernel,
# M > 16: the wgmma kernel); N = 576 off both kernels' tiles; K = 16 and 48
# (not a multiple of 32 or 64: the byte-load paths)
# M = 16 and 20: a speculative verify chunk of 4 slots x (spec_k + 1) rows
# at spec_k 3 (the last gemv row count) and 4 (wgmma)
@pytest.mark.parametrize("m", [4, 64, 5, 1, 8, 15, 16, 17, 20, 63, 65, 2048])
@pytest.mark.parametrize("n,k", FP4_MATMUL_NK)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fp4_matmul_matches_plain(dev, m, n, k, out_dtype):
    args = _fp4_operands(dev, m, n, k, m + n + k)
    FM.REGIME_LAUNCHES.update(gemv=0, mma=0)
    c = ops.fp4_matmul(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    regime = "gemv" if m <= FM.GEMV_MAX_M else "mma"
    assert FM.REGIME_LAUNCHES == {"gemv": int(regime == "gemv"),
                                  "mma": int(regime == "mma")}
    ref = FM.fp4_matmul_plain(*args)
    assert c.shape == (m, n) and c.dtype == out_dtype
    if out_dtype == torch.float32:
        err = (c - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err
    else:  # the bf16 rounding of a result within the f32 bar
        err = (c.float() - ref).abs()
        assert (err <= 2.0**-8 * ref.abs() + 1e-5 * ref.abs().max()).all()


@pytest.mark.parametrize("m,n,k", [(8, 2048, 7168), (4, 7168, 16384),
                                   (2048, 1280, 3456), (65, 576, 48)])
def test_fp4_matmul_deterministic_and_bf16_is_cast(dev, m, n, k):
    """Two calls agree bit for bit (split-K partials summed in a fixed
    order, no atomics), and the bf16 output is bitwise the f32 output's
    round to nearest."""
    args = _fp4_operands(dev, m, n, k, 3)
    c1, c2 = ops.fp4_matmul(*args), ops.fp4_matmul(*args)
    cb = ops.fp4_matmul(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2)
    assert torch.equal(cb, c1.to(torch.bfloat16))


@pytest.mark.parametrize("m", [8, 64])
def test_fp4_matmul_zero_and_extreme_operands(dev, m):
    """All-zero operands give exact zeros; the largest block values (e2m1 6
    x e4m3 448 in every element) give K * 2688^2 * ga * gb exactly (a sum
    of equal powers-of-two multiples stays exact in f32), and its bf16
    rounding in bf16."""
    n, k = 96, 512
    zp = torch.zeros((m, k // 2), dtype=torch.uint8, device=dev)
    zs = torch.zeros((m, k // 16), dtype=torch.uint8, device=dev)
    one = torch.ones((), device=dev)
    wz = (torch.zeros((n, k // 2), dtype=torch.uint8, device=dev),
          torch.zeros((n, k // 16), dtype=torch.uint8, device=dev))
    c = ops.fp4_matmul(zp, zs, *wz, one, one)
    assert int((c != 0).sum()) == 0
    # code 7 (6.0) in both nibbles, scale bits 0x7E (448); A negated (code 15)
    ap = torch.full((m, k // 2), 0xFF, dtype=torch.uint8, device=dev)
    asb = torch.full((m, k // 16), 0x7E, dtype=torch.uint8, device=dev)
    bp = torch.full((n, k // 2), 0x77, dtype=torch.uint8, device=dev)
    bsb = torch.full((n, k // 16), 0x7E, dtype=torch.uint8, device=dev)
    ga = torch.full((), 0.5, device=dev)
    gb = torch.full((), 2.0**-10, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        c = ops.fp4_matmul(ap, asb, bp, bsb, ga, gb, out_dtype=dt)
        ref = FM.fp4_matmul_plain(ap, asb, bp, bsb, ga, gb, dt)
        torch.cuda.synchronize()
        assert torch.equal(c, ref)
        exact = torch.tensor(-k * 2688.0**2 * 0.5 * 2.0**-10).to(dt)
        assert float(c[0, 0]) == float(exact)


def _pool_case(dev, b, sq, h, kv, hd, bs, maxb, lens, window=None,
               dead_rows=(), q_dtype=torch.bfloat16, seed=0, scale=3.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * maxb + 3
    perm = torch.randperm(n_blocks, generator=g).tolist()
    table = torch.full((b, maxb), n_blocks, dtype=torch.int32)
    for i, n in enumerate(lens):
        if i in dead_rows:
            continue
        for j in range(-(-n // bs)):
            table[i, j] = perm.pop()
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    q = torch.randn((b, sq, h, hd), generator=g).to(q_dtype)
    kp = (torch.randn((n_blocks, bs, kv, hd), generator=g) * scale).bfloat16()
    vp = (torch.randn((n_blocks, bs, kv, hd), generator=g) * scale).bfloat16()
    return [t.to(dev) for t in (q, kp, vp, table, pos)], window


# Cases of the split-KV kernels (kernels/paged_attention.py:plan cuts the
# keys into splits of SPLIT_KEYS = 16, or one block of 32): every block size,
# a 1,024-token row at maxb 64, lengths ending on a split boundary and one
# past it (Sq 1 and 16), and windows that leave whole splits dead.
SPLIT_CASES = [
    *(dict(b=3, sq=1, h=8, kv=2, hd=128, bs=bs, maxb=256 // bs,
           lens=[40, 256, 129], seed=bs) for bs in (4, 8, 16, 32)),
    dict(b=3, sq=1, h=10, kv=10, hd=128, bs=16, maxb=64, lens=[1024, 517, 300],
         dead_rows=(2,)),
    dict(b=4, sq=1, h=4, kv=2, hd=128, bs=16, maxb=8, lens=[32, 33, 64, 65]),
    dict(b=4, sq=16, h=4, kv=2, hd=128, bs=16, maxb=8, lens=[32, 33, 64, 65]),
    dict(b=3, sq=1, h=8, kv=2, hd=128, bs=16, maxb=16, lens=[250, 100, 33],
         window=40),
    dict(b=2, sq=16, h=8, kv=2, hd=64, bs=8, maxb=32, lens=[256, 70],
         window=50),
]
# The registry's other group sizes at hd 128, decode and Sq 16 chunks:
# nemotron-4-15b (H 48, KV 8: 6 rows a KV head, which no row-group count
# divides) and chatglm3-6b (H 32, KV 2: 16 rows, 256 at Sq 16, spread over 4
# warp groups of up to 4 rows a chunk).
GROUP_CASES = [
    dict(b=4, sq=1, h=48, kv=8, hd=128, bs=16, maxb=16, lens=[47, 100, 131, 18],
         dead_rows=(3,)),
    dict(b=4, sq=16, h=48, kv=8, hd=128, bs=16, maxb=16, lens=[16, 64, 100, 33]),
    dict(b=4, sq=1, h=32, kv=2, hd=128, bs=16, maxb=16, lens=[47, 100, 131, 18]),
    dict(b=4, sq=16, h=32, kv=2, hd=128, bs=16, maxb=16, lens=[16, 64, 100, 33],
         dead_rows=(2,)),
]

# Head dims above 128 (a lane owns 8 dims): recurrentgemma-9b's lattn
# layers (H 16, KV 1, hd 256, window 2,048) at decode and Sq 16, a dead row;
# 4,096-token tables under windows of 2,048 and 64 (whole splits dead); BS 32
# (32 KB of bf16 tiles a CTA); and hd 136, above 128 but no power of two.
# K/V at unit scale, as chip_smoke.py's bf16 cases: at 3x data the plain
# version itself lies up to 9.5e-6 from float64 at hd 256 Sq 16 (the
# kernel 2.8e-6; tools/gqa_split_probe.py), past the bar around either, so
# there the kernel is held to float64 (test_paged_gqa_hd256_against_float64).
HD256_CASES = [
    dict(b=4, sq=1, h=16, kv=1, hd=256, bs=16, maxb=16, lens=[47, 100, 131, 18],
         dead_rows=(3,), window=2048),
    dict(b=4, sq=16, h=16, kv=1, hd=256, bs=16, maxb=16, lens=[16, 64, 100, 33],
         window=2048),
    dict(b=2, sq=1, h=16, kv=1, hd=256, bs=16, maxb=256, lens=[4096, 3000],
         window=2048),
    dict(b=2, sq=16, h=16, kv=1, hd=256, bs=16, maxb=256, lens=[4096, 2100],
         window=64),
    dict(b=3, sq=4, h=16, kv=1, hd=256, bs=32, maxb=8, lens=[100, 256, 33],
         window=64),
    dict(b=2, sq=1, h=4, kv=2, hd=136, bs=8, maxb=8, lens=[20, 64]),
]
HD256_CASES = [dict(c, scale=1.0) for c in HD256_CASES]


@pytest.mark.parametrize("case", [
    # llama-200m decode and prefill chunk: H 10, KV 10, hd 128, BS 16
    dict(b=4, sq=1, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[37, 100, 1, 256]),
    dict(b=4, sq=16, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[16, 64, 100, 17]),
    # a speculative verify chunk: Sq 4 from mid-sequence positions
    dict(b=4, sq=4, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[51, 100, 133, 20]),
    # yi-9b grouped heads: H 32, KV 4
    dict(b=4, sq=1, h=32, kv=4, hd=128, bs=16, maxb=16, lens=[5, 130, 77, 200]),
    dict(b=2, sq=16, h=32, kv=4, hd=128, bs=16, maxb=16, lens=[40, 200]),
    # window, sentinel (dead) row, small blocks, f32 q, head dim 32
    dict(b=3, sq=4, h=4, kv=2, hd=32, bs=4, maxb=8, lens=[9, 30, 12],
         window=6, dead_rows=(1,), q_dtype=torch.float32),
    dict(b=3, sq=1, h=4, kv=4, hd=64, bs=8, maxb=4, lens=[3, 32, 20],
         window=11, dead_rows=(0,)),
    *SPLIT_CASES,
    *GROUP_CASES,
    *HD256_CASES,
])
def test_paged_gqa_matches_plain(dev, case):
    (q, kp, vp, table, pos), window = _pool_case(dev, **case)
    out = ops.paged_gqa(q, kp, vp, table, pos, window=window)
    again = ops.paged_gqa(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    ref = PA.paged_gqa_plain(q, kp, vp, table, pos, window=window)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, again)  # fixed-order split merge: same bits
    for r in case.get("dead_rows", ()):
        assert int((out[r] != 0).sum()) == 0  # fully masked row: exact zeros


@pytest.mark.parametrize("case", [
    # llama-200m decode and prefill chunk: H 10, KV 10, hd 128, BS 16
    dict(b=4, sq=1, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[37, 100, 1, 256]),
    dict(b=4, sq=16, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[16, 64, 100, 17]),
    # grouped heads, window, dead row, f32 q, small blocks
    dict(b=3, sq=4, h=4, kv=2, hd=32, bs=4, maxb=8, lens=[9, 30, 12],
         window=6, dead_rows=(1,), q_dtype=torch.float32),
    dict(b=3, sq=1, h=8, kv=2, hd=64, bs=32, maxb=4, lens=[3, 100, 40],
         dead_rows=(0,)),
    # yi-9b grouped heads (H 32, KV 4) over the packed pool, decode and chunk
    dict(b=4, sq=1, h=32, kv=4, hd=128, bs=16, maxb=16, lens=[5, 130, 77, 200]),
    dict(b=2, sq=16, h=32, kv=4, hd=128, bs=16, maxb=16, lens=[40, 200]),
    *SPLIT_CASES,
    *GROUP_CASES,
    *HD256_CASES[:5],
])
def test_paged_gqa_q_matches_plain(dev, case):
    (q, kp, vp, table, pos), window = _pool_case(dev, **case)
    (kc, ks), (vc, vs) = F.nvfp4_cache_encode(kp), F.nvfp4_cache_encode(vp)
    ops.reset_launches()
    out = ops.paged_gqa_q(q, kc, ks, vc, vs, table, pos, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_gqa_q"] == 1 and ops.LAUNCHES["paged_gqa"] == 0
    again = ops.paged_gqa_q(q, kc, ks, vc, vs, table, pos, window=window)
    ref = PA.paged_gqa_q_plain(q, kc, ks, vc, vs, table, pos, window=window)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, again)  # fixed-order split merge: same bits
    for r in case.get("dead_rows", ()):
        assert int((out[r] != 0).sum()) == 0


def _f64_attention(q, k, v, pos, window):
    """decode_sdpa's attention in float64 over gathered (B, T, KV, d) views."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qd = q.double().reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqgrd,btgd->bgrqt", qd, k.double()) / hd ** 0.5
    qpos = pos.long()[:, None] + torch.arange(sq, device=q.device)[None]
    kj = torch.arange(k.shape[1], device=q.device)[None, None]
    ok = kj <= qpos[..., None]
    if window is not None:
        ok &= kj > qpos[..., None] - window
    p = torch.softmax(torch.where(ok[:, None, None], s, -1e30), -1)
    return torch.einsum("bgrqt,btgv->bqgrv", p, v.double()).reshape(b, sq, h, -1)


@pytest.mark.parametrize("case", [dict(c, scale=3.0) for c in HD256_CASES[:5]])
def test_paged_gqa_hd256_against_float64(dev, case):
    """At 3x data the kernel at hd 256 lies within the attention bar of the
    same attention in float64 (the plain f32 version need not)."""
    (q, kp, vp, table, pos), window = _pool_case(dev, **case)
    out = ops.paged_gqa(q, kp, vp, table, pos, window=window)
    truth = _f64_attention(q, KV.gather_view(kp, table),
                           KV.gather_view(vp, table), pos, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.double(), truth, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("packed", [False, True], ids=["bf16", "nvfp4"])
def test_paged_gqa_refuses_head_dims_above_256(dev, packed):
    (q, kp, vp, table, pos), _ = _pool_case(dev, b=2, sq=1, h=4, kv=2, hd=272,
                                            bs=16, maxb=4, lens=[20, 64])
    with pytest.raises(ValueError, match="head dims above 256"):
        if packed:
            (kc, ks), (vc, vs) = F.nvfp4_cache_encode(kp), F.nvfp4_cache_encode(vp)
            ops.paged_gqa_q(q, kc, ks, vc, vs, table, pos)
        else:
            ops.paged_gqa(q, kp, vp, table, pos)


def _mla_case(dev, b, sq, h, lora, rope, bs, maxb, lens, dead_rows=(),
              rope_dtype=torch.bfloat16, seed=0, q_scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * maxb + 3
    perm = torch.randperm(n_blocks, generator=g).tolist()
    table = torch.full((b, maxb), n_blocks, dtype=torch.int32)
    for i, n in enumerate(lens):
        if i in dead_rows:
            continue
        for j in range(-(-n // bs)):
            table[i, j] = perm.pop()
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    qa = torch.randn((b, sq, h, lora), generator=g) * (0.1 * q_scale)
    qr = (torch.randn((b, sq, h, rope), generator=g)).to(rope_dtype)
    cc = torch.randn((n_blocks, bs, lora), generator=g).bfloat16()
    kc = (torch.randn((n_blocks, bs, rope), generator=g) * 2).bfloat16()
    return [t.to(dev) for t in (qa, qr, cc, kc, table, pos)]


MLA_CASES = [
    # deepseek-v3: H 128, lora 512, rope 64 (qk_dim 192), BS 16; decode and
    # a 16-token prefill chunk; ragged lengths and an inactive row
    dict(b=4, sq=1, h=128, lora=512, rope=64, bs=16, maxb=16,
         lens=[37, 100, 1, 200], dead_rows=(2,)),
    dict(b=4, sq=16, h=128, lora=512, rope=64, bs=16, maxb=16,
         lens=[16, 64, 100, 17], dead_rows=(3,)),
    # a speculative verify chunk: Sq 4 from mid-sequence positions
    dict(b=4, sq=4, h=128, lora=512, rope=64, bs=16, maxb=16,
         lens=[44, 61, 76, 29]),
    # reduced widths, f32 q_rope, BS 4 and BS 32 (dynamic shared memory
    # above 48 KB at lora 512)
    dict(b=3, sq=3, h=4, lora=32, rope=16, bs=4, maxb=8, lens=[6, 14, 0],
         dead_rows=(2,), rope_dtype=torch.float32),
    dict(b=2, sq=2, h=8, lora=512, rope=64, bs=32, maxb=4, lens=[70, 128]),
    # deepseek-v3 at 4 rows x 4,096 tokens (#8: 29 splits of 9 blocks)
    dict(b=4, sq=1, h=128, lora=512, rope=64, bs=16, maxb=256,
         lens=[4096, 4096, 4096, 4096]),
    # Sq 16 where the scratch cap binds (#8: 3 splits of 22, 22, 20 blocks)
    dict(b=2, sq=16, h=128, lora=512, rope=64, bs=16, maxb=64,
         lens=[1000, 517]),
    # deepseek-v3 widths stressing #7's three-term split, both with an f32
    # q_rope (three terms too) and ragged rows over several splits: q_abs
    # scaled by 10 (the latent part dominates) and by 1e-4 (the rope part
    # does). Ten is the largest power of ten at which the plain f32 version
    # itself stays within the bar of the float64 function
    # (tests/test_torch_paged_attention.py): at 1e2 and 1e4 near-tied scores
    # in the hundreds move any f32 order's output past it.
    dict(b=4, sq=1, h=128, lora=512, rope=64, bs=16, maxb=32,
         lens=[500, 37, 0, 300], dead_rows=(2,), rope_dtype=torch.float32,
         q_scale=10.0),
    dict(b=3, sq=2, h=128, lora=512, rope=64, bs=8, maxb=48,
         lens=[380, 129, 2], rope_dtype=torch.float32, q_scale=1e-4),
]


@pytest.mark.parametrize("case", MLA_CASES)
@pytest.mark.parametrize("packed", [False, True], ids=["bf16", "nvfp4"])
def test_paged_mla_matches_plain(dev, case, packed):
    qa, qr, cc, kc, table, pos = _mla_case(dev, **case)
    qk_dim = 128 + case["rope"]
    ops.reset_launches()
    if packed:
        (ccc, ccs), (kcc, kcs) = F.nvfp4_cache_encode(cc), F.nvfp4_cache_encode(kc)
        out = ops.paged_mla_q(qa, qr, ccc, ccs, kcc, kcs, table, pos,
                              qk_dim=qk_dim)
        torch.cuda.synchronize()
        ref = PA.paged_mla_q_plain(qa, qr, ccc, ccs, kcc, kcs, table, pos,
                                   qk_dim)
    else:
        out = ops.paged_mla(qa, qr, cc, kc, table, pos, qk_dim=qk_dim)
        torch.cuda.synchronize()
        ref = PA.paged_mla_plain(qa, qr, cc, kc, table, pos, qk_dim)
    name = "paged_mla_q" if packed else "paged_mla"
    assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
    assert out.dtype == torch.float32 and out.shape == qa.shape
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    for r in case.get("dead_rows", ()):
        assert int((out[r] != 0).sum()) == 0  # inactive row: exact zeros
    again = (ops.paged_mla_q(qa, qr, ccc, ccs, kcc, kcs, table, pos,
                             qk_dim=qk_dim) if packed
             else ops.paged_mla(qa, qr, cc, kc, table, pos, qk_dim=qk_dim))
    assert torch.equal(out, again)  # fixed-order split merge: same bits



def paged_step_card_vs_cpu(arch, scheme, kv_quant):
    """Logits of four paged steps (a 16-token chunk, then three decode
    tokens) at reduced size on the card and on the CPU, same weights and
    tokens: [(card, cpu)] per step."""
    cfg = registry.get(arch).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step = serve_decode.make_paged_serve_step(cfg, scheme)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 24))
    outs = {}
    for d in ("cpu", "cuda"):
        # prequantize packs into new tensors; the raw weights are read only
        p = prequantize(_to(params, d), cfg, scheme)
        pool = KVPool(cfg, 2, 64, block_size=16, device=d, quantized=kv_quant)
        for s in range(2):
            pool.commit(s, 40)
            pool.ensure(s, 40)
        logits = []
        for start, size in ((0, 16), (16, 1), (17, 1), (18, 1)):
            t = torch.as_tensor(toks[:, start:start + size], dtype=torch.int32)
            lg, _ = step(p, pool.caches, pool.tables_device(), t.to(d),
                         torch.full((2,), start, dtype=torch.int32).to(d),
                         torch.ones(2, dtype=torch.bool).to(d))
            logits.append(lg.float().cpu())
        outs[d] = logits
    return list(zip(outs["cuda"], outs["cpu"]))


def test_paged_step_on_card_matches_cpu(dev):
    """The whole paged step at reduced size: kernels on the card against the
    plain versions on the CPU, same weights, teacher-forced tokens. bf16
    logits; the tolerance covers fp32 summation order through two layers."""
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step = serve_decode.make_paged_serve_step(cfg, "quartet2")
    from repro_torch.serve.prequant import prequantize
    outs = {}
    for d in ("cpu", "cuda"):
        p = prequantize({k: _to(v, d) for k, v in params.items()}, cfg,
                        "quartet2")
        pool = KVPool(cfg, 2, 64, block_size=16, device=d)
        for s in range(2):
            pool.commit(s, 40)
            pool.ensure(s, 40)
        rng = np.random.RandomState(0)
        logits = []
        toks = rng.randint(0, cfg.vocab, (2, 24))
        for start, size in ((0, 16), (16, 1), (17, 1), (18, 1)):
            t = torch.as_tensor(toks[:, start:start + size], dtype=torch.int32)
            lg, _ = step(p, pool.caches, pool.tables_device(), t.to(d),
                         torch.full((2,), start, dtype=torch.int32).to(d),
                         torch.ones(2, dtype=torch.bool).to(d))
            logits.append(lg.float().cpu())
        outs[d] = logits
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_pool", "nvfp4_pool"])
@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
def test_mla_moe_paged_step_on_card_matches_cpu(dev, kv_quant, scheme):
    """The reduced deepseek-v3 paged step (MLA + MoE, both pool modes):
    kernels on the card against the plain versions on the CPU. bf16 logits
    within 2e-2 (fp32 summation order through two layers); quartet2 logits
    within 0.3 relative RMS (an ulp of an absmax can move a tensor's codes,
    as for chip_smoke's reduced llama step)."""
    ops.reset_launches()
    for card, cpu in paged_step_card_vs_cpu("deepseek_v3_671b", scheme,
                                            kv_quant):
        assert torch.isfinite(card).all()
        if scheme == "bf16":
            assert (card - cpu).abs().max().item() <= 2e-2
        else:
            rel = ((card - cpu).pow(2).mean() / cpu.pow(2).mean()).sqrt()
            assert rel.item() <= 0.3
    assert ops.LAUNCHES["paged_mla_q" if kv_quant else "paged_mla"] > 0


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)


def _requant_inputs(dev, m, k, seed, zero_rows=()):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev) * torch.exp(
        torch.randn((m, k), generator=g, device=dev))
    for r in zero_rows:
        x[r] = 0
    draws = rng.HashDraws([seed, 1])
    from repro_torch.core import rht as R
    return x, draws.signs(0, R.block_size(k), dev), draws.uniform(
        1, (m, k // 16), dev)


# every operand shape of one llama-200m training step at T = 2048 tokens,
# plus small b = 16/32/64 blocks, an M that is no multiple of 128, zero rows
REQUANT_SHAPES = [(2048, 1280), (2048, 3456), (1280, 1280), (3456, 1280),
                  (1280, 3456), (1280, 2048), (3456, 2048), (96, 48),
                  (33, 80), (5, 96), (7, 64), (130, 128)]


@pytest.mark.parametrize("m,k", REQUANT_SHAPES)
def test_ms_eden_phase1_matches_plain(dev, m, k):
    x, signs, _ = _requant_inputs(dev, m, k, m + k, zero_rows=(0, m - 1))
    kern = ops.ms_eden_phase1(x, signs)
    torch.cuda.synchronize()
    plain = MR.phase1_plain(x, signs)
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,k", REQUANT_SHAPES)
@pytest.mark.parametrize("view", ["transposed", "pitched"])
def test_ms_eden_phase1_views_match_plain(dev, m, k, view):
    """x as the backward hands it (the transpose of a row-major tensor, read
    in place; M % 4 != 0 takes 4-byte chunks) or row-major rows at a pitch
    wider than K: bitwise the plain version on the same view, and the kernel
    on a contiguous copy."""
    x, signs, _ = _requant_inputs(dev, m, k, 2 * m + k, zero_rows=(0, m - 1))
    if view == "transposed":
        xv = x.T.contiguous().T
        assert MR.layout(xv)[0] == "cols"
    else:
        xv = torch.zeros((m, k + 16), device=dev)[:, 1:k + 1]  # 4-byte aligned
        xv.copy_(x)
        assert MR.layout(xv) == ("rows", k + 16)
    kern = ops.ms_eden_phase1(xv, signs)
    flat = ops.ms_eden_phase1(x, signs)
    torch.cuda.synchronize()
    plain = MR.phase1_plain(xv, signs)
    for a, b, c in zip(kern, plain, flat):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("m,k", REQUANT_SHAPES)
def test_ms_eden_phase2_matches_plain(dev, m, k):
    x, signs, u = _requant_inputs(dev, m, k, 3 * m + k)
    p1 = MR.phase1_plain(x, signs)
    kern = ops.ms_eden_phase2(p1[4], p1[1], p1[2], p1[3], u)
    torch.cuda.synchronize()
    plain = MR.phase2_plain(p1[4], p1[1], p1[2], p1[3], u)
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])


@pytest.mark.parametrize("m,k", REQUANT_SHAPES)
def test_ms_eden_phase2_hashed_matches_plain(dev, m, k):
    """Uniforms hashed in the kernel from the tag's key pair: bitwise the
    plain version on HashDraws.uniform's tensor, which is the same on the
    card and on the CPU."""
    x, signs, _ = _requant_inputs(dev, m, k, 5 * m + k)
    draws = rng.HashDraws([m, k])
    p1 = MR.phase1_plain(x, signs)
    u = draws.uniform(1, p1[1].shape, dev)
    assert torch.equal(u.cpu(), draws.uniform(1, p1[1].shape, "cpu"))
    kern = ops.ms_eden_phase2(p1[4], p1[1], p1[2], p1[3], draws.keys(1))
    torch.cuda.synchronize()
    plain = MR.phase2_plain(p1[4], p1[1], p1[2], p1[3], u)
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])


# (a, b) operand shapes of the training step's backward GEMMs at T = 2048:
# dX = E (T, N) . W^T (K, N), dW = E^T (N, T) . X^T (K, T), and ragged ones
PHASE2_PAIRS = [((2048, 1280), (1280, 1280)), ((1280, 2048), (1280, 2048)),
                ((2048, 1280), (3456, 1280)), ((1280, 2048), (3456, 2048)),
                ((2048, 3456), (1280, 3456)), ((3456, 2048), (1280, 2048)),
                ((33, 80), (7, 80)), ((5, 96), (130, 96))]


@pytest.mark.parametrize("sa,sb", PHASE2_PAIRS)
@pytest.mark.parametrize("mode", ["hashed", "uniforms", "mixed"])
def test_ms_eden_phase2_two_operands_match_plain(dev, sa, sb, mode):
    """One launch over both operands of a backward GEMM, each with its own
    absmax, gscale and key pair (or uniforms tensor): bitwise the plain
    version of each operand."""
    draws = rng.HashDraws([sa[0], sb[0]])
    ops_in, want = [], []
    for i, (m, k) in enumerate((sa, sb)):
        x, signs, _ = _requant_inputs(dev, m, k, 7 * m + k + i, zero_rows=(0,))
        p1 = MR.phase1_plain(x, signs)
        keys = draws.keys(1 + i)
        hashed = mode == "hashed" or (mode == "mixed" and i == 0)
        u = draws.uniform(1 + i, p1[1].shape, dev)
        ops_in.append((p1[4], p1[1], p1[2], p1[3], keys if hashed else u))
        want.append(MR.phase2_plain(p1[4], p1[1], p1[2], p1[3], u))
    ops.reset_launches()
    got = ops.ms_eden_phase2_batch(ops_in)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ms_eden_phase2"] == 1
    for (bits, gs), (pb, pg) in zip(got, want):
        assert torch.equal(bits, pb) and torch.equal(gs, pg)


@pytest.mark.parametrize("mode", ["hashed", "uniforms"])
def test_ms_eden_phase2_unaligned_matches_plain(dev, mode):
    """Operands whose pointers do not allow 16-byte loads take the scalar
    loads: still bitwise."""
    m, k = 130, 128
    x, signs, _ = _requant_inputs(dev, m, k, 11)
    p1 = MR.phase1_plain(x, signs)
    draws = rng.HashDraws([1, 2])
    u = draws.uniform(1, p1[1].shape, dev)

    def shifted(t):  # the same values one float past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    args = [shifted(t) for t in p1[1:4]]
    kern = ops.ms_eden_phase2(p1[4], *args, draws.keys(1) if mode == "hashed"
                              else shifted(u))
    torch.cuda.synchronize()
    plain = MR.phase2_plain(p1[4], p1[1], p1[2], p1[3], u)
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])


def test_quartet2_backward_gemm_launches_phase2_once(dev):
    """One phase-2 launch per backward GEMM: keys or uniforms tensors."""
    a, signs, ua = _requant_inputs(dev, 256, 1280, 3)
    b, _, ub = _requant_inputs(dev, 96, 1280, 4)
    draws = rng.HashDraws([3, 4])
    for u_a, u_b in ((draws.keys(1), draws.keys(2)), (ua, ub)):
        ops.reset_launches()
        ops.quartet2_backward_gemm(a, b, signs, u_a, u_b)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
            "ms_eden_phase1": 2, "ms_eden_phase2": 1, "fp4_matmul": 1}


def test_ms_eden_requant_zero_and_counts(dev):
    ops.reset_launches()
    packed, bits, gs = ops.ms_eden_requant(
        torch.zeros((4, 64), device=dev), torch.ones(64, device=dev),
        torch.rand((4, 4), device=dev))
    assert int(packed.sum()) == 0 and int(bits.sum()) == 0 and float(gs) == 1.0
    ops.ms_eden_requant(torch.zeros(4, 64), torch.ones(64), torch.rand(4, 4))
    assert ops.LAUNCHES["ms_eden_phase1"] == ops.LAUNCHES["ms_eden_phase2"] == 1


@pytest.mark.parametrize("ma,mb,d", [(2048, 1280, 1280), (1280, 3456, 2048),
                                     (96, 33, 48)])
def test_quartet2_backward_gemm_matches_plain(dev, ma, mb, d):
    a, signs, ua = _requant_inputs(dev, ma, d, ma)
    b, _, ub = _requant_inputs(dev, mb, d, mb + 1)
    c = ops.quartet2_backward_gemm(a, b, signs, ua, ub)
    torch.cuda.synchronize()
    qa = MR.phase1_plain(a, signs)
    qb = MR.phase1_plain(b, signs)
    sa = MR.phase2_plain(qa[4], *qa[1:4], ua)
    sb = MR.phase2_plain(qb[4], *qb[1:4], ub)
    ref = FM.fp4_matmul_plain(qa[0], sa[0], qb[0], sb[0], sa[1], sb[1])
    assert (c - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


def _bf16_close(a, ref):
    """One bf16 rounding apart, after fp32 sums in another order."""
    return bool(((a - ref).abs() <= 2.0**-7 * ref.abs()
                 + 1e-5 * ref.abs().max()).all())


@pytest.mark.parametrize("scheme", ["quartet2", "tetrajet_v2", "bf16"])
def test_qlinear_autograd_card_vs_cpu(dev, scheme):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 100, 128), generator=g).bfloat16()
    w = torch.randn((96, 128), generator=g) * 128 ** -0.5
    e = torch.randn((2, 100, 96), generator=g).bfloat16()
    seed = np.array([3, 4], np.uint32)
    out = {}
    for d in ("cpu", "cuda"):
        tx = x.to(d, copy=True).requires_grad_()
        tw = w.to(d, copy=True).requires_grad_()
        ops.reset_launches()
        y = L.qlinear(tx, tw, seed, scheme)
        y.backward(e.to(d))
        out[d] = (y.detach().float().cpu(), tx.grad.float().cpu(),
                  tw.grad.cpu(), dict(ops.LAUNCHES))
    (yc, dxc, dwc, _), (yg, dxg, dwg, n) = out["cpu"], out["cuda"]
    assert _bf16_close(yg, yc) and _bf16_close(dxg, dxc)
    assert (dwg - dwc).abs().max().item() <= 1e-5 * dwc.abs().max().item()
    if scheme == "quartet2":  # forward x, w; requant of E, W^T, E^T, X^T,
        # phase 2 once per backward GEMM (dX, dW)
        assert n == {"nvfp4_fos_quant": 2, "fp4_matmul": 3, "paged_gqa": 0,
                     "ms_eden_phase1": 4, "ms_eden_phase2": 2,
                     "paged_gqa_q": 0, "paged_mla": 0, "paged_mla_q": 0,
                     "bf16_matmul": 0}


def test_checkpoint_of_card_state_is_a_snapshot(dev, tmp_path):
    g = torch.Generator(device=dev).manual_seed(9)
    tree = {"w": torch.randn((64, 128), generator=g, device=dev),
            "b": torch.randn((128,), generator=g, device=dev).bfloat16(),
            "ids": torch.arange(12, dtype=torch.int32, device=dev),
            "step": 3}
    want = {k: (v.cpu().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, tree, blocking=False)
    tree["w"].add_(1.0)  # in place, as the optimizer does right after
    tree["b"].mul_(2)
    ptrs = {i: b.data_ptr() for i, b in ck._staging.items()}
    ck.save(2, tree, blocking=False)  # refills the same pinned buffers
    ck.wait()
    assert {i: b.data_ptr() for i, b in ck._staging.items()} == ptrs
    assert all(b.is_pinned() for b in ck._staging.values())
    like = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0)
            for k, v in tree.items()}
    out, meta = ck.restore(like, step=1)
    assert meta["step"] == 1 and out["step"] == 3
    for k in ("w", "b", "ids"):
        assert out[k].device.type == "cuda" and out[k].dtype == want[k].dtype
        assert torch.equal(out[k].cpu(), want[k])
    out, _ = ck.restore(like, step=2)
    assert torch.equal(out["w"].cpu(), want["w"] + 1.0)


def test_quant_probe_card_vs_cpu(dev):
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(2), "cpu")
    got = {}
    for d in ("cpu", "cuda"):
        p = {"stages": [{"l0": {k: {n: t.to(d) for n, t in v.items()}
                                for k, v in params["stages"][0]["l0"].items()
                                if k in ("mix", "ff")}}]}
        ops.reset_launches()
        got[d] = QuantProbe(every_n=2, max_sites=3,
                            registry=MetricsRegistry()).probe_params(p, step=2)
        got[d + "_launches"] = dict(ops.LAUNCHES)
    assert list(got["cuda"]) == list(got["cpu"]) and len(got["cpu"]) == 3
    for site, vals in got["cpu"].items():
        for m, v in vals.items():
            assert abs(got["cuda"][site][m] - v) <= 1e-5 * abs(v) + 1e-9, (site, m)
    n = got["cuda_launches"]
    assert (n["nvfp4_fos_quant"], n["fp4_matmul"], n["ms_eden_phase1"],
            n["ms_eden_phase2"]) == (3, 0, 3, 3)


# --------------------------------------------------------------------------
# the prefix cache's block copies and host tier on the card
# --------------------------------------------------------------------------

def _random_pool(dev, quantized, n_slots=2, max_len=64, seed=11):
    """A reduced llama pool on `dev` whose every token leaf holds random
    bytes (a PackedKV's codes and scales alike)."""
    cfg = registry.get("llama_200m").reduced()
    pool = KVPool(cfg, n_slots, max_len, block_size=16, device=dev,
                  quantized=quantized)
    g = torch.Generator(device=dev).manual_seed(seed)
    for leaf in KV.token_leaves(pool.caches):
        if leaf.dtype == torch.uint8:
            leaf.copy_(torch.randint(0, 256, leaf.shape, generator=g,
                                     device=dev, dtype=torch.uint8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev))
    return pool


def _block(pool, b):
    return [leaf[:, b].cpu().clone() for leaf in KV.token_leaves(pool.caches)]


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "nvfp4"])
def test_cow_copies_every_leaf_of_a_block(dev, quantized):
    """cow_block on the card: the new block equals its source in every
    leaf (a PackedKV's codes AND scales), and no other block moves."""
    pool = _random_pool(dev, quantized)
    pool.commit(0, 40)
    pool.ensure(0, 16)
    src = int(pool._table[0, 0])
    pool.incref(src)            # as the prefix cache holds it
    pool.release(0)
    before = {b: _block(pool, b) for b in range(pool.n_blocks + 1)}
    pool.commit(1, 40)
    dst = pool.cow_block(1, src)
    torch.cuda.synchronize()
    for b in range(pool.n_blocks + 1):
        want = before[src] if b == dst else before[b]
        assert all(torch.equal(x, y) for x, y in zip(_block(pool, b), want)), b


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "nvfp4"])
def test_host_round_trip_is_byte_identical(dev, quantized):
    """read_block_host -> write_block_host -> read_block_host on the card:
    the same bytes, pinned buffers, a PackedKV payload stays uint8."""
    pool = _random_pool(dev, quantized)
    p1, n1 = pool.read_block_host(3)
    assert p1.buf.is_pinned() and n1 <= pool.host_block_bytes
    if quantized:
        assert all(t.dtype == torch.uint8
                   for t in KV.token_leaves(p1.stages))
    pool.write_block_host(7, p1)
    p2, n2 = pool.read_block_host(7)
    assert n1 == n2 and torch.equal(p1.buf, p2.buf)
    assert all(torch.equal(x, y) for x, y in zip(_block(pool, 7),
                                                 _block(pool, 3)))
    pool.release_host(p1)
    pool.release_host(p2)
    pool.poll_host()            # both copies have run (read is synchronous)
    assert len(pool._host_free) == 2 and not pool._host_pending


def test_swap_in_survives_its_snapshot_dropped_after_dispatch(dev):
    """A swap-in whose snapshot the cache drops straight after dispatch:
    the buffer stays referenced (pending, not reusable) until the event
    behind its copy completes, and the block gets the snapshot's bytes."""
    pool = _random_pool(dev, False)
    payload, _ = pool.read_block_host(2)
    want = _block(pool, 2)
    torch.cuda._sleep(200_000_000)   # keep the stream busy: the copy waits
    pool.write_block_host(6, payload)
    pool.release_host(payload)       # as _trim_host does
    assert payload in pool._host_pending and not pool._host_free
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(_block(pool, 6), want))
    pool.poll_host()
    assert not pool._host_pending and len(pool._host_free) == 1


def test_write_table_sentinels_send_scatters_to_scratch(dev):
    """A scatter through the write table of a slot that adopted a shared
    block lands in the scratch block: the shared block and block 0 keep
    their bytes."""
    pool = _random_pool(dev, False)
    pool.commit(0, 32)
    pool.ensure(0, 32)
    shared = [int(b) for b in pool._table[0, :2]]
    for b in shared:
        pool.incref(b)
    pool.release(0)
    pool.commit(1, 48)
    pool.adopt_prefix(1, shared, 32)
    pool.ensure(1, 40)
    before = {b: _block(pool, b) for b in (0, *shared)}
    scratch = _block(pool, pool.n_blocks)
    rt, wt = KV.split_tables(pool.tables_device())
    assert int(wt[1, 0]) == int(wt[1, 1]) == pool.sentinel
    k = pool.caches[0]["l0"]["kv"][0][0]        # layer 0's K leaf
    pos = torch.arange(0, 40, dtype=torch.int32, device=dev)[None].expand(2, 40)
    vals = torch.full((2, 40, *k.shape[2:]), 7.0, dtype=torch.bfloat16,
                      device=dev)
    valid = torch.tensor([[False] * 40, [True] * 40], device=dev)
    KV.scatter_tokens(k, wt, pos.contiguous(), vals, valid)
    torch.cuda.synchronize()
    for b in (0, *shared):
        assert all(torch.equal(x, y) for x, y in zip(_block(pool, b), before[b]))
    own = int(pool._table[1, 2])
    assert (k[own, :8] == 7.0).all()              # positions 32..39
    assert not torch.equal(_block(pool, pool.n_blocks)[0], scratch[0])


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -126))) - 7)


def _recorders(eng):
    """Per (request, token index) the sampled row's f32 logits, and per
    request its slot's K/V leaves (positions on axis 1) at retirement."""
    rows, kv = {}, {}
    sample, retire = eng._sample, eng._retire_slot

    def rec_sample(last_logits):
        lf = last_logits.float().cpu()
        for i, s in enumerate(eng.slots):
            if s.req is not None:
                rows[(s.req.req_id, len(s.generated))] = lf[i]
        return sample(last_logits)

    def rec_retire(i):
        pool, n = eng.pool, eng.pool.length(i)
        blocks = torch.as_tensor(pool._table[i, :pool.blocks_for(n)],
                                 dtype=torch.long, device=eng.device)
        kv[eng.slots[i].req.req_id] = [
            leaf[:, blocks].flatten(1, 2)[:, :n].clone()
            for leaf in KV.token_leaves(pool.caches)]
        return retire(i)

    eng._sample, eng._retire_slot = rec_sample, rec_retire
    return rows, kv


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_pool", "nvfp4_pool"])
def test_prefix_streams_on_card_against_cold(dev, kv_quant):
    """scheme bf16, reduced llama on the card, the cache built with the
    host tier and LatencyPolicy: a block-aligned hot stream and a spill-hot
    one are bitwise cold. A COW stream (the match ends inside a block, so
    the rest of the prompt runs in other step shapes than the cold run's:
    cuBLAS may pick another algorithm) holds the matched positions' K/V
    byte-identical to the cold run's, and a spill-hot COW stream (the same
    step shapes) bitwise the device-hot one, K/V included; its tokens are
    bitwise cold, or else equal up to the first token whose cold top-2
    logit margin is within 2 bf16 ulps of the top logit, at least half of
    them compared (tests/_torch_streams.py's rule)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.scheduler import LatencyPolicy
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(8)
    system = rng.randint(0, cfg.vocab, 64).tolist()
    a, b, c = (rng.randint(0, cfg.vocab, 16).tolist() for _ in range(3))
    warm, probe, fork = system + a, system + b, system + a[:8] + c[:8]
    matched, new = 72, 12

    def engine(**kw):
        return ServeEngine(cfg, params, EngineConfig(
            n_slots=2, max_len=128, block_size=16, prefill_chunk=16,
            scheme="bf16", kv_quant=kv_quant, device="cuda", **kw))

    def one(eng, p):
        eng.submit(Request(list(p), new))
        return eng.run()[0].tokens

    cold_eng = engine()
    cold_rows, cold_kv = _recorders(cold_eng)
    cold_probe, cold_fork = one(cold_eng, probe), one(cold_eng, fork)
    eng = engine(prefix_cache=True, prefix_spill=True,
                 scheduler=LatencyPolicy())
    _, hot_kv = _recorders(eng)
    one(eng, warm)
    assert one(eng, probe) == cold_probe
    hot_fork = one(eng, fork)
    assert eng.stats["prefill_skipped_tokens"] == 64 + 72
    assert eng.cache.evict(None, 999) > 0 and eng.cache.cached_blocks() == 0
    assert one(eng, probe) == cold_probe             # spill-hot
    assert eng.cache.stats["swapped_in_blocks"] >= 4
    assert one(eng, fork) == hot_fork                # spill-hot COW
    for h, k in zip(hot_kv[2], cold_kv[1]):          # the fork in each
        assert torch.equal(h[:, :matched], k[:, :matched])
    assert all(torch.equal(h, k) for h, k in zip(hot_kv[2], hot_kv[4]))
    if hot_fork == cold_fork:
        return
    checked = 0
    for j in range(new):
        top2 = cold_rows[(1, j)].topk(2).values
        if float(top2[0] - top2[1]) <= 2 * _bf16_ulp(float(top2[0])):
            break
        assert hot_fork[j] == cold_fork[j], j
        checked += 1
    assert checked >= new // 2, checked


# --------------------------------------------------------------------------
# self-speculative decoding on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("arch", ["llama_200m", "deepseek_v3_671b"])
def test_forward_prefix_on_card_equals_the_cut_model(dev, arch, sq):
    """The draft stack on the card: `forward_prefix` over the first layer of
    the reduced 2-layer model, quartet2 with packed weights, bitwise
    `forward` of the config cut to that layer over the same parameters and
    a fresh pool (the same kernels on the same shapes), logits and K/V."""
    import dataclasses
    from repro_torch.serve.prequant import prequantize
    cfg = registry.get(arch).reduced()
    params = prequantize(_to(lm.init(cfg, torch.Generator().manual_seed(0),
                                     "cpu"), "cuda"), cfg, "quartet2")
    cut = dataclasses.replace(cfg, n_layers=1)
    cut_params = {**params, "stages": lm.prefix_stage_params(params, cfg, 1)}
    toks = torch.from_numpy(np.random.RandomState(sq).randint(
        0, cfg.vocab, (2, sq))).to(dev)
    pos = torch.tensor([5, 0], dtype=torch.int32, device=dev)
    act = torch.tensor([True, False], device=dev)
    outs = []
    for fwd in ("prefix", "cut"):
        pool = KVPool(cfg, 2, 16, block_size=4, device="cuda",
                      specs=lm.prefix_specs(cfg, 1))
        pool.commit(0, 16)
        pool.ensure(0, 5 + sq)
        kw = dict(caches=pool.caches, mode="decode", pos=pos, active=act,
                  block_table=pool.tables_device())
        if fwd == "prefix":
            logits, _ = lm.forward_prefix(params, cfg, {"tokens": toks},
                                          "quartet2", np.array([7, 7], np.uint32),
                                          n_prefix=1, **kw)
        else:
            logits, _ = lm.forward(cut_params, cut, {"tokens": toks}, "quartet2",
                                   np.array([7, 7], np.uint32), **kw)
        # the readable blocks: the scratch block takes the dropped writes
        # (the inactive row's), in no fixed order on the card
        outs.append((logits, [t[:, :-1] for t in KV.token_leaves(pool.caches)]))
    (a, ca), (b, cb) = outs
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))


def test_spec_engine_on_card_is_repeatable_and_frees_both_pools(dev):
    """Reduced llama, quartet2, spec_k 3 over 1 draft layer, more requests
    than slots: two runs bitwise equal (the card's forward is
    deterministic), every block of both pools free, every round through the
    kernels (#1, #2, #5 launched)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab, n).tolist() for n in (9, 20, 13, 5)]

    def run():
        eng = ServeEngine(cfg, params, EngineConfig(
            n_slots=2, max_len=64, prefill_chunk=8, spec_k=3, draft_layers=1,
            device="cuda"))
        for p in prompts:
            eng.submit(Request(p, 10))
        out = {r.req_id: r.tokens for r in eng.run()}
        assert eng.pool.free_block_count == eng.pool.n_blocks
        assert eng.draft.pool.free_block_count == eng.draft.pool.n_blocks
        assert eng.stats["spec_rounds"] > 0
        return out

    ops.reset_launches()
    a = run()
    assert all(ops.LAUNCHES[k] > 0
               for k in ("nvfp4_fos_quant", "fp4_matmul", "paged_gqa"))
    assert run() == a and all(len(t) == 10 for t in a.values())


# ---- threads: the frontend's engine thread ------------------------------

def _on_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=120)
    assert out, "the thread did not finish"
    return out[0]


def test_kernels_on_another_thread_bitwise_main_thread(dev):
    """#1, #2 (M 4: gemv, M 64: wgmma) and #5 launched from a thread that is
    not the main thread, on its current stream, give the main thread's
    bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, 1280), generator=g, device=dev).bfloat16()

    def quant():
        r = ops.nvfp4_fos_quant(x)
        torch.cuda.synchronize()
        return r

    assert all(torch.equal(a, b) for a, b in zip(quant(), _on_thread(quant)))
    for m in (4, 64):
        args = _fp4_operands(dev, m, 3456, 1280, 7)

        def mm():
            c = ops.fp4_matmul(*args)
            torch.cuda.synchronize()
            return c

        assert torch.equal(mm(), _on_thread(mm))
    (q, kp, vp, table, pos), _ = _pool_case(
        dev, b=4, sq=1, h=10, kv=10, hd=128, bs=16, maxb=16,
        lens=[37, 100, 1, 256])

    def attn():
        o = ops.paged_gqa(q, kp, vp, table, pos)
        torch.cuda.synchronize()
        return o

    ops.reset_launches()
    assert torch.equal(attn(), _on_thread(attn))
    assert ops.LAUNCHES["paged_gqa"] == 2


async def _sse_tokens(port, prompt, max_new):
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection("127.0.0.1", port), 60)
    body = json.dumps({"prompt": prompt, "max_tokens": max_new,
                       "stream": True}).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await asyncio.wait_for(writer.drain(), 60)
    toks, done = [], False
    while True:
        line = await asyncio.wait_for(reader.readline(), 60)
        if not line:
            break
        if line.startswith(b"data: "):
            if line[6:].strip() == b"[DONE]":
                done = True
                break
            toks.extend(json.loads(line[6:])["choices"][0]["tokens"])
    writer.close()
    assert done
    return toks


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "nvfp4"])
def test_sse_streams_on_card_bitwise_run(dev, kv_quant):
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.frontend import CompletionFrontend, EngineBridge
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab, n).tolist() for n in (9, 20, 13, 5)]
    econf = EngineConfig(n_slots=2, max_len=48, prefill_chunk=8,
                         scheme="bf16", kv_quant=kv_quant, device="cuda")
    eng = ServeEngine(cfg, params, econf)
    ids = [eng.submit(Request(p, 12)) for p in prompts]
    ref = {r.req_id: r.tokens for r in eng.run()}
    eng = ServeEngine(cfg, params, econf)
    ticked = set()
    step = eng.step
    eng.step = lambda: (ticked.add(threading.get_ident()), step())[1]

    async def scenario():
        bridge = EngineBridge(eng).start()
        fe = await asyncio.wait_for(CompletionFrontend(bridge).start(), 60)
        try:
            return await asyncio.wait_for(asyncio.gather(
                *[_sse_tokens(fe.port, p, 12) for p in prompts]), 120)
        finally:
            await asyncio.wait_for(fe.stop(), 60)
            bridge.stop()
            assert bridge.error is None

    ops.reset_launches()
    got = asyncio.run(scenario())
    assert got == [ref[i] for i in ids]
    assert ticked and threading.main_thread().ident not in ticked
    assert ops.LAUNCHES["paged_gqa_q" if kv_quant else "paged_gqa"] > 0
    assert eng.pool.free_block_count == eng.pool.n_blocks


# --------------------------------------------------------------------------
# dense per-slot caches and chunked attention on the card
# --------------------------------------------------------------------------

def test_dense_step_on_card_against_cpu(dev):
    """The engine's step over dense caches (no block table), reduced llama
    under scheme bf16, card against CPU over the same schedule: row 0's
    8-token prefill chunk (row 1 inactive), row 1's, then 3 decode steps of
    both rows. Logits within 2e-2 (fp32 summation order through two
    layers); each active row's argmax equal wherever the CPU's top-2 margin
    is above 2 bf16 ulps of its top logit (the tie rule), and the dense
    caches' written positions within one bf16 ulp of the CPU's."""
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(12)
    p0, p1 = rng.randint(0, cfg.vocab, 8), rng.randint(0, cfg.vocab, 8)
    steps = [([p0, [0] * 8], [0, 0], [True, False]),
             ([[0] * 8, p1], [0, 0], [False, True])]
    for d in range(3):
        t = rng.randint(0, cfg.vocab, 2)
        steps.append(([[t[0]], [t[1]]], [8 + d, 8 + d], [True, True]))
    outs = {}
    for d in ("cpu", "cuda"):
        pool = KVPool(cfg, 2, 32, paged=False, block_size=16, device=d)
        assert pool.tables_device() is None
        step = serve_decode.make_paged_serve_step(cfg, "bf16")
        p = _to(params, d)
        seq = []
        for toks, pos, act in steps:
            lg, _ = step(p, pool.caches, None,
                         torch.tensor(np.asarray(toks), dtype=torch.int32, device=d),
                         torch.tensor(pos, dtype=torch.int32, device=d),
                         torch.tensor(act, device=d))
            seq.append((lg[:, -1].float().cpu(), act))
        outs[d] = seq, [t[:, :, :11].float().cpu()
                        for t in KV.token_leaves(pool.caches)]
    (card, card_kv), (cpu, cpu_kv) = outs["cuda"], outs["cpu"]
    for (a, act), (b, _) in zip(card, cpu):
        assert torch.isfinite(a).all() and (a - b).abs().max() <= 2e-2
        for i in np.nonzero(act)[0]:
            top2 = b[i].topk(2).values
            if float(top2[0] - top2[1]) > 2 * _bf16_ulp(float(top2[0])):
                assert a[i].argmax() == b[i].argmax()
    for a, b in zip(card_kv, cpu_kv):
        assert (a - b).abs().max() <= _bf16_ulp(float(b.abs().max()))


@pytest.mark.parametrize("window", [None, 1536])
def test_chunked_sdpa_on_card_against_sdpa(dev, window):
    """chunked_sdpa at its own blocks (1,024 queries x 1,024 keys) over
    2,048 tokens at llama-200m's heads (10 x 128), f32, against plain sdpa
    on the card within 2e-3 (the reference's bar); two calls bitwise."""
    from repro_torch.models import attention as A
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn((1, 2048, 10, 128), generator=g, device=dev)
               for _ in range(3))
    out = A.chunked_sdpa(q, k, v, causal=True, window=window)
    again = A.chunked_sdpa(q, k, v, causal=True, window=window)
    ref = A.sdpa(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 2e-3


# --------------------------------------------------------------------------
# whisper's shapes and the disaggregated pair on the card
# --------------------------------------------------------------------------

# whisper-tiny (d 384, d_ff 1,536): a decode step of 4 rows (the cross K/V
# projected from 4 x 1,500 encoder frames) and a training step of 8 x
# (1,500 frames, 448 tokens): T 3,584 decoder and 12,000 encoder tokens
WHISPER_MK = [(4, 384), (4, 1536), (6000, 384), (3584, 384), (3584, 1536),
              (12000, 384), (12000, 1536)]
WHISPER_MNK = [(4, 384, 384), (4, 1536, 384), (4, 384, 1536), (6000, 384, 384),
               (3584, 1536, 384), (3584, 384, 1536), (12000, 384, 384),
               (3584, 384, 3584), (1536, 384, 12000), (12000, 384, 1536)]
WHISPER_REQUANT = [(3584, 384), (3584, 1536), (384, 3584), (1536, 12000),
                   (12000, 384), (384, 1536)]


@pytest.mark.parametrize("m,k", WHISPER_MK)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nvfp4_fos_quant_at_whisper_shapes(dev, m, k, dtype):
    g = torch.Generator(device=dev).manual_seed(m * 7 + k)
    x = (torch.randn((m, k), generator=g, device=dev)
         * torch.exp(torch.randn((m, k), generator=g, device=dev))).to(dtype)
    kern = ops.nvfp4_fos_quant(x)
    torch.cuda.synchronize()
    assert_quant_close(kern, NQ.nvfp4_fos_quant_plain(x))


@pytest.mark.parametrize("m,n,k", WHISPER_MNK)
def test_fp4_matmul_at_whisper_shapes(dev, m, n, k):
    args = _fp4_operands(dev, m, n, k, m + 3 * n + k)
    c = ops.fp4_matmul(*args)
    torch.cuda.synchronize()
    ref = FM.fp4_matmul_plain(*args)
    assert (c - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("m,k", WHISPER_REQUANT)
def test_ms_eden_phases_at_whisper_shapes(dev, m, k):
    """Phase 1 on the operand and on its transposed view (as the backward
    hands E^T and X^T), phase 2 with hashed uniforms: bitwise the plain
    versions (k 12,000 takes RHT blocks of 32)."""
    x, signs, _ = _requant_inputs(dev, m, k, 11 * m + k)
    xv = x.T.contiguous().T
    p1, p1v = ops.ms_eden_phase1(x, signs), ops.ms_eden_phase1(xv, signs)
    torch.cuda.synchronize()
    plain = MR.phase1_plain(x, signs)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(p1, plain, p1v))
    draws = rng.HashDraws([m, k])
    keys = draws.keys(3)
    kern = ops.ms_eden_phase2(plain[4], plain[1], plain[2], plain[3], keys)
    torch.cuda.synchronize()
    ref = MR.phase2_plain(plain[4], plain[1], plain[2], plain[3],
                          draws.uniform(3, plain[1].shape, dev))
    assert torch.equal(kern[0], ref[0]) and torch.equal(kern[1], ref[1])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "nvfp4"])
def test_disagg_pair_round_trip_on_card(dev, kv_quant):
    """A handoff's payload bytes equal the prefill pool's blocks, and the
    decode pool's blocks after the import equal the payload (bitwise); the
    pair's bf16 streams equal the single engine's; at the end both pools
    hold no block and every pinned payload buffer is back on the prefill
    pool's free list."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.frontend import make_disagg_pair
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng_ = np.random.RandomState(5)
    prompts = [rng_.randint(0, cfg.vocab, n).tolist() for n in (40, 9, 23, 17)]
    econf = EngineConfig(n_slots=2, max_len=64, prefill_chunk=8, scheme="bf16",
                         kv_quant=kv_quant, device="cuda")
    eng = ServeEngine(cfg, params, econf)
    ids = [eng.submit(Request(p, 10)) for p in prompts]
    ref = {r.req_id: r.tokens for r in eng.run()}
    pair = make_disagg_pair(cfg, params, econf)
    pe, de = pair.prefill, pair.decode
    assert [pair.submit(Request(p, 10)) for p in prompts] == ids
    while not pe.handoffs:
        pe.step()
    h = pe.handoffs[0]
    torch.cuda.synchronize()
    assert all(p.buf.is_pinned() for _, p in h.blocks)
    leaves = KV.token_leaves(pe.pool.caches)
    exported = {}
    for j, p in h.blocks:
        exported[j] = [t.clone() for t in KV.token_leaves(p.stages)]
        # the prefill worker released the blocks; nothing has reused them
        blk = [b for b in range(pe.pool.n_blocks)
               if all(torch.equal(x[:, b].cpu(), y)
                      for x, y in zip(leaves, exported[j]))]
        assert blk, j
    pair.decode.submit_handoff(pe.handoffs.popleft())
    de._admit()
    torch.cuda.synchronize()
    i = next(i for i, s in enumerate(de.slots) if s.req is h.req)
    for j, want in exported.items():
        b = int(de.pool._table[i, j])
        assert all(torch.equal(x[:, b].cpu(), y) for x, y in
                   zip(KV.token_leaves(de.pool.caches), want))
    got = {r.req_id: r.tokens for r in pair.run()}
    assert got == ref
    torch.cuda.synchronize()
    pe.pool.poll_host()
    assert pe.pool.free_block_count == pe.pool.n_blocks
    assert de.pool.free_block_count == de.pool.n_blocks
    assert len(pe.pool._host_free) == pe.pool.host_allocs > 0
    assert pe.stats["handoffs"] == len(prompts) and de.stats["prefill_steps"] == 0


# --------------------------------------------------------------------------
# the distribution layer (dist/): what one card can hold
# --------------------------------------------------------------------------

def test_sr_roundtrip_on_the_card_equals_the_cpu(dev):
    """The compression's SR round trip is plain PyTorch: the card's equals
    the CPU's bitwise for the same uniforms (the hashed draws are the same
    on both devices)."""
    from repro_torch.dist import compression as C
    x = torch.randn(3001, 37) * 5
    draws = C.rank_draws(np.array([4, 2], np.uint32), 1)
    shape = (1, C._padded(x.numel()))
    u = draws.uniform(7, shape, "cpu")
    assert torch.equal(draws.uniform(7, shape, dev).cpu(), u)
    want = C._sr_roundtrip(x, u)
    assert torch.equal(C._sr_roundtrip(x.to(dev), u.to(dev)).cpu(), want)


@pytest.fixture
def nccl_world1(dev, tmp_path):
    from repro_torch import dist as D
    D.init("nccl", 0, 1, f"file://{tmp_path}/store", timeout_s=60)
    yield
    D.shutdown()


def test_gpipe_and_compression_at_world_size_1_over_nccl(dev, nccl_world1):
    """One stage over NCCL: the pipe is its stage applied to each
    microbatch (quartet2 qlinear: #1 and #2 each tick), bitwise; the
    compressed mean of one rank is its round trip, bitwise."""
    from repro_torch.dist import compression as C
    from repro_torch.dist import pipeline as PP
    stage = lambda w, x: torch.tanh(L.qlinear(x, w, None, "quartet2"))  # noqa
    ws = torch.randn(1, 256, 256, device=dev) / 16
    xs = torch.randn(3, 32, 256, device=dev)
    ops.reset_launches()
    with torch.no_grad():
        got = PP.gpipe(stage, 1, 3)(ws, xs)
        assert (ops.LAUNCHES["nvfp4_fos_quant"], ops.LAUNCHES["fp4_matmul"]) == (6, 3)
        want = torch.stack([stage(ws[0], x) for x in xs])
    assert torch.equal(got, want)
    x = torch.randn(1000, 7, device=dev)
    seed = np.array([3, 9], np.uint32)
    u = C.rank_draws(seed, 0).uniform(2, (1, C._padded(x.numel())), dev)
    assert torch.equal(C.compressed_psum_mean(x, None, seed, tag=2),
                       C._sr_roundtrip(x, u))


def test_dp_step_at_world_size_1_over_nccl_is_the_plain_step(dev, nccl_world1):
    import torch.distributed as tdist
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    cfg = registry.get("llama_200m").reduced()
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=4))
    runs = []
    for group in (tdist.group.WORLD, None):
        init, step = make_train_step(cfg, "quartet2", base_lr=2e-3,
                                     total_steps=2, group=group)
        state = init(lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev))
        for i in range(2):
            state, m = step(state, {k: v.to(dev) for k, v in
                                    corpus.batch_at(i).items()})
        runs.append((float(m["loss"]), adamw.leaves(state.params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ---- mesh-sharded serving: shard-local tables, the sharded step ----------

def _two_shard_pool(cfg, d="cpu"):
    """A two-shard pool of 4 slots over 256 positions: slots 0-2 hold 47,
    100 and 131 tokens, slot 3 is unbound (its row all sentinel)."""
    pool = KVPool(cfg, 4, 256, block_size=16, n_shards=2, device=d)
    for slot, n in zip(range(3), (47, 100, 131)):
        pool.commit(slot, n)
        pool.ensure(slot, n)
    return pool


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("kernel", ["paged_gqa", "paged_gqa_q", "paged_mla",
                                    "paged_mla_q"])
def test_attention_kernels_on_shard_local_tables(dev, kernel, sq):
    pool = _two_shard_pool(registry.get("llama_200m").reduced())
    bps = pool.blocks_per_shard
    g = torch.Generator().manual_seed(17)
    for s, tables in enumerate(pool.tables_device()):
        table = tables[:, 0].contiguous().to(dev)
        assert int(table.max()) == bps          # the local sentinel
        lens = [pool.length(i) for i in pool._shard_slots(s)]
        pos = torch.tensor([max(n - sq, 0) for n in lens],
                           dtype=torch.int32).to(dev)
        if kernel.startswith("paged_gqa"):
            q = torch.randn((2, sq, 10, 128), generator=g).bfloat16().to(dev)
            k, v = ((torch.randn((bps + 1, 16, 10, 128), generator=g) * 3)
                    .bfloat16().to(dev) for _ in range(2))
            if kernel == "paged_gqa":
                args = (q, k[:bps], v[:bps], table, pos)
            else:
                (kc, ks), (vc, vs) = (F.nvfp4_cache_encode(t) for t in (k, v))
                args = (q, kc[:bps], ks[:bps], vc[:bps], vs[:bps], table, pos)
            kw = {}
            plain = getattr(PA, f"{kernel}_plain")(*args)
        else:
            qa = (torch.randn((2, sq, 128, 512), generator=g) * 0.1).to(dev)
            qr = torch.randn((2, sq, 128, 64), generator=g).bfloat16().to(dev)
            cc = torch.randn((bps + 1, 16, 512), generator=g).bfloat16().to(dev)
            kc = (torch.randn((bps + 1, 16, 64), generator=g) * 2).bfloat16().to(dev)
            if kernel == "paged_mla":
                args = (qa, qr, cc[:bps], kc[:bps], table, pos)
            else:
                (c1, c2), (k1, k2) = (F.nvfp4_cache_encode(t) for t in (cc, kc))
                args = (qa, qr, c1[:bps], c2[:bps], k1[:bps], k2[:bps], table,
                        pos)
            kw = {"qk_dim": 192}
            plain = getattr(PA, f"{kernel}_plain")(*args, 192)
        out = getattr(ops, kernel)(*args, **kw)
        torch.testing.assert_close(out, plain, atol=ATOL, rtol=RTOL)
        for j, n in enumerate(lens):
            if n == 0:
                assert int((out[j] != 0).sum()) == 0    # inactive row
        assert torch.equal(out, getattr(ops, kernel)(*args, **kw))


def test_sharded_llama_step_on_card_against_unsharded(dev):
    from repro_torch.launch.mesh import make_serve_mesh
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    params = prequantize(_to(params, dev), cfg, "bf16")
    mesh = make_serve_mesh(2, 1, devices=[dev, dev])
    sharded = serve_decode.make_sharded_serve_step(cfg, "bf16", mesh)
    plain = serve_decode.make_paged_serve_step(cfg, "bf16")
    spool = _two_shard_pool(cfg, dev)
    upool = KVPool(cfg, 4, 256, block_size=16, device=dev)
    for slot, n in zip(range(3), (47, 100, 131)):
        upool.commit(slot, n)
        upool.ensure(slot, n)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (4, 20))
    active = torch.tensor([True, True, True, False])
    for start, size in ((0, 16), (16, 1), (17, 1)):
        t = torch.as_tensor(toks[:, start:start + size], dtype=torch.int32)
        pos = torch.full((4,), start, dtype=torch.int32)
        got, _ = sharded([params, params], spool.shard_caches,
                         spool.tables_device(), t, pos, active)
        want, _ = plain(params, upool.caches, upool.tables_device(),
                        t.to(dev), pos.to(dev), active.to(dev))
        assert got.device == want.device and got.shape == want.shape
        g, w = got[:3].float(), want[:3].float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 2e-2
        assert torch.equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))
    # slot 2 (shard 1, local row 0) wrote its K into shard 1's blocks
    k1 = spool.shard_caches[1][0]["l0"]["kv"][0]
    ku = upool.caches[0]["l0"]["kv"][0]
    local = int(spool._local_table_np()[2, 0])
    torch.testing.assert_close(k1[:, local].float(),
                               ku[:, int(upool._table[2, 0])].float(),
                               atol=1e-6, rtol=2.0 ** -7)


# --------------------------------------------------------------------------
# bf16_matmul, row-count and column-slice independence, model-axis serving
# --------------------------------------------------------------------------

BF16_MM_BAR = 1e-5   # * max|C_plain|: the f32 summation order alone differs
BF16_MM_NK = [(1280, 1280), (3456, 1280), (1280, 3456), (32000, 1280), (40, 72)]


@pytest.mark.parametrize("n,k", BF16_MM_NK)
@pytest.mark.parametrize("m", [1, 2, 4, 16, 64, 200])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_bf16_matmul_matches_plain(dev, m, n, k, wdtype):
    from repro_torch.kernels import bf16_matmul as BM
    g = torch.Generator(device=dev).manual_seed(m * n + k)
    a = torch.randn((m, k), generator=g, device=dev).bfloat16()
    b = (torch.randn((n, k), generator=g, device=dev) * k ** -0.5).to(wdtype)
    before = ops.LAUNCHES["bf16_matmul"]
    got = ops.bf16_matmul(a, b)
    assert ops.LAUNCHES["bf16_matmul"] == before + 1
    want = BM.bf16_matmul_plain(a, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert (got - want).abs().max().item() <= BF16_MM_BAR * want.abs().max().item()
    assert torch.equal(got, ops.bf16_matmul(a, b))
    assert torch.equal(got, ops.bf16_matmul(a.float(), b.bfloat16()))


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_bf16_matmul_matches_plain_at_nemotron_head(dev, wdtype):
    """nemotron-4-15b's head at a decode step: 256,000 x 6,144 (6.29 GB in
    f32), M = 4, within BF16_MM_BAR of the plain version; one launch."""
    from repro_torch.kernels import bf16_matmul as BM
    g = torch.Generator(device=dev).manual_seed(15)
    a = torch.randn((4, 6144), generator=g, device=dev).bfloat16()
    b = (torch.randn((256000, 6144), generator=g, device=dev)
         * 6144 ** -0.5).to(wdtype)
    before = ops.LAUNCHES["bf16_matmul"]
    got = ops.bf16_matmul(a, b)
    assert ops.LAUNCHES["bf16_matmul"] == before + 1
    want = BM.bf16_matmul_plain(a, b)
    assert (got - want).abs().max().item() <= BF16_MM_BAR * want.abs().max().item()


def test_bf16_matmul_views_ragged_k_and_refusals(dev):
    """A row-pitched view and a K off the vector loads (K = 52: the scalar
    loader) give, bitwise, the call on contiguous operands zero-padded to K
    = 56 (the vector loader: the same values in every k16 step); a
    transposed operand raises."""
    g = torch.Generator(device=dev).manual_seed(9)
    big = torch.randn((6, 100), generator=g, device=dev)
    a, b = big[:, :52], torch.randn((30, 52), generator=g, device=dev)
    assert not a.is_contiguous()
    pad = torch.nn.functional.pad
    assert torch.equal(ops.bf16_matmul(a, b),
                       ops.bf16_matmul(pad(a, (0, 4)), pad(b, (0, 4))))
    with pytest.raises(ValueError, match="inner stride"):
        ops.bf16_matmul(a, b.T.contiguous().T)


def _mm_ops(dev, n, k):
    """The three GEMMs of a bf16 or quartet2 decode step, each as
    f(rows (M, K) bf16) -> (M, N), with its weight (N, K)."""
    g = torch.Generator(device=dev).manual_seed(n + k)
    w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
    qw = ops.nvfp4_fos_quant(w)

    def fp4(x, w_rows=slice(None)):
        qx = ops.nvfp4_fos_quant(x)
        return ops.fp4_matmul(qx[0], qx[1], qw[0][w_rows].contiguous(),
                              qw[1][w_rows].contiguous(), qx[2], qw[2])
    return {"_mm": lambda x, r=slice(None): L._mm(x, w[r], serving=True),
            "dense": lambda x, r=slice(None): L.dense(x, w[r]),
            "fp4_matmul": fp4}


# (M, first part's rows): a whole call and its parts on either side of every
# activation width of bf16_matmul's plan (8, 16, 32, 64, 128), of one
# warpgroup against two (64 / 65 rows), of one grid row against several
# (128 / 129, 200, 300), and, at N = 8,192, of one block a weight tile
# against a cluster of 8 over its chains (300 rows against 44)
BF16_SPLITS = [(4, 2), (5, 3), (9, 8), (17, 16), (32, 16), (64, 32), (65, 64),
               (128, 64), (129, 128), (200, 100), (300, 44)]


@pytest.mark.parametrize("n,k", [(1280, 1280), (3456, 1280), (1280, 3456)])
@pytest.mark.parametrize("op", ["_mm", "dense", "fp4_matmul"])
def test_rows_independent_of_row_count(dev, op, n, k):
    """The rows of one call over M rows equal those of calls over parts of
    them, bitwise: for `_mm` and `dense` at every split of BF16_SPLITS (a
    decode step's 4 rows against a data shard's 2; a 16-token prefill chunk
    of 8 slots, 128 rows, against a shard's 64); for #2 at 4 against 2 + 2
    and 64 against 32 + 32. #2 quantizes its activation per call (a
    per-tensor absmax), so its rows are fed the whole batch's codes: the
    GEMM alone is held."""
    f = _mm_ops(dev, n, k)[op]
    g = torch.Generator(device=dev).manual_seed(3)
    splits = [(4, 2), (64, 32)] if op == "fp4_matmul" else BF16_SPLITS
    for m, h in splits:
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        if op == "fp4_matmul":
            qx = ops.nvfp4_fos_quant(x)
            qw = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device=dev))
            whole = ops.fp4_matmul(qx[0], qx[1], qw[0], qw[1], qx[2], qw[2])
            parts = [ops.fp4_matmul(qx[0][r].contiguous(), qx[1][r].contiguous(),
                                    qw[0], qw[1], qx[2], qw[2])
                     for r in (slice(0, h), slice(h, m))]
        else:
            whole = f(x)
            parts = [f(x[:h]), f(x[h:])]
        assert torch.equal(whole, torch.cat(parts)), (m, h)


@pytest.mark.parametrize("n,k", [(1280, 1280), (3456, 1280), (32000, 1280)])
@pytest.mark.parametrize("op", ["_mm", "dense", "fp4_matmul"])
def test_columns_independent_of_the_slice(dev, op, n, k):
    """An N / 2 call (a model shard's half of the weight) equals the
    matching half of the full call, bitwise, at M = 4, 9, 64, 65, 128 and
    300 (every activation width and warpgroup count of bf16_matmul's plan,
    grid rows at 300; the halves 1,728 rows of a 3,456 weight, ragged at
    two warpgroups' 128)."""
    f = _mm_ops(dev, n, k)[op]
    g = torch.Generator(device=dev).manual_seed(4)
    for m in (4, 9, 64, 65, 128, 300):
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        whole = f(x)
        for half in (slice(0, n // 2), slice(n // 2, n)):
            assert torch.equal(f(x, half), whole[:, half]), (m, half)


# (N, K) off llama's shapes: N ragged against the 64- and 128-row weight
# tiles (1,728 and 40, K 72 past its last whole chunk), N whose halves
# change the chain split (8,192 and 10,240: one block a tile at the whole
# N, a cluster of 8 at N / 2 for small M), K off a whole chain (1,000)
BF16_MM_PLANS_NK = [(1728, 1280), (40, 72), (8192, 1280), (10240, 1280),
                    (1280, 1000)]


@pytest.mark.parametrize("n,k", BF16_MM_PLANS_NK)
def test_bf16_matmul_rows_and_columns_across_plans(dev, n, k):
    """bf16_matmul on f32 weights: every split of BF16_SPLITS bitwise the
    whole call's rows, and at M = 4, 9, 64, 65, 128 and 300 each N / 2 half
    bitwise the whole call's columns; the plans these calls take cover
    every activation width, both warpgroup counts and both chain splits."""
    from repro_torch.kernels import bf16_matmul as BM
    g = torch.Generator(device=dev).manual_seed(n + k)
    w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
    seen = set()
    for m, h in BF16_SPLITS:
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        whole = ops.bf16_matmul(x, w)
        assert torch.equal(whole, torch.cat([ops.bf16_matmul(x[:h], w),
                                             ops.bf16_matmul(x[h:], w)])), (m, h)
        seen |= {BM.plan(r, n, k) for r in (m, h, m - h)}
    half = n // 2
    for m in (4, 9, 64, 65, 128, 300):
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        whole = ops.bf16_matmul(x, w)
        assert torch.equal(ops.bf16_matmul(x, w[:half]), whole[:, :half]), m
        assert torch.equal(ops.bf16_matmul(x, w[half:]), whole[:, half:]), m
        seen |= {BM.plan(m, c, k) for c in (n, half, n - half)}
    assert {p.width for p in seen} == set(BM.WIDTHS)
    assert {p.groups for p in seen} == {1, 2}
    if n >= 8192:
        assert {p.splits for p in seen} == {1, BM.CHAINS}


@pytest.mark.parametrize("n,k", [(1280, 1280), (3456, 1280), (1280, 3456),
                                 (40, 72), (1728, 1000)])
def test_bf16_matmul_wide_range_rows_across_instructions(dev, n, k):
    """At the 128-row activation tile the kernel issues one m64n128k16 a k16
    step, at every narrower tile m64n8k16 side by side: a 128-row call
    bitwise its two 64-row halves, and a 129-row call (two grid rows of
    128) bitwise its first 128 rows and its last one (an 8-row tile), on
    operands of wide dynamic range (exponents over +-24) and with
    cancellation (the second half of K the first half's products
    negated), f32 and bf16 weights."""
    from repro_torch.kernels import bf16_matmul as BM
    g = torch.Generator(device=dev).manual_seed(n + k)

    def wide(shape):
        e = torch.randint(-24, 25, shape, generator=g, device=dev).float()
        return torch.randn(shape, generator=g, device=dev) * torch.exp2(e)

    for m, h in ((128, 64), (129, 128)):
        assert BM.plan(m, n, k).width == 128
        assert BM.plan(m - h, n, k).width < 128
        for cancel in (False, True):
            a, w = wide((m, k)).bfloat16(), wide((n, k))
            if cancel:
                half = k // 2
                w[:, half:2 * half] = -w[:, :half]
                a[:, half:2 * half] = a[:, :half]
            for b in (w, w.bfloat16()):
                whole = ops.bf16_matmul(a, b)
                parts = [ops.bf16_matmul(a[:h], b), ops.bf16_matmul(a[h:], b)]
                assert torch.equal(whole, torch.cat(parts)), (m, h, cancel)


@pytest.mark.parametrize("shape,h", [((8, 1, 1280), 4), ((128, 1280), 64),
                                     ((4, 16, 1280), 2), ((8, 1, 32, 128), 4),
                                     ((300, 3456), 44), ((7, 6144), 1)])
def test_rmsnorm_rows_independent_of_row_count_on_card(dev, shape, h):
    """rmsnorm outside autograd on the card (a serving step's): the rows of
    one call bitwise those of calls over parts of them (8 decode rows
    against a data shard's 4, a 128-row chunk against 64, qk-norm heads of
    width 128), each within one bf16 ulp of the CPU's `mean` form; under
    autograd it keeps `mean` and its gradient."""
    from repro_torch.models import blocks as B
    g = torch.Generator(device=dev).manual_seed(shape[-1] + h)
    x = (torch.randn(shape, generator=g, device=dev) * 3).bfloat16()
    gain = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    with torch.no_grad():
        whole = B.rmsnorm(x, gain)
        parts = torch.cat([B.rmsnorm(x[:h], gain), B.rmsnorm(x[h:], gain)])
    assert torch.equal(whole, parts)
    want = B.rmsnorm(x.cpu(), gain.cpu()).float()
    err = (whole.float().cpu() - want).abs()
    assert (err <= want.abs() * 2.0 ** -7).all()
    xg = x.float().requires_grad_()
    y = B.rmsnorm(xg, gain)
    y.sum().backward()
    assert torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("m,k", [(1280, 1280), (3456, 1280), (32000, 1280)])
def test_given_absmax_quant_is_the_whole_quantization_on_card(dev, m, k):
    """#1's given-absmax entry (the encode kernel alone): each half of a
    weight's rows quantized with the max of the halves' absmaxes is, bitwise,
    that half of the kernel's whole-weight quantization, and within #1's
    bar of the plain version with the same absmax; one launch a call."""
    g = torch.Generator(device=dev).manual_seed(m)
    w = torch.randn((m, k), generator=g, device=dev) * k ** -0.5
    whole = ops.nvfp4_fos_quant(w)
    halves = [w[:m // 2].contiguous(), w[m // 2:].contiguous()]
    absmax = torch.maximum(halves[0].abs().amax(), halves[1].abs().amax()).reshape(1)
    NQ.REGIME_LAUNCHES.update(given_absmax=0)
    for j, h in enumerate(halves):
        got = ops.nvfp4_fos_quant(h, absmax)
        rows = slice(j * m // 2, (j + 1) * m // 2)
        assert torch.equal(got[0], whole[0][rows])
        assert torch.equal(got[1], whole[1][rows])
        assert torch.equal(got[2], whole[2])
        assert_quant_close(got, NQ.nvfp4_fos_quant_plain(h, absmax))
    assert NQ.REGIME_LAUNCHES["given_absmax"] == 2


def _llama4(dev):
    import dataclasses
    full = registry.get("llama_200m")
    cfg = dataclasses.replace(full, n_layers=4)
    return cfg, lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _engine_streams(cfg, params, dev, prompts, max_new, **kw):
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(**{**dict(
        n_slots=4, max_len=80, block_size=16, prefill_chunk=16,
        scheme="bf16", prequant=True, device=str(dev)), **kw}))
    ids = [eng.submit(Request(list(p), max_new)) for p in prompts]
    res = {r.req_id: r.tokens for r in eng.run()}
    torch.cuda.synchronize()
    assert eng.pool.free_block_count == eng.pool.n_blocks
    return [res[i] for i in ids]


def _prompts17(vocab, n=4):
    g = torch.Generator().manual_seed(17)
    return [torch.randint(0, vocab, (n,), generator=g).tolist()
            for n in (33, 17, 49, 33, 41, 25, 17, 49)[:n]]


@pytest.mark.parametrize("slots", [4, 8])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_pool", "nvfp4_pool"])
def test_data_sharded_bf16_streams_bitwise_on_card(dev, kv_quant, slots):
    """Phase 17a's guard: two data shards on the one card serve llama-200m's
    first 4 layers at full width under bf16 bitwise the unsharded engine,
    12 new tokens a request: 4 slots (a 64-row prefill chunk against a
    shard's 32) and 8 (128 rows against 64)."""
    from repro_torch.launch.mesh import make_serve_mesh
    cfg, params = _llama4(dev)
    prompts = _prompts17(cfg.vocab, slots)
    kw = dict(kv_quant=kv_quant, n_slots=slots)
    want = _engine_streams(cfg, params, dev, prompts, 12, **kw)
    got = _engine_streams(cfg, params, dev, prompts, 12, **kw,
                          mesh=make_serve_mesh(2, 1, devices=[dev] * 2))
    assert got == want


@pytest.mark.parametrize("scheme,prequant", [("bf16", True), ("quartet2", True),
                                             ("quartet2", False)])
def test_model_sharded_streams_bitwise_on_card(dev, scheme, prequant):
    """make_serve_mesh(1, 2) with both model devices on the one card: the
    streams bitwise the unsharded engine's (llama-200m's first 4 layers at
    full width, 6 new tokens a request), #2 launched on N / 2 slices."""
    from repro_torch.launch.mesh import make_serve_mesh
    cfg, params = _llama4(dev)
    prompts = _prompts17(cfg.vocab)
    kw = dict(scheme=scheme, prequant=prequant)
    want = _engine_streams(cfg, params, dev, prompts, 6, **kw)
    got = _engine_streams(cfg, params, dev, prompts, 6,
                          mesh=make_serve_mesh(1, 2, devices=[dev] * 2), **kw)
    assert got == want



def test_rwkv6_verify_chunk_is_the_decode_steps_on_card(dev):
    """rwkv6-7b at full width (2 layers), bf16: one 4-token verify chunk
    over 4 slots gives, bitwise, the logits of the 4 single-token steps it
    stands for (every GEMM of the chunk, 16 rows, against 4: the bf16
    linears through bf16_matmul, the f32 LoRAs in calls of one shape)."""
    import dataclasses
    cfg = dataclasses.replace(registry.get("rwkv6_7b"), n_layers=2)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    b, p, s = 4, 20, 4
    toks = torch.randint(0, cfg.vocab, (b, p + s),
                         generator=torch.Generator().manual_seed(1)).to(dev)

    def clone(t):
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(clone(v) for v in t)
        return t.clone()
    with torch.no_grad():
        cache = lm.init_cache(cfg, b, 64, device=dev)
        serve_decode.make_prefill_step(cfg, "bf16")(params, cache, {"tokens": toks[:, :p]})
        step = serve_decode.make_serve_step(cfg, "bf16")
        steps, c1 = [], clone(cache)
        for j in range(s):
            pos = torch.full((b,), p + j, dtype=torch.int32, device=dev)
            steps.append(step(params, c1, toks[:, p + j:p + j + 1], pos)[0][:, -1])
        pos = torch.full((b,), p, dtype=torch.int32, device=dev)
        chunk = step(params, clone(cache), toks[:, p:], pos)[0]
    assert torch.equal(chunk, torch.stack(steps, 1))
