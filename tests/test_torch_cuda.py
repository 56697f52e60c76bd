"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and the CUDA toolkit (the repo's
tests/conftest.py imports jax, which that machine does not need, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test skips where no CUDA device is present; the decision is made in a
fixture, never at import. Tolerances are the kernel bars of the port:
  - nvfp4_fos_quant: scales and gscale equal; codes may differ only on
    rounding ties, for < 1e-4 of elements and by at most one grid step;
  - fp4_matmul: |C_kernel - C_plain| <= 1e-5 * max|C_plain| (exact block
    values; only the fp32 summation order differs);
  - paged_gqa: |o_kernel - o_plain| <= 5e-6 + 1e-5 |o_plain|, the bar of
    tests/test_paged_attention.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import formats as F
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import nvfp4_quant as NQ
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import lm
from repro_torch.serve import decode as serve_decode
from repro_torch.serve.kv_pool import KVPool

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


@pytest.mark.parametrize("m", [4, 64, 5])
@pytest.mark.parametrize("n,k", [(1280, 1280), (3456, 1280), (1280, 3456)])
def test_fp4_matmul_matches_plain(dev, m, n, k):
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = ops.nvfp4_fos_quant(torch.randn((m, k), generator=g, device=dev))
    b = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device=dev))
    c = ops.fp4_matmul(a[0], a[1], b[0], b[1], a[2], b[2])
    torch.cuda.synchronize()
    ref = FM.fp4_matmul_plain(a[0], a[1], b[0], b[1], a[2], b[2])
    assert c.shape == (m, n) and c.dtype == torch.float32
    err = (c - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def _pool_case(dev, b, sq, h, kv, hd, bs, maxb, lens, window=None,
               dead_rows=(), q_dtype=torch.bfloat16, seed=0):
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
    kp = (torch.randn((n_blocks, bs, kv, hd), generator=g) * 3).bfloat16()
    vp = (torch.randn((n_blocks, bs, kv, hd), generator=g) * 3).bfloat16()
    return [t.to(dev) for t in (q, kp, vp, table, pos)], window


@pytest.mark.parametrize("case", [
    # llama-200m decode and prefill chunk: H 10, KV 10, hd 128, BS 16
    dict(b=4, sq=1, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[37, 100, 1, 256]),
    dict(b=4, sq=16, h=10, kv=10, hd=128, bs=16, maxb=16, lens=[16, 64, 100, 17]),
    # yi-9b grouped heads: H 32, KV 4
    dict(b=4, sq=1, h=32, kv=4, hd=128, bs=16, maxb=16, lens=[5, 130, 77, 200]),
    dict(b=2, sq=16, h=32, kv=4, hd=128, bs=16, maxb=16, lens=[40, 200]),
    # window, sentinel (dead) row, small blocks, f32 q, head dim 32
    dict(b=3, sq=4, h=4, kv=2, hd=32, bs=4, maxb=8, lens=[9, 30, 12],
         window=6, dead_rows=(1,), q_dtype=torch.float32),
    dict(b=3, sq=1, h=4, kv=4, hd=64, bs=8, maxb=4, lens=[3, 32, 20],
         window=11, dead_rows=(0,)),
])
def test_paged_gqa_matches_plain(dev, case):
    (q, kp, vp, table, pos), window = _pool_case(dev, **case)
    out = ops.paged_gqa(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    ref = PA.paged_gqa_plain(q, kp, vp, table, pos, window=window)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    for r in case.get("dead_rows", ()):
        assert int((out[r] != 0).sum()) == 0  # fully masked row: exact zeros


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


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)
