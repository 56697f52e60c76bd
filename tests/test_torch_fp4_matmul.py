"""The port's NVFP4 GEMM on the CPU: its bf16 output against the reference's
Pallas kernel, and the launch geometry of the two card kernels.

- `ops.fp4_matmul(..., out_dtype=torch.bfloat16)` (the plain version here)
  is BITWISE its f32 result cast to bf16, and within one bf16 ulp of the
  reference kernel's f32 result (interpret mode) cast to bf16: the f32 sums
  may differ in order (|dC| <= 1e-5 max|C|, as in test_torch_linear.py), so
  a value next to a bf16 rounding boundary may round the other way;
- `fp4_matmul.plan`: the regime flips from the weight-streaming kernel to
  the wgmma kernel above GEMV_MAX_M; every K group lies in exactly one K
  split, no split is empty or longer than GEMV_MAX_CHUNKS chunks, and the
  grid covers every output tile exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import formats as F
from repro_torch.core import linear as L
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _packed(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return L.pack_weight(torch.from_numpy(x), "fos")


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().view(torch.int16).int().numpy()


@pytest.mark.parametrize("m,n,k", [(64, 128, 256), (8, 96, 512), (17, 40, 48)])
def test_plain_bf16_output_vs_jax_kernel(m, n, k):
    a, b = _packed((m, k), 11), _packed((n, k), 12)
    args = (a.packed, a.scale_bits, b.packed, b.scale_bits, a.gscale, b.gscale)
    got = ops.fp4_matmul(*args, out_dtype=torch.bfloat16)
    f32 = ops.fp4_matmul(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.equal(got, f32.to(torch.bfloat16))
    want = np.asarray(jops.fp4_matmul(
        jnp.asarray(a.packed.numpy()), jnp.asarray(F.bits_to_e4m3(a.scale_bits).numpy()),
        jnp.asarray(b.packed.numpy()), jnp.asarray(F.bits_to_e4m3(b.scale_bits).numpy()),
        jnp.asarray(float(a.gscale)), jnp.asarray(float(b.gscale)),
        bm=m, bn=n, bk=k, interpret=True))
    ulps = np.abs(_bf16_bits(got.float().numpy()) - _bf16_bits(want))
    assert ulps.max() <= 1


def test_out_dtype_is_checked():
    a = _packed((4, 32), 1)
    with pytest.raises(ValueError):
        ops.fp4_matmul(a.packed, a.scale_bits, a.packed, a.scale_bits,
                       a.gscale, a.gscale, out_dtype=torch.float16)


@pytest.mark.parametrize("m", [1, 8, FM.GEMV_MAX_M, FM.GEMV_MAX_M + 1, 64, 2048])
def test_plan_regime_flips_at_gemv_max_m(m):
    p = FM.plan(m, 1280, 1280)
    assert p.regime == ("gemv" if m <= FM.GEMV_MAX_M else "mma")
    assert FM.GEMV_MAX_M == 16


# decode shapes of llama-200m and deepseek-v3, training and prefill shapes,
# and ragged ones (K = 16 and 48, N and M off the tiles)
PLAN_SHAPES = [(m, n, k) for m in (1, 4, 8, 16, 17, 64, 65, 2048)
               for n, k in ((1280, 1280), (3456, 1280), (1280, 3456),
                            (2048, 7168), (7168, 2048), (24576, 1536),
                            (576, 7168), (7168, 16384), (96, 16), (576, 48))]


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_plan_covers_k_and_tiles_once(m, n, k):
    p = FM.plan(m, n, k)
    gx, gy = p.grid
    if p.regime == "gemv":
        chunks = -(-k // FM.GEMV_CHUNK)
        groups = np.zeros(k // F.GROUP, np.int64)
        for split in range(gy):  # the kernel's chunk range of split y
            c0 = split * p.chunks_per_split
            nch = min(p.chunks_per_split, chunks - c0)
            assert 1 <= nch <= FM.GEMV_MAX_CHUNKS
            lo = c0 * FM.GEMV_CHUNK
            hi = min(k, (c0 + nch) * FM.GEMV_CHUNK)
            groups[lo // F.GROUP:hi // F.GROUP] += 1
        assert p.splits == gy and (groups == 1).all()
        cover = np.zeros((n,), np.int64)
        for x in range(gx):
            cover[x * FM.GEMV_ROWS:(x + 1) * FM.GEMV_ROWS] += 1
        assert (cover == 1).all() and (gx - 1) * FM.GEMV_ROWS < n
    else:
        bm, bn, _ = FM.MMA_TILE
        assert p.splits == 1
        cover = np.zeros((m, n), np.int64)
        for y in range(gy):
            for x in range(gx):
                cover[y * bm:(y + 1) * bm, x * bn:(x + 1) * bn] += 1
        assert (cover == 1).all()
        assert (gx - 1) * bn < n and (gy - 1) * bm < m
