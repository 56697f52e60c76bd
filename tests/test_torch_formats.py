"""The port's NVFP4 formats and quantizers against the JAX reference.

Same numpy inputs to both packages; everything here is compared BITWISE,
except the plain 4/6 quantization op against the reference's Pallas kernel
(interpret mode), whose E2M1 rounding breaks ties the other way: there codes
may differ only on rounding ties, for < 1e-4 of elements and by at most one
grid step (the bar of tests/test_kernels.py), scales and gscale equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import quant as JQ
from repro.kernels import ops as jops
from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_all_e2m1_codes():
    codes = np.arange(16, dtype=np.uint8)
    want = np.asarray(JF.fp4_decode(jnp.asarray(codes)))
    got = F.fp4_decode(torch.from_numpy(codes)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(F.fp4_code(torch.from_numpy(got)).numpy(),
                          np.asarray(JF.fp4_code(jnp.asarray(want))))


def test_fp4_rtn_ties_and_clipping():
    grid = np.concatenate([JF.FP4_GRID, (JF.FP4_GRID[:-1] + JF.FP4_GRID[1:]) / 2,
                           [5.999, 6.0, 7.5, 1e9, 0.2499, 0.2501]])
    x = np.concatenate([grid, -grid]).astype(np.float32)
    rng = np.random.RandomState(0)
    x = np.concatenate([x, (rng.randn(4096) * 3).astype(np.float32)])
    want = np.asarray(JF.fp4_rtn(jnp.asarray(x)))
    assert np.array_equal(F.fp4_rtn(torch.from_numpy(x)).numpy(), want)


def test_all_finite_e4m3_patterns():
    bits = np.arange(127, dtype=np.uint8)  # 0x00 .. 0x7E: every finite value >= 0
    want = np.asarray(jnp.asarray(bits).view(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    vals = F.bits_to_e4m3(torch.from_numpy(bits))
    assert np.array_equal(vals.numpy(), want)
    assert np.array_equal(F.e4m3_to_bits(vals).numpy(), bits)
    assert np.array_equal(F.fp8_rtn(vals).numpy(), want)  # on-grid: identity


def test_fp8_rtn_matches_jax():
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(4096) * 100, [448, 449, 463.9, 464, 1e6,
                                               -1e6, 2 ** -10, 0]])
    x = x.astype(np.float32)
    want = np.asarray(JF.fp8_rtn(jnp.asarray(x)))
    assert np.array_equal(F.fp8_rtn(torch.from_numpy(x)).numpy(), want)


def test_pack_unpack_matches_jax():
    codes = np.random.RandomState(2).randint(0, 16, (5, 64)).astype(np.uint8)
    want = np.asarray(JF.pack_fp4(jnp.asarray(codes)))
    packed = F.pack_fp4(torch.from_numpy(codes))
    assert np.array_equal(packed.numpy(), want)
    assert np.array_equal(F.unpack_fp4(packed).numpy(), codes)


@pytest.mark.parametrize("name", ["four_over_six", "rtn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((64, 1280), 1.0), ((8, 3456), 40.0),
                                         ((4, 128), 1e-3), ((3, 32), 0.0)])
def test_quantizers_bitwise_vs_jax(name, dtype, shape, scale):
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * scale * np.exp(rng.randn(*shape))).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq = getattr(JQ, "quant_" + name)(jx)
    tq = getattr(Q, "quant_" + name)(tx)
    assert np.array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    assert np.array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert float(tq.gscale) == float(jq.gscale)
    assert np.array_equal(Q.dequant(tq).numpy(), np.asarray(JQ.dequant(jq)))


@pytest.mark.parametrize("shape,blocks", [((128, 512), (128, 512)),
                                          ((64, 256), (32, 128))])
def test_plain_fos_quant_op_vs_jax_kernel(shape, blocks):
    rng = np.random.RandomState(4)
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape))).astype(np.float32)
    _, jcodes, jscales, jg = jops.nvfp4_fos_quant(
        jnp.asarray(x), bm=blocks[0], bk=blocks[1], interpret=True)
    packed, bits, g = ops.nvfp4_fos_quant(torch.from_numpy(x))
    assert float(g) == float(jg)
    assert np.array_equal(F.bits_to_e4m3(bits).numpy(), np.asarray(jscales))
    ck = F.unpack_fp4(packed).numpy().astype(np.int32)
    cr = np.asarray(jcodes, np.int32)
    ordk = np.where(ck & 8, -(ck & 7), ck & 7)
    ordr = np.where(cr & 8, -(cr & 7), cr & 7)
    diff = ordk != ordr
    assert diff.mean() < 1e-4, diff.mean()
    assert (np.abs(ordk - ordr)[diff] <= 1).all()
    assert ops.LAUNCHES["nvfp4_fos_quant"] == 0  # CPU: the plain version
