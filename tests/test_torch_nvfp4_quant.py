"""The port's 4/6 quantizer (#1) on the CPU: its launch geometry, the plain
version against the reference's Pallas kernel, and the f32 identities its
CUDA kernel and MS-EDEN phase 1's rely on, mirrored here in PyTorch.

- `nvfp4_quant.plan`: every llama-200m and deepseek-v3 decode call is one
  cluster launch (the regime flips above SMALL_MAX_CHUNKS chunks of 8), the
  cluster covers every chunk with whole warps and at most MAX_CLUSTER CTAs,
  training shapes take the two passes.
- `ops.nvfp4_fos_quant` on the CPU (the plain version) against the
  reference kernel in interpret mode on bf16 inputs: codes, scales and
  gscale BITWISE (the reference's absmax, taken outside its pallas_call, is
  the same max); against the reference's `quant_four_over_six` (eager) on
  inputs with 4/6 near-ties, BITWISE: both sum a group's errors in index
  order.
- The E2M1 rounding of the kernels, (m + c) - c then min(., 6) with c =
  2^22 scaled by m's binade, and the 3-bit index read from its f32 bits:
  EQUAL to `formats.fp4_rtn` / `fp4_code` on every threshold, grid point and
  their f32 neighbours, specials, and random magnitudes.
- The reciprocal route of csrc/nvfp4_quant.cu: where the rounding of
  |x * RN(1/d)| is not flagged as near a threshold, it equals the rounding of
  fl(x / d); checked on random and adversarial (x = t * d) pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nvfp4_quant import nvfp4_fos_quant as jquant
from repro_torch.core import formats as F
from repro_torch.kernels import nvfp4_quant as NQ
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# (M, K) of every quantizer call of a decode step: llama-200m at 4 slots
# (K = 1280, 3456), deepseek-v3 (wq_a / wkv_a / shared expert at 7168, wq_b
# 1536, wo 16384, shared w2 2048 at M = 4; routed experts at M = 8)
LLAMA_DECODE = [(4, 1280), (4, 3456)]
DEEPSEEK_DECODE = [(4, 7168), (4, 1536), (4, 16384), (4, 2048), (8, 7168), (8, 2048)]
TRAINING = [(2048, 1280), (2048, 3456), (1280, 1280), (3456, 1280), (1280, 3456)]


@pytest.mark.parametrize("m,k", LLAMA_DECODE + DEEPSEEK_DECODE)
def test_plan_decode_shapes_are_one_cluster(m, k):
    p = NQ.plan(m, k)
    chunks = m * k // NQ.CHUNK
    assert p.regime == "cluster" and p.partial_ctas == 0
    assert 1 <= p.ctas <= NQ.MAX_CLUSTER
    assert p.threads % 32 == 0 and 32 <= p.threads <= NQ.SMALL_THREADS
    assert p.ctas * p.threads >= chunks > (p.ctas - 1) * p.threads


@pytest.mark.parametrize("m,k", TRAINING + [(64, 1280), (64, 3456)])
def test_plan_training_and_prefill_take_two_passes(m, k):
    p = NQ.plan(m, k)
    chunks = m * k // NQ.CHUNK
    assert p.regime == "two_pass"
    assert 1 <= p.partial_ctas <= 2 * NQ.SMS and 1 <= p.ctas <= 4 * NQ.SMS
    assert p.threads == NQ.THREADS
    assert p.ctas == min(-(-chunks // NQ.THREADS), 4 * NQ.SMS)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_plan_threshold(m):
    """At SMALL_MAX_CHUNKS chunks the last cluster, one group (2 chunks) more
    the two passes."""
    k = NQ.SMALL_MAX_CHUNKS * NQ.CHUNK // m
    assert NQ.plan(m, k).regime == "cluster"
    assert NQ.plan(m, k).ctas * NQ.plan(m, k).threads == NQ.SMALL_MAX_CHUNKS
    assert NQ.plan(m, k + 16).regime == "two_pass"


@pytest.mark.parametrize("m,k", [(4, 1024), (8, 2048), (128, 3072), (16, 512)])
def test_plain_matches_jax_kernel(m, k):
    x = np.random.RandomState(m + k).randn(m, k).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    _, codes, scales, gscale = jquant(xb, interpret=True)
    packed, bits, gs = ops.nvfp4_fos_quant(torch.from_numpy(x).bfloat16())
    assert np.array_equal(F.unpack_fp4(packed).numpy(), np.asarray(codes))
    assert np.array_equal(F.bits_to_e4m3(bits).numpy(), np.asarray(scales))
    assert float(gs) == float(gscale)


@pytest.mark.parametrize("seed", [5, 32])
def test_four_over_six_near_ties_take_the_references_sum_order(seed):
    """A group whose /4 and /6 squared errors tie to an ulp keeps the branch
    the reference keeps: the plain version sums a group's 16 errors in
    index order, as XLA and the CUDA kernel do (`Tensor.sum`'s order would
    pick the other branch for 2 groups of seed 5's input and 1 of seed
    32's, both (1024, 4096) normals in bf16). The reference runs EAGERLY
    (under jax.jit its gscale divide becomes a reciprocal multiply)."""
    import jax
    from repro.core import quant as JQ
    from repro_torch.core import quant as Q

    x = np.random.RandomState(seed).randn(1024, 4096).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        want = JQ.quant_four_over_six(xb)
    got = Q.quant_four_over_six(torch.from_numpy(x).bfloat16())
    assert float(got.gscale) == float(want.gscale)
    assert np.array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert np.array_equal(got.vals.numpy(), np.asarray(want.vals))
    e = torch.from_numpy(np.random.RandomState(seed).rand(4096, 16).astype(
        np.float32))
    with jax.disable_jit():
        jsum = np.asarray(jnp.sum(jnp.asarray(e.numpy()), axis=-1))
    assert np.array_equal(Q._sum_in_order(e).numpy(), jsum)


def rtn_mag(m: torch.Tensor, near: bool = False):
    """The kernels' fp4_rtn_mag (and fp4_rtn_mag_near) in f32 PyTorch."""
    m = torch.where(torch.isnan(m), 8.0, m.clamp(max=8.0))  # fminf(m, 8)
    e = torch.maximum(m.view(torch.int32) & 0x7F800000,
                      torch.tensor(0x3F800000, dtype=torch.int32))
    c = (e + (22 << 23)).view(torch.float32)
    q = (m + c) - c
    k = torch.tensor(0x337FFFC0, dtype=torch.int32).view(torch.float32)
    flag = (q - m).abs() > c * k
    q = q.clamp(max=6.0)
    return (q, flag) if near else q


def fp4_index(q: torch.Tensor) -> torch.Tensor:
    """The kernels' fp4_index: the 3-bit index of a grid magnitude."""
    hi = (q.view(torch.int32) >> 22) - 252
    return torch.where(q >= 1.0, hi, (q > 0).int())


def _threshold_neighbourhood() -> torch.Tensor:
    pts = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5,
                        3.0, 3.5, 4.0, 5.0, 6.0, 7.0, 8.0, 100.0])
    bits = pts.view(torch.int32)
    near = torch.cat([bits + d for d in range(-4, 5)]).clamp(min=0)
    rand = torch.rand(200_000, generator=torch.Generator().manual_seed(0)) * 9
    special = torch.tensor([float("inf"), 3.4e38, 1e-45, 1e-38])
    return torch.cat([near.view(torch.float32), rand, special])


def test_kernel_rounding_equals_fp4_rtn():
    m = _threshold_neighbourhood()
    q = rtn_mag(m)
    want = F.fp4_rtn(m).abs()
    assert torch.equal(q, want)
    assert torch.equal(fp4_index(q), F.fp4_code(want).int() & 7)
    # NaN: the earlier kernels' threshold chain gives index 7 (all compares
    # false); so does the rounding (fminf(NaN, 8) = 8 -> 6)
    nan = rtn_mag(torch.tensor([float("nan")]))
    assert float(nan) == 6.0 and int(fp4_index(nan)) == 7


@pytest.mark.parametrize("adversarial", [False, True])
def test_reciprocal_route_rounds_as_the_divide(adversarial):
    g = torch.Generator().manual_seed(int(adversarial))
    n = 400_000
    d = (torch.rand(n, generator=g) + 0.05) * torch.exp2(
        torch.randint(-40, 40, (n,), generator=g).float())
    if adversarial:  # x on a threshold or a grid point times d, then an ulp off
        t = torch.tensor([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 0.5, 1.0, 4.0, 6.0])
        x = t[torch.randint(0, len(t), (n,), generator=g)] * d
        step = torch.randint(-2, 3, (n,), generator=g).int()
        x = (x.view(torch.int32) + step).view(torch.float32)
    else:
        x = torch.randn(n, generator=g) * 3 * d
    exact = rtn_mag((x / d).abs())
    q, flag = rtn_mag((x * (1.0 / d)).abs(), near=True)
    assert torch.equal(q[~flag], exact[~flag])
    rate = flag.double().mean().item()
    # random data is rarely near a threshold; on the adversarial pairs the
    # thresholds' neighbours are flagged and the grid points are not
    assert 0 < rate < 1 if adversarial else rate < 1e-3
