"""The port's stochastic formats, RHT and MS-EDEN against the JAX reference.

The port takes its randomness as tensors (RHT signs, SR uniforms); here both
packages get JAX's own draws, so the claims below are exact where the math
is deterministic. Tolerances:

- `fp4_sr`, `fp8_sr_pos`, `e8m3_rtn`, `quant_sr`, `quant_square_block`,
  `fp4_overflow_fraction`: BITWISE, with JAX-drawn uniforms, on normal
  floats. (XLA's CPU runtime treats denormal inputs as zero; the port keeps
  them, as its CUDA kernels do, so `e8m3_rtn(1e-39)` is 1.03e-38 in the
  port and 0 in the reference.)
- `rht` / `rht_inv` with JAX's rademacher signs: |d| <= 1e-6 max|x|. The
  port applies H_b as a butterfly, the reference as a GEMM: only the
  rounding order differs.
- The RHT bar (direct `ms_eden` and plain phase 1 against eager JAX): FP4
  codes equal for all but <= 1e-4 of elements, each flip one grid step;
  pseudo-scales equal for all but <= 1e-4 of groups; EDEN sums within 1e-5
  relative, absmax within 1e-6 relative. (One rotated value that lands on
  the other side of a rounding boundary flips a code.)
- Plain phase 2 fed JAX's phase-1 outputs and uniforms: BITWISE equal to
  eager `ME.ms_eden_phase2` (scales and gscale).
- Plain `quartet2_backward_gemm` against JAX's `ops.quartet2_backward_gemm`
  (Pallas, interpret mode) with JAX's draws: each requantized operand within
  the RHT bar (scales equal; gscale within rtol 1e-6, the bar of
  tests/test_kernels.py:77: the absmax moves by the RHT order, and the jitted
  reference turns `absmax / C` into `absmax * (1/C)`), and |dC| <= 1e-5
  max|C|, the fp4_matmul bar.
- Statistics, the port's own versions of tests/test_quant.py's: the
  post-hoc path is unbiased (mean of 1024 draws within 2% of x, relative
  norm) and its mean MSE is within 10% of the direct path's over 128 draws.
- Hash draws (`core/rng.py`): identical for equal (seed, tag); uniforms pass
  a Kolmogorov-Smirnov bound (D < 1.63 / sqrt(n), p = 0.01); signs are
  balanced within 4 sigma. A tag's key pair (`HashDraws.keys`) hashed per
  flat index in uint32 arithmetic, as the phase-2 kernel does (modelled in
  numpy uint32), gives `HashDraws.uniform` BITWISE; phase 2 driven by the
  key pair is BITWISE phase 2 on the materialized uniforms, and so is a
  quartet2 backward whose hashed draws reach phase 2 as keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import linear as JL
from repro.core import ms_eden as JME
from repro.core import quant as JQ
from repro.core import rht as JR
from repro.kernels import ops as jops
from repro.kernels.ms_eden_requant import ms_eden_requant as jrequant
from repro_torch.core import formats as F
from repro_torch.core import linear as L
from repro_torch.core import ms_eden as ME
from repro_torch.core import quant as Q
from repro_torch.core import rht as R
from repro_torch.core import rng
from repro_torch.kernels import ms_eden_requant as MR
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


def _signed_ordinal(codes: np.ndarray) -> np.ndarray:
    c = codes.astype(np.int64)
    return np.where(c & 8, -(c & 7), c & 7)


def assert_codes_close(got: np.ndarray, want: np.ndarray) -> None:
    """The RHT bar on FP4 codes."""
    a, b = _signed_ordinal(got), _signed_ordinal(want)
    diff = a != b
    assert diff.mean() <= 1e-4, diff.mean()
    assert (np.abs(a - b)[diff] <= 1).all()


# --------------------------------------------------------------------------
# formats and quantizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_fp4_sr_bitwise(seed):
    x = _rand((64, 96), seed, 3.0)
    x[0, :8] = [0.0, -0.0, 6.0, -6.0, 7.5, 0.25, -2.5, 1e-30]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JF.fp4_sr(jnp.asarray(x), key))
    got = F.fp4_sr(T(x), T(_uniform(key, x.shape))).numpy()
    assert np.array_equal(got, want)
    assert float(F.fp4_overflow_fraction(T(x))) == float(
        JF.fp4_overflow_fraction(jnp.asarray(x)))


def test_fp8_sr_pos_bitwise():
    rs = np.random.RandomState(2)
    x = np.abs(rs.randn(4096)).astype(np.float32) * np.exp2(
        rs.randint(-12, 10, 4096)).astype(np.float32)
    x[:6] = [0.0, 448.0, 500.0, 1e-9, 0.001953125, 2.0]
    key = jax.random.PRNGKey(3)
    want = np.asarray(JF.fp8_sr_pos(jnp.asarray(x), key))
    got = F.fp8_sr_pos(T(x), T(_uniform(key, x.shape))).numpy()
    assert np.array_equal(got, want)


def test_e8m3_rtn_bitwise():
    rs = np.random.RandomState(4)
    x = (rs.randn(8192) * np.exp2(rs.randint(-60, 60, 8192))).astype(np.float32)
    x[:5] = [0.0, -1.0, 1.03125, 1.09375, 1.1754944e-38]  # ties, least normal
    assert np.array_equal(F.e8m3_rtn(T(x)).numpy(),
                          np.asarray(JF.e8m3_rtn(jnp.asarray(x))))


def test_quant_sr_bitwise():
    x = _rand((32, 256), 5)
    key = jax.random.PRNGKey(6)
    want = JQ.quant_sr(jnp.asarray(x), key)
    got = Q.quant_sr(T(x), T(_uniform(key, x.shape)))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert float(Q.mse(T(x), got)) == pytest.approx(
        float(JQ.mse(jnp.asarray(x), want)), rel=1e-6)


def test_quant_square_block_bitwise():
    x = _rand((48, 128), 7)
    for a, b in zip(Q.quant_square_block(T(x)),
                    JQ.quant_square_block(jnp.asarray(x))):
        assert np.array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# RHT
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_rht_matches_jax(b):
    x = _rand((24, 4 * b), b)
    key = jax.random.PRNGKey(b)
    signs = T(JR.sign_vector(key, b))
    want = np.asarray(JR.rht(jnp.asarray(x), key, b))
    got = R.rht(T(x), signs, b).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(x).max()
    back = R.rht_inv(T(want), signs, b).numpy()
    want_back = np.asarray(JR.rht_inv(jnp.asarray(want), key, b))
    assert np.abs(back - want_back).max() <= 1e-6 * np.abs(x).max()
    assert R.block_size(4 * b) == JR.block_size(4 * b)


# --------------------------------------------------------------------------
# MS-EDEN: direct, and the post-hoc phases
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 256), (128, 128), (96, 48)])
def test_direct_ms_eden_matches_jax(shape):
    x = _rand(shape, 8)
    rk, sk = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    b = JR.block_size(shape[1])
    want = JME.ms_eden(jnp.asarray(x), rk, sk).qt
    got = ME.ms_eden(T(x), T(JR.sign_vector(rk, b)),
                     T(_uniform(sk, (shape[0], shape[1] // 16)))).qt
    assert_codes_close(got.codes.numpy(), np.asarray(want.codes))
    assert (got.scales.numpy() != np.asarray(want.scales)).mean() <= 1e-4
    assert float(got.gscale) == pytest.approx(float(want.gscale), rel=1e-6)


@pytest.mark.parametrize("shape", [(128, 256), (96, 48), (64, 1024), (256, 128)])
def test_phase1_matches_eager_jax(shape):
    x = _rand(shape, 11)
    rk = jax.random.PRNGKey(12)
    b = JR.block_size(shape[1])
    want = JME.ms_eden_phase1(jnp.asarray(x), rk)
    packed, pseudo, num, den, absmax = ops.ms_eden_phase1(
        T(x), T(JR.sign_vector(rk, b)))
    assert packed.shape == (shape[0], shape[1] // 2)
    assert_codes_close(F.unpack_fp4(packed).numpy(), np.asarray(want.codes))
    assert (pseudo.numpy() != np.asarray(want.pseudo_scales)).mean() <= 1e-4
    for a, b_ in ((num, want.eden_num), (den, want.eden_den)):
        b_ = np.asarray(b_)
        assert np.abs(a.numpy() - b_).max() <= 1e-5 * np.abs(b_).max()
    assert float(absmax[0]) == pytest.approx(float(want.absmax), rel=1e-6)


def _views(x: np.ndarray):
    """x (M, K) as the backward hands operands over: the transpose of a
    row-major (K, M) tensor, and row-major rows at a pitch wider than K."""
    m, k = x.shape
    wide = torch.zeros((m, k + 16))
    wide[:, 1:k + 1] = T(x)
    return {"transposed": T(x.T.copy()).T, "pitched": wide[:, 1:k + 1]}


@pytest.mark.parametrize("shape", [(128, 256), (96, 48), (64, 1024), (33, 80)])
@pytest.mark.parametrize("view", ["transposed", "pitched"])
def test_phase1_on_views_bitwise_and_vs_eager_jax(shape, view):
    """ops.ms_eden_phase1 on a strided view: bitwise its result on the
    contiguous tensor, and within the RHT bar of eager JAX."""
    x = _rand(shape, 21)
    xv = _views(x)[view]
    assert not xv.is_contiguous()
    assert MR.layout(xv)[0] == ("cols" if view == "transposed" else "rows")
    rk = jax.random.PRNGKey(22)
    signs = T(JR.sign_vector(rk, JR.block_size(shape[1])))
    got = ops.ms_eden_phase1(xv, signs)
    for a, b in zip(got, ops.ms_eden_phase1(T(x), signs)):
        assert torch.equal(a, b)
    want = JME.ms_eden_phase1(jnp.asarray(x), rk)
    assert_codes_close(F.unpack_fp4(got[0]).numpy(), np.asarray(want.codes))
    assert (got[1].numpy() != np.asarray(want.pseudo_scales)).mean() <= 1e-4
    assert float(got[4][0]) == pytest.approx(float(want.absmax), rel=1e-6)


@pytest.mark.parametrize("view", ["transposed", "pitched"])
def test_requant_on_views_bitwise(view):
    x = _rand((64, 384), 23)
    signs = rng.HashDraws([1, 2]).signs(0, 128, "cpu")
    u = rng.HashDraws([1, 2]).uniform(1, (64, 384 // 16), "cpu")
    got = ops.ms_eden_requant(_views(x)[view], signs, u)
    for a, b in zip(got, ops.ms_eden_requant(T(x), signs, u)):
        assert torch.equal(a, b)


def test_layout_of_views():
    x = torch.zeros((8, 32))
    assert MR.layout(x) == ("rows", 32)
    assert MR.layout(torch.zeros((32, 8)).T) == ("cols", 8)
    assert MR.layout(torch.zeros((8, 48))[:, :32]) == ("rows", 48)
    assert MR.layout(torch.zeros((1, 32))) == ("rows", 32)
    assert MR.layout(torch.zeros((8, 64))[:, ::2]) is None
    assert MR.layout(torch.zeros((4, 8, 32))[:, 0, :]) == ("rows", 256)


class _KeyDraws:
    """The reference's draws of one site seed (`repro.core.linear._key`)."""

    def __init__(self, seed):
        self.seed = jnp.asarray(seed, jnp.uint32)

    def key(self, tag):
        return JL._key(self.seed, tag)

    def signs(self, tag, n, device):
        return T(jax.random.rademacher(self.key(tag), (n,), jnp.float32)).to(device)

    def uniform(self, tag, shape, device):
        return T(jax.random.uniform(self.key(tag), tuple(shape), jnp.float32)).to(device)


def test_qlinear_backward_on_views_bitwise_and_vs_jax_kernel_path(monkeypatch):
    """A quartet2 qlinear backward whose MS-EDEN operands need no padding
    (N = 256 and M = 128 tokens): E^T, W^T and X^T reach the requant as
    transposed views, and the gradients are BITWISE those of the earlier
    contiguous copies; each backward GEMM is within the fp4_matmul bar
    (1e-5 max|C|) of the reference's kernel path on the same operands and
    draws (the RHT order differs: butterfly against GEMM)."""
    m, k, n = 128, 128, 256
    x = T(_rand((m, k), 24)).bfloat16()
    w = T(_rand((n, k), 25, k ** -0.5))
    e = T(_rand((m, n), 26)).bfloat16()
    draws = _KeyDraws(np.array([9, 10], np.uint32))
    seen, grads = [], {}
    real = ops.quartet2_backward_gemm

    def spy(a, b, *rest):
        seen.append((a.clone(), b.clone(), a.is_contiguous(), b.is_contiguous()))
        return real(a, b, *rest)

    monkeypatch.setattr(ops, "quartet2_backward_gemm", spy)
    for path in ("views", "copies"):
        if path == "copies":  # the backward before it took views
            monkeypatch.setattr(L, "_operand", lambda t, mult: L._pad_to(
                t, mult).float().contiguous())
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        L.qlinear(tx, tw, draws, "quartet2").backward(e)
        grads[path] = (tx.grad, tw.grad)
    assert [c for _, _, *c in seen[:2]] == [[True, False], [False, False]]
    assert all(a and b for _, _, a, b in seen[2:])
    for g, h in zip(grads["views"], grads["copies"]):
        assert torch.equal(g, h)
    for (a, b, *_), tag in zip(seen[:2], (1, 4)):
        want = np.asarray(jops.quartet2_backward_gemm(
            jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), draws.key(tag),
            jax.random.key_data(draws.key(tag + 1)),
            jax.random.key_data(draws.key(tag + 2))))
        g = a.shape[1] // 16
        got = ops.quartet2_backward_gemm(a, b, draws.signs(tag, 128, "cpu"),
                                         draws.uniform(tag + 1, (a.shape[0], g), "cpu"),
                                         draws.uniform(tag + 2, (b.shape[0], g), "cpu"))
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(128, 256), (96, 48), (64, 1024)])
def test_phase2_bitwise_vs_eager_jax(shape):
    x = _rand(shape, 13, 0.01)
    rk, sk = jax.random.PRNGKey(14), jax.random.PRNGKey(15)
    p1 = JME.ms_eden_phase1(jnp.asarray(x), rk)
    want = JME.ms_eden_phase2(p1, sk)
    u = _uniform(sk, (shape[0], shape[1] // 16))
    bits, gscale = ops.ms_eden_phase2(
        T(p1.absmax).reshape(1), T(p1.pseudo_scales), T(p1.eden_num),
        T(p1.eden_den), T(u))
    assert np.array_equal(F.bits_to_e4m3(bits).numpy(), np.asarray(want.scales))
    assert float(gscale) == float(want.gscale)
    qt = ME.ms_eden_phase2(ME.Phase1Out(*(T(a) for a in p1)), T(u))
    assert np.array_equal(qt.scales.numpy(), np.asarray(want.scales))
    assert np.array_equal(qt.vals.numpy(), np.asarray(want.vals))


def test_zero_tensor_requant():
    packed, bits, gscale = ops.ms_eden_requant(
        torch.zeros(8, 64), torch.ones(64), torch.rand(8, 4))
    assert int(packed.sum()) == 0 and int(bits.sum()) == 0
    assert float(gscale) == 1.0


@pytest.mark.parametrize("ma,mb,d", [(64, 32, 256), (128, 96, 128), (32, 48, 384)])
def test_backward_gemm_matches_jax_kernel_path(ma, mb, d):
    a, b = _rand((ma, d), 16), _rand((mb, d), 17)
    rk = jnp.asarray([1, 2], jnp.uint32)
    ka, kb = jnp.asarray([3, 4], jnp.uint32), jnp.asarray([5, 6], jnp.uint32)
    signs = T(JR.sign_vector(rk, JR.block_size(d)))
    ua = T(_uniform(jax.random.wrap_key_data(ka), (ma, d // 16)))
    ub = T(_uniform(jax.random.wrap_key_data(kb), (mb, d // 16)))
    ops.reset_launches()
    for x, key, u in ((a, ka, ua), (b, kb, ub)):
        jc, js, jg = jrequant(jnp.asarray(x), rk, key, interpret=True)
        packed, bits, gscale = ops.ms_eden_requant(T(x), signs, u)
        assert_codes_close(F.unpack_fp4(packed).numpy(), np.asarray(jc))
        assert np.array_equal(F.bits_to_e4m3(bits).numpy(), np.asarray(js))
        assert float(gscale) == pytest.approx(float(jg), rel=1e-6)
    want = np.asarray(jops.quartet2_backward_gemm(
        jnp.asarray(a), jnp.asarray(b), rk, ka, kb))
    got = ops.quartet2_backward_gemm(T(a), T(b), signs, ua, ub).numpy()
    assert got.shape == (ma, mb)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # plain versions on the CPU: no kernel launch is counted
    assert ops.LAUNCHES["ms_eden_phase1"] == ops.LAUNCHES["ms_eden_phase2"] == 0


def _posthoc(x: torch.Tensor, draws) -> torch.Tensor:
    b = R.block_size(x.shape[-1])
    signs = draws.signs(0, b, "cpu")
    qt = ME.ms_eden_phase2(ME.ms_eden_phase1(x, signs),
                           draws.uniform(1, (x.shape[0], x.shape[1] // 16), "cpu"))
    return R.rht_inv(Q.dequant(qt), signs)


def _direct(x: torch.Tensor, draws) -> torch.Tensor:
    b = R.block_size(x.shape[-1])
    signs = draws.signs(0, b, "cpu")
    out = ME.ms_eden(x, signs, draws.uniform(1, (x.shape[0], x.shape[1] // 16),
                                             "cpu"))
    return ME.ms_eden_dequant(out, rotated=False)


def test_posthoc_unbiased():
    """tests/test_quant.py::test_posthoc_matches_direct_statistically, on the
    port with hashed draws."""
    x = T(_rand((64, 256), 18))
    acc = torch.zeros_like(x)
    n = 1024
    for i in range(n):
        acc += _posthoc(x, rng.HashDraws([i, 7]))
    rel = float((acc / n - x).norm() / x.norm())
    assert rel < 0.02, rel


def test_posthoc_vs_direct_mse_parity():
    """tests/test_quant.py::test_posthoc_vs_direct_mse_parity, on the port:
    same draws for both paths, mean MSE within 10%."""
    x = T(_rand((64, 256), 19))
    n = 128
    de = sum(float(((_direct(x, rng.HashDraws([i, 9])) - x) ** 2).mean())
             for i in range(n)) / n
    pe = sum(float(((_posthoc(x, rng.HashDraws([i, 9])) - x) ** 2).mean())
             for i in range(n)) / n
    assert abs(pe - de) < 0.10 * de, (de, pe)


# --------------------------------------------------------------------------
# hashed draws
# --------------------------------------------------------------------------

def test_hash_draws_deterministic_and_distinct():
    d = rng.HashDraws(np.array([7, 4000000000], np.uint32))
    u = d.uniform(3, (50, 40), "cpu")
    assert torch.equal(u, rng.HashDraws([7, 4000000000]).uniform(3, (50, 40), "cpu"))
    assert not torch.equal(u, d.uniform(4, (50, 40), "cpu"))
    assert not torch.equal(u, rng.HashDraws([8, 4000000000]).uniform(3, (50, 40), "cpu"))
    assert torch.equal(d.signs(1, 128, "cpu"), d.signs(1, 128, "cpu"))
    assert rng.draws(d) is d
    assert isinstance(rng.draws(np.zeros(2, np.uint32)), rng.HashDraws)


def test_hash_draws_uniform_and_balanced():
    d = rng.HashDraws([123, 456])
    u = np.sort(d.uniform(5, (100_000,), "cpu").numpy().astype(np.float64))
    assert u.min() >= 0.0 and u.max() < 1.0
    n = u.size
    ks = max((np.arange(1, n + 1) / n - u).max(), (u - np.arange(n) / n).max())
    assert ks < 1.63 / np.sqrt(n), ks
    s = d.signs(6, 100_000, "cpu").numpy()
    assert set(np.unique(s)) == {-1.0, 1.0}
    assert abs(s.mean()) < 4 / np.sqrt(s.size)


def _kernel_hash_uniform(keys, n: int) -> np.ndarray:
    """The phase-2 kernel's uniform of flat index i (csrc/ms_eden_requant.cu
    hash_uniform), in numpy uint32 arithmetic: products wrap mod 2^32."""
    def mix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x2C1B3C6D)
        return h ^ (h >> np.uint32(16))
    k, k2 = (np.uint32(v) for v in keys)
    i = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = mix(mix(i ^ k) + k2)
    return (h >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)


@pytest.mark.parametrize("seed,tag,shape", [
    ([7, 4000000000], 3, (128, 80)), ([0, 0], 0, (5, 7)),
    ([123, 456], 2**32 - 1, (1027,)), ([9, 10], 12, (96, 3))])
def test_hash_keys_give_hash_draws_uniforms_bitwise(seed, tag, shape):
    """Group counts 10,240, 35, 1,027 and 288: whole and ragged 4-group
    runs of the kernel's threads."""
    d = rng.HashDraws(seed)
    k = d.keys(tag)
    assert all(isinstance(v, int) and 0 <= v < 2**32 for v in k)
    want = d.uniform(tag, shape, "cpu")
    got = _kernel_hash_uniform(k, int(np.prod(shape))).reshape(shape)
    assert np.array_equal(got, want.numpy())
    assert torch.equal(rng.uniform_from_keys(k, shape, "cpu"), want)
    assert torch.equal(MR.uniforms(k, shape, "cpu"), want)


@pytest.mark.parametrize("shape", [(128, 256), (96, 48), (33, 80)])
def test_phase2_plain_from_keys_bitwise(shape):
    """Phase 2's plain path driven by a key pair equals phase2_plain on the
    materialized uniforms, bitwise, alone and as one of two operands."""
    x = T(_rand(shape, 31))
    d = rng.HashDraws([4, 8])
    signs = d.signs(0, R.block_size(shape[1]), "cpu")
    p1 = MR.phase1_plain(x, signs)
    u = d.uniform(1, p1[1].shape, "cpu")
    want = MR.phase2_plain(p1[4], *p1[1:4], u)
    for got in (MR.phase2_plain(p1[4], *p1[1:4], d.keys(1)),
                ops.ms_eden_phase2(p1[4], *p1[1:4], d.keys(1)),
                ops.ms_eden_phase2_batch([(p1[4], *p1[1:4], u),
                             (p1[4], *p1[1:4], d.keys(1))])[1]):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b = T(_rand((40, shape[1]), 32))
    pb = MR.phase1_plain(b, signs)
    c_keys = ops.quartet2_backward_gemm(x, b, signs, d.keys(1), d.keys(2))
    c_tensors = ops.quartet2_backward_gemm(
        x, b, signs, u, d.uniform(2, pb[1].shape, "cpu"))
    assert torch.equal(c_keys, c_tensors)


class _TensorDraws:
    """HashDraws' numbers, but not a HashDraws: the backward takes its
    uniforms as tensors."""

    def __init__(self, seed):
        self.inner = rng.HashDraws(seed)

    def signs(self, tag, n, device):
        return self.inner.signs(tag, n, device)

    def uniform(self, tag, shape, device):
        return self.inner.uniform(tag, shape, device)


def test_qlinear_backward_hashed_keys_equal_uniform_tensors(monkeypatch):
    """quartet2's backward with a hashed seed hands phase 2 key pairs (no
    uniform tensor is drawn); its gradients are BITWISE those of the same
    draws handed over as tensors."""
    x = T(_rand((2, 40, 128), 33)).bfloat16()
    w = T(_rand((96, 128), 34, 128 ** -0.5))
    e = T(_rand((2, 40, 96), 35)).bfloat16()
    seed = np.array([21, 22], np.uint32)
    seen, grads = [], {}
    real = ops.quartet2_backward_gemm

    def spy(a, b, signs, u_a, u_b):
        seen.append((type(u_a), type(u_b)))
        return real(a, b, signs, u_a, u_b)

    monkeypatch.setattr(ops, "quartet2_backward_gemm", spy)
    for name, s in (("keys", seed), ("tensors", _TensorDraws(seed))):
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        L.qlinear(tx, tw, s, "quartet2").backward(e)
        grads[name] = (tx.grad, tw.grad)
    assert seen == [(tuple, tuple)] * 2 + [(torch.Tensor, torch.Tensor)] * 2
    for g, h in zip(grads["keys"], grads["tensors"]):
        assert torch.equal(g, h)
