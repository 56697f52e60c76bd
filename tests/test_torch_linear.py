"""The port's quantized linear against the JAX reference.

- `pack_weight` is BITWISE equal to the reference's (packed bytes, e4m3 scale
  bits, gscale), and converting the reference's prequantized parameters
  gives exactly the port's own prequantized parameters;

The bitwise claims hold against the reference run EAGERLY, as its serving
engine runs `prequantize`. Under `jax.jit`, XLA rewrites a division by a
constant into a multiplication by the f32 reciprocal, which moves the
per-tensor gscale `absmax / C` by one ulp for ~2% of tensors; the port, like
the reference's source and its eager run, divides (IEEE).
- the plain `fp4_matmul` op against the reference's Pallas kernel (interpret
  mode): |dC| <= 1e-5 max|C| (exact block values; only the fp32 summation
  order differs);
- `qlinear` on packed (quartet2) and raw (bf16) weights against the
  reference: equal (bf16 outputs; the fp32 sums round to the same bf16 at
  these sizes, allowed one bf16 ulp);
- inside the port, prequant == per-step quantization, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import formats as JF
from repro.core import linear as JL
from repro.kernels import ops as jops
from repro.serve import prequant as jprequant
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import formats as F
from repro_torch.core import linear as L
from repro_torch.kernels import ops
from repro_torch.serve import prequant

SEED = jnp.zeros((2,), jnp.uint32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["fos", "rtn"])
@pytest.mark.parametrize("shape", [(96, 128), (16, 3456)])
def test_pack_weight_bitwise_vs_jax(kind, shape):
    w = _rand(shape, 0, shape[1] ** -0.5)
    jw = JL.pack_weight(jnp.asarray(w), kind)
    tw = L.pack_weight(torch.from_numpy(w), kind)
    assert np.array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    assert np.array_equal(tw.scale_bits.numpy(),
                          np.asarray(jw.scales8).view(np.uint8))
    assert float(tw.gscale) == float(jw.gscale)


def test_converted_prequant_params_equal_port_prequant():
    """A stacked two-layer leaf, a norm and the head (one packed leaf keeps
    the reference's eager prequantize cheap)."""
    jcfg = jregistry.get("llama_200m").reduced()
    cfg = registry.get("llama_200m").reduced()
    jparams = {"stages": [{"l0": {"mix": {"wq": jnp.asarray(_rand((2, 64, 128), 3))},
                                  "n1": {"g": jnp.ones((2, 128))}}}],
               "head": jnp.asarray(_rand((512, 128), 4))}
    mine = prequant.prequantize(
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"), cfg, "quartet2")
    theirs = params_from_jax(jax.tree.map(
        np.asarray, jprequant.prequantize(jparams, jcfg, "quartet2")), cfg, "cpu")
    w = mine["stages"][0]["l0"]["mix"]["wq"]
    other = theirs["stages"][0]["l0"]["mix"]["wq"]
    assert isinstance(other, L.PackedQWeight) and w.packed.shape == (2, 64, 64)
    for a, b in zip(w, other):
        assert torch.equal(a, b)
    for leaf in (lambda t: t["stages"][0]["l0"]["n1"]["g"], lambda t: t["head"]):
        assert torch.equal(leaf(mine), leaf(theirs))  # not packed


@pytest.mark.parametrize("m,n,k", [(64, 128, 256), (8, 96, 512)])
def test_plain_fp4_matmul_vs_jax_kernel(m, n, k):
    a = L.pack_weight(torch.from_numpy(_rand((m, k), 1)), "fos")
    b = L.pack_weight(torch.from_numpy(_rand((n, k), 2)), "fos")
    got = ops.fp4_matmul(a.packed, a.scale_bits, b.packed, b.scale_bits,
                         a.gscale, b.gscale).numpy()
    want = np.asarray(jops.fp4_matmul(
        jnp.asarray(a.packed.numpy()), jnp.asarray(F.bits_to_e4m3(a.scale_bits).numpy()),
        jnp.asarray(b.packed.numpy()), jnp.asarray(F.bits_to_e4m3(b.scale_bits).numpy()),
        jnp.asarray(float(a.gscale)), jnp.asarray(float(b.gscale)),
        bm=min(m, 64), bn=min(n, 32), bk=128, interpret=True))
    assert got.shape == (m, n) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _bf16_ulps(a, b):
    a = torch.from_numpy(a).bfloat16().view(torch.int16).int()
    b = torch.from_numpy(np.array(b)).bfloat16().view(torch.int16).int()
    return (a - b).abs().max().item()


@pytest.mark.parametrize("scheme", ["quartet2", "bf16"])
@pytest.mark.parametrize("m,n,k", [(4, 96, 128), (3, 128, 3456)])
def test_qlinear_vs_jax(scheme, m, n, k):
    x = _rand((2, m, k), 5)
    w = _rand((n, k), 6, k ** -0.5)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    if scheme == "quartet2":
        jw, tw = JL.pack_weight(jnp.asarray(w), "fos"), L.pack_weight(
            torch.from_numpy(w), "fos")
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    want = np.asarray(JL.qlinear(jx, jw, SEED, scheme).astype(jnp.float32))
    got = L.qlinear(tx, tw, None, scheme)
    assert got.dtype == torch.bfloat16 and got.shape == (2, m, n)
    assert _bf16_ulps(got.float().numpy(), want) <= 1


@pytest.mark.parametrize("scheme", ["quartet2", "fwd_rtn_1x16", "fwd_rtn_1x16_fos"])
def test_prequant_equals_per_step_bitwise(scheme):
    x = torch.from_numpy(_rand((6, 256), 7)).bfloat16()
    w = torch.from_numpy(_rand((128, 256), 8, 1 / 16))
    kind = "fos" if scheme != "fwd_rtn_1x16" else "rtn"
    assert torch.equal(L.qlinear(x, w, None, scheme),
                       L.qlinear(x, L.pack_weight(w, kind), None, scheme))


def test_square_block_schemes_raise():
    w = torch.from_numpy(_rand((32, 64), 9))
    with pytest.raises(NotImplementedError):
        L.pack_weight(w, "square")
