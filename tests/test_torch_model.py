"""The port's paged serving step against the JAX reference step.

Same weights (JAX init, converted with `repro_torch.convert`), same token
stream, teacher-forced through prefill chunks and decode steps; the JAX side
is `make_paged_serve_step(paged_kernel=True)` with its Pallas kernel in
interpret mode, the port side its plain-version kernels on the CPU. Logits
are compared at every step.

Tolerances. The port reproduces the reference's bf16 roundings and its
quantizers bit for bit (tests/test_torch_formats.py, test_torch_linear.py),
but its fp32 sums (matmul, attention, softmax) and its cos/sin run in another
order or libm, so a bf16 rounding somewhere upstream flips by one ulp:
  - bf16: |dlogit| <= LOGIT_ATOL (measured <= 9e-3 on logits up to ~0.9,
    i.e. 1-2 bf16 ulps);
  - quartet2: one flipped ulp can move a tensor's absmax and with it every
    NVFP4 code of the tensor, so the two packages draw different, equally
    valid quantization noise. The bar: per step, the relative RMS distance
    of the port's logits to the reference's is below Q2_NOISE_FRACTION of the
    reference's own quantization error (its quartet2 logits against its bf16
    logits on the same step); measured ratios are 0.48-0.59.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve import kv_pool as jkv
from repro.serve import prequant as jprequant
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import blocks
from repro_torch.serve import decode as tdecode
from repro_torch.serve import prequant
from repro_torch.serve.kv_pool import KVPool

LOGIT_ATOL = 2e-2
Q2_NOISE_FRACTION = 0.75
CHUNK = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _schedule(vocab, rng):
    """Engine-like steps for 2 slots: row 0 prefills a 20-token prompt in two
    chunks and four single tokens (row 1 inactive), row 1 an 8-token prompt in
    one chunk, then three batched decode steps."""
    p0 = rng.randint(0, vocab, 20)
    p1 = rng.randint(0, vocab, 8)
    steps = []
    for start in (0, 8):
        steps.append(([p0[start:start + CHUNK], [0] * CHUNK], [start, 0],
                      [True, False]))
    for t in range(16, 20):
        steps.append(([[p0[t]], [0]], [t, 0], [True, False]))
    steps.append(([[0] * CHUNK, p1], [0, 0], [False, True]))
    for d in range(3):
        toks = rng.randint(0, vocab, 2)
        steps.append(([[toks[0]], [toks[1]]], [20 + d, 8 + d], [True, True]))
    return [(np.asarray(t, np.int32), np.asarray(p, np.int32),
             np.asarray(a, bool)) for t, p, a in steps]


@functools.lru_cache(maxsize=None)
def _run_both(arch, scheme):
    jcfg = jregistry.get(arch).reduced()
    cfg = registry.get(arch).reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jp = jprequant.prequantize(jparams, jcfg, scheme)
    tp = prequant.prequantize(params, cfg, scheme)

    jpool = jkv.KVPool(jcfg, 2, 32, paged=True, block_size=4)
    tpool = KVPool(cfg, 2, 32, block_size=4, device="cpu")
    for pool in (jpool, tpool):
        for s, n in ((0, 23), (1, 11)):
            pool.commit(s, n)
            pool.ensure(s, n)
    jstep = jax.jit(jdecode.make_paged_serve_step(jcfg, scheme,
                                                  paged_kernel=True))
    tstep = tdecode.make_paged_serve_step(cfg, scheme)
    caches = jpool.caches
    out = []
    for toks, pos, act in _schedule(cfg.vocab, np.random.RandomState(1)):
        jl, caches = jstep(jp, caches, jpool.table_device(), jnp.asarray(toks),
                           jnp.asarray(pos), jnp.asarray(act))
        tl, _ = tstep(tp, tpool.caches, tpool.tables_device(),
                      torch.from_numpy(toks), torch.from_numpy(pos),
                      torch.from_numpy(act))
        out.append((np.asarray(jl.astype(jnp.float32)), tl.float().numpy(),
                    act))
    return out


def _rel_rms(x, y, rows):
    return float(np.sqrt(((x - y)[rows] ** 2).mean() / (y[rows] ** 2).mean()))


@pytest.mark.parametrize("arch", ["llama_200m", "yi_9b"])
def test_paged_step_logits_match_jax_bf16(arch):
    for jl, tl, act in _run_both(arch, "bf16"):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        diff = np.abs(tl - jl)[act]  # inactive rows carry no claim
        assert diff.max() <= LOGIT_ATOL, (diff.max(), np.abs(jl).max())


@pytest.mark.parametrize("arch", ["llama_200m", "yi_9b"])
def test_paged_step_logits_match_jax_quartet2(arch):
    ref_bf16 = _run_both(arch, "bf16")
    for (jl, tl, act), (jb, _, _) in zip(_run_both(arch, "quartet2"), ref_bf16):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        noise = _rel_rms(jl, jb, act)
        assert _rel_rms(tl, jl, act) <= Q2_NOISE_FRACTION * noise, noise


def test_site_seed_matches_jax():
    seed = np.array([7, 4000000000], np.uint32)
    for layer, site in ((0, 0), (3, 12), (47, 99)):
        want = np.asarray(jblocks.site_seed(jnp.asarray(seed), layer, site))
        assert np.array_equal(blocks.site_seed(seed, layer, site), want)
