"""The port's MLA decode against the JAX reference: the plain versions of
kernels #7 and #8, one `mla_decode` layer over the paged latent pools, and
the ServeEngine on reduced deepseek-v3.

Tolerances:
  - `ops.paged_mla` / `ops.paged_mla_q` on CPU tensors (the plain versions)
    against `repro.kernels.ops.paged_mla_attention(_q)` (the Pallas kernels
    in interpret mode) at ATOL, RTOL = 5e-6, 1e-5, the bar of
    tests/test_paged_attention.py and tests/test_kv_quant.py; inactive rows
    exactly 0;
  - one `mla_decode` layer against the reference's, run eagerly (under
    `jax.jit` XLA turns a division by a constant into a multiplication by
    its reciprocal, PERF.md §6), same weights and inputs, bf16 and NVFP4
    pools: the updated pools BITWISE equal (the latent projections and the
    cache codec are bit-exact), the bf16 output within one bf16 rounding
    (2^-7 relative; the attention's fp32 sums run in another order);
  - the engine on reduced deepseek-v3 (capacity_factor 8.0, so no row is
    dropped and bf16 rows stay independent) against the reference's jitted
    engine (paged_kernel=True): bf16 greedy streams equal up to a row's
    first reference near-tie of 2 bf16 ulps (tests/_torch_streams.py).
    Under quartet2 the reference's first sampled token on this model already
    has a top-2 margin below the narrow-margin rule's 0.25, so that rule
    would claim no token; quartet2 is held per step instead:
    the whole paged step with the bf16 latent pool against the reference's
    step run eagerly, logits within 2e-2 (tests/test_torch_moe.py states
    the bar; measured bit-identical).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_streams import assert_equal_up_to_bf16_ties, run_jax, run_port
from test_torch_moe import paged_step_logits_match_eager_jax_quartet2
from repro.configs import registry as jregistry
from repro.core import formats as JF
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.serve import kv_pool as jkv
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import formats as F
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models import mla
from repro_torch.serve import kv_pool as kv

ATOL, RTOL = 5e-6, 1e-5
BS, MAXB, N_BLOCKS = 4, 4, 10
SEED = np.array([7, 7], np.uint32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bf16(a):
    """(port bf16 tensor, JAX bf16 array) of the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _table(rng, lens):
    table = np.full((len(lens), MAXB), N_BLOCKS, np.int32)
    free = list(rng.permutation(N_BLOCKS))
    for i, n in enumerate(lens):
        for j in range(-(-n // BS)):
            table[i, j] = free.pop()
    return table


def _pool(rng, table, lens, dim):
    """bf16 latents: real ones at backed positions, garbage (x7) elsewhere."""
    pool = rng.randn(N_BLOCKS, BS, dim) * 7.0
    for i, n in enumerate(lens):
        for t in range(n):
            if table[i, t // BS] < N_BLOCKS:
                pool[table[i, t // BS], t % BS] = rng.randn(dim) * 0.5
    return _bf16(pool)


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("packed", [False, True], ids=["bf16", "nvfp4"])
def test_plain_paged_mla_matches_jax_kernel(sq, packed):
    rng = np.random.RandomState(sq + 10 * packed)
    h, lora, rope, qk_dim = 3, 32, 16, 48
    lens = [6, 14, 0]                       # ragged; row 2 inactive
    table = _table(rng, lens)
    pos = np.asarray([max(n - sq, 0) for n in lens], np.int32)
    (cc, jcc), (kc, jkc) = _pool(rng, table, lens, lora), _pool(rng, table,
                                                               lens, rope)
    qa = (rng.randn(len(lens), sq, h, lora) * 0.5).astype(np.float32)
    qr = (rng.randn(len(lens), sq, h, rope) * 0.5).astype(np.float32)
    jargs = (jnp.asarray(table), jnp.asarray(pos))
    targs = (torch.from_numpy(table), torch.from_numpy(pos))
    ops.reset_launches()
    if packed:
        want = jops.paged_mla_attention_q(
            jnp.asarray(qa), jnp.asarray(qr), *JF.nvfp4_cache_encode(jcc),
            *JF.nvfp4_cache_encode(jkc), *jargs, qk_dim=qk_dim,
            interpret=True)
        got = ops.paged_mla_q(torch.from_numpy(qa), torch.from_numpy(qr),
                              *F.nvfp4_cache_encode(cc),
                              *F.nvfp4_cache_encode(kc), *targs, qk_dim=qk_dim)
    else:
        want = jops.paged_mla_attention(
            jnp.asarray(qa), jnp.asarray(qr), jcc, jkc, *jargs, qk_dim=qk_dim,
            interpret=True)
        got = ops.paged_mla(torch.from_numpy(qa), torch.from_numpy(qr), cc, kc,
                            *targs, qk_dim=qk_dim)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert not got[2].any() and not np.abs(want[2]).max()  # inactive row
    assert sum(ops.LAUNCHES.values()) == 0  # CPU: the plain versions


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jregistry.get("deepseek_v3_671b").reduced()
    return jcfg, jlm.init(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "nvfp4"])
def test_mla_decode_layer_matches_jax(scheme, quantized):
    """One absorbed-form decode layer over the paged latent pools: a
    3-token chunk per row, ragged positions, an inactive row."""
    jcfg, jparams = _weights()
    cfg = registry.get("deepseek_v3_671b").reduced()
    jp = jax.tree.map(lambda a: a[0], jparams["stages"][0]["l0"]["mix"])
    tp = lm.layer_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")["stages"][0]["l0"]["mix"],
        0)
    m = cfg.mla
    rng = np.random.RandomState(3)
    lens = [9, 14, 0]
    table = _table(rng, lens)
    pos = np.asarray([6, 11, 0], np.int32)
    active = np.asarray([True, True, False])
    x, jx = _bf16(rng.randn(3, 3, cfg.d_model))
    (cc, jcc), (kc, jkc) = (_pool(rng, table, lens, d)
                            for d in (m.kv_lora_rank, m.qk_rope_head_dim))
    if quantized:
        jcache = tuple(jkv.PackedKV(*JF.nvfp4_cache_encode(p)) for p in (jcc, jkc))
        tcache = tuple(kv.PackedKV(*(torch.cat([a, torch.zeros_like(a[:1])])
                                     for a in F.nvfp4_cache_encode(p)))
                       for p in (cc, kc))
    else:
        jcache = (jcc, jkc)
        tcache = tuple(torch.cat([p, torch.zeros_like(p[:1])]) for p in (cc, kc))
    with jax.disable_jit():
        jout, jnew = jmla.mla_decode(
            jp, jx, jcfg, scheme, jnp.asarray(SEED), 0, jcache,
            jnp.asarray(pos), active=jnp.asarray(active),
            block_table=jnp.asarray(table), paged_kernel=True)
    out, new = mla.mla_decode(tp, x, cfg, scheme, SEED, 0, tcache,
                              torch.from_numpy(pos),
                              active=torch.from_numpy(active),
                              block_table=torch.from_numpy(table))
    for leaf, jleaf in zip(new, jnew):
        for a, b in zip(jax.tree.leaves(kv.readable(leaf)),
                        jax.tree.leaves(jleaf)):
            np.testing.assert_array_equal(
                a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy(),
                np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                           else b))
    o, jo = out.float().numpy(), np.asarray(jout.astype(jnp.float32))
    assert out.dtype == torch.bfloat16 and o.shape == jo.shape
    np.testing.assert_allclose(o, jo, rtol=2.0 ** -7, atol=1e-6)


# ---- engine: reduced deepseek-v3, bf16 pool, against the reference ----

PROMPT_LENS = (19, 5, 11, 8, 3)
MAX_NEW = 6
KW = dict(n_slots=2, max_len=48, prefill_chunk=8)


def _no_drop(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def test_bf16_greedy_streams_equal_jax():
    jcfg, jparams = _weights()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, jcfg.vocab, n).tolist() for n in PROMPT_LENS]
    want, margins = run_jax(_no_drop(jcfg), jparams, prompts, MAX_NEW,
                            scheme="bf16", paged_kernel=True, **KW)
    cfg = _no_drop(registry.get("deepseek_v3_671b").reduced())
    got, eng = run_port(cfg, jparams, prompts, MAX_NEW, scheme="bf16", **KW)
    assert not eng.pool.quantized
    assert_equal_up_to_bf16_ties(got, want, margins, len(PROMPT_LENS), MAX_NEW)


def test_paged_step_logits_match_eager_jax_quartet2_bf16_pool():
    paged_step_logits_match_eager_jax_quartet2(quantized=False)
