"""The port's NVFP4 KV pool against the JAX reference: the cache codec, the
packed pool primitives, the packed GQA decode (#6's plain version) and the
kv_quant engine.

Tolerances:
  - `nvfp4_cache_encode`: codes and e4m3 scale bits BITWISE equal to the
    reference's (eager JAX: the same IEEE divisions and roundings), and
    `nvfp4_cache_decode` bitwise (the dequant is exact in bf16);
  - packed `scatter_tokens` / `gather_view`: bitwise;
  - `ops.paged_gqa_q` on CPU tensors (the plain version) against
    `repro.kernels.ops.paged_attention_q` (the Pallas kernel in interpret
    mode) at ATOL, RTOL = 5e-6, 1e-5, the bar of tests/test_kv_quant.py;
    inactive rows exactly 0;
  - engine: bf16 greedy streams equal to the reference engine's
    (kv_quant=True, paged_kernel=True) up to a row's first reference
    near-tie of 2 bf16 ulps (here request 4's second token has a one-ulp
    top-2 margin); quartet2 streams equal up to a narrow reference margin
    (tests/_torch_streams.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_streams import (assert_equal_up_to_bf16_ties,
                            assert_equal_up_to_narrow_margin, run_jax,
                            run_port)
from repro.configs import registry as jregistry
from repro.core import formats as JF
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serve import kv_pool as jkv
from repro_torch.configs import registry
from repro_torch.core import formats as F
from repro_torch.kernels import ops
from repro_torch.serve import kv_pool as kv

ATOL, RTOL = 5e-6, 1e-5
BS, MAXB, N_BLOCKS = 4, 4, 10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bf16(a):
    """(port bf16 tensor, JAX bf16 array) of the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _codec_inputs():
    rng = np.random.RandomState(0)
    return {
        "normal": rng.randn(6, 4, 2, 64) * 3,
        "heavy": rng.randn(5, 3, 32) * np.exp(rng.randn(5, 3, 32) * 3),
        "tiny": rng.randn(4, 48) * 1e-30,
        "zeros_and_ties": np.concatenate(
            [np.zeros((2, 16)), np.tile(np.arange(16) * 0.25, (2, 1))]),
    }


@pytest.mark.parametrize("name", sorted(_codec_inputs()))
def test_cache_codec_bitwise_equal_to_jax(name):
    x, jx = _bf16(_codec_inputs()[name])
    codes, scales = F.nvfp4_cache_encode(x)
    jcodes, jscales = JF.nvfp4_cache_encode(jx)
    assert codes.dtype == scales.dtype == torch.uint8
    assert codes.shape == (*x.shape[:-1], x.shape[-1] // 2)
    assert scales.shape == (*x.shape[:-1], x.shape[-1] // 16)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    dec = F.nvfp4_cache_decode(codes, scales)
    jdec = JF.nvfp4_cache_decode(jcodes, jscales)
    assert dec.dtype == torch.bfloat16
    np.testing.assert_array_equal(dec.float().numpy(),
                                  np.asarray(jdec.astype(jnp.float32)))
    # exact: the f32 decode is the bf16 decode
    assert torch.equal(F.nvfp4_cache_decode(codes, scales, torch.float32),
                       dec.float())
    assert float(F.nvfp4_cache_overflow(x)) == 0.0
    assert float(F.nvfp4_cache_overflow(x)) == float(JF.nvfp4_cache_overflow(jx))
    assert (codes.numel() + scales.numel()) / (x.numel() * 2) == 0.28125


def test_packed_scatter_and_gather_bitwise_equal_to_jax():
    """Per-token encode at scatter time, drops (inactive rows, negative
    positions, past the table, sentinel entries) into the scratch block,
    and gather_view's exact bf16 dequant with zeros for sentinels."""
    rng = np.random.RandomState(1)
    table = np.array([[3, 1, N_BLOCKS, N_BLOCKS], [0, 2, 4, 5],
                      [N_BLOCKS] * 4], np.int32)
    positions = np.array([[6, 7, 8, 9], [-1, 0, 15, 16], [0, 1, 2, 3]],
                         np.int32)
    valid = np.array([[True] * 4, [True] * 4, [False] * 4])
    vals, jvals = _bf16(rng.randn(3, 4, 2, 32) * 2)
    old, jold = _bf16(rng.randn(N_BLOCKS, BS, 2, 32))
    jpool = jkv.PackedKV(*JF.nvfp4_cache_encode(jold))
    jpool = jkv.scatter_tokens(jpool, jnp.asarray(table), jnp.asarray(positions),
                               jvals, jnp.asarray(valid))
    codes, scales = F.nvfp4_cache_encode(old)
    pool = kv.PackedKV(torch.cat([codes, torch.zeros_like(codes[:1])]),
                       torch.cat([scales, torch.zeros_like(scales[:1])]))
    kv.scatter_tokens(pool, torch.from_numpy(table),
                      torch.from_numpy(positions), vals,
                      torch.from_numpy(valid))
    readable = kv.readable(pool)
    np.testing.assert_array_equal(readable.codes.numpy(),
                                  np.asarray(jpool.codes))
    np.testing.assert_array_equal(readable.scales.numpy(),
                                  np.asarray(jpool.scales))
    view = kv.gather_view(readable, torch.from_numpy(table))
    jview = jkv.gather_view(jpool, jnp.asarray(table))
    assert view.dtype == torch.bfloat16
    np.testing.assert_array_equal(view.float().numpy(),
                                  np.asarray(jview.astype(jnp.float32)))


def test_quantized_pool_construction_and_guards():
    cfg = registry.get("llama_200m").reduced()
    pool = kv.KVPool(cfg, 2, 32, block_size=4, device="cpu", quantized=True)
    assert pool.quantized
    k, v = pool.caches[0]["l0"]["kv"]
    assert isinstance(k, kv.PackedKV)
    assert k.codes.shape == (cfg.n_layers, pool.n_blocks + 1, 4,
                             cfg.n_kv_heads, cfg.hd // 2)
    assert k.scales.shape == (cfg.n_layers, pool.n_blocks + 1, 4,
                              cfg.n_kv_heads, cfg.hd // 16)
    assert k.codes.dtype == k.scales.dtype == torch.uint8
    assert not k.codes.any() and not v.scales.any()  # decode to exact zeros
    with pytest.raises(ValueError):
        kv.KVPool(cfg, 2, 32, block_size=4, device="cpu", paged=False,
                  quantized=True)
    with pytest.raises(NotImplementedError):
        kv.KVPool(cfg, 2, 32, block_size=4, device="cpu", paged=False)
    odd = cfg.__class__(**{**cfg.__dict__, "head_dim": 8})
    with pytest.raises(ValueError):
        kv.KVPool(odd, 2, 32, block_size=4, device="cpu", quantized=True)


def _table(rng, lens):
    table = np.full((len(lens), MAXB), N_BLOCKS, np.int32)
    free = list(rng.permutation(N_BLOCKS))
    for i, n in enumerate(lens):
        for j in range(-(-n // BS)):
            table[i, j] = free.pop()
    return table


def _pool(rng, table, lens, *feat):
    """bf16 values: real ones at backed positions, garbage (x7) elsewhere."""
    pool = rng.randn(N_BLOCKS, BS, *feat) * 7.0
    for i, n in enumerate(lens):
        for t in range(n):
            if table[i, t // BS] < N_BLOCKS:
                pool[table[i, t // BS], t % BS] = rng.randn(*feat) * 0.5
    return _bf16(pool)


@pytest.mark.parametrize("sq,window", [(1, None), (1, 6), (3, None), (3, 6)])
def test_plain_paged_gqa_q_matches_jax_kernel(sq, window):
    rng = np.random.RandomState(10 * sq + (window or 0))
    kvh, rep, hd = 2, 2, 32
    lens = [5, 11, 16, 0]     # ragged; partial tables; row 3 inactive
    table = _table(rng, lens)
    pos = np.asarray([max(n - sq, 0) for n in lens], np.int32)
    (kp, jkp), (vp, jvp) = (_pool(rng, table, lens, kvh, hd) for _ in range(2))
    (kc, ks), (vc, vs) = F.nvfp4_cache_encode(kp), F.nvfp4_cache_encode(vp)
    q = (rng.randn(len(lens), sq, kvh * rep, hd) * 0.5).astype(np.float32)
    jk, jv = JF.nvfp4_cache_encode(jkp), JF.nvfp4_cache_encode(jvp)
    want = np.asarray(jops.paged_attention_q(
        jnp.asarray(q), *jk, *jv, jnp.asarray(table), jnp.asarray(pos),
        window=window, interpret=True))
    ops.reset_launches()
    got = ops.paged_gqa_q(torch.from_numpy(q), kc, ks, vc, vs,
                          torch.from_numpy(table), torch.from_numpy(pos),
                          window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert not got[3].any() and not np.abs(want[3]).max()  # inactive row
    assert sum(ops.LAUNCHES.values()) == 0  # CPU: the plain version


# ---- engine: reduced llama-200m with kv_quant, against the reference ----

PROMPT_LENS = (19, 5, 11, 8, 3)
MAX_NEW = 6
Q2_LOGIT_TOL = 0.25
KW = dict(n_slots=2, max_len=48, prefill_chunk=8, kv_quant=True)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jregistry.get("llama_200m").reduced()
    return jcfg, jlm.init(jcfg, jax.random.PRNGKey(0))


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_streams():
    jcfg, jparams = _weights()
    return {s: run_jax(jcfg, jparams, _prompts(jcfg.vocab), MAX_NEW,
                       scheme=s, paged_kernel=True, **KW)
            for s in ("bf16", "quartet2")}


def _port(scheme):
    jcfg, jparams = _weights()
    cfg = registry.get("llama_200m").reduced()
    got, eng = run_port(cfg, jparams, _prompts(cfg.vocab), MAX_NEW,
                        scheme=scheme, **KW)
    assert eng.pool.quantized
    return got


def test_kv_quant_bf16_greedy_streams_equal_jax(jax_streams):
    want, margins = jax_streams["bf16"]
    assert_equal_up_to_bf16_ties(_port("bf16"), want, margins,
                                 len(PROMPT_LENS), MAX_NEW)


def test_kv_quant_quartet2_streams_equal_jax_up_to_a_narrow_margin(jax_streams):
    want, margins = jax_streams["quartet2"]
    assert_equal_up_to_narrow_margin(_port("quartet2"), want, margins,
                                     Q2_LOGIT_TOL, MAX_NEW)
