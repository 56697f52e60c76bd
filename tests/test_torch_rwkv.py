"""The port's RWKV-6 module (`repro_torch.models.rwkv6`) against the JAX
reference's (`repro.models.rwkv6`), function by function, at the reduced
rwkv6-7b config (d_model 128, head dim 32, LoRA rank 8, chunk 8).

Same numpy inputs from a seed; parameters are the reference's `rwkv_init`
converted with `repro_torch.convert`. The reference runs jitted. Tolerances:
  - the WKV recurrence (`wkv_chunked`, `wkv_apply` with a remainder below
    one chunk, `wkv_decode`), f32 inputs: outputs and states within
    WKV_RTOL = 2e-6 of the largest magnitude of the reference's tensor
    (exp, cumsum and the einsums' f32 sums are XLA's own against
    PyTorch's; measured at most 3.7e-7);
  - the per-token remainder of `wkv_apply` against `wkv_decode` steps of the
    port itself: BITWISE (the same `_wkv_step`, the speculative verify
    chunk's premise);
  - `timemix_apply` and `channelmix_apply` under scheme bf16, with and
    without a carried state / token shift: outputs within BF16_ULPS = 2
    bf16 ulps of max|out| (the LoRA's tanh and the decay's exp are XLA's
    polynomials, so an f32 input of a bf16 rounding may sit an ulp away;
    measured one ulp, channel-mix bitwise), the time-mix state within
    STATE_FRAC = 5e-3 of its max (r, k, v are bf16 outputs an ulp apart
    where they differ; measured 1.5e-3), the carried last token bitwise
    (it is the input's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import rwkv6 as JW
from repro_torch.configs import registry
from repro_torch.convert import _convert
from repro_torch.models import rwkv6 as W

SEED = np.array([1, 2], np.uint32)
WKV_RTOL = 2e-6
BF16_ULPS = 2
STATE_FRAC = 5e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jregistry.get("rwkv6_7b").reduced()
    cfg = registry.get("rwkv6_7b").reduced()
    jp = JW.rwkv_init(jax.random.PRNGKey(3), jcfg)
    p = _convert(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p


def _wkv_inputs(b, s, h, d, seed=0):
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(b, s, h, d).astype(np.float32) * 0.5 for _ in range(3))
    logw = np.clip(-np.exp(rs.randn(b, s, h, d) - 1.0), JW.LOG_W_MIN,
                   -1e-4).astype(np.float32)
    u = (rs.randn(h, d) * 0.1).astype(np.float32)
    state = (rs.randn(b, h, d, d) * 0.2).astype(np.float32)
    return r, k, v, logw, u, state


def _close(got, want, rtol=WKV_RTOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(scale, 1e-30), (err, scale)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -126))) - 7)
    err = float(np.abs(np.asarray(got.float(), np.float32) - want).max())
    assert err <= BF16_ULPS * ulp, (err, ulp)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8)],
                         ids=["chunked", "with_remainder"])
def test_wkv_chunked_and_apply_match_jax(s, chunk):
    args = _wkv_inputs(2, s, 4, 32)
    if s % chunk == 0:
        jo, js = jax.jit(JW.wkv_chunked, static_argnums=6)(*args, chunk)
        o, st = W.wkv_chunked(*_t(*args), chunk)
        _close(o, jo)
        _close(st, js)
    jo, js = jax.jit(JW.wkv_apply, static_argnums=6)(*args, chunk)
    o, st = W.wkv_apply(*_t(*args), chunk)
    _close(o, jo)
    _close(st, js)


def test_wkv_decode_matches_jax_and_the_tail_is_its_steps():
    r, k, v, logw, u, state = _wkv_inputs(2, 5, 4, 32, seed=1)
    jo, js = jax.jit(JW.wkv_decode)(r[:, :1], k[:, :1], v[:, :1], logw[:, :1],
                                    u, state)
    tr, tk, tv, tw, tu, ts = _t(r, k, v, logw, u, state)
    o, st = W.wkv_decode(tr[:, :1], tk[:, :1], tv[:, :1], tw[:, :1], tu, ts)
    _close(o, jo)
    _close(st, js)
    # a chunk below `chunk` tokens is exactly its single-token steps
    tail, tail_state = W.wkv_apply(tr, tk, tv, tw, tu, ts, chunk=8)
    steps, S = [], ts
    for t in range(5):
        o, S = W.wkv_decode(tr[:, t:t + 1], tk[:, t:t + 1], tv[:, t:t + 1],
                            tw[:, t:t + 1], tu, S)
        steps.append(o)
    assert torch.equal(tail, torch.cat(steps, dim=1))
    assert torch.equal(tail_state, S)


def _x(cfg, b, s, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, s, cfg.d_model) * 0.5).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("s", [1, 12])
def test_timemix_matches_jax(carried, s):
    jcfg, cfg, jp, p = _setup()
    jx, x = _x(cfg, 2, s, seed=4 + s)
    h, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    jkw, kw = {}, {}
    if carried:
        rs = np.random.RandomState(9)
        st = (rs.randn(2, h, hd, hd) * 0.2).astype(np.float32)
        prev = (rs.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
        jkw = dict(state=jnp.asarray(st), prev=jnp.asarray(prev, jnp.bfloat16))
        kw = dict(state=torch.from_numpy(st),
                  prev=torch.from_numpy(prev).bfloat16())
    fn = jax.jit(lambda p_, x_, **k: JW.timemix_apply(
        p_, x_, jcfg, "bf16", jnp.asarray(SEED), 0, **k))
    jo, jst, jlast = fn(jp, jx, **jkw)
    with torch.no_grad():
        o, st, last = W.timemix_apply(p, x, cfg, "bf16", SEED, 0, **kw)
    assert o.dtype == torch.bfloat16 and tuple(o.shape) == tuple(jo.shape)
    _bf16_close(o, jo)
    _close(st, jst, STATE_FRAC)
    assert torch.equal(last.float(), torch.from_numpy(
        np.asarray(jlast, np.float32)))


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_channelmix_matches_jax(carried):
    jcfg, cfg, jp, p = _setup()
    jx, x = _x(cfg, 2, 7, seed=11)
    jkw, kw = {}, {}
    if carried:
        prev = (np.random.RandomState(12).randn(2, 1, cfg.d_model) * 0.5
                ).astype(np.float32)
        jkw = dict(prev=jnp.asarray(prev, jnp.bfloat16))
        kw = dict(prev=torch.from_numpy(prev).bfloat16())
    fn = jax.jit(lambda p_, x_, **k: JW.channelmix_apply(
        p_, x_, jcfg, "bf16", jnp.asarray(SEED), 0, **k))
    jo, jlast = fn(jp, jx, **jkw)
    with torch.no_grad():
        o, last = W.channelmix_apply(p, x, cfg, "bf16", SEED, 0, **kw)
    _bf16_close(o, jo)
    assert torch.equal(last.float(), torch.from_numpy(
        np.asarray(jlast, np.float32)))
