"""The port's Griffin module (`repro_torch.models.griffin`) against the JAX
reference's (`repro.models.griffin`), function by function, at the reduced
recurrentgemma-9b config (d_model = lru width 128, conv width 4), and the
sliding-window ring cache (`models.attention`, `lm._fill_cache`).

Same numpy inputs from a seed; parameters are the reference's `rglru_init`
and `gqa_init` converted with `repro_torch.convert`. Tolerances:
  - `associative_scan` on the same (a, b) against `jax.lax.associative_scan`
    run EAGERLY (`jax.disable_jit`, each primitive on its own): BITWISE, at
    even and odd lengths (the same odd/even recursion, so every f32 product
    and sum comes in the reference's order);
  - `rglru_scan` (with and without a carried h0), `rglru_step`: f32 inputs,
    bf16 outputs within GATE_ULPS = 2 bf16 ulps of max|h| (the gates'
    sigmoid, exp and log1p are XLA's polynomials against PyTorch's: an f32
    ulp apart before the final bf16 rounding; measured 0.06 of an ulp of
    the max, the step's bitwise), the step's f32 state within STATE_RTOL =
    2e-6 of its max (measured 2.1e-7);
  - `_conv1d` with and without a tail: BITWISE (bf16 products and sums in
    the reference's order);
  - `recurrent_block_apply` under scheme bf16 (train form, and prefill with
    a carried state): outputs and the new h (the scan's last output, rounded
    to bf16 before it becomes the f32 state) within GATE_ULPS bf16 ulps of
    their max (measured one ulp), the conv tail bitwise;
  - ring cache: decode over a window-sized ring filled by the prefill roll
    (S = 13, window 8, four wrap points) BITWISE a full-capacity cache under
    the window mask, as tests/test_serve.py holds the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import griffin as JG
from repro.models import attention as JA
from repro_torch.configs import registry
from repro_torch.convert import _convert
from repro_torch.models import attention as A
from repro_torch.models import griffin as G
from repro_torch.models import lm

SEED = np.array([1, 2], np.uint32)
GATE_ULPS = 2
STATE_RTOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jregistry.get("recurrentgemma_9b").reduced()
    cfg = registry.get("recurrentgemma_9b").reduced()
    jp = JG.rglru_init(jax.random.PRNGKey(5), jcfg)
    # nonzero biases and a conv bias, so every leaf is exercised
    rs = np.random.RandomState(6)
    jp = {**jp, **{k: jnp.asarray(rs.randn(*jp[k].shape).astype(np.float32)
                                  * 0.1) for k in ("ba", "bx", "conv_b")}}
    p = _convert(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p


def _ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -126))) - 7)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got.float(), np.float32) - want).max())
    assert err <= GATE_ULPS * _ulp(float(np.abs(want).max())), err


def _rel_close(got, want, rtol):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got.float(), np.float32) - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _u(cfg, b, s, seed, dtype=jnp.bfloat16):
    x = (np.random.RandomState(seed).randn(b, s, cfg.griffin.lru_width)
         ).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("n", [1, 2, 13, 16, 17])
def test_associative_scan_is_bitwise_jax(n):
    rs = np.random.RandomState(n)
    a = rs.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
    b = rs.randn(2, n, 8).astype(np.float32)

    def comb(x, y):
        return (x[0] * y[0], x[1] * y[0] + y[1])

    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                          axis=1)
    ta, tb = G.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "h0"])
def test_rglru_scan_matches_jax(carried):
    jcfg, cfg, jp, p = _setup()
    ju, u = _u(cfg, 2, 13, seed=1)
    h0 = (np.random.RandomState(2).randn(2, cfg.griffin.lru_width)
          ).astype(np.float32) if carried else None
    jh = jax.jit(JG.rglru_scan)(jp, ju, None if h0 is None else jnp.asarray(h0))
    h = G.rglru_scan(p, u, None if h0 is None else torch.from_numpy(h0))
    assert h.dtype == torch.bfloat16
    _bf16_close(h, jh)


def test_rglru_step_matches_jax():
    jcfg, cfg, jp, p = _setup()
    ju, u = _u(cfg, 3, 1, seed=3)
    h0 = np.random.RandomState(4).randn(3, cfg.griffin.lru_width).astype(np.float32)
    jo, jh = jax.jit(JG.rglru_step)(jp, ju, jnp.asarray(h0))
    o, h = G.rglru_step(p, u, torch.from_numpy(h0))
    _bf16_close(o, jo)
    _rel_close(h, jh, STATE_RTOL)


@pytest.mark.parametrize("with_tail", [False, True], ids=["fresh", "tail"])
def test_conv1d_is_bitwise_jax(with_tail):
    jcfg, cfg, jp, p = _setup()
    ju, u = _u(cfg, 2, 6, seed=7)
    jt = t = None
    if with_tail:
        jt, t = _u(cfg, 2, cfg.griffin.conv_width - 1, seed=8)
    jo, jtail = jax.jit(JG._conv1d)(ju, jp["conv_w"], jp["conv_b"], jt)
    o, tail = G._conv1d(u, p["conv_w"], p["conv_b"], t)
    assert np.array_equal(o.float().numpy(), np.asarray(jo, np.float32))
    assert np.array_equal(tail.float().numpy(), np.asarray(jtail, np.float32))


@pytest.mark.parametrize("carried", [False, True], ids=["train", "state"])
def test_recurrent_block_matches_jax(carried):
    jcfg, cfg, jp, p = _setup()
    rs = np.random.RandomState(10)
    x = (rs.randn(2, 11, cfg.d_model) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jst = st = None
    if carried:
        h0 = rs.randn(2, cfg.griffin.lru_width).astype(np.float32)
        tail = (rs.randn(2, cfg.griffin.conv_width - 1, cfg.griffin.lru_width)
                * 0.5).astype(np.float32)
        jst = (jnp.asarray(h0), jnp.asarray(tail, jnp.bfloat16))
        st = (torch.from_numpy(h0), torch.from_numpy(tail).bfloat16())
    fn = jax.jit(lambda p_, x_, s_: JG.recurrent_block_apply(
        p_, x_, jcfg, "bf16", jnp.asarray(SEED), 0, state=s_))
    jo, (jh, jtail) = fn(jp, jx, jst)
    with torch.no_grad():
        o, (h, tail) = G.recurrent_block_apply(p, tx, cfg, "bf16", SEED, 0,
                                               state=st)
    _bf16_close(o, jo)
    _bf16_close(h, jh)  # the scan's last output, rounded to bf16
    assert np.array_equal(tail.float().numpy(), np.asarray(jtail, np.float32))


def test_ring_window_cache_matches_dense_window():
    """Dense decode with cap == window is a ring buffer: the prefill roll and
    `ring_abs_pos` reproduce a full-capacity windowed cache exactly, with a
    prompt length (13) that is no multiple of the window (8)."""
    jcfg = jregistry.get("recurrentgemma_9b").reduced()
    cfg = registry.get("recurrentgemma_9b").reduced()
    w, s = 8, 13
    cfg = dataclasses.replace(cfg, griffin=dataclasses.replace(cfg.griffin,
                                                               window=w))
    p = _convert(jax.tree.map(np.asarray, JA.gqa_init(jax.random.PRNGKey(0),
                                                      jcfg)), "cpu")
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, s, cfg.d_model).astype(np.float32)
                         * 0.3).bfloat16()
    with torch.no_grad():
        _, kv = A.gqa_apply(p, x, cfg, "bf16", SEED, 0, causal=True, window=w)
        full = lm.init_cache(cfg, 1, 32, device="cpu",
                             specs=[((("lattn", "mlp"),), 1)],
                             lattn_ring=False)[0]["l0"]["kv"]
        ring = lm.init_cache(cfg, 1, 32, device="cpu",
                             specs=[((("lattn", "mlp"),), 1)])[0]["l0"]["kv"]
        full, ring = tuple(t[0] for t in full), tuple(t[0] for t in ring)
        assert ring[0].shape[1] == w + 1 and full[0].shape[1] == 33
        lm._fill_cache(full, kv, w)
        lm._fill_cache(ring, kv, w)
        for i in range(4):  # decode across several wrap points
            step = torch.from_numpy(rs.randn(1, 1, cfg.d_model).astype(
                np.float32) * 0.3).bfloat16()
            pos = torch.tensor([s + i], dtype=torch.int32)
            o_full, _ = A.gqa_decode(p, step, cfg, "bf16", SEED, 0, full, pos,
                                     window=w)
            o_ring, _ = A.gqa_decode(p, step, cfg, "bf16", SEED, 0, ring, pos,
                                     window=w)
            assert torch.equal(o_full, o_ring), i
        with pytest.raises(NotImplementedError, match="one token at a time"):
            A.gqa_decode(p, x[:, :2], cfg, "bf16", SEED, 0, ring,
                         torch.tensor([s + 4], dtype=torch.int32), window=w)


def test_ring_abs_pos_is_the_references():
    pos = np.array([0, 5, 13, 40], np.int32)
    for sq in (1, 3):
        want = np.asarray(JA.ring_abs_pos(jnp.asarray(pos), sq, 8))
        got = A.ring_abs_pos(torch.from_numpy(pos), sq, 8).numpy()
        assert np.array_equal(got, want)
