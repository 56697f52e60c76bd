"""The port's MoE layer and the whole MLA + MoE serving step against the JAX
reference, and the packing of deepseek-v3's weights.

Tolerances:
  - `moe_apply` on reduced deepseek-v3 (sigmoid top-2 of 8, route scale 2.5,
    one shared expert), eager JAX, same weights and inputs, with the default
    capacity and with a capacity that drops rows: the routing (top_e and the
    keep mask) IDENTICAL wherever a token's k-th and (k+1)-th scores differ
    by more than 1e-6 (the f32 router matmul sums in another order); the
    bf16 output within one bf16 rounding (2^-7 relative) on those tokens;
  - the whole paged step (four prefill chunks and singles, then batched
    decode) under quartet2 against the reference's step run eagerly, with
    the NVFP4 latent pool here and the bf16 pool in tests/test_torch_mla.py:
    logits within LOGIT_ATOL = 2e-2,
    the bar of tests/test_torch_model.py (measured: bit-identical over all
    10 steps in both modes). Eager, because under `jax.jit` XLA turns a
    division by a constant into a multiplication by its reciprocal (PERF.md
    §6), and an ulp moved before a quantizer (a 4/6 absmax, a cache group's
    scale) moves whole codes;
  - `prequant.init_packed` BITWISE equal to `prequantize(lm.init(...))`, and
    the port's prequantize of converted weights bitwise equal to the
    reference's prequantize (wkv_b and the router stay raw).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import decode as jdecode
from repro.serve import kv_pool as jkv
from repro.serve import prequant as jprequant
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core.linear import PackedQWeight
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.serve import decode as tdecode
from repro_torch.serve import prequant
from repro_torch.serve.kv_pool import KVPool

TIE = 1e-6
LOGIT_ATOL = 2e-2
SEED = np.array([7, 7], np.uint32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jregistry.get("deepseek_v3_671b").reduced()
    cfg = registry.get("deepseek_v3_671b").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def test_capacity_matches_jax():
    for arch in ("deepseek_v3_671b",):
        for cfgs in ((jregistry.get(arch), registry.get(arch)),
                     (jregistry.get(arch).reduced(),
                      registry.get(arch).reduced())):
            for t in (1, 4, 16, 64, 100, 1000, 4096):
                assert moe._capacity(t, cfgs[1]) == jmoe._capacity(t, cfgs[0])


def _jax_keep(top_e, cap, n_routed):
    """The reference's dispatch keep mask (repro/models/moe.py:66-76), per
    sorted replica, from its top_e."""
    fe = top_e.reshape(-1)
    order = jnp.argsort(fe)
    fe_s = fe[order]
    counts = jnp.zeros((n_routed,), jnp.int32).at[fe_s].add(1)
    seg_start = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(fe.shape[0]) - seg_start[fe_s]
    return np.asarray(order), np.asarray(pos_in_e < cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25],
                         ids=["default", "dropping"])
@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
def test_moe_apply_matches_jax(scheme, capacity_factor, monkeypatch):
    jcfg, cfg, jparams, params = _weights()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp = jax.tree.map(lambda a: a[1], jparams["stages"][0]["l0"]["ff"])
    tp = lm.layer_params(params["stages"][0]["l0"]["ff"], 1)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 16, cfg.d_model).astype(np.float32)
                         ).bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    seen = {}
    top_k = jax.lax.top_k

    def recording_top_k(scores, k):
        out = top_k(scores, k)
        seen["scores"], seen["top_e"] = np.asarray(scores), np.asarray(out[1])
        return out

    monkeypatch.setattr(jmoe.jax.lax, "top_k", recording_top_k)
    with jax.disable_jit():
        jy, jaux = jmoe.moe_apply(jp, jx, jcfg, scheme, jnp.asarray(SEED), 1)
    y, aux = moe.moe_apply(tp, x, cfg, scheme, SEED, 1)

    t, k = 64, cfg.moe.top_k
    scores, top_w, top_e = moe.route(tp, x.reshape(t, -1), cfg)
    srt = np.sort(seen["scores"], axis=-1)[:, ::-1]
    clear = srt[:, k - 1] - srt[:, k] > TIE          # tokens off near-ties
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sort(top_e.numpy(), -1)[clear],
                                  np.sort(seen["top_e"], -1)[clear])
    cap = moe._capacity(t, cfg)
    order, _, _, keep = moe.dispatch(top_e, cap, cfg.moe.n_routed)
    jorder, jkeep = _jax_keep(jnp.asarray(seen["top_e"]), cap,
                              cfg.moe.n_routed)
    if clear.all():  # one flipped expert re-sorts every later replica
        np.testing.assert_array_equal(order.numpy(), jorder)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
    if capacity_factor < 1:
        assert not jkeep.all()  # the case drops rows
    yo, jyo = y.float().numpy().reshape(t, -1), np.asarray(
        jy.astype(jnp.float32)).reshape(t, -1)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    np.testing.assert_allclose(yo[clear], jyo[clear], rtol=2.0 ** -7,
                               atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def _schedule(vocab, rng):
    """Row 0 prefills 20 tokens (two chunks of 8, four singles; row 1
    inactive), row 1 an 8-token prompt, then three batched decode steps."""
    p0, p1 = rng.randint(0, vocab, 20), rng.randint(0, vocab, 8)
    steps = [([p0[s:s + 8], [0] * 8], [s, 0], [True, False]) for s in (0, 8)]
    steps += [([[p0[t]], [0]], [t, 0], [True, False]) for t in range(16, 20)]
    steps.append(([[0] * 8, p1], [0, 0], [False, True]))
    for d in range(3):
        tk = rng.randint(0, vocab, 2)
        steps.append(([[tk[0]], [tk[1]]], [20 + d, 8 + d], [True, True]))
    return [tuple(np.asarray(a, dt) for a, dt in zip(s, (np.int32, np.int32,
                                                          bool)))
            for s in steps]


def paged_step_logits_match_eager_jax_quartet2(quantized):
    """The whole quartet2 paged step, the port against the reference run
    eagerly, step by step over `_schedule` (shared with
    tests/test_torch_mla.py, which runs the bf16 pool)."""
    jcfg, cfg, jparams, params = _weights()
    jp = jprequant.prequantize(jparams, jcfg, "quartet2")
    tp = prequant.prequantize(params, cfg, "quartet2")
    jpool = jkv.KVPool(jcfg, 2, 32, paged=True, block_size=4,
                       quantized=quantized)
    tpool = KVPool(cfg, 2, 32, block_size=4, device="cpu", quantized=quantized)
    for pool in (jpool, tpool):
        for s, n in ((0, 23), (1, 11)):
            pool.commit(s, n)
            pool.ensure(s, n)
    jstep = jdecode.make_paged_serve_step(jcfg, "quartet2", paged_kernel=True)
    tstep = tdecode.make_paged_serve_step(cfg, "quartet2")
    caches = jpool.caches
    for toks, pos, act in _schedule(cfg.vocab, np.random.RandomState(1)):
        with jax.disable_jit():
            jl, caches = jstep(jp, caches, jpool.table_device(),
                               jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(act))
        tl, _ = tstep(tp, tpool.caches, tpool.tables_device(),
                      torch.from_numpy(toks), torch.from_numpy(pos),
                      torch.from_numpy(act))
        jl, tl = np.asarray(jl.astype(jnp.float32)), tl.float().numpy()
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl)[act].max() <= LOGIT_ATOL


def test_paged_step_logits_match_eager_jax_quartet2_nvfp4_pool():
    paged_step_logits_match_eager_jax_quartet2(quantized=True)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, PackedQWeight):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_prequant_packs_deepseek_like_jax_and_init_packed_equals_it():
    jcfg, cfg, jparams, params = _weights()
    want = params_from_jax(jax.tree.map(
        np.asarray, jprequant.prequantize(jparams, jcfg, "quartet2")), cfg,
        "cpu")
    got = prequant.prequantize(params, cfg, "quartet2")
    packed = {p for p, leaf in _leaves(got) if isinstance(leaf, PackedQWeight)}
    assert {p.rsplit("/", 1)[1] for p in packed} == {
        "wq_a", "wq_b", "wkv_a", "wo", "wi", "wg"}
    assert not any(p.endswith(("wkv_b", "router")) for p in packed)
    for (p, a), (q, b) in zip(_leaves(got), _leaves(want), strict=True):
        assert p == q
        for u, v in zip(a if isinstance(a, PackedQWeight) else (a,),
                        b if isinstance(b, PackedQWeight) else (b,)):
            assert u.shape == v.shape and torch.equal(u, v), p
    # expert stacks: one (packed, scale bits, gscale) per (layer, expert)
    wi = got["stages"][0]["l0"]["ff"]["wi"]
    assert wi.gscale.shape == (cfg.n_layers, cfg.moe.n_routed)

    ref = prequant.prequantize(lm.init(cfg, torch.Generator().manual_seed(0),
                                       "cpu"), cfg, "quartet2")
    for chunk in (3, 1000):
        drawn = prequant.init_packed(cfg, torch.Generator().manual_seed(0),
                                     "quartet2", "cpu", chunk=chunk)
        for (p, a), (q, b) in zip(_leaves(drawn), _leaves(ref), strict=True):
            assert p == q and type(a) is type(b)
            for u, v in zip(a if isinstance(a, PackedQWeight) else (a,),
                            b if isinstance(b, PackedQWeight) else (b,)):
                assert torch.equal(u, v), p
