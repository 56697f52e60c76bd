"""Serving the new configs of the port's registry against the JAX
reference (tests/test_torch_archs.py holds their configs, train-mode forward
and dense-cache decode). Same weights (the reference's init at the reduced
size, converted with `repro_torch.convert`). Tolerances, each where it is
used:
  - a paged serving step of reduced chatglm3-6b (rope_fraction 0.5, 2 KV
    heads) against the reference's jitted step, through
    tests/test_torch_model.py's harness and bars: bf16 logits within
    LOGIT_ATOL, quartet2 within its noise rule (Q2_NOISE_FRACTION of the
    reference's own quartet2-bf16 distance, relative RMS);
  - the same schedule on reduced deepseek-moe-16b under bf16 against the
    reference step run EAGERLY: logits within LOGIT_ATOL;
  - deepseek-moe-16b's packed weights BITWISE the reference's prequantize,
    `init_packed` bitwise `prequantize(lm.init(...))`, its pool's cache
    leaves of the reference pool's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_archs import Q2_NOISE_FRACTION, _rel_rms, _weights
from test_torch_model import LOGIT_ATOL, _run_both, _schedule
from repro.serve import decode as jdecode
from repro.serve import kv_pool as jkv
from repro.serve import prequant as jprequant
from repro_torch.convert import params_from_jax
from repro_torch.core.linear import PackedQWeight
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.serve import decode as tdecode
from repro_torch.serve import prequant
from repro_torch.serve.kv_pool import KVPool


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_chatglm3_paged_step_matches_jax_bf16():
    for jl, tl, act in _run_both("chatglm3_6b", "bf16"):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl)[act].max() <= LOGIT_ATOL


def test_chatglm3_paged_step_matches_jax_quartet2():
    ref_bf16 = _run_both("chatglm3_6b", "bf16")
    for (jl, tl, act), (jb, _, _) in zip(_run_both("chatglm3_6b", "quartet2"),
                                         ref_bf16):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        noise = _rel_rms(jl[act], jb[act])
        assert _rel_rms(tl[act], jl[act]) <= Q2_NOISE_FRACTION * noise


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tuple(tree) if isinstance(tree, PackedQWeight)
             else (tree,))]


def test_deepseek_moe_packs_and_converts_like_jax():
    """The (gqa, moe) stack through the paths llama and deepseek-v3 use:
    `prequantize` of converted weights BITWISE the reference's (attention
    and expert stacks packed, the router raw), and `init_packed` bitwise
    `prequantize(lm.init(...))`; the pool's cache leaves have the
    reference pool's shapes."""
    jcfg, cfg, jparams, params = _weights("deepseek_moe_16b")
    want = params_from_jax(jax.tree.map(
        np.asarray, jprequant.prequantize(jparams, jcfg, "quartet2")), cfg,
        "cpu")
    got = prequant.prequantize(params, cfg, "quartet2")
    packed = {p.rsplit("/", 1)[1] for p, leaf in _leaves(got)
              if len(leaf) == 3}
    assert packed == {"wq", "wk", "wv", "wo", "wi", "wg"}
    for (p, a), (q, b) in zip(_leaves(got), _leaves(want), strict=True):
        assert p == q and all(u.shape == v.shape and torch.equal(u, v)
                              for u, v in zip(a, b, strict=True)), p
    ref = prequant.prequantize(lm.init(cfg, torch.Generator().manual_seed(0),
                                       "cpu"), cfg, "quartet2")
    drawn = prequant.init_packed(cfg, torch.Generator().manual_seed(0),
                                 "quartet2", "cpu", chunk=3)
    for (p, a), (q, b) in zip(_leaves(drawn), _leaves(ref), strict=True):
        assert p == q and all(torch.equal(u, v) for u, v in zip(a, b)), p
    jpool = jkv.KVPool(jcfg, 2, 32, paged=True, block_size=4)
    tpool = KVPool(cfg, 2, 32, block_size=4, device="cpu")
    jshapes = [tuple(x.shape) for x in jax.tree.leaves(jpool.caches)]
    # the port's pool leaves carry one scratch block past the reference's
    assert [(x.shape[0], x.shape[1] - 1, *x.shape[2:])
            for x in adamw.leaves(tpool.caches)] == jshapes


def test_deepseek_moe_paged_step_matches_eager_jax_bf16():
    """Reduced deepseek-moe-16b over tests/test_torch_model.py's step
    schedule, the reference step run EAGERLY (a jitted router moves an ulp
    and with it a near-tie's expert, and a dropped row with it): every
    compared logit within LOGIT_ATOL."""
    jcfg, cfg, jparams, params = _weights("deepseek_moe_16b")
    jpool = jkv.KVPool(jcfg, 2, 32, paged=True, block_size=4)
    tpool = KVPool(cfg, 2, 32, block_size=4, device="cpu")
    for pool in (jpool, tpool):
        for s, n in ((0, 23), (1, 11)):
            pool.commit(s, n)
            pool.ensure(s, n)
    jstep = jdecode.make_paged_serve_step(jcfg, "bf16", paged_kernel=True)
    tstep = tdecode.make_paged_serve_step(cfg, "bf16")
    caches = jpool.caches
    for toks, pos, act in _schedule(cfg.vocab, np.random.RandomState(1)):
        with jax.disable_jit():
            jl, caches = jstep(jparams, caches, jpool.table_device(),
                               jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(act))
        tl, _ = tstep(params, tpool.caches, tpool.tables_device(),
                      torch.from_numpy(toks), torch.from_numpy(pos),
                      torch.from_numpy(act))
        jl, tl = np.asarray(jl.astype(jnp.float32)), tl.float().numpy()
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl)[act].max() <= LOGIT_ATOL
