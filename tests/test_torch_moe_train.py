"""Training the MoE families with the port against the JAX reference: the
backward through the expert loop, with the load-balance aux loss. The checks
run here on reduced deepseek-moe-16b (GQA + softmax routing, 2 shared
experts) and in tests/test_torch_mla_train.py on reduced deepseek-v3 (MLA +
sigmoid routing, the backward through `mla_apply`): two files, so the two
eager-JAX halves run on two workers.

Same weights (the reference's init, converted with `repro_torch.convert`),
same numpy batches. Tolerances, each where it is used:
  - bf16, capacity_factor 8.0 (nothing drops), against the reference's
    `jax.value_and_grad(lm.lm_loss)` run EAGERLY (`jax.disable_jit`):
    `lm_loss` within 1e-3 relative, every gradient leaf within GRAD_REL_RMS
    relative RMS. bf16 roundings of activations and cotangents that land on
    the other side of a tie compound over the layers (measured: 1.4e-7 to
    8.0e-3 across the leaves of both models, and 1.4e-3 to 7.6e-3 on dense
    llama-200m with the same harness). The summed aux of the stack within
    STACK_AUX_RTOL = 1e-5 (measured 3.3e-6: layer 1's router reads layer 0's
    bf16 output, where such a flip lands), and `loss == ce + 0.01 * aux`
    bitwise;
  - the aux loss alone (one MoE layer's, on the same bf16 input) within
    AUX_RTOL = 1e-6 relative;
  - an expert that receives no row: its slice of every stacked expert
    gradient exactly zero in both packages (the reference's jitted
    gradient says which experts are live), and after one AdamW update of
    the whole gradient list (weight decay moves it) equal to the
    reference's slice within 1e-6 relative;
  - 3 steps of `make_train_step` against the reference's jitted loop on the
    reference corpus's batches (as tests/test_torch_train.py's
    `test_bf16_train_loop_matches_jax`): losses within 1e-3 relative;
  - quartet2 `lm_loss` (the default capacity) against the reference run
    EAGERLY (`jax.disable_jit`), the noise rule of tests/test_torch_train.py:
    within the reference's own quartet2-bf16 loss shift; its backward
    (hashed MS-EDEN draws) finite and nonzero on every leaf.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import lm, moe
from repro_torch.models.blocks import chunked_head_ce
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

SEED = np.array([3, 4], np.uint32)
GRAD_REL_RMS = 1.5e-2
AUX_RTOL = 1e-6
STACK_AUX_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch, capacity_factor=8.0):
    out = []
    for c in (jregistry.get(arch).reduced(), registry.get(arch).reduced()):
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)))
    return out


@functools.lru_cache(maxsize=None)
def _weights(arch, capacity_factor=8.0):
    jcfg, cfg = _cfgs(arch, capacity_factor)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, b=2, s=16, seed=0):
    rs = np.random.RandomState(seed)
    j = {"tokens": rs.randint(0, cfg.vocab, (b, s)).astype(np.int32),
         "labels": rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    return j, {k: torch.from_numpy(v) for k, v in j.items()}


def _fresh(params):
    """A copy of a converted parameter tree whose leaves require grad."""
    if isinstance(params, dict):
        return {k: _fresh(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_fresh(v) for v in params]
    return params.detach().clone().requires_grad_(True)


def _named(jtree):
    """[(path, numpy leaf)] in the reference's flattening order, which is the
    port's `adamw.leaves` order of a converted tree (sorted dict keys)."""
    return [(jax.tree_util.keystr(k), np.asarray(v, np.float32))
            for k, v in jax.tree_util.tree_leaves_with_path(jtree)]


def _ce_and_aux(params, cfg, tb, scheme):
    """The CE and the summed aux that `lm.lm_loss` adds, read separately."""
    hidden, _, aux = lm._forward(
        params, params["stages"], lm.layer_specs(cfg), cfg, tb, scheme, SEED,
        caches=None, mode="train", pos=None, active=None, block_table=None,
        head=False)
    ce = chunked_head_ce(hidden, lm.head_weight(params, cfg), tb["labels"],
                         cfg.quantize_lm_head, scheme, SEED)
    return ce, aux


def _rel_rms(x, y):
    return float(np.sqrt(((x - y) ** 2).mean() / max((y ** 2).mean(), 1e-30)))


@functools.lru_cache(maxsize=None)
def _bf16_grads(arch):
    """The reference's loss, aux and gradients, EAGER, and the port's."""
    jcfg, cfg, jparams, params = _weights(arch)
    jb, tb = _batch(cfg)
    jseed = jnp.asarray(SEED)

    def jloss_fn(p):  # lm.lm_loss's arithmetic, its aux returned beside
        hidden, _, aux = jlm.forward(p, jcfg, jb, "bf16", jseed, mode="train",
                                     head=False)
        return jblocks.chunked_head_ce(hidden, jlm.head_weight(p, jcfg),
                                       jb["labels"], False, "bf16",
                                       jseed) + 0.01 * aux, aux

    with jax.disable_jit():
        (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn,
                                                   has_aux=True)(jparams)
    params = _fresh(params)
    loss = lm.lm_loss(params, cfg, tb, "bf16", SEED)
    with torch.no_grad():
        ce, aux = _ce_and_aux(params, cfg, tb, "bf16")
    grads = torch.autograd.grad(loss, adamw.leaves(params))
    return (float(jloss), float(jaux), _named(jgrads), loss.detach(), ce,
            aux, [g.float().numpy() for g in grads])


def check_bf16_loss_and_every_gradient(arch):
    jloss, jaux, jgrads, loss, ce, aux, grads = _bf16_grads(arch)
    assert float(loss) == pytest.approx(jloss, rel=1e-3)
    assert float(aux) > 0 and torch.equal(loss, ce + 0.01 * aux)
    assert float(aux) == pytest.approx(jaux, rel=STACK_AUX_RTOL)
    assert len(grads) == len(jgrads)
    for (path, jg), g in zip(jgrads, grads):
        assert g.shape == jg.shape and np.isfinite(g).all(), path
        assert _rel_rms(g, jg) <= GRAD_REL_RMS, (path, _rel_rms(g, jg))


def check_aux_loss(arch):
    """One MoE layer's aux on the same bf16 input in both packages."""
    jcfg, cfg, jparams, params = _weights(arch)
    jp = jax.tree.map(lambda a: a[1], jparams["stages"][0]["l0"]["ff"])
    tp = lm.layer_params(params["stages"][0]["l0"]["ff"], 1)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 16, cfg.d_model).astype(np.float32)).bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    with jax.disable_jit():
        _, jaux = jmoe.moe_apply(jp, jx, jcfg, "bf16", jnp.asarray(SEED), 1)
    _, aux = moe.moe_apply(tp, x, cfg, "bf16", SEED, 1)
    assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)
    assert float(jaux) > 0


def check_idle_expert_gradient(arch):
    """Two tokens route to at most 4 of 8 experts a layer: the other
    experts' slices of the stacked (count, E, f, d) gradients are exact
    zeros in both packages, and one AdamW update (its weight decay) moves
    them as the reference's does."""
    jcfg, cfg, jparams, params = _weights(arch)
    jb, tb = _batch(cfg, b=1, s=2, seed=5)
    params = _fresh(params)
    names = [p for p, _ in _named(jparams)]
    grads = torch.autograd.grad(
        lm.lm_loss(params, cfg, tb, "bf16", SEED), adamw.leaves(params))
    jgrads = jax.jit(jax.grad(lambda p: jlm.lm_loss(
        p, jcfg, jb, "bf16", jnp.asarray(SEED))))(jparams)
    jg_named = dict(_named(jgrads))
    stacks = [i for i, n in enumerate(names)
              if n.endswith(("['ff']['wi']", "['ff']['wg']", "['ff']['wo']"))]
    assert len(stacks) == 3
    idle = {}
    for i in stacks:
        g, jg = grads[i].numpy(), jg_named[names[i]]
        assert g.shape == jg.shape == tuple(adamw.leaves(params)[i].shape)
        live = np.abs(jg).max(axis=(2, 3)) > 0                 # (count, E)
        assert np.array_equal(np.abs(g).max(axis=(2, 3)) > 0, live), names[i]
        assert (~live).sum() >= 4 * cfg.n_layers
        assert np.all(g[~live] == 0)
        idle[i] = ~live
    new, _ = adamw.update(list(grads), adamw.init(params), params, lr=1e-2)
    jnew, _ = jadamw.update(jgrads, jadamw.init(jparams), jparams, lr=1e-2)
    jnew = dict(_named(jnew))
    old = dict(_named(jparams))
    for i in stacks:
        w, jw = adamw.leaves(new)[i].detach().numpy(), jnew[names[i]]
        moved = w[idle[i]] != old[names[i]][idle[i]]
        assert moved.mean() > 0.99  # decoupled weight decay
        np.testing.assert_allclose(w[idle[i]], jw[idle[i]], rtol=1e-6,
                                   atol=1e-9)


def check_bf16_train_loop(arch):
    jcfg, cfg, jparams, params = _weights(arch)
    corpus = JCorpus(JDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    batches = [jax.tree.map(np.asarray, corpus.batch_at(i)) for i in range(3)]
    kw = dict(base_lr=2e-3, total_steps=3)
    jinit, jstep = jts.make_train_step(jcfg, "bf16", **kw)
    jstate, jstep = jinit(jparams), jax.jit(jstep)
    init, step = ts.make_train_step(cfg, "bf16", **kw)
    state = init(_fresh(params))
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
    assert state.step == 3


def check_quartet2_loss(arch):
    jcfg, cfg, jparams, params = _weights(arch, capacity_factor=1.25)
    jb, tb = _batch(cfg)
    with jax.disable_jit():
        jq = float(jlm.lm_loss(jparams, jcfg, jb, "quartet2",
                               jnp.asarray(SEED)))
    jbf = float(jax.jit(lambda p: jlm.lm_loss(
        p, jcfg, jb, "bf16", jnp.asarray(SEED)))(jparams))
    params = _fresh(params)
    loss = lm.lm_loss(params, cfg, tb, "quartet2", SEED)
    with torch.no_grad():
        ce, aux = _ce_and_aux(params, cfg, tb, "quartet2")
    assert abs(float(loss) - jq) <= abs(jq - jbf)
    assert float(aux) > 0 and torch.equal(loss, ce + 0.01 * aux)
    grads = torch.autograd.grad(loss, adamw.leaves(params))
    assert all(torch.isfinite(g).all() for g in grads)
    assert all(bool(g.abs().sum() > 0) for g in grads)


ARCH = "deepseek_moe_16b"


def test_bf16_loss_and_every_gradient_match_eager_jax():
    check_bf16_loss_and_every_gradient(ARCH)


def test_aux_loss_matches_jax():
    check_aux_loss(ARCH)


def test_idle_expert_gradient_is_zero_and_decays():
    check_idle_expert_gradient(ARCH)


def test_bf16_train_loop_matches_jax():
    check_bf16_train_loop(ARCH)


def test_quartet2_loss_within_noise_of_eager_jax():
    check_quartet2_loss(ARCH)
