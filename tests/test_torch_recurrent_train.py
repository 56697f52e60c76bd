"""Training the recurrent families with the port against the JAX reference:
the forward and backward through rwkv6's WKV recurrence (two whole chunks),
its token shifts and LoRAs, and through griffin's RG-LRU scan, conv and
local attention, at the reduced rwkv6-7b and recurrentgemma-9b configs.

Same weights (the reference's init, converted), same numpy batch (2 x 16
tokens). The quartet2 `lm_loss` of both models is held to the reference's
run EAGERLY in tests/test_torch_archs.py (within 1e-5 relative; measured
1.5e-7; under jax.jit XLA turns a division by a constant into a
multiplication by its reciprocal, which moves a quartet2 loss by 7e-4).
Tolerances here, each where it is used:
  - bf16 gradients against the reference's jitted `jax.value_and_grad(
    lm.lm_loss)`: every leaf within GRAD_REL_RMS = 5e-2 relative RMS
    (measured 3.1e-2 for rwkv6, 2.5e-2 for recurrentgemma, the loss 6e-5
    apart: bf16 roundings of activations and cotangents that land on the
    other side of a tie compound through the recurrences, as the MoE
    models' 8e-3 do in tests/test_torch_moe_train.py). The quartet2
    gradients are not held leaf by leaf: with the reference's draws
    injected they sit 0.1-0.2 relative RMS from the eager reference's on
    rwkv6 (an ulp of a tanh or exp, XLA's polynomial against PyTorch's,
    moves whole NVFP4 codes of the cotangents), against a quartet2-bf16
    distance of about 1.1 on the same leaves;
  - two `make_train_step` steps under quartet2 (hashed draws): finite losses
    and gradient norms, every parameter finite and moved (the first step's
    warmup learning rate is 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

ARCHS = ["rwkv6_7b", "recurrentgemma_9b"]
SEED = np.array([3, 4], np.uint32)
GRAD_REL_RMS = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jregistry.get(arch).reduced()
    cfg = registry.get(arch).reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    batch = {k: rs.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, cfg, jparams, batch


def _port(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_rms(x, y):
    return float(np.sqrt(((x - y) ** 2).mean() / max((y ** 2).mean(), 1e-60)))


def _named(tree, path=()):
    """(path, leaf) in jax.tree_util's order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_every_gradient_match_jax(arch):
    jcfg, cfg, jparams, batch = _setup(arch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, batch, "bf16", jnp.asarray(SEED))))(
        jparams)
    params = _port(jparams, cfg)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.lm_loss(params, cfg, _tb(batch), "bf16", SEED)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-3)
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    named = _named(params)
    assert len(named) == len(want) == len(leaves)
    for (path, p), (jpath, jg) in zip(named, want):
        assert path == tuple(getattr(k, "key", getattr(k, "idx", None))
                             for k in jpath)
        rel = _rel_rms(grads[id(p)].float().numpy(), np.asarray(jg, np.float32))
        assert rel <= GRAD_REL_RMS, (path, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_quartet2_train_steps_move_every_parameter(arch):
    _, cfg, jparams, batch = _setup(arch)
    init, step = ts.make_train_step(cfg, "quartet2", base_lr=1e-3,
                                    total_steps=10)
    state = init(_port(jparams, cfg))
    before = [p.detach().clone() for p in adamw.leaves(state.params)]
    for _ in range(2):
        state, m = step(state, _tb(batch))
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    after = adamw.leaves(state.params)
    assert all(bool(torch.isfinite(p).all()) for p in after)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
