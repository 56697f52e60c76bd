"""The port's Muon optimizer against the JAX reference.

Tolerances:
- `newton_schulz` on batched, tall and wide f32 matrices: |d| <= 1e-5
  max|ref|, against the reference eager and jitted (the Frobenius norm and
  the f32 products sum in another order; measured <= 3.2e-6).
- `partition_mask`: the same leaves by path, exactly.
- two `update` steps from the same params and grads: moments (Muon's and
  AdamW's) BITWISE, parameters within 1e-6 max|p| (the Newton-Schulz
  rounding above; measured 1.6e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.optim import muon as jmuon
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.optim import adamw, muon

OVER = dict(qk_norm=True, mlp="relu2")  # the nanochat recipe's model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _ref_params():
    cfg = dataclasses.replace(jregistry.get("llama_200m").reduced(), **OVER)
    tcfg = dataclasses.replace(registry.get("llama_200m").reduced(), **OVER)
    jp = jlm.init(cfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _by_path(tree) -> dict:
    """{port-style path tuple: numpy leaf} of a reference pytree."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("shape", [(3, 32, 64), (96, 48), (48, 96), (2, 256, 128)])
def test_newton_schulz_matches_jax(shape):
    g = _rand(shape, 1)
    got = muon.newton_schulz(torch.from_numpy(g)).numpy()
    for fn in (jmuon.newton_schulz, jax.jit(jmuon.newton_schulz)):
        want = np.asarray(fn(jnp.asarray(g)))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_partition_mask_matches_jax():
    jp, tp = _ref_params()
    jmask = _by_path(jmuon.partition_mask(jp))
    paths = [path for path, _ in muon._paths(tp)]
    got = dict(zip(paths, muon.partition_mask(tp)))
    assert got == {k: bool(v) for k, v in jmask.items()}
    # the reference's mask, caveat included: the stacked norm and QK-norm
    # gains are matrices to it, so they go to Muon
    assert got[("stages", 0, "l0", "n1", "g")] and got[("stages", 0, "l0", "mix", "qn")]
    assert not got[("embed",)] and not got[("head",)] and not got[("final_norm", "g")]


def test_update_matches_jax():
    jp, tp = _ref_params()
    paths = [path for path, _ in muon._paths(tp)]
    shapes = {path: tuple(leaf.shape) for path, leaf in muon._paths(tp)}
    jstate, tstate = jmuon.init(jp), muon.init(tp)
    for it in range(2):
        grads = {path: _rand(shapes[path], 100 + 31 * it + i, 0.1)
                 for i, path in enumerate(paths)}
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp),
            [jnp.asarray(grads[path]) for path in _by_path(jp)])
        jp, jstate = jmuon.update(jg, jstate, jp, lr=jnp.float32(0.02),
                                  weight_decay=0.1)
        tp, tstate = muon.update([torch.from_numpy(grads[p]) for p in paths],
                                 tstate, tp, lr=0.02, weight_decay=0.1)
    assert tstate.step == tstate.adam.step == int(jstate.step) == 2
    want_p, want_m = _by_path(jp), _by_path(jstate.mom)
    want_mu, want_nu = _by_path(jstate.adam.mu), _by_path(jstate.adam.nu)
    for i, (path, leaf) in enumerate(muon._paths(tp)):
        w = want_p[path]
        assert np.abs(leaf.numpy() - w).max() <= 1e-6 * np.abs(w).max(), path
        assert np.array_equal(tstate.mom[i].numpy(), want_m[path]), path
        assert np.array_equal(tstate.adam.mu[i].numpy(), want_mu[path]), path
        assert np.array_equal(tstate.adam.nu[i].numpy(), want_nu[path]), path
    assert len(adamw.leaves(tp)) == len(tstate.mom) == len(paths)
