"""The paper's nanochat recipe (Sec. 6.2: Muon, WSD, QK-norm, ReLU^2) in the
port against the JAX reference, at reduced size (llama-200m's smoke config
with qk_norm=True and mlp="relu2"), on the reference corpus's batches.

Tolerances:
- the parameter tree of `lm.init`: the reference's paths and shapes (no
  `wg` under relu2; `qn`/`kn` stacked per layer), exactly.
- the train-mode forward (logits) against EAGER JAX (`jax.disable_jit`):
  quartet2 within 1e-5 relative RMS (measured 1.4e-9); bf16 within one
  bf16 ulp of max|logits| (f32 summation order moves single elements;
  measured half an ulp).
- 3 recipe steps under bf16 against the reference's JITTED `train_step`:
  losses within 1e-3 relative (measured 1.4e-4), the Muon leaves within
  1e-3 max|w| (measured 4.0e-4). The AdamW leaves (embed, head) are not
  compared element by element: AdamW turns a gradient's summation-order ulp
  into a full-size step wherever that gradient is near zero.
- 3 recipe steps under quartet2 against the reference's step run EAGERLY,
  with the reference's draws injected into the port (RHT signs, SR
  uniforms) and the reference's MS-EDEN swapped for the post-hoc
  composition of its kernel path, which the port's backward runs (as in
  tests/test_torch_train.py): the losses of steps 0 and 1 within 1e-6
  relative (WSD's first learning rate is 0, so both read the initial
  weights; measured 7.6e-8 and 0), the step-2 loss within 2e-3 relative
  and the Muon leaves within 1e-2 max|w| (measured 6.9e-4 and 5.2e-3: an
  ulp of a dW sum moves a weight across a 4/6 rounding boundary, which
  moves whole codes in the next forward).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import linear as JL
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import rng
from repro_torch.models import lm
from repro_torch.optim import muon
from repro_torch.train import train_step as ts
from test_torch_train import JaxDraws, _posthoc_ms_eden

OVER = dict(qk_norm=True, mlp="relu2")
JCFG = dataclasses.replace(jregistry.get("llama_200m").reduced(), **OVER)
CFG = dataclasses.replace(registry.get("llama_200m").reduced(), **OVER)
RECIPE = dict(optimizer="muon", schedule="wsd", base_lr=2e-2, total_steps=3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(steps=3):
    jparams = jlm.init(JCFG, jax.random.PRNGKey(0))
    corpus = JCorpus(JDataConfig(vocab=CFG.vocab, seq_len=32, global_batch=4))
    batches = [jax.tree.map(np.asarray, corpus.batch_at(i)) for i in range(steps)]
    return jparams, batches


def _port(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _tb(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _by_path(tree) -> dict:
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_tree_matches_jax():
    want = {k: v.shape for k, v in _by_path(jlm.init(JCFG, jax.random.PRNGKey(0))).items()}
    params = lm.init(CFG, torch.Generator().manual_seed(0), "cpu")
    got = {path: tuple(leaf.shape) for path, leaf in muon._paths(params)}
    assert got == want
    assert ("stages", 0, "l0", "ff", "wg") not in got


@pytest.mark.parametrize("scheme", ["quartet2", "bf16"])
def test_relu2_qk_norm_forward_matches_eager_jax(scheme):
    jparams, batches = _setup(1)
    with jax.disable_jit():
        want = np.asarray(jlm.forward(jparams, JCFG, batches[0], scheme,
                                      jts.step_seed(0, 0), mode="train")[0]
                          .astype(jnp.float32))
    got = lm.forward(_port(jparams), CFG, _tb(batches[0]), scheme,
                     ts.step_seed(0, 0), mode="train")[0].float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    if scheme == "quartet2":
        rel = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
        assert rel <= 1e-5
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp


def _muon_leaves(tparams, jparams):
    want = _by_path(jparams)
    mask = muon.partition_mask(tparams)
    return [(path, leaf.detach().numpy(), want[path])
            for (path, leaf), use in zip(muon._paths(tparams), mask) if use]


def test_recipe_bf16_matches_jitted_jax():
    jparams, batches = _setup()
    jinit, jstep = jts.make_train_step(JCFG, "bf16", **RECIPE)
    jstate, jstep = jinit(jparams), jax.jit(jstep)
    init, step = ts.make_train_step(CFG, "bf16", **RECIPE)
    state = init(_port(jparams))
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tb(batch))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
    assert state.step == state.opt.step == int(jstate.opt.step) == 3
    for path, got, want in _muon_leaves(state.params, jstate.params):
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), path


def test_recipe_quartet2_matches_eager_jax_with_injected_draws(monkeypatch):
    monkeypatch.setattr(JL, "ME", types.SimpleNamespace(ms_eden=_posthoc_ms_eden))
    monkeypatch.setattr(rng, "draws", JaxDraws)
    jparams, batches = _setup()
    jinit, jstep = jts.make_train_step(JCFG, "quartet2", **RECIPE)
    jstate = jinit(jparams)
    init, step = ts.make_train_step(CFG, "quartet2", **RECIPE)
    state = init(_port(jparams))
    for i, batch in enumerate(batches):
        with jax.disable_jit():
            jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tb(batch))
        rel = 1e-6 if i < 2 else 2e-3
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=rel), i
    assert all(np.isfinite(float(v)) for v in m.values())
    for path, got, want in _muon_leaves(state.params, jstate.params):
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), path
