"""A 5-step quartet2 training loop of the port against the reference's own
seed-to-seed spread, at reduced size.

The two packages cannot draw the same quantization noise in training: the
reference's `qlinear` runs the direct MS-EDEN with threefry draws, the port
the post-hoc kernel path with hashed draws (`core/rng.py`). So the port is
held statistically: the reference's jitted `train_step` runs from the same
weights on the same batches (its corpus) under base seeds 0, 1, 2; at each
step its losses span [lo_t, hi_t], and W is the widest such span over the 5
steps. The band: every loss of the port, under the same three base seeds,
lies in [lo_t - W, hi_t + W] — the reference's own envelope widened by its
own width, which also covers the forward's deterministic quantization gap
(tests/test_torch_train.py holds that one to its own bar).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

SEEDS = (0, 1, 2)
STEPS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_quartet2_loop_within_reference_seed_band():
    jcfg = jregistry.get("llama_200m").reduced()
    cfg = registry.get("llama_200m").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    corpus = JCorpus(JDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    batches = [jax.tree.map(np.asarray, corpus.batch_at(i)) for i in range(STEPS)]
    kw = dict(base_lr=2e-3, total_steps=STEPS)

    ref, port = [], []
    for seed in SEEDS:
        jinit, jstep = jts.make_train_step(jcfg, "quartet2", base_seed=seed, **kw)
        jstate, jstep = jinit(jparams), jax.jit(jstep)
        init, step = ts.make_train_step(cfg, "quartet2", base_seed=seed, **kw)
        state = init(params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu"))
        rl, pl = [], []
        for batch in batches:
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, {k: torch.from_numpy(np.array(v))
                                    for k, v in batch.items()})
            rl.append(float(jm["loss"]))
            pl.append(float(m["loss"]))
        ref.append(rl)
        port.append(pl)
        assert all(torch.isfinite(p).all() for p in adamw.leaves(state.params))
    ref, port = np.asarray(ref), np.asarray(port)
    lo, hi = ref.min(0), ref.max(0)
    width = (hi - lo).max()
    assert np.isfinite(port).all()
    assert ((port >= lo - width) & (port <= hi + width)).all(), (ref, port)
    # the run learns: the last loss of every seed is below its first
    assert (port[:, -1] < port[:, 0]).all()
