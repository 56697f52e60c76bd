"""The port's training path against the JAX reference, at reduced size.

Tolerances:
- `qlinear` under bf16: y and dx (bf16) within one bf16 ulp, dw (f32)
  within 1e-6 max|dw| (fp32 summation order).
- `qlinear` under every registered scheme, with the reference's own draws
  injected (RHT signs, SR uniforms): y within one bf16 ulp, and dx, dw
  within the RHT bar — a rotated value on the other side of a rounding
  boundary flips one code by one grid step, which moves a GEMM output by at
  most ~5% of its largest magnitude at these widths: |d| <= 5e-2 max|g|.
  The MS-EDEN schemes are held against the reference's `qlinear` with its
  MS-EDEN quantizer swapped for the post-hoc composition its kernel path
  computes (`ms_eden_phase1` + `ms_eden_phase2`, the port's backward).
  (Measured: bitwise except dx of abl_c_sr, abl_e_sr, abl_c_ms_eden and
  abl_e_ms_eden, within 1.1e-3 max|dx|.)
- `qlinear` under quartet2 (the kernel path: post-hoc MS-EDEN, hashed
  draws): over 64 seeds the mean gradient converges to the exact product of
  the quantized operands (E against the dequantized saved W and X) as an
  unbiased estimate must: relative error of the mean <= 1.5 x (per-draw
  relative error) / sqrt(64); its per-draw MSE is within 10% of the
  reference's direct MS-EDEN backward over the same 64 seeds.
- `step_seed`: bitwise. Schedules: rtol 1e-6 (the f32 `cos` of numpy and
  XLA may differ by an ulp). AdamW (3 steps) and `clip_by_global_norm`: rtol
  1e-6.
- `lm_loss` at step 0, same weights and batch: bf16 within 1e-3 relative;
  quartet2 (deterministic forward) under tests/test_torch_model.py's bar:
  the relative RMS distance of the port's logits to the reference's is
  below 0.75 of the reference's own quantization error (quartet2 against
  bf16 logits), and the loss within the reference's own quartet2-bf16 shift.
  The reference runs eagerly; its layer scan is compiled, so XLA's
  reciprocal-for-division rewrite (ROADMAP "known numeric gap") applies.
- `cross_entropy` with masked labels: rtol 1e-6.
- A 5-step bf16 training loop (and 2 microbatches) against the reference's
  jitted `train_step` on the reference corpus's batches: losses within 1e-3
  relative.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import linear as JL
from repro.core import ms_eden as JME
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as L
from repro_torch.core import schemes
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.models import blocks, lm
from repro_torch.optim import adamw, schedules
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

Q2_NOISE_FRACTION = 0.75


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


class JaxDraws:
    """The reference's draws for one site seed: `_key(seed, tag)` folded as
    its `_bwd_gemm` folds it, rademacher signs and f32 uniforms."""

    def __init__(self, seed):
        self.seed = jnp.asarray(seed, jnp.uint32)

    def signs(self, tag, n, device):
        k = JL._key(self.seed, tag)
        return torch.from_numpy(np.array(
            jax.random.rademacher(k, (n,), jnp.float32))).to(device)

    def uniform(self, tag, shape, device):
        k = JL._key(self.seed, tag)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, tuple(shape), jnp.float32))).to(device)


M, K, N = 64, 128, 96
X = _rand((M, K), 0)
W = _rand((N, K), 1, K ** -0.5)
E = _rand((M, N), 2)
XB, EB = jnp.asarray(X, jnp.bfloat16), jnp.asarray(E, jnp.bfloat16)


def _t(a: jax.Array) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


def _port_grads(scheme, seed):
    tx = _t(XB).bfloat16().requires_grad_()
    tw = torch.from_numpy(W.copy()).requires_grad_()
    y = L.qlinear(tx, tw, seed, scheme)
    y.backward(_t(EB).bfloat16())
    return y.float().detach().numpy(), tx.grad, tw.grad


def _jax_grads(scheme, seed):
    y, vjp = jax.vjp(lambda a, b: JL.qlinear(a, b, jnp.asarray(seed), scheme),
                     XB, jnp.asarray(W))
    dx, dw = vjp(EB)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)), np.asarray(dw))


def _bf16_ulps(a: torch.Tensor, b: np.ndarray) -> int:
    a = a.bfloat16().view(torch.int16).int()
    b = torch.from_numpy(b).bfloat16().view(torch.int16).int()
    return (a - b).abs().max().item()


# --------------------------------------------------------------------------
# qlinear: forward and backward
# --------------------------------------------------------------------------

def test_qlinear_bf16_vjp_matches_jax():
    seed = np.array([5, 7], np.uint32)
    jy, jdx, jdw = _jax_grads("bf16", seed)
    y, dx, dw = _port_grads("bf16", seed)
    assert _bf16_ulps(torch.from_numpy(y), jy) <= 1
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert _bf16_ulps(dx.float(), jdx) <= 1
    assert np.abs(dw.numpy() - jdw).max() <= 1e-6 * np.abs(jdw).max()


def _posthoc_ms_eden(x, rht_key, sr_key):
    """The reference's kernel-path MS-EDEN in its plain form, shaped like its
    direct `ms_eden`'s output."""
    return types.SimpleNamespace(
        qt=JME.ms_eden_phase2(JME.ms_eden_phase1(x, rht_key), sr_key))


@pytest.mark.parametrize("scheme", schemes.names())
def test_qlinear_injected_draws_match_jax(scheme, monkeypatch):
    if schemes.get(scheme).bwd == "ms_eden":
        monkeypatch.setattr(JL, "ME", types.SimpleNamespace(
            ms_eden=_posthoc_ms_eden))
    seed = np.array([5, 7], np.uint32)
    jy, jdx, jdw = _jax_grads(scheme, seed)
    y, dx, dw = _port_grads(scheme, JaxDraws(seed))
    assert _bf16_ulps(torch.from_numpy(y), jy) <= 1
    for got, want in ((dx.float().numpy(), jdx), (dw.numpy(), jdw)):
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_qlinear_quartet2_unbiased_and_mse_matches_direct():
    tx = _t(XB)
    qx = L._quant_packed(tx.bfloat16(), "fos")
    qw = L._quant_packed(torch.from_numpy(W), "fos")
    xq = L._dequant_packed(*qx, dtype=torch.float32).double()
    wq = L._dequant_packed(*qw, dtype=torch.float32).double()
    e = _t(EB).double()
    exact = (e @ wq, e.T @ xq)

    jvjp = jax.jit(lambda s: jax.vjp(
        lambda a, b: JL.qlinear(a, b, s, "quartet2"), XB, jnp.asarray(W))[1](EB))
    n = 64
    port_sum = [torch.zeros_like(g) for g in exact]
    port_mse, jax_mse = np.zeros(2), np.zeros(2)
    for i in range(n):
        seed = np.array([i, 11], np.uint32)
        _, dx, dw = _port_grads("quartet2", seed)
        jdx, jdw = jvjp(jnp.asarray(seed))
        for j, (g, jg) in enumerate(((dx.double(), jdx), (dw.double(), jdw))):
            port_sum[j] += g
            port_mse[j] += float(((g - exact[j]) ** 2).mean()) / n
            jg = torch.from_numpy(np.array(jg.astype(jnp.float32))).double()
            jax_mse[j] += float(((jg - exact[j]) ** 2).mean()) / n
    for j in range(2):
        per_draw = np.sqrt(port_mse[j] / float((exact[j] ** 2).mean()))
        mean_rel = float((port_sum[j] / n - exact[j]).norm() / exact[j].norm())
        assert mean_rel <= 1.5 * per_draw / np.sqrt(n), (j, mean_rel, per_draw)
        assert abs(port_mse[j] - jax_mse[j]) < 0.10 * jax_mse[j], (j, port_mse, jax_mse)


# --------------------------------------------------------------------------
# seeds, schedules, optimizer
# --------------------------------------------------------------------------

def test_step_seed_matches_jax():
    for base, step, micro in ((0, 0, 0), (7, 123, 3), (0x5555, 2**31 + 5, 1)):
        want = np.asarray(jts.step_seed(base, jnp.asarray(step, jnp.uint32), micro))
        assert np.array_equal(ts.step_seed(base, step, micro), want)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_jax(name):
    for total in (5, 100, 1000):
        for step in sorted({0, 1, 2, total // 10, total // 2, total - 1,
                            total - total // 5, total + 3}):
            want = float(jschedules.get(name)(step, base_lr=2e-3, total_steps=total))
            got = schedules.get(name)(step, base_lr=2e-3, total_steps=total)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (total, step)


def test_adamw_and_clip_match_jax():
    shapes = {"a": (16, 32), "b": (32,), "c": (4, 8, 8)}
    params = {k: _rand(s, i) for i, (k, s) in enumerate(shapes.items())}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        grads = {k: _rand(s, 10 + 3 * step + i, 5.0)
                 for i, (k, s) in enumerate(shapes.items())}
        jg, jn = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
        tg, tn = adamw.clip_by_global_norm(
            [torch.from_numpy(v) for v in grads.values()], 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for a, k in zip(tg, shapes):
            np.testing.assert_allclose(a.numpy(), np.asarray(jg[k]), rtol=1e-6,
                                       atol=1e-7)
        lr = 1e-2 / (step + 1)
        jp, jst = jadamw.update(jg, jst, jp, lr=lr)
        tp, tst = adamw.update(tg, tst, tp, lr=lr)
    assert tst.step == int(jst.step) == 3
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tst.mu[i].numpy(), np.asarray(jst.mu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.nu[i].numpy(), np.asarray(jst.nu[k]),
                                   rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------------------
# the model's loss and the training loop
# --------------------------------------------------------------------------

JCFG = jregistry.get("llama_200m").reduced()
CFG = registry.get("llama_200m").reduced()


def _jax_setup():
    jparams = jlm.init(JCFG, jax.random.PRNGKey(0))
    corpus = JCorpus(JDataConfig(vocab=CFG.vocab, seq_len=32, global_batch=4))
    batches = [jax.tree.map(np.asarray, corpus.batch_at(i)) for i in range(5)]
    return jparams, batches


def _tb(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _rel_rms(x, y):
    return float(np.sqrt(((x - y) ** 2).mean() / (y ** 2).mean()))


def test_lm_loss_step0_matches_eager_jax():
    jparams, batches = _jax_setup()
    params = _port_params(jparams)
    seed = ts.step_seed(0, 0)
    jseed = jts.step_seed(0, 0)
    out = {}
    for scheme in ("bf16", "quartet2"):
        jlogits = np.asarray(jlm.forward(jparams, JCFG, batches[0], scheme, jseed,
                                         mode="train")[0].astype(jnp.float32))
        logits = lm.forward(params, CFG, _tb(batches[0]), scheme, seed,
                            mode="train")[0].float().numpy()
        jloss = float(jlm.lm_loss(jparams, JCFG, batches[0], scheme, jseed))
        loss = float(lm.lm_loss(params, CFG, _tb(batches[0]), scheme, seed))
        assert np.isfinite(logits).all() and logits.shape == jlogits.shape
        out[scheme] = (jlogits, logits, jloss, loss)
    jl, tl, jloss, loss = out["bf16"]
    assert loss == pytest.approx(jloss, rel=1e-3)
    jq, tq, jqloss, qloss = out["quartet2"]
    assert _rel_rms(tq, jq) <= Q2_NOISE_FRACTION * _rel_rms(jq, jl)
    assert abs(qloss - jqloss) <= abs(jqloss - jloss)


def test_cross_entropy_matches_jax():
    logits = _rand((3, 7, 50), 20, 3.0)
    labels = np.random.RandomState(21).randint(-1, 50, (3, 7)).astype(np.int32)
    want = float(jblocks.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       z_loss=1e-4))
    got = float(blocks.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), z_loss=1e-4))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_bf16_train_loop_matches_jax(microbatches):
    jparams, batches = _jax_setup()
    kw = dict(base_lr=2e-3, total_steps=5, microbatches=microbatches)
    jinit, jstep = jts.make_train_step(JCFG, "bf16", **kw)
    jstate, jstep = jinit(jparams), jax.jit(jstep)
    init, step = ts.make_train_step(CFG, "bf16", **kw)
    state = init(_port_params(jparams))
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tb(batch))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6, abs=1e-12)
    assert state.step == 5 and state.opt.step == 5


# --------------------------------------------------------------------------
# the port's corpus, trainer and entry point
# --------------------------------------------------------------------------

def test_synthetic_corpus_deterministic_and_structured():
    corpus = SyntheticCorpus(DataConfig(vocab=512, seq_len=64, global_batch=8))
    a, b = corpus.batch_at(3), corpus.batch_at(3)
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].shape == (8, 64)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], corpus.batch_at(4)["tokens"])
    toks = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1).long()
    bigram = (corpus._perm[toks[:, :-1]] == toks[:, 1:]).float().mean().item()
    assert 0.4 < bigram < 0.7  # p = 0.5 plus chance hits of the unigram draw
    assert 0 <= int(toks.min()) and int(toks.max()) < 512


def test_trainer_loss_falls_and_history():
    corpus = SyntheticCorpus(DataConfig(vocab=CFG.vocab, seq_len=32,
                                        global_batch=4))
    init, step = ts.make_train_step(CFG, "quartet2", base_lr=2e-3,
                                    total_steps=8)
    state = init(lm.init(CFG, torch.Generator().manual_seed(0), "cpu"))
    trainer = Trainer(TrainerConfig(total_steps=8, log_every=100), step, corpus,
                      device=torch.device("cpu"))
    state = trainer.run(state)
    losses = [h["loss"] for h in trainer.history]
    assert state.step == 8 and len(losses) == 8
    assert all(h["finite"] for h in trainer.history)
    assert losses[-1] < losses[0]
    assert all(torch.isfinite(p).all() for p in adamw.leaves(state.params))


def test_launch_train_cpu_reduced():
    out = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                             "--seq", "16", "--batch", "2"])
    assert out["device"] == "cpu" and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"])) and out["tokens_per_s"] > 0


def test_launch_train_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        launch_train.main(["--reduced", "--steps", "1"])
