"""The port's fault-tolerant training loop on the CPU (quartet2, llama-200m's
smoke config): checkpoints, resume, the preemption and NaN emergency saves,
the probe tap, and the launcher's --ckpt/--resume.

Tolerances: none. A resumed run is BITWISE the uninterrupted one in its
losses and its weights: batches are pure functions of the step, the
quantization draws of (base seed, step), and the checkpoint holds every
leaf of the state exactly.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.quant_probe import QuantProbe
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = registry.get("llama_200m").reduced()
STEPS = 6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _corpus():
    return SyntheticCorpus(DataConfig(vocab=CFG.vocab, seq_len=16, global_batch=2))


def _fresh(optimizer="adamw"):
    """A freshly built (train_step, state): the same seeded weights each call."""
    init, step = ts.make_train_step(CFG, "quartet2", optimizer=optimizer,
                                    base_lr=2e-3, total_steps=STEPS)
    return step, init(lm.init(CFG, torch.Generator().manual_seed(0), "cpu"))


def _trainer(step, total, ckpt_dir=None, **kw):
    return Trainer(TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                 log_every=100, **kw),
                   step, _corpus(), device=CPU)


def _straight():
    step, state = _fresh()
    tr = _trainer(step, STEPS)
    state = tr.run(state)
    return [h["loss"] for h in tr.history], adamw.leaves(state.params)


def _assert_same_run(losses, params, want_losses, want_params):
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))


def test_trainer_defaults_to_the_card():
    assert Trainer(TrainerConfig(1), None, None).device == torch.device("cuda")


def test_resume_is_bitwise_the_straight_run(tmp_path):
    want_losses, want_params = _straight()
    d = str(tmp_path)
    step, state = _fresh()
    first = _trainer(step, 3, d, ckpt_every=2)
    first.run(state)
    # the reference's rule: a save after step index 2 (label 3, the steps
    # taken); then the final save, which finds it already written
    assert Checkpointer(d).all_steps() == [3]
    step, state = _fresh()  # a fresh trainer and freshly built state
    second = _trainer(step, STEPS, d)
    state = second.run(state)
    assert [h["step"] for h in second.history] == [3, 4, 5]
    _assert_same_run([h["loss"] for h in first.history + second.history],
                     adamw.leaves(state.params), want_losses, want_params)
    assert Checkpointer(d).latest_step() == STEPS


def test_sigterm_drains_the_step_saves_and_resumes(tmp_path):
    want_losses, want_params = _straight()
    d = str(tmp_path)
    step, state = _fresh()

    def preempted(state, batch):
        out = step(state, batch)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)  # arrives mid-step
        return out

    # the handlers install only on the main thread; elsewhere the signal
    # below would end the process
    assert threading.current_thread() is threading.main_thread()
    handler = signal.getsignal(signal.SIGTERM)
    tr = _trainer(preempted, STEPS, d)
    tr.run(state)
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert [h["step"] for h in tr.history] == [0, 1, 2]  # step 2 drained
    ck = Checkpointer(d)
    assert ck.all_steps() == [3]  # the emergency save only: no final save
    _, meta = ck.restore(_fresh()[1])
    assert meta["extra"]["emergency"] and "preemption" in meta["extra"]["reason"]
    step, state = _fresh()
    tr2 = _trainer(step, STEPS, d)
    state = tr2.run(state)
    _assert_same_run([h["loss"] for h in tr.history + tr2.history],
                     adamw.leaves(state.params), want_losses, want_params)


def test_nan_loss_writes_an_emergency_checkpoint(tmp_path):
    d = str(tmp_path)
    step, state = _fresh()

    def nan_at_1(state, batch):
        new, m = step(state, batch)
        if state.step == 1:
            m = {**m, "loss": torch.tensor(float("nan"))}
        return new, m

    tr = _trainer(nan_at_1, 3, d, ckpt_every=100)
    tr.run(state)
    assert [h["finite"] for h in tr.history] == [True, False, True]
    ck = Checkpointer(d)
    assert ck.all_steps() == [2, 3]  # the emergency one and the final one
    _, meta = ck.restore(_fresh()[1], step=2)
    assert meta["extra"] == {"nan_at": 1, "emergency": True}


def test_exception_saves_then_reraises(tmp_path):
    d = str(tmp_path)
    step, state = _fresh()

    def broken(state, batch):
        if state.step == 2:
            raise RuntimeError("device lost")
        return step(state, batch)

    with pytest.raises(RuntimeError, match="device lost"):
        _trainer(broken, STEPS, d).run(state)
    ck = Checkpointer(d)
    assert ck.all_steps() == [2]
    restored, meta = ck.restore(_fresh()[1])
    assert restored.step == 2 and "device lost" in meta["extra"]["reason"]


def test_probe_tap_samples_at_its_period():
    step, state = _fresh("muon")
    reg = MetricsRegistry()
    probe = QuantProbe("quartet2", every_n=2, max_sites=2, registry=reg)
    tr = Trainer(TrainerConfig(total_steps=4, log_every=100), step, _corpus(),
                 device=CPU, probe=probe)
    tr.run(state)
    # steps 0 and 2 sampled, two sites each
    assert reg.value("nvfp4_probe_samples_total", phase="train") == 4
    assert 0 < reg.value("nvfp4_quant_mse_rel", site="[0]/l0/ff/wg",
                         phase="train", quantizer="sr")


def test_launch_train_muon_ckpt_then_resume(tmp_path):
    d = str(tmp_path / "run")
    args = ["--device", "cpu", "--reduced", "--optimizer", "muon", "--schedule",
            "wsd", "--qk-norm", "--mlp", "relu2", "--steps", "4", "--seq", "16",
            "--batch", "2", "--ckpt", d, "--ckpt-every", "2", "--probe-every", "2"]
    out = launch_train.main(args)
    assert out["optimizer"] == "muon" and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    assert Checkpointer(d).all_steps() == [3, 4]
    resumed = launch_train.main([*args[:-6], "--steps", "6", "--ckpt", d,
                                 "--resume"])
    assert len(resumed["losses"]) == 2 and all(np.isfinite(resumed["losses"]))
    assert Checkpointer(d).latest_step() == 6
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--reduced", "--resume"])
