"""Fault-tolerant training loop.

Counterpart of `repro/train/trainer.py`:
  - periodic checkpoints, async by default (the disk write overlaps the
    next steps; `checkpoint/checkpointer.py`);
  - an emergency checkpoint on any exception and on SIGTERM/SIGINT
    (preemption): a signal lets the current step finish, then the loop
    stops and saves;
  - deterministic resume: data batches are pure functions of the step and
    the quantization seeds of (base seed, step), so a run restored at step
    k continues the uninterrupted run's stream bit for bit;
  - the straggler watchdog: steps slower than `straggler_factor` x the EWMA
    of the step time are logged;
  - the NaN-loss circuit breaker: log, write an emergency checkpoint, go on;
  - the optional quantization-health tap (`obs/quant_probe.py`), called at
    the host step boundary after the step's own host sync.

Per step the host synchronizes once, to read the loss (the probe, when it
samples, adds its own one). A checkpoint is labelled with the number of
steps its state has taken (`state.step`), and a resumed run starts there.
The reference labels its emergency checkpoints one step off and, after a
preemption, also writes its final checkpoint under `total_steps`; the port
does neither (ROADMAP.md, reference caveats). Without `ckpt_dir` no
checkpoint is written or read.
"""

from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.train.train_step import TrainState


@dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    async_ckpt: bool = True


@dataclass
class Trainer:
    cfg: TrainerConfig
    train_step: object          # (state, batch) -> (state, metrics)
    corpus: object              # .batch_at(step)
    device: torch.device = torch.device("cuda")
    history: list = field(default_factory=list)
    # optional quantization-health tap (obs/quant_probe.py QuantProbe),
    # consulted at the host step boundary only; None costs one `is None`
    # test per step
    probe: object = None
    _stop: bool = field(default=False, repr=False)

    def __post_init__(self):
        self.ckpt = (Checkpointer(self.cfg.ckpt_dir, keep=self.cfg.keep_ckpts)
                     if self.cfg.ckpt_dir else None)

    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):
            self._stop = True  # drain the current step, then emergency-save
        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread
        return old

    def _save(self, state: TrainState, blocking: bool) -> None:
        if self.ckpt is not None:
            self.ckpt.save(state.step, state, blocking=blocking)

    def _emergency(self, state: TrainState, extra: dict) -> None:
        if self.ckpt is None:
            return
        ok = self.ckpt.emergency_save(state.step, state, extra)
        print(f"[trainer] emergency checkpoint "
              f"{'written' if ok else 'FAILED'} at step {state.step}: {extra}")

    def run(self, state: TrainState, resume: bool = True) -> TrainState:
        self._stop = False
        old_handlers = self._install_signal_handlers()
        if resume and self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, _ = self.ckpt.restore(state)
            print(f"[trainer] resumed from step {state.step}")
        start = state.step
        ewma = None
        try:
            for step in range(start, self.cfg.total_steps):
                if self._stop:
                    raise KeyboardInterrupt("preemption signal")
                batch = {k: v.to(self.device)
                         for k, v in self.corpus.batch_at(step).items()}
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])  # the step's one host sync
                dt = time.perf_counter() - t0

                # sampled quantization-health tap, after the step's sync
                if self.probe is not None and self.probe.should_sample(step):
                    self.probe.probe_params(state.params, step=step,
                                            phase="train")

                # straggler watchdog
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                straggler = dt > self.cfg.straggler_factor * ewma and step > start + 3
                if straggler:
                    print(f"[watchdog] step {step} took {dt:.2f}s "
                          f"(ewma {ewma:.2f}s) — straggler suspected")
                # NaN circuit breaker
                finite = math.isfinite(loss)
                if not finite:
                    print(f"[trainer] non-finite loss at step {step}; "
                          f"checkpointing and continuing")
                    self._emergency(state, {"nan_at": step})

                self.history.append({"step": step, "loss": loss, "dt": dt,
                                     "straggler": straggler, "finite": finite})
                if step % self.cfg.log_every == 0:
                    print(f"[trainer] step {step} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"{dt * 1e3:.0f}ms")
                if step and step % self.cfg.ckpt_every == 0:
                    self._save(state, blocking=not self.cfg.async_ckpt)
        except BaseException as e:  # noqa: BLE001 — the preemption path
            self._emergency(state, {"reason": repr(e)[:200]})
            if not isinstance(e, KeyboardInterrupt):
                raise
            return state
        finally:
            if self.ckpt is not None:
                self.ckpt.wait()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        if self.ckpt is not None and self.ckpt.latest_step() != state.step:
            self._save(state, blocking=True)
        return state
