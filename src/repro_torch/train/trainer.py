"""The training loop: steps, logging, the straggler watchdog and the NaN
circuit breaker.

Counterpart of `repro/train/trainer.py`. Data batches are pure functions of
the step, so a run is reproducible step for step. Per step the host
synchronizes once, to read the loss. Left out with checkpointing (ROADMAP.md
Queue 5): periodic, async and emergency checkpoints, resume, and the
preemption signal handlers.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch

from repro_torch.train.train_step import TrainState


@dataclass
class TrainerConfig:
    total_steps: int
    log_every: int = 10
    straggler_factor: float = 3.0


@dataclass
class Trainer:
    cfg: TrainerConfig
    train_step: object          # (state, batch) -> (state, metrics)
    corpus: object              # .batch_at(step)
    device: torch.device = torch.device("cpu")
    history: list = field(default_factory=list)

    def run(self, state: TrainState) -> TrainState:
        ewma = None
        start = state.step
        for step in range(start, self.cfg.total_steps):
            batch = {k: v.to(self.device)
                     for k, v in self.corpus.batch_at(step).items()}
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # the step's one host sync
            dt = time.perf_counter() - t0

            # straggler watchdog
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            straggler = dt > self.cfg.straggler_factor * ewma and step > start + 3
            if straggler:
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(ewma {ewma:.2f}s) — straggler suspected")
            # NaN circuit breaker: log and go on (the reference also writes
            # an emergency checkpoint here)
            if not math.isfinite(loss):
                print(f"[trainer] non-finite loss at step {step}; continuing")

            self.history.append({"step": step, "loss": loss, "dt": dt,
                                 "straggler": straggler,
                                 "finite": math.isfinite(loss)})
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
        return state
