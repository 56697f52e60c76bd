"""Train a model with the port: Quartet II (or another scheme) on the
synthetic corpus.

    python -m repro_torch.launch.train --arch llama_200m --steps 500

Counterpart of `repro/launch/train.py` and `examples/quickstart.py`. Builds
seeded random weights, trains with AdamW and the chosen LR schedule, and
prints the losses and tokens per second labelled with the device they ran
on. Runs on the card unless `--device cpu` is given (`--reduced` shrinks the
model to its CPU smoke size); without a card it exits. Checkpointing
(`--ckpt`, `--resume`) and Muon are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.serve import device_label
from repro_torch.models import lm
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama_200m")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's CPU smoke size (ArchConfig.reduced)")
    ap.add_argument("--scheme", default="quartet2")
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    return args


def run(argv=None):
    """Train as the command line says; returns (summary dict, trainer, final
    state)."""
    args = parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch, seed=args.seed))
    init_state, train_step = make_train_step(
        cfg, args.scheme, schedule=args.schedule, base_lr=args.lr,
        total_steps=args.steps, base_seed=args.seed,
        microbatches=args.microbatches)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(lm.init(cfg, gen, device))
    trainer = Trainer(TrainerConfig(total_steps=args.steps,
                                    log_every=args.log_every),
                      train_step, corpus, device=device)
    t0 = time.perf_counter()
    state = trainer.run(state)
    wall = time.perf_counter() - t0
    steady = [h["dt"] for h in trainer.history[1:]] or [trainer.history[0]["dt"]]
    step_s = sum(steady) / len(steady)
    out = {"device": device_label(device), "arch": cfg.name,
           "scheme": args.scheme, "steps": args.steps,
           "tokens_per_step": args.batch * args.seq,
           "losses": [h["loss"] for h in trainer.history],
           "step_ms": step_s * 1e3,
           "tokens_per_s": args.batch * args.seq / step_s, "wall_s": wall}
    print(f"[{out['device']}] {cfg.name} {args.scheme}: {args.steps} steps of "
          f"{out['tokens_per_step']} tokens, loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, {out['step_ms']:.1f} ms/step after the "
          f"first, {out['tokens_per_s']:.0f} tokens/s, wall {wall:.2f} s")
    return out, trainer, state


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
