"""Train a model with the port: Quartet II (or another scheme) on the
synthetic corpus, with checkpoints, resume and an optional
quantization-health probe.

    python -m repro_torch.launch.train --arch llama_200m --steps 500 \
        --ckpt runs/llama [--resume]
    # the paper's nanochat recipe (Sec. 6.2): Muon, WSD, QK-norm, ReLU^2
    python -m repro_torch.launch.train --arch llama_200m --optimizer muon \
        --schedule wsd --qk-norm --mlp relu2 --probe-every 50
    # data parallelism: 2 ranks, NVFP4-compressed gradient mean
    python -m repro_torch.launch.train --dp 2 --backend gloo --compress

Counterpart of `repro/launch/train.py` and `examples/quickstart.py`. Builds
seeded random weights, trains with AdamW or Muon and the chosen LR schedule,
and prints the losses and tokens per second labelled with the device they
ran on. `--ckpt DIR` writes async checkpoints every `--ckpt-every` steps
(and emergency ones on SIGTERM/SIGINT, a NaN loss or an exception);
`--resume` continues from the newest checkpoint in DIR. Without `--ckpt`
nothing is written. `--probe-every N` samples the weights' NVFP4 health
(`obs/quant_probe.py`) every N steps. Runs on the card unless `--device cpu`
is given (`--reduced` shrinks the model to its CPU smoke size); without a
card it exits.

`--dp R` spawns R data-parallel ranks (`dist.spawn`), the counterpart of
`examples/distributed_sim.py` on the "data" axis: every rank builds the
same seeded weights, takes its shard `batch_at(step, rank, R)` of each
global batch of `--batch` rows, and the train step averages grads and loss
over the ranks (`--compress`: grads by `dist.compression.
compressed_grad_mean`, the loss exactly). Rank r trains on card r mod the
cards. `--backend` is nccl on cuda (one card per rank) and gloo on cpu;
several ranks on one card take `--backend gloo`. Only rank 0 prints and
writes checkpoints; a failing rank stops the run with a non-zero exit.
`--dp 1` is the single-process path.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import dist as D
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.serve import device_label
from repro_torch.models import lm
from repro_torch.obs.quant_probe import QuantProbe
from repro_torch.optim.adamw import leaves as adamw_leaves
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama_200m")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's CPU smoke size (ArchConfig.reduced)")
    ap.add_argument("--scheme", default="quartet2")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"])
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--qk-norm", action="store_true",
                    help="RMS-normalize q and k per head (nanochat recipe)")
    ap.add_argument("--mlp", choices=["swiglu", "relu2"],
                    help="the MLP kind (default: the arch's own)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="checkpoint directory (default: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default max(steps // 5, 50))")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="quantization-health probe period in steps (0 = off)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks, spawned (default 1: no group)")
    ap.add_argument("--backend", choices=list(D.BACKENDS), default=None,
                    help="process-group backend of --dp (default nccl on "
                         "cuda, gloo on cpu; ranks sharing a card need gloo)")
    ap.add_argument("--compress", action="store_true",
                    help="NVFP4 SR-compressed gradient mean over the ranks")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    if args.dp < 1:
        ap.error("--dp must be at least 1")
    if args.batch % args.dp:
        ap.error(f"--batch {args.batch} does not split over --dp {args.dp}")
    if args.dp == 1 and (args.backend or args.compress):
        ap.error("--backend and --compress need --dp 2 or more")
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    if args.resume and not args.ckpt:
        ap.error("--resume needs --ckpt")
    return args


def _rank_main(rank: int, world: int, argv) -> dict:
    """One spawned data-parallel rank (its group already joined): rank 0's
    summary, and every rank's final params checksum. CPU ranks split the
    host's threads between them."""
    if torch.device(parse(argv).device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    out, _, state = run(argv, rank=rank, world=world)
    out["params_checksum"] = D.checksum(adamw_leaves(state.params))
    return out


def run(argv=None, rank: int = 0, world: int = 1):
    """Train as the command line says; returns (summary dict, trainer, final
    state). With --dp R > 1 and no `world`, spawns the ranks and returns
    rank 0's summary (with each rank's params checksum), and no trainer or
    state."""
    args = parse(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    if args.dp > 1 and world == 1:
        D.check_backend(args.backend, args.dp, args.device)
        outs = D.spawn(_rank_main, args.dp, (argv,), backend=args.backend)
        out = dict(outs[0], ranks_checksums=[o["params_checksum"]
                                             for o in outs])
        return out, None, None
    device = D.rank_device(args.device, rank)
    if device.type == "cuda":  # the kernels launch on the current device
        torch.cuda.set_device(device)
    group = torch.distributed.group.WORLD if world > 1 else None
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, qk_norm=cfg.qk_norm or args.qk_norm,
                              mlp=args.mlp or cfg.mlp)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, d_model=cfg.d_model,
        emit_embeds=cfg.input_mode == "embeds"))
    init_state, train_step = make_train_step(
        cfg, args.scheme, optimizer=args.optimizer, schedule=args.schedule,
        base_lr=args.lr, total_steps=args.steps, base_seed=args.seed,
        microbatches=args.microbatches, group=group, compress=args.compress)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(lm.init(cfg, gen, device))
    probe = (QuantProbe(args.scheme, every_n=args.probe_every,
                        base_seed=args.seed) if args.probe_every else None)
    ckpt_every = args.ckpt_every or max(args.steps // 5, 50)
    trainer = Trainer(TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                                    ckpt_every=ckpt_every,
                                    log_every=args.log_every),
                      train_step, corpus, device=device, probe=probe,
                      rank=rank, world=world)
    t0 = time.perf_counter()
    state = trainer.run(state, resume=args.resume)
    wall = time.perf_counter() - t0
    hist = trainer.history
    out = {"device": device_label(device), "arch": cfg.name,
           "scheme": args.scheme, "optimizer": args.optimizer,
           "steps": len(hist), "tokens_per_step": args.batch * args.seq,
           "losses": [h["loss"] for h in hist], "wall_s": wall,
           "dp": world, "rank": rank}
    say = print if rank == 0 else (lambda *a, **k: None)
    if not hist:
        say(f"[{out['device']}] {cfg.name}: nothing to run, the checkpoint "
            f"is at step {state.step} of {args.steps}")
        return out, trainer, state
    steady = [h["dt"] for h in hist[1:]] or [hist[0]["dt"]]
    step_s = sum(steady) / len(steady)
    out.update(step_ms=step_s * 1e3, tokens_per_s=args.batch * args.seq / step_s)
    dp = f", {world} ranks" if world > 1 else ""
    say(f"[{out['device']}{dp}] {cfg.name} {args.scheme} ({args.optimizer}): "
        f"steps {hist[0]['step']}-{hist[-1]['step']} of {args.steps}, "
        f"{out['tokens_per_step']} tokens each, loss {out['losses'][0]:.4f} "
        f"-> {out['losses'][-1]:.4f}, {out['step_ms']:.1f} ms/step after the "
        f"first, {out['tokens_per_s']:.0f} tokens/s, wall {wall:.2f} s")
    return out, trainer, state


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
