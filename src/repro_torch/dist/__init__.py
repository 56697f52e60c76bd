"""The port's process-group layer: `init`, `rank`, `world`, a spawn helper
and the one reduction the data-parallel paths share.

Counterpart of `repro/dist/__init__.py`, whose `shard_map` shim runs one
program over a mesh of devices inside one process. The port runs one
process per rank over `torch.distributed` instead (`sharding.py`,
`compression.py` and `pipeline.py` beside this file hold the reference's
rules and collectives).

The backend is the caller's choice, never a fallback:
  - "gloo": CPU ranks, and ranks that share one card. gloo's all_reduce
    takes CUDA tensors (it stages them through the host inside); its
    `send`/`recv` do not, so `pipeline.gpipe`'s ring hop stages CUDA tensors
    through pinned host buffers itself (`host_staged`, `to_host`);
  - "nccl": one card per rank. Asking for more ranks than cards raises.

`init_process_group` always gets a timeout, so a hung collective fails the
run instead of stalling it. `spawn` starts ranks with the `spawn` start
method (a process whose CUDA context is live cannot fork ranks); a rank that
raises tears its group down and exits non-zero, and `spawn` then stops the
other ranks and raises with the failing rank's traceback.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# seconds a collective may wait for its peers before it fails the run
PG_TIMEOUT_S = 300.0


def check_backend(backend: str, world: int, device_type: str) -> None:
    """Raise unless `backend` can run `world` ranks on `device_type`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("nccl runs CUDA ranks only: CPU ranks take "
                             "backend='gloo'")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl needs one card per rank: {world} ranks, {cards} "
                "card(s); ranks that share a card take backend='gloo'")


def init(backend: str, rank: int, world: int, init_method: str, *,
         timeout_s: float = PG_TIMEOUT_S) -> None:
    """Join the default process group as `rank` of `world` (the rendezvous
    at `init_method`, e.g. "file:///path" or "tcp://localhost:PORT")."""
    check_backend(backend, world,
                  "cuda" if backend == "nccl" else "cpu")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def rank(group=None) -> int:
    """This process's rank in `group` (0 outside any group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world(group=None) -> int:
    """The ranks in `group` (1 outside any group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the default group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device_type: str, rank_: int) -> torch.device:
    """The device of rank `rank_`: the CPU, or card rank mod the cards (so
    ranks beyond the card count share cards, as gloo groups may)."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank_ % torch.cuda.device_count())


def host_staged(group=None) -> bool:
    """Whether `group`'s point-to-point ops take host tensors only (gloo's
    `send`/`recv`), so CUDA tensors go through pinned host buffers around
    them."""
    return dist.get_backend(group) == "gloo"


def to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of a CUDA tensor in pinned memory (the tensor itself on
    the CPU)."""
    if x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def all_reduce_sum_(tensors: list, group=None) -> list:
    """Sum each tensor over the ranks of `group`, in place, in ONE collective:
    the tensors (one dtype) are laid end to end in a flat buffer. Each
    element's sum is the collective's sum of that element alone, so the flat
    buffer changes no value. Returns `tensors`."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off: off + t.numel()].view(t.shape))
        off += t.numel()
    return tensors


def checksum(tensors: list) -> int:
    """A 64-bit checksum of every bit of `tensors` (4-byte dtypes), equal
    on two ranks exactly when their tensors are bitwise equal (but for a
    2^-64 chance): each 32-bit word times an odd weight of its position and
    tensor, summed modulo 2^64 (in any order, so on any device alike)."""
    total = 0
    for i, t in enumerate(tensors):
        w = t.detach().contiguous().view(-1).view(torch.int32).long()
        pos = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
        total += int((w * ((pos * 2 + 1) * (2 * i + 0x9E3779B1))).sum())
    return total % 2**64


def _rank_entry(fn, rank_, world_, backend, init_method, pg_timeout_s, args,
                out_q) -> None:
    """A spawned rank: join the group, run fn, report; any exception tears
    the group down and exits non-zero."""
    ok = False
    try:
        init(backend, rank_, world_, init_method, timeout_s=pg_timeout_s)
        result = fn(rank_, world_, *args)
        out_q.put((rank_, True, pickle.dumps(result)))
        ok = True
    except BaseException:  # noqa: BLE001 — reported, then exit non-zero
        out_q.put((rank_, False, traceback.format_exc()))
    finally:
        shutdown()
    if not ok:
        sys.exit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(fn, world_: int, args: tuple = (), *, backend: str,
          init_method: str | None = None, timeout_s: float = 1800.0,
          pg_timeout_s: float = PG_TIMEOUT_S) -> list:
    """Run `fn(rank, world, *args)` on `world_` spawned ranks of a fresh
    group and return their results in rank order.

    `fn` must be importable by name (a module-level function) and its result
    picklable; move tensors to the CPU before returning them. Without
    `init_method` the ranks meet at a file store in a temporary directory,
    removed afterwards. A rank that fails, dies or outlives `timeout_s`
    stops every rank and raises RuntimeError with what each failing rank
    reported."""
    ctx = mp.get_context("spawn")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_dist_")
        init_method = "file://" + os.path.join(tmp, "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_, backend, init_method,
                               pg_timeout_s, args, out_q), daemon=True)
             for r in range(world_)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        grace = None
        while len(results) + len(errors) < world_:
            now = time.monotonic()
            if now > deadline or (grace is not None and now > grace):
                break
            try:
                r, ok, payload = out_q.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                for r in dead:
                    errors[r] = f"rank {r} died with exit code {procs[r].exitcode}"
                if dead and grace is None:
                    grace = time.monotonic() + 5.0
                continue
            if ok:
                results[r] = pickle.loads(payload)
            else:
                errors[r] = payload
                if grace is None:  # let the peers report what they saw
                    grace = time.monotonic() + 5.0
        if errors or len(results) < world_:
            _stop(procs)
            missing = [r for r in range(world_)
                       if r not in results and r not in errors]
            msg = "".join(f"\n--- rank {r} ---\n{errors[r]}"
                          for r in sorted(errors))
            if missing:
                msg += f"\nranks {missing} reported nothing (timeout or hang)"
            raise RuntimeError(f"{len(errors) + len(missing)} of {world_} "
                               f"ranks failed:{msg}")
        for p in procs:
            p.join(60)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            _stop(procs)
            raise RuntimeError(f"ranks exited with codes {codes}")
        return [results[r] for r in range(world_)]
    finally:
        _stop(procs)
        out_q.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
