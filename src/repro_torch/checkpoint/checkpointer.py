"""Checkpoints of a training state, async-capable, in the reference's format.

Counterpart of `repro/checkpoint/checkpointer.py`, with the same on-disk
format: a directory `step_%010d` per checkpoint holding one
`leaf_%05d.npy` per leaf and a `meta.json` (`step`, `extra`, `n_leaves`).
bf16 and float8 leaves are upcast to f32 on disk and cast back on restore
(exactly invertible). Leaves are numbered in the reference's
`jax.tree_util.tree_flatten` order of the matching `TrainState`: dict keys
sorted, NamedTuple fields in order, list items in order, Python int steps as
0-d int32 arrays. The port keeps its optimizer moments as lists in
`adamw.leaves` order (dict insertion order); they are laid out on the
params' tree before flattening (`reference_tree`), so a checkpoint that
either package writes restores in the other.

Fault-tolerance contract used by the trainer:
  - atomic commit: leaves go to `.tmp_step_N`, which is renamed once
    complete, so a crash mid-save never corrupts the latest checkpoint (a
    failed save removes its temporary directory);
  - one save in flight: `save` first waits for the previous one;
  - `save(..., blocking=False)` copies the state to the host before it
    returns (a consistent snapshot: the optimizer updates in place right
    after) and writes it on a one-thread executor while training goes on.
    Device leaves are copied into pinned host buffers that are kept from
    one save to the next (one host copy of the state), so the copy runs at
    the link's pinned rate; the one-save-in-flight rule means the writer is
    done with them before the next save refills them;
  - `emergency_save` is called from failure paths: blocking, never raises;
  - the newest `keep` checkpoints are kept, older ones removed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.optim import adamw, muon
from repro_torch.train.train_step import TrainState

_UPCAST = (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
           torch.float8_e5m2)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _lay_out(tree, flat):
    """The items of `flat` (in `adamw.leaves` order) in `tree`'s structure."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return next(it)
    return walk(tree)


def _opt_tree(opt, params):
    if isinstance(opt, muon.MuonState):
        return muon.MuonState(opt.step, _lay_out(params, opt.mom),
                              _opt_tree(opt.adam, params))
    if isinstance(opt, adamw.AdamWState):
        return adamw.AdamWState(opt.step, _lay_out(params, opt.mu),
                                _lay_out(params, opt.nu))
    return opt


def _opt_lists(opt):
    if isinstance(opt, muon.MuonState):
        return muon.MuonState(opt.step, adamw.leaves(opt.mom),
                              _opt_lists(opt.adam))
    if isinstance(opt, adamw.AdamWState):
        return adamw.AdamWState(opt.step, adamw.leaves(opt.mu),
                                adamw.leaves(opt.nu))
    return opt


def reference_tree(state):
    """A port `TrainState` in the reference's tree layout (each moment list
    as a tree like the params); any other tree as it is."""
    if isinstance(state, TrainState):
        return TrainState(state.params, _opt_tree(state.opt, state.params),
                          state.step)
    return state


def _from_reference_tree(tree):
    if isinstance(tree, TrainState):
        return TrainState(tree.params, _opt_lists(tree.opt), tree.step)
    return tree


def flatten(tree) -> list:
    """Leaves (tensors and ints) in `jax.tree_util.tree_flatten` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def _rebuild(like, it):
    """`like`'s structure with its leaves taken from `it` in flatten order
    (dicts keep their insertion order)."""
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: new[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, it) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _host_copy(x):
    """A host copy of one leaf, made now (never a view of the live leaf)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (bool, int, np.integer)):
        return np.asarray(x, np.int32)
    raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype in _UPCAST else x).numpy()
    return x


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._lock = threading.Lock()
        self._staging: dict[int, torch.Tensor] = {}  # pinned, by leaf index
        # the last save: host seconds `save` blocked for (the device-to-host
        # copy), seconds of the write, bytes on disk
        self.last = {}

    # ---- save -------------------------------------------------------------

    def save(self, step: int, state, extra: dict | None = None,
             blocking: bool = True):
        """state: a port TrainState or any tree of dicts, lists, NamedTuples,
        tensors and ints. extra: JSON-serializable metadata."""
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        leaves = flatten(reference_tree(state))
        host = [self._to_host(i, x) for i, x in enumerate(leaves)]
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            torch.cuda.synchronize()  # the staging copies are asynchronous
        meta = {"step": int(step), "extra": extra or {}, "n_leaves": len(host)}
        self.last = {"copy_s": time.perf_counter() - t0}

        def _write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            try:
                os.makedirs(tmp, exist_ok=True)
                nbytes = 0
                for i, leaf in enumerate(host):
                    arr = _to_numpy(leaf)
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
                    nbytes += arr.nbytes
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()
            self.last.update(write_s=time.perf_counter() - t1, bytes=nbytes)

        if blocking:
            _write()
        else:
            with self._lock:
                self._pending = self._pool.submit(_write)

    def _to_host(self, i: int, x):
        """Leaf i's host copy: a device tensor goes to its pinned staging
        buffer (made at the first save); anything else as `_host_copy`."""
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            return _host_copy(x)
        buf = self._staging.get(i)
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = self._staging[i] = torch.empty(x.shape, dtype=x.dtype,
                                                 pin_memory=True)
        return buf.copy_(x.detach(), non_blocking=True)

    def emergency_save(self, step: int, state, extra=None) -> bool:
        """Called from failure paths; always blocking, never raises."""
        try:
            self.save(step, state, {**(extra or {}), "emergency": True},
                      blocking=True)
            return True
        except Exception:
            return False

    def wait(self):
        with self._lock:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                pending.result()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> int | None:
        s = self.all_steps()
        return s[-1] if s else None

    @torch.no_grad()
    def restore(self, state_like, step: int | None = None):
        """Restore checkpoint `step` (default the latest) into the structure
        of `state_like`. Tensor leaves are written IN PLACE (cast to their
        dtype, on their device); int leaves come back as ints. Returns
        (state, meta)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        like_tree = reference_tree(state_like)
        leaves = flatten(like_tree)
        if len(leaves) != meta["n_leaves"]:
            raise ValueError(f"structure mismatch: {len(leaves)} leaves "
                             f"against {meta['n_leaves']} on disk")
        out = []
        for i, like in enumerate(leaves):
            arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            shape = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
            if arr.shape != shape:
                raise ValueError(f"leaf {i}: {arr.shape} on disk, {shape} here")
            if isinstance(like, torch.Tensor):
                like.copy_(torch.from_numpy(arr))
                out.append(like)
            else:
                out.append(int(arr))
        return _from_reference_tree(_rebuild(like_tree, iter(out))), meta
