"""The port's checkpointer: its own contract, and its on-disk format against
the JAX reference's `Checkpointer` in both directions.

Tolerances: none. Every comparison here is bitwise — a leaf goes to disk as
it is (bf16 and float8 upcast to f32, which is exact) and comes back cast
to its dtype; a checkpoint that either package writes restores in the other
with the same numbers.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch.checkpoint import checkpointer as C
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import lm
from repro_torch.optim import adamw, muon
from repro_torch.train import train_step as ts

JCFG = jregistry.get("llama_200m").reduced()
CFG = registry.get("llama_200m").reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "b": torch.randn(16, generator=g).bfloat16(),
            "ids": torch.randint(-5, 1000, (4, 3), generator=g, dtype=torch.int32),
            "layers": [{"k": torch.randn(2, 4, generator=g)},
                       {"k": torch.randn(2, 4, generator=g)}],
            "step": 7}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


def _assert_trees_equal(a, b):
    la, lb = C.flatten(a), C.flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("blocking", [True, False])
def test_round_trip_bitwise(tmp_path, blocking):
    ck = C.Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ck.save(5, tree, extra={"note": "x"}, blocking=blocking)
    ck.wait()
    assert ck.latest_step() == 5 and ck.all_steps() == [5]
    out, meta = ck.restore(_zeros_like(tree))
    assert meta == {"step": 5, "extra": {"note": "x"}, "n_leaves": 6}
    _assert_trees_equal(out, tree)
    # on disk: the reference's names, order (sorted keys) and dtypes
    d = tmp_path / "step_0000000005"
    assert sorted(os.listdir(d)) == [f"leaf_{i:05d}.npy" for i in range(6)] + ["meta.json"]
    assert np.load(d / "leaf_00000.npy").dtype == np.float32      # "b", bf16
    assert np.load(d / "leaf_00001.npy").dtype == np.int32        # "ids"
    assert np.load(d / "leaf_00004.npy").shape == ()              # "step"
    assert ck.last["bytes"] > 0 and ck.last["write_s"] >= 0


def test_async_save_is_a_snapshot(tmp_path):
    """AdamW updates in place right after the save; on the CPU a tensor's
    numpy() shares its memory, so `save` must copy before it returns."""
    ck = C.Checkpointer(str(tmp_path))
    tree = _tree()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items() if k != "layers"}
    ck.save(1, {k: v for k, v in tree.items() if k != "layers"}, blocking=False)
    tree["w"].add_(1.0)
    tree["b"].mul_(3)
    ck.wait()
    out, _ = ck.restore(_zeros_like(want))
    _assert_trees_equal(out, want)


def test_failed_save_commits_nothing(tmp_path, monkeypatch):
    ck = C.Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    real, calls = np.save, []

    def failing(path, arr):
        calls.append(path)
        if len(calls) >= 3:  # the third leaf of a save, and all after it
            raise OSError("disk full")
        real(path, arr)

    monkeypatch.setattr(np, "save", failing)
    with pytest.raises(OSError):
        ck.save(2, _tree(1))
    assert not ck.emergency_save(3, _tree(1))  # never raises
    assert ck.latest_step() == 1 and ck.all_steps() == [1]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001"]


def test_keep_collects_old_checkpoints(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=s % 2 == 0)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    out, meta = ck.restore(_zeros_like(_tree()), step=3)
    _assert_trees_equal(out, _tree(3))
    with pytest.raises(FileNotFoundError):
        C.Checkpointer(str(tmp_path / "empty")).restore(_tree())


def test_structure_mismatch_raises(tmp_path):
    ck = C.Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    with pytest.raises(ValueError, match="structure"):
        ck.restore({"w": torch.zeros(8, 16)})


# --------------------------------------------------------------------------
# the reference's format, both directions
# --------------------------------------------------------------------------

def _batches():
    corpus = JCorpus(JDataConfig(vocab=CFG.vocab, seq_len=16, global_batch=2))
    return [jax.tree.map(np.asarray, corpus.batch_at(i)) for i in range(2)]


def _tb(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_state(optimizer, jparams):
    init, _ = ts.make_train_step(CFG, "bf16", optimizer=optimizer)
    return init(params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu"))


def _moment_lists(opt):
    """Every f32 moment list of a port optimizer state, by name."""
    if isinstance(opt, muon.MuonState):
        return {"mom": opt.mom, **_moment_lists(opt.adam)}
    return {"mu": opt.mu, "nu": opt.nu}


def _ref_moments(opt):
    """The reference optimizer state's moment trees as port lists (params'
    leaf order)."""
    conv = lambda t: adamw.leaves(params_from_jax(jax.tree.map(np.asarray, t),
                                                  CFG, "cpu"))
    if hasattr(opt, "mom"):
        return {"mom": conv(opt.mom), **_ref_moments(opt.adam)}
    return {"mu": conv(opt.mu), "nu": conv(opt.nu)}


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, optimizer):
    jparams = jlm.init(JCFG, jax.random.PRNGKey(0))
    jinit, jstep = jts.make_train_step(JCFG, "bf16", optimizer=optimizer)
    jstate, jstep = jinit(jparams), jax.jit(jstep)
    for batch in _batches():
        jstate, _ = jstep(jstate, batch)
    JCheckpointer(str(tmp_path)).save(2, jstate)

    state = _port_state(optimizer, jparams)
    state, meta = C.Checkpointer(str(tmp_path)).restore(state)
    assert meta["step"] == 2 and state.step == state.opt.step == 2
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), CFG, "cpu")
    for a, b in zip(adamw.leaves(state.params), adamw.leaves(want)):
        assert torch.equal(a, b)
    ref = _ref_moments(jstate.opt)
    for name, got in _moment_lists(state.opt).items():
        for a, b in zip(got, ref[name]):
            assert torch.equal(a, b), name
    if optimizer == "muon":
        assert state.opt.adam.step == 2


def _by_path(tree) -> dict:
    """{port-style path tuple: numpy leaf} of a reference pytree."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, optimizer):
    """The port's own `lm.init` tree (dict insertion order, not sorted) after
    2 bf16 steps: the reference restores every leaf under its path."""
    init, step = ts.make_train_step(CFG, "bf16", optimizer=optimizer)
    state = init(lm.init(CFG, torch.Generator().manual_seed(0), "cpu"))
    for batch in _batches():
        state, _ = step(state, _tb(batch))
    C.Checkpointer(str(tmp_path)).save(state.step, state)
    meta = json.loads((tmp_path / "step_0000000002" / "meta.json").read_text())
    assert meta["step"] == 2

    jinit, _ = jts.make_train_step(JCFG, "bf16", optimizer=optimizer)
    like = jinit(jlm.init(JCFG, jax.random.PRNGKey(1)))
    jstate, jmeta = JCheckpointer(str(tmp_path)).restore(like)
    assert jmeta["step"] == 2 and int(jstate.step) == int(jstate.opt.step) == 2
    paths = [path for path, _ in muon._paths(state.params)]
    assert list(state.params) != sorted(state.params)  # insertion order
    trees = {"params": (jstate.params, adamw.leaves(state.params))}
    opt = jstate.opt
    if optimizer == "muon":
        trees["mom"] = (opt.mom, state.opt.mom)
        opt = opt.adam
        assert int(opt.step) == state.opt.adam.step == 2
    moments = _moment_lists(state.opt)
    trees["mu"], trees["nu"] = (opt.mu, moments["mu"]), (opt.nu, moments["nu"])
    for name, (ref, port) in trees.items():
        ref = _by_path(ref)
        assert len(ref) == len(port) == len(paths)
        for path, leaf in zip(paths, port):
            assert np.array_equal(ref[path], leaf.detach().numpy()), (name, path)
