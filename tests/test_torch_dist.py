"""The port's distribution layer (`repro_torch/dist/`, `launch/mesh.py`)
against the JAX package's, on the CPU: gloo ranks spawned by
`repro_torch.dist.spawn`, their bodies in tests/_torch_dist_workers.py
(jax-free), their inputs numpy arrays made here from seeds.

Tolerances:
  - the sharding rules (`param_spec`, `cache_spec`, `packed_weight_spec`,
    `SERVE_CACHE_SPEC`): EQUAL to the reference's, for every leaf of the 11
    registry configs' reference trees (`jax.eval_shape(lm.init)`, and the
    decode caches of the decoder-only ones) at (model, data) 16/16 and 2/2,
    fsdp on and off; the port's own reduced-llama paths give the reference's;
  - four ranks on a (2, 2) gloo mesh: each leaf of reduced llama placed by
    `state_shardings(fsdp=True)` has the local shape the reference's spec
    gives it (each named dim halved), and `full_tensor()` is BITWISE the
    leaf; the train state's and the serving trees' placements are the
    reference's specs;
  - `_sr_roundtrip` with the reference's uniforms injected: BITWISE the
    reference's; `compressed_psum_mean` over 4 ranks with them: within 1e-6
    relative (L2) of the mean of the reference's four round trips (gloo's
    summation order); with the port's hashed draws, the reference's bars
    (tests/test_substrate.py): one step < 0.2 relative, the mean over 32
    seeds < half of that; a tree's sub-group leaf is the exact mean;
  - `gpipe` over 4 ranks within 1e-5 of sequential application (the
    reference's bar), compressed boundaries < 0.30 relative
    (tests/test_pipeline.py's); `_compress_boundary` BITWISE the reference's;
    two quartet2 `qlinear` stages over 2 ranks within 1e-5 of sequential.

Each test has a 60 s SIGALRM guard of this file's own; the spawned groups
meet at a file store under the test's tmp_path, have a collective timeout
of at most 60 s, and `spawn` joins or kills every rank it started.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jregistry
from repro.dist import compression as JC
from repro.dist import pipeline as JPP
from repro.dist import sharding as JSH
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train.train_step import TrainState as JTrainState
from repro_torch import dist as D
from repro_torch.configs import registry
from repro_torch.dist import compression as C
from repro_torch.dist import pipeline as PP
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import lm

import _torch_dist_workers as W

TEST_TIMEOUT_S = 60
MESHES = ((16, 16), (2, 2))
SEEDS = 32


@pytest.fixture(autouse=True)
def _guard():
    torch.set_num_threads(1)

    def fail(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT_S} s (a hung "
                           "collective?)")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _flat_paths(tree):
    return [(JSH._path_str(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _ref_key(seed, rank, tag):
    key = jax.random.wrap_key_data(jnp.asarray(seed, jnp.uint32))
    return jax.random.fold_in(jax.random.fold_in(key, rank), tag)


def _names(spec) -> tuple:
    """Placement strings of a spec on a ("data", "model") mesh."""
    spec = tuple(spec)
    return tuple(str(Shard(spec.index(a))) if a in spec else str(Replicate())
                 for a in ("data", "model"))


# --------------------------------------------------------------------------
# the pure rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jregistry.names())
def test_param_and_cache_specs_equal_the_reference(arch):
    cfg = jregistry.get(arch)
    params = jax.eval_shape(lambda: jlm.init(cfg, jax.random.PRNGKey(0)))
    leaves = _flat_paths(params)
    assert leaves
    for model, data in MESHES:
        for fsdp in (True, False):
            for path, shape in leaves:
                want = JSH.param_spec(path, shape, model=model, data=data,
                                      fsdp=fsdp)
                assert SH.param_spec(path, shape, model=model, data=data,
                                     fsdp=fsdp) == tuple(want), (path, shape)
        for path, shape in leaves:
            assert SH.packed_weight_spec(shape, model=model) == tuple(
                JSH.packed_weight_spec(shape, model=model))
    if cfg.enc_dec:
        return  # the reference's decode cache is enc-dec's own
    cache = jax.eval_shape(lambda: jlm.init_cache(cfg, 4, 64))
    for model, data in MESHES:
        for path, shape in _flat_paths(cache):
            kind = path.rsplit("/", 1)[-1]
            assert SH.cache_spec(kind, shape, model=model, data=data) == tuple(
                JSH.cache_spec(kind, shape, model=model, data=data)), path


def test_sharding_rules_reference_cases():
    """tests/test_dist.py::TestShardingRules, on the port's rules."""
    spec = SH.param_spec("stages/0/l0/mix/wq", (4096, 4096), model=16,
                         data=16, fsdp=True)
    assert spec == ("model", "data")
    assert SH.param_spec("head", (64000, 4096), model=16, data=16,
                         fsdp=True) == ("model", "data")
    assert SH.param_spec("dec_head", (51865, 384), model=16, data=16,
                         fsdp=False) == (None, "model")
    assert SH.param_spec("n1/g", (4096,), model=16, data=16,
                         fsdp=True) == (None,)
    assert all(s is None for s in SH.param_spec(
        "ff/router", (256, 7168), model=16, data=16, fsdp=True))
    assert SH.param_spec("stages/0/l0/ff/wi", (61, 256, 2048, 7168),
                         model=16, data=16, fsdp=True)[1] == "model"
    assert SH.param_spec("stages/0/l0/mix/wq", (48, 4096, 4096), model=16,
                         data=16, fsdp=True)[0] is None
    spec = SH.cache_spec("kv", (48, 128, 32768, 4, 128), model=16, data=16)
    assert spec[1] == "data" and spec[2] is None and spec[4] == "model"
    for shape in ((16, 16), (128, 384), (512, 4096), (4096, 128),
                  (11008, 4096), (11008, 384)):
        spec = SH.param_spec("w", shape, model=16, data=16, fsdp=True)
        assert spec == tuple(JSH.param_spec("w", shape, model=16, data=16,
                                            fsdp=True))
        for dim, ax in zip(shape, spec):
            if ax in ("model", "data"):
                assert dim % 16 == 0
    assert SH.SERVE_CACHE_SPEC == tuple(JSH.SERVE_CACHE_SPEC)


def test_port_paths_are_the_reference_paths():
    """The port's reduced llama tree walks to the reference's paths and
    shapes, so its specs are the reference's."""
    jcfg = jregistry.get("llama_200m").reduced()
    want = dict(_flat_paths(jax.eval_shape(
        lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))))
    params = lm.init(registry.get("llama_200m").reduced(),
                     torch.Generator().manual_seed(0), "cpu")
    got = {p: tuple(x.shape) for p, x in SH.leaf_paths(params)}
    assert got == want
    for path, shape in got.items():
        assert SH.param_spec(path, shape, model=2, data=2, fsdp=True) == \
            tuple(JSH.param_spec(path, shape, model=2, data=2, fsdp=True))


def test_production_mesh_waits_for_the_dryrun_slice():
    with pytest.raises(NotImplementedError, match="dry-run"):
        M.make_production_mesh()


def test_bubble_fraction_and_stack_stage_params():
    assert PP.bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert PP.bubble_fraction(1, 8) == 0.0
    assert PP.bubble_fraction(2, 4) == JPP.bubble_fraction(2, 4)
    p = {"w": torch.arange(24).reshape(8, 3), "l": [torch.zeros(8, 2, 5)]}
    s = PP.stack_stage_params(p, 4)
    assert s["w"].shape == (4, 2, 3) and s["l"][0].shape == (4, 2, 2, 5)
    assert torch.equal(s["w"][1], p["w"][2:4])
    with pytest.raises(ValueError, match="do not split"):
        PP.stack_stage_params(p, 3)


@pytest.mark.parametrize("shape", [(2, 16), (3, 5, 32), (4, 64)])
def test_compress_boundary_bitwise_the_reference(shape):
    y = (np.random.default_rng(sum(shape)).standard_normal(shape) * 3
         ).astype(np.float32)
    want = np.asarray(JPP._compress_boundary(jnp.asarray(y)))
    got = PP._compress_boundary(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2048,), (37,), (5, 7), (64, 48)])
def test_sr_roundtrip_bitwise_the_reference(shape):
    x = np.random.default_rng(len(shape) * 7 + shape[0]).standard_normal(
        shape).astype(np.float32)
    key = _ref_key([3, 4], 1, 2)
    want = np.asarray(JC._sr_roundtrip(jnp.asarray(x), key))
    n = C._padded(x.size)
    u = np.array(jax.random.uniform(key, (1, n), jnp.float32))
    got = C._sr_roundtrip(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rank_draws_differ_by_rank_and_tag():
    seed = np.array([5, 0], np.uint32)
    a = C.rank_draws(seed, 0).uniform(1, (1, 64), "cpu")
    assert torch.equal(a, C.rank_draws(seed, 0).uniform(1, (1, 64), "cpu"))
    assert not torch.equal(a, C.rank_draws(seed, 1).uniform(1, (1, 64), "cpu"))
    assert not torch.equal(a, C.rank_draws(seed, 0).uniform(2, (1, 64), "cpu"))
    inj = W.Injected({})
    assert C.rank_draws(inj, 3) is inj


def test_nccl_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match="one card per rank"):
        D.check_backend("nccl", torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="CUDA ranks only"):
        D.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="backend must be"):
        D.check_backend("mpi", 2, "cpu")


def test_a_failing_rank_fails_the_spawn(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1"):
        D.spawn(W.failing_body, 2, backend="gloo", timeout_s=50,
                pg_timeout_s=20, init_method=f"file://{tmp_path}/store")


# --------------------------------------------------------------------------
# four gloo ranks: one group runs sharding, compression and GPipe
# --------------------------------------------------------------------------

def _inputs() -> dict:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 2048)).astype(np.float32)
    ref_u = [np.asarray(jax.random.uniform(_ref_key([5, 0], r, 0), (1, 2048),
                                           jnp.float32)) for r in range(4)]
    return {"x": x, "ref_u": ref_u, "seeds": SEEDS,
            "tree_w": rng.standard_normal((4, 8, 32)).astype(np.float32),
            "tree_g": rng.standard_normal((4, 6)).astype(np.float32),
            "ws": (rng.standard_normal((4, 16, 16)) / 4).astype(np.float32),
            "xs": rng.standard_normal((8, 2, 16)).astype(np.float32),
            "ws32": (rng.standard_normal((4, 32, 32)) / np.sqrt(32)
                     ).astype(np.float32),
            "xs32": rng.standard_normal((4, 2, 32)).astype(np.float32)}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inputs = _inputs()
    store = tmp_path_factory.mktemp("four") / "store"
    outs = D.spawn(W.four_rank_body, 4, (inputs,), backend="gloo",
                   timeout_s=120, pg_timeout_s=60, init_method=f"file://{store}")
    return inputs, outs


def test_fsdp_local_shapes_and_round_trip(four):
    _, outs = four
    jcfg = jregistry.get("llama_200m").reduced()
    ref = dict(_flat_paths(jax.eval_shape(
        lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))))
    for out in outs:
        assert out["full_tensor_bitwise"]
        assert set(out["local_shapes"]) == set(ref)
        for path, shape in ref.items():
            spec = JSH.param_spec(path, shape, model=2, data=2, fsdp=True)
            want = tuple(d // 2 if ax in ("model", "data") else d
                         for d, ax in zip(shape, tuple(spec)))
            assert out["local_shapes"][path] == want, path
    assert any(tuple(v) != ref[p] for p, v in outs[0]["local_shapes"].items())


def test_state_and_input_placements_are_the_reference_specs(four):
    _, outs = four
    jcfg = jregistry.get("llama_200m").reduced()

    def state():
        p = jlm.init(jcfg, jax.random.PRNGKey(0))
        return JTrainState(p, jadamw.init(p), jnp.zeros((), jnp.int32))

    ref = dict(_flat_paths(jax.eval_shape(state)))
    # the port's moments are lists aligned with the leaves: entry i of
    # opt/mu stands for the reference's opt/mu/<path of leaf i>
    names = outs[0]["param_paths"]
    got = {}
    for path, plc in outs[0]["state_placements"]:
        head, _, last = path.rpartition("/")
        got[f"{head}/{names[int(last)]}" if head in ("opt/mu", "opt/nu")
            else path] = plc
    assert set(got) == set(ref)
    for path, shape in ref.items():
        if got[path] is None:  # the port's int step counters
            assert shape == (), path
            continue
        spec = JSH.param_spec(path, shape, model=2, data=2, fsdp=True)
        assert got[path] == _names(spec), path
    assert all(got[p] == (str(Replicate()),) * 2 for p in got
               if "/mu/" in p)  # the reference's "mu" token
    assert dict(outs[0]["input_placements"]) == {
        "tokens": (str(Shard(0)), str(Replicate()))}
    assert all(o["state_placements"] == outs[0]["state_placements"]
               for o in outs)


def test_cache_placements_are_the_reference_specs(four):
    _, outs = four
    got = dict(outs[0]["cache_placements"])
    want = {}
    for path, shape in (("0/l0/kv/0", (2, 4, 8, 2, 16)),
                        ("0/l0/kv/1", (2, 4, 8, 2, 16)),
                        ("0/l0/wkv", (2, 4, 3))):
        want[path] = _names(JSH.cache_spec(path.rsplit("/", 1)[-1], shape,
                                           model=2, data=2))
    assert got == want
    assert got["0/l0/kv/0"] == (str(Shard(1)), str(Shard(4)))


def test_serving_placements_are_the_reference_specs(four):
    _, outs = four
    got = dict(outs[0]["serve_placements"])
    want = {"embed": _names(JSH.param_spec("embed", (512, 128), model=2,
                                           data=1, fsdp=False)),
            "final_norm/g": (str(Replicate()),) * 2}
    for field, shape in (("packed", (2, 64, 16)), ("scale_bits", (2, 64, 4)),
                         ("gscale", (2,))):
        want[f"stages/0/l0/mix/wq/{field}"] = _names(
            JSH.packed_weight_spec(shape, model=2))
    assert got == want
    assert got["stages/0/l0/mix/wq/packed"] == (str(Replicate()),
                                                str(Shard(1)))
    spec = tuple(JSH.SERVE_CACHE_SPEC)
    assert dict(outs[0]["serve_cache_placements"]) == {
        "kv": _names(spec), "wkv": _names(spec)}


def test_compressed_psum_mean_with_reference_draws(four):
    inputs, outs = four
    x = inputs["x"]
    trips = [np.asarray(JC._sr_roundtrip(jnp.asarray(x[r]),
                                         _ref_key([5, 0], r, 0)))
             for r in range(4)]
    want = np.mean(np.stack(trips), axis=0)
    for out in outs:
        got = out["injected_mean"]
        assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    assert all(np.array_equal(o["injected_mean"], outs[0]["injected_mean"])
               for o in outs)


def test_compressed_mean_accurate_and_unbiased_with_hashed_draws(four):
    inputs, outs = four
    want = inputs["x"].mean(axis=0)
    means = outs[0]["hashed_means"]
    one = np.linalg.norm(means[0] - want) / np.linalg.norm(want)
    many = np.linalg.norm(means.mean(0) - want) / np.linalg.norm(want)
    assert one < 0.2, one
    assert many < one / 2, (one, many)
    assert all(np.array_equal(o["hashed_means"], means) for o in outs)
    # ranks draw differently: the 4 round trips are not one draw repeated
    assert len({m.tobytes() for m in means}) == SEEDS


def test_compressed_grad_mean_tree(four):
    inputs, outs = four
    tree = outs[0]["tree"]
    # the 6-element leaf is under one scale group: the exact mean
    np.testing.assert_allclose(tree["g"], inputs["tree_g"].mean(0),
                               rtol=1e-6, atol=1e-7)
    w = inputs["tree_w"].mean(0)
    rel = np.linalg.norm(tree["w"] - w) / np.linalg.norm(w)
    assert 0 < rel < 0.2, rel
    assert all(np.array_equal(o["tree"]["w"], tree["w"]) for o in outs)


def test_gpipe_matches_sequential(four):
    inputs, outs = four
    want = jnp.asarray(inputs["xs"])
    for s in range(4):
        want = jnp.tanh(want @ jnp.asarray(inputs["ws"][s]))
    want = np.asarray(want)
    for out in outs:
        assert np.max(np.abs(out["gpipe_False"] - want)) < 1e-5
        rel = np.linalg.norm(out["gpipe_True"] - want) / np.linalg.norm(want)
        assert 0 < rel < 0.30, rel
    want = jnp.asarray(inputs["xs32"])
    for s in range(4):
        want = jnp.tanh(want @ jnp.asarray(inputs["ws32"][s]))
    want = np.asarray(want)
    for out in outs:
        rel = np.linalg.norm(out["gpipe_d32"] - want) / np.linalg.norm(want)
        assert 0 < rel < 0.30, rel


def test_gpipe_quartet2_stages_over_two_ranks(tmp_path):
    outs = D.spawn(W.gpipe_quartet2_body, 2, (64,), backend="gloo",
                   timeout_s=50, pg_timeout_s=30,
                   init_method=f"file://{tmp_path}/store")
    for out in outs:
        err = np.max(np.abs(out["got"] - out["want"]))
        assert err < 1e-5, err
        np.testing.assert_array_equal(out["got"], outs[0]["got"])
