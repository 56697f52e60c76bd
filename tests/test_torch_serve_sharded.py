"""Mesh-sharded serving in the port (`EngineConfig(mesh=make_serve_mesh(2, 1,
devices=["cpu"] * 2))`): two data shards, each with its slots, its cache
tree and its shard-local tables, one engine over both.

The reference's own sharded engine tests (tests/test_serve_sharded.py) do
not run in this environment (jax's `shard_map` lacks the `auto` argument
the reference passes), so the port is held three other ways:

  - each shard's step against the reference's UNSHARDED paged step fed
    that shard's slice: its rows of tokens, positions and the active mask,
    its rows of the reference's shard-local tables (`KVPool(n_shards=2)`)
    and its axis-1 slice of the reference's cache tree, which is what the
    reference's manual-"data" `shard_map` hands each shard
    (`repro/serve/decode.py:shard_serve_step`). bf16 against the jitted
    reference: |dlogit| <= 2e-2, the bar tests/test_torch_model.py holds
    the unsharded step to against the same reference (measured 8.8e-3 on
    logits up to 0.84: XLA's reciprocal multiply moves bf16 roundings by
    an ulp). quartet2 against the reference run eagerly: relative RMS
    within 1e-5 (the rules' bar; measured bitwise);
  - the properties tests/test_serve_sharded.py states, against the port's
    own unsharded engine (itself held against the reference's): bf16
    greedy streams bitwise for gqa, mla and lattn over paged and dense
    caches, sampled streams bitwise where both engines serve a request in
    the same slot, the speculative stream, quartet2 determinism and each shard's
    quartet2 step bitwise the unsharded step over that shard's slice, slot
    affinity and reclamation, shard-local table indices, the divisibility
    and "model"-axis errors, the prefix cache (bitwise and affine,
    unreachable across shards without the host tier, spill-hot across
    shards, hot through a replica), occupancy-aware placement, and
    `launch.serve --data-shards`.

The pool walk and the prefix-cache walk against the reference's two-shard
allocator and cache are in test_torch_kv_pool.py and
test_torch_prefix_cache.py, the NVFP4 pool in test_torch_kv_quant.py, obs
in test_torch_obs.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve import kv_pool as jkv
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import lm
from repro_torch.serve import decode as tdecode
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kv_pool import KVPool

BF16_LOGIT_ATOL = 2e-2   # tests/test_torch_model.py's, against jitted JAX
Q2_REL_RMS = 1e-5        # against eager JAX
MESH = make_serve_mesh(2, 1, devices=["cpu", "cpu"])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# each shard's step against the reference's unsharded step on its slice
# --------------------------------------------------------------------------

def _steps(vocab):
    """Two single-token steps over 4 slots at ragged positions (keys below
    each position are the pool's zeros in both packages); slot 3 inactive
    in the first."""
    rng = np.random.RandomState(1)
    return [(rng.randint(0, vocab, (4, 1)).astype(np.int32),
             np.asarray(pos, np.int32), np.asarray(act))
            for pos, act in (((5, 9, 3, 0), (True, True, True, False)),
                             ((6, 10, 4, 1), (True, True, True, True)))]


@functools.lru_cache(maxsize=None)
def _llama():
    jcfg = jregistry.get("llama_200m").reduced()
    cfg = registry.get("llama_200m").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
def test_shard_step_matches_reference_step_on_its_slice(scheme):
    """Raw weights (each step quantizes them, in both packages), a two-shard
    pool of 4 slots, two steps; each shard's logits against the reference's
    unsharded step over the shard's slice, which carries the cache writes
    of the first step into the second."""
    jcfg, cfg, jparams, params = _llama()
    jpool = jkv.KVPool(jcfg, 4, 32, paged=True, block_size=4, n_shards=2)
    pool = KVPool(cfg, 4, 32, block_size=4, device="cpu", n_shards=2)
    for p in (jpool, pool):
        for s, n in ((0, 23), (1, 11), (2, 17), (3, 9)):
            p.commit(s, n)
            p.ensure(s, n)
    bps = pool.blocks_per_shard
    jtables = np.asarray(jpool.tables_device())
    assert np.array_equal(np.concatenate(
        [t.numpy() for t in pool.tables_device()]), jtables)
    # the reference's shard_map hands shard s the axis-1 slice of its tree
    jcaches = [jax.tree.map(lambda a, s=s: a[:, s * bps:(s + 1) * bps],
                            jpool.caches) for s in range(2)]
    jstep = jdecode.make_paged_serve_step(jcfg, scheme, paged_kernel=True)
    if scheme == "bf16":
        jstep = jax.jit(jstep)
    step = tdecode.make_sharded_serve_step(cfg, scheme, MESH)
    for toks, pos, act in _steps(cfg.vocab):
        got, _ = step([params, params], pool.shard_caches,
                      pool.tables_device(), torch.from_numpy(toks),
                      torch.from_numpy(pos), torch.from_numpy(act))
        got = got.float().numpy()
        for s in range(2):
            r = slice(2 * s, 2 * s + 2)
            args = [jnp.asarray(a[r]) for a in (jtables, toks, pos, act)]
            if scheme == "bf16":
                want, jcaches[s] = jstep(jparams, jcaches[s], *args)
            else:
                with jax.disable_jit():
                    want, jcaches[s] = jstep(jparams, jcaches[s], *args)
            want = np.asarray(want.astype(jnp.float32))
            live = act[r]
            diff = (got[r] - want)[live]
            if scheme == "bf16":
                assert np.abs(diff).max() <= BF16_LOGIT_ATOL
            else:
                rel = np.sqrt((diff ** 2).mean() / (want[live] ** 2).mean())
                assert rel <= Q2_REL_RMS, rel


# --------------------------------------------------------------------------
# the sharded engine against the port's unsharded engine
# --------------------------------------------------------------------------

def _gqa_cfg():
    return registry.get("yi_9b").reduced()


def _mla_cfg():
    cfg = registry.get("deepseek_v3_671b").reduced()
    # bf16 rows are independent only without capacity drops
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _lattn_cfg():
    base = registry.get("recurrentgemma_9b").reduced()
    return dataclasses.replace(
        base, griffin=dataclasses.replace(base.griffin, window=8,
                                          pattern=("attn", "attn")))


_CFGS = {"gqa": _gqa_cfg, "mla": _mla_cfg, "lattn": _lattn_cfg}


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = _CFGS[arch]()
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(vocab, lens=(9, 13, 7, 11), seed=1):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, n))) for n in lens]


def _engine(arch="gqa", **kw):
    cfg, params = _model(arch)
    for k, v in dict(n_slots=4, max_len=64, prefill_chunk=8, scheme="bf16",
                     device="cpu").items():
        kw.setdefault(k, v)
    return ServeEngine(cfg, params, EngineConfig(**kw))


def _streams(eng, prompts, max_new=5):
    ids = [eng.submit(Request(p, max_new)) for p in prompts]
    res = {r.req_id: r.tokens for r in eng.run()}
    return [res[i] for i in ids]


def _affine(pool):
    bps = pool.blocks_per_shard
    return all(b // bps == pool.shard_of_slot(s)
               for s in range(pool.n_slots) for b in pool._owned[s])


def _conserved(pool):
    held = sum(1 for b in range(pool.n_blocks) if pool.refcount(b) > 0)
    return pool.free_block_count + held == pool.n_blocks


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ["gqa", "mla", "lattn"])
def test_sharded_streams_bitwise_unsharded(arch, paged):
    """A data = 2 split of the slot batch gives the unsharded engine's bf16
    greedy streams bit for bit, over the paged pool and dense caches."""
    cfg, _ = _model(arch)
    prompts = _prompts(cfg.vocab)
    single = _streams(_engine(arch, paged=paged), prompts)
    eng = _engine(arch, paged=paged, mesh=MESH)
    assert _streams(eng, prompts) == single
    assert eng.data_shards == 2 and eng.pool.n_shards == 2
    assert eng.pool.free_block_count == eng.pool.n_blocks


def test_sharded_sampled_streams_bitwise_in_the_same_slots():
    """Sampling draws its noise per slot row from the engine's generator,
    and the sharded engine places requests by shard occupancy: fed the
    requests in the sharded engine's slot order (so both run one schedule
    in the same rows), the unsharded engine's sampled streams (temperature
    0.8, top-k 8, the same base seed) are the sharded ones bit for bit."""
    from repro_torch.serve.sampling import SamplingParams
    cfg, _ = _model("gqa")
    prompts = _prompts(cfg.vocab)
    sp = SamplingParams(0.8, 8)
    eng = _engine(mesh=MESH)
    ids = [eng.submit(Request(p, 5, sp)) for p in prompts]
    eng.step()                                   # every request admitted
    order = [ids.index(s.req.req_id) for s in eng.slots]
    assert order != sorted(order)                # placed off first-fit
    sharded = {r.req_id: r.tokens for r in eng.run()}
    single = _engine()
    sids = [single.submit(Request(prompts[i], 5, sp)) for i in order]
    res = {r.req_id: r.tokens for r in single.run()}
    assert all(res[sids[k]] == sharded[ids[i]] for k, i in enumerate(order))


def test_sharded_spec_stream_bitwise_unsharded():
    """Speculation under the mesh (the draft pool sharded too, its steps
    and its propose loop run a shard at a time, the verify chunk through
    the sharded step) emits the unsharded non-speculative stream."""
    cfg, _ = _model("gqa")
    prompts = _prompts(cfg.vocab)
    single = _streams(_engine(), prompts)
    eng = _engine(mesh=MESH, spec_k=2, draft_layers=1)
    assert _streams(eng, prompts) == single
    assert eng.stats["spec_rounds"] > 0 and eng.draft.pool.n_shards == 2


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def test_sharded_quartet2_is_each_shards_unsharded_step():
    """Under quartet2 the activation absmax spans a shard's slots: two
    sharded runs are bitwise each other, and every shard step's logits are
    bitwise the unsharded step run on a copy of that shard's tree with its
    rows of the inputs and its tables."""
    cfg, _ = _model("gqa")
    prompts = _prompts(cfg.vocab)
    kw = dict(scheme="quartet2", mesh=MESH)
    first = _streams(_engine(**kw), prompts)
    eng = _engine(**kw)
    plain = tdecode.make_paged_serve_step(cfg, "quartet2")
    checked = []

    def step_checked(params, caches, tables, tokens, pos, active):
        n = tokens.shape[0] // 2
        want = []
        for s in range(2):
            r = slice(s * n, (s + 1) * n)
            want.append(plain(params[s], _clone(caches[s]), tables[s],
                              tokens[r], pos[r], active[r])[0])
        logits, out = inner(params, caches, tables, tokens, pos, active)
        assert torch.equal(logits, torch.cat(want))
        checked.append(1)
        return logits, out

    inner, eng._step = eng._step, step_checked
    assert _streams(eng, prompts) == first
    assert len(checked) > 10


def test_sharded_slot_affinity_local_tables_and_reclamation():
    """More requests than slots cycle through both shards; every table a
    step read sends each slot's blocks to its own shard, every device table
    carries shard-local ids under the local sentinel, and each shard's free
    list is whole at the end."""
    cfg, _ = _model("gqa")
    eng = _engine(n_slots=2, mesh=MESH)
    pool = eng.pool
    assert pool.slots_per_shard == 1 and pool.shard_caches[0] is not \
        pool.shard_caches[1]
    k = pool.shard_caches[1][0]["l0"]["kv"][0]
    assert k.shape[1] == pool.blocks_per_shard + 1   # its own scratch block
    whole = [pool.free_blocks_in_shard(s) for s in range(2)]
    seen = []
    orig = eng._forward

    def spy(tokens, pos, active):
        seen.append((pool._table.copy(),
                     [t.clone() for t in pool.tables_device()]))
        return orig(tokens, pos, active)

    eng._forward = spy
    res = _streams(eng, _prompts(cfg.vocab, (9, 13, 7, 11, 5)), max_new=3)
    assert len(res) == 5 and seen
    bps = pool.blocks_per_shard
    for table, local in seen:
        for slot in range(2):
            real = table[slot][table[slot] != pool.sentinel]
            assert np.all(real // bps == slot)
            row = local[slot][0]                        # (2, max_blocks)
            n = len(real)
            assert torch.equal(row[0, :n], torch.from_numpy(real - slot * bps))
            assert (row[:, n:] == bps).all()            # the local sentinel
    assert [pool.free_blocks_in_shard(s) for s in range(2)] == whole


def test_sharded_configuration_errors():
    cfg, params = _model("gqa")
    with pytest.raises(ValueError, match="n_slots"):
        _engine(n_slots=3, mesh=MESH)
    with pytest.raises(ValueError, match="n_shards"):
        _engine(n_slots=2, n_blocks=7, mesh=MESH)
    with pytest.raises(ValueError, match="one a data shard"):
        make_serve_mesh(2, 2, devices=["cpu", "cpu"])   # 4 devices: 2 x 2
    with pytest.raises(ValueError, match="one a data shard"):
        make_serve_mesh(2, 1, devices=["cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices"):
            make_serve_mesh(2, 1)          # a card a shard, no fallback


def _affine_wave(**kw):
    """Two waves of one 24-token prompt through a sharded engine of 2
    slots and 4-token blocks."""
    cfg, _ = _model("gqa")
    prompt = _prompts(cfg.vocab, (24,), seed=2)[0]
    eng = _engine(n_slots=2, block_size=4, mesh=MESH, **kw)
    return [_streams(eng, [prompt], 4)[0] for _ in range(2)], eng


def test_sharded_prefix_cache_bitwise_and_affine():
    cold, _ = _affine_wave()
    hot, eng = _affine_wave(prefix_cache=True)
    assert hot == cold
    assert eng.stats["prefill_skipped_tokens"] == 23
    assert _affine(eng.pool) and _conserved(eng.pool)


@pytest.mark.parametrize("spill", [False, True], ids=["drop", "spill"])
def test_sharded_prefix_across_shards(spill):
    """A prefix cached on shard 0 while shard 0's one slot is busy: without
    the host tier the resubmission admits COLD on shard 1 (only the
    blocker reuses the prefix, +19 skipped); with it the path materializes
    on shard 1 from host snapshots and admits HOT (+19 + 19). The stream is
    bitwise either way and slot affinity holds."""
    cfg, _ = _model("gqa")
    prompt = _prompts(cfg.vocab, (20,), seed=3)[0]
    eng = _engine(n_slots=2, block_size=4, mesh=MESH, prefix_cache=True,
                  prefix_spill=spill)
    ref = _streams(eng, [prompt], 3)[0]                # cached on shard 0
    skipped0 = eng.stats["prefill_skipped_tokens"]
    eng.submit(Request(prompt, 12))                    # the blocker
    shared = eng.submit(Request(prompt, 3))
    eng.step()        # the blocker takes slot 0 (shard 0, prefix reuse)
    res = {r.req_id: r.tokens for r in eng.run()}
    assert res[shared] == ref
    assert eng.stats["prefill_skipped_tokens"] == skipped0 + 19 + 19 * spill
    if spill:
        assert eng.cache.stats["swapped_in_blocks"] >= 4
    assert _affine(eng.pool) and _conserved(eng.pool)


def test_replicated_prefix_admits_hot_on_the_other_shard():
    """`replicate_hits=1`: after one hit the prefix's blocks are copied into
    shard 1 at tick boundaries (free blocks only), a request placed on
    shard 1 adopts the replicas with no swap-in, and its stream is bitwise
    the cold one."""
    cfg, _ = _model("gqa")
    prompt = _prompts(cfg.vocab, (20,), seed=3)[0]
    cold = _streams(_engine(n_slots=2, block_size=4, mesh=MESH), [prompt], 3)
    eng = _engine(n_slots=2, block_size=4, mesh=MESH, prefix_cache=True,
                  prefix_spill=True, replicate_hits=1)
    _streams(eng, [prompt], 3)                          # cached on shard 0
    _streams(eng, [prompt], 3)                          # one hit
    for _ in range(8):                                  # a block a tick
        eng.step()
    assert eng.cache.stats["replicated_blocks"] >= 4
    swapped = eng.cache.stats["swapped_in_blocks"]
    eng.submit(Request(prompt, 12))                     # blocks shard 0
    shared = eng.submit(Request(prompt, 3))
    eng.step()
    res = {r.req_id: r.tokens for r in eng.run()}
    assert res[shared] == cold[0]
    assert eng.cache.stats["swapped_in_blocks"] == swapped  # replicas only
    assert _affine(eng.pool) and _conserved(eng.pool)


def test_shard_occupancy_aware_placement():
    """A request is placed on the shard with the most effective free blocks
    (free less outstanding commitments), not in the first free slot."""
    eng = _engine(n_slots=4, block_size=4, mesh=MESH)
    eng.submit(Request([1] * 16, 31))       # 47 tokens: 12 blocks reserved
    eng._admit()
    assert eng.slots[0].state != "free"     # a tie breaks to shard 0
    eng.submit(Request([1] * 8, 4))
    eng._admit()
    assert eng.slots[2].state != "free" and eng.slots[1].state == "free"
    eng.run()
    assert _conserved(eng.pool)


def test_launch_serve_data_shards_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--reduced", "--scheme",
                             "bf16", "--data-shards", "2", "--shard-devices",
                             "cpu,cpu", "--prompt-len", "12", "--tokens", "3"])
    assert out["data_shards"] == 2 and out["requests"] == 4
    assert out["free_by_shard"] == [out["n_blocks"] // 2] * 2
    assert "2 data shards" in capsys.readouterr().out
