"""The port's radix prefix cache and its host tier against the reference.

  - a seeded random walk drives the reference `PrefixCache` (with its pool)
    and the port's through the same admissions (match, plan, pin, swap-in,
    adopt, COW), growth, retirements (insert, unpin, release) and
    evictions, with and without the host tier and under a host budget: the
    trees, match results, plans, stats, host bytes and pools agree after
    every operation;
  - under `scheme="bf16"` a hot stream (its prefix adopted, or copied on
    write at an in-block divergence) and a spill-hot stream (its prefix
    swapped back in from host memory) are BITWISE the cold stream, over
    gqa and mla and both pools, with the reference tests' skip counts
    (tests/test_serve.py, tests/test_prefix_tiers.py);
  - a follow-up turn whose prompt extends a finished stream is bitwise
    cold: the port caches only blocks whose every position the pool holds
    (the reference also caches the last sampled token, whose K/V was never
    written, so a full block ending on it would be adopted stale);
  - the port's engine with the prefix cache and host tier against the
    reference's on a shared-prompt workload under pool pressure: streams
    equal up to bf16 near-ties (tests/_torch_streams.py), engine and cache
    counts equal exactly;
  - `launch/serve.py --shared-prefix`.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_streams import (assert_equal_up_to_bf16_ties, run_jax_engine,
                            run_port)
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve.kv_pool import KVPool as JPool
from repro.serve.prefix_cache import PrefixCache as JCache
from repro_torch.configs import registry
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kv_pool import KVPool, token_leaves
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import LatencyPolicy

CACHE_COUNTS = ("lookups", "hits", "hit_tokens", "inserted_blocks",
                "evicted_blocks", "spilled_blocks", "swapped_in_blocks",
                "replicated_blocks")
ENGINE_COUNTS = ("ticks", "admitted", "finished", "prefill_tokens",
                 "prefill_steps", "decode_tokens", "decode_steps",
                 "prefill_skipped_tokens", "prefix_hits")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the tree against the reference's
# --------------------------------------------------------------------------

def _tree(cache):
    """(path, device blocks, has host, refs, hits) of every node, sorted."""
    out = []

    def walk(node, path):
        for key, c in node.children.items():
            p = path + key
            out.append((p, tuple(sorted(c.blocks.items())), c.host is not None,
                        c.host_bytes, c.refs, c.hits))
            walk(c, p)

    walk(cache.root, ())
    return sorted(out)


def _same_state(jc, pc, what):
    assert _tree(jc) == _tree(pc), what
    assert {k: jc.stats[k] for k in CACHE_COUNTS} == \
        {k: pc.stats[k] for k in CACHE_COUNTS}, what
    assert (jc.cached_blocks(), jc.host_nodes(), jc.host_bytes, jc.epoch,
            jc.inflight_swaps) == (pc.cached_blocks(), pc.host_nodes(),
                                   pc.host_bytes, pc.epoch,
                                   pc.inflight_swaps), what
    jp, pp = jc.pool, pc.pool
    assert np.array_equal(jp._table, pp._table), what
    assert np.array_equal(jp._ref, pp._ref), what
    assert jp._free == pp._free, what
    tables = pp.tables_device()
    if pp.n_shards > 1:
        tables = torch.cat(tables)
    assert np.array_equal(np.asarray(jp.tables_device()),
                          tables.numpy()), what


def _call(obj, name, *args):
    try:
        return getattr(obj, name)(*args)
    except RuntimeError as e:  # OutOfBlocks of either package
        return type(e).__name__


def _admit(cache, pool, slot, prompt, total):
    """The engine's admission of `prompt` into `slot`, step by step.
    Returns (what happened, the adopted nodes to unpin at retirement)."""
    m = cache.match(prompt)
    mtoks, adopt, tail = m.plan(len(prompt) - 1, pool.block_size)
    sh = pool.shard_of_slot(slot)
    what = [m.tokens, len(m.nodes), m.partial, mtoks, len(adopt),
            tail is not None, m.shard]
    if mtoks and not cache.spill and m.shard != sh:
        mtoks, adopt, tail = 0, [], None   # another shard's prefix: cold
    pinned = adopt + ([tail] if tail is not None else [])
    if mtoks:
        cache.acquire(pinned)
        if cache.spill:
            r = _call(cache, "materialize", pinned, sh)
            what.append(r)
            if isinstance(r, str):
                cache.release(pinned)
                mtoks, adopt, tail = 0, [], None
    pool.commit(slot, total)
    if mtoks:
        if adopt:
            pool.adopt_prefix(slot, [n.blocks[sh] for n in adopt],
                              len(adopt) * pool.block_size)
        if tail is not None:
            what.append(_call(pool, "cow_block", slot, tail.blocks[sh]))
            cache.release([tail])
        what.append(_call(pool, "ensure", slot, mtoks))
    cache.record(m if mtoks else None)
    return what, adopt


@pytest.mark.parametrize("mode", ["drop", "spill", "spill_budget",
                                  "sharded_drop", "sharded_replicate"])
def test_tree_random_walk_matches_reference(mode):
    """Admissions over a family of prompts sharing prefixes, growth,
    retirements and evictions drive both caches the same way; after every
    operation the trees, stats, host tier and pools agree. The sharded
    modes run a two-shard pool of 4 slots: without the host tier a prefix
    homed on another shard admits cold; with it (and `replicate_hits=2`,
    `replicate_hot` at every step) it materializes on the slot's shard and
    hot nodes are copied into the other shard, free blocks only."""
    spill = mode not in ("drop", "sharded_drop")
    sharded = mode.startswith("sharded")
    n_slots = 4 if sharded else 3
    jcfg = jregistry.get("llama_200m").reduced()
    cfg = registry.get("llama_200m").reduced()
    geo = dict(block_size=4, n_blocks=20 if sharded else 18)
    if sharded:
        geo["n_shards"] = 2
    jpool = JPool(jcfg, n_slots, 32, **geo)
    pool = KVPool(cfg, n_slots, 32, device="cpu", **geo)
    block_bytes = sum(t[:, 0].numel() * t.element_size()
                      for t in token_leaves(pool.shard_caches[0]))
    budget = 3 * block_bytes if mode == "spill_budget" else None
    hits = 2 if mode == "sharded_replicate" else None
    jc = JCache(jpool, spill=spill, host_budget_bytes=budget,
                replicate_hits=hits)
    pc = PrefixCache(pool, spill=spill, host_budget_bytes=budget,
                     replicate_hits=hits)
    rng = np.random.RandomState(1)
    bases = [rng.randint(0, 50, 24).tolist() for _ in range(3)]
    live: dict[int, tuple] = {}    # slot -> (stream, total, adopted nodes)
    done = {"admit": 0, "retire": 0, "evict": 0, "grow": 0}
    for step in range(400):
        op = ("admit", "grow", "retire", "evict")[
            rng.choice(4, p=[0.3, 0.3, 0.3, 0.1])]
        slot = int(rng.randint(n_slots))
        if op == "admit" and slot not in live:
            base = bases[rng.randint(3)]
            cut = int(rng.randint(4, 25))
            prompt = base[:cut] + rng.randint(0, 50, rng.randint(1, 6)).tolist()
            total = min(32, len(prompt) + int(rng.randint(1, 6)))
            stream = prompt + rng.randint(0, 50, 32).tolist()
            wj, nj = _admit(jc, jpool, slot, prompt, total)
            wp, np_ = _admit(pc, pool, slot, prompt, total)
            assert wj == wp, (step, wj, wp)
            live[slot] = (stream, total, (nj, np_))
        elif op == "grow" and slot in live:
            n = min(live[slot][1], pool.length(slot) + int(rng.randint(1, 6)))
            assert _call(jpool, "ensure", slot, n) == _call(pool, "ensure",
                                                            slot, n)
        elif op == "retire" and slot in live:
            stream, _, (nj, np_) = live.pop(slot)
            n = pool.length(slot)
            assert jc.insert(stream[:n], slot) == pc.insert(stream[:n], slot)
            jc.release(nj)
            pc.release(np_)
            jpool.release(slot)
            pool.release(slot)
        elif op == "evict":
            k = int(rng.randint(1, 3))
            sh = (None, int(rng.randint(pool.n_shards)))[rng.randint(2)]
            assert jc.evict(sh, k) == pc.evict(sh, k)
        else:
            continue
        done[op] += 1
        assert jc.replicate_hot() == pc.replicate_hot()
        jc.complete_swaps()
        pc.complete_swaps()
        _same_state(jc, pc, (step, op))
    assert min(done.values()) >= 30, done
    assert pc.stats["hits"] >= 10
    if spill:
        assert pc.stats["swapped_in_blocks"] >= 3 and pc.stats["spilled_blocks"]
    if hits:
        assert pc.stats["replicated_blocks"] >= 3
    if sharded:
        bps = pool.blocks_per_shard
        assert all(b // bps == pool.shard_of_slot(s)
                   for s in range(n_slots) for b in pool._owned[s])


def test_replication_never_evicts_and_reports_to_obs():
    """`replicate_hot` into a shard whose free list is empty copies nothing
    and evicts nothing (the reference's tests/test_prefix_tiers.py case);
    once the shard has room it copies the hot node's blocks, counted in
    the stats and by `obs.on_cache_replicate`, as the reference's cache
    does over the same pool."""
    from repro_torch.obs import Instrumentation, MetricsRegistry
    jcfg = jregistry.get("llama_200m").reduced()
    cfg = registry.get("llama_200m").reduced()
    jpool = JPool(jcfg, 4, 32, block_size=4, n_blocks=8, n_shards=2)
    pool = KVPool(cfg, 4, 32, block_size=4, n_blocks=8, n_shards=2,
                  device="cpu")
    jc = JCache(jpool, spill=True, replicate_hits=1)
    pc = PrefixCache(pool, spill=True, replicate_hits=1)
    pc.obs = Instrumentation(registry=MetricsRegistry())
    prompt = [1] * 8
    for c, p in ((jc, jpool), (pc, pool)):
        p.commit(0, 8)
        p.ensure(0, 8)
        c.insert(prompt, 0)
        p.release(0)
        c.record(c.match(prompt))
        p.commit(2, 16)                        # drains shard 1
        p.ensure(2, 16)
    assert pool.free_blocks_in_shard(1) == 0
    assert jc.replicate_hot(budget=8) == pc.replicate_hot(budget=8) == 0
    assert pc.stats["evicted_blocks"] == 0
    for c, p in ((jc, jpool), (pc, pool)):
        p.release(2)
    assert jc.replicate_hot(budget=8) == pc.replicate_hot(budget=8) == 2
    _same_state(jc, pc, "replicated")
    assert pc.obs.cache_replicated.get() == 2


def test_cache_excluded_on_a_windowed_pool():
    cfg = registry.get("llama_200m").reduced()
    pool = KVPool(cfg, 2, 32, block_size=4, device="cpu")
    assert PrefixCache.supported(pool)
    pool.window = 6              # as a pure sliding-window stack
    assert not PrefixCache.supported(pool)
    with pytest.raises(ValueError):
        PrefixCache(pool)


# --------------------------------------------------------------------------
# hot == cold, bitwise, under bf16
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = registry.get(arch).reduced()
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(arch, **kw):
    cfg, params = _params(arch)
    for k, v in dict(n_slots=2, max_len=64, block_size=4, prefill_chunk=8,
                     scheme="bf16", device="cpu").items():
        kw.setdefault(k, v)
    return ServeEngine(cfg, params, EngineConfig(**kw))


def _wave(eng, prompts, max_new=4):
    ids = [eng.submit(Request(list(p), max_new)) for p in prompts]
    res = {r.req_id: r.tokens for r in eng.run()}
    return [res[i] for i in ids]


ARCHS = [("llama_200m", False), ("llama_200m", True),
         ("deepseek_v3_671b", False), ("deepseek_v3_671b", True)]
ARCH_IDS = ["gqa", "gqa-nvfp4", "mla", "mla-nvfp4"]


@pytest.mark.parametrize("arch,kvq", ARCHS, ids=ARCH_IDS)
def test_hot_stream_skips_prefill_bitwise(arch, kvq):
    """A second request with the same 24-token prompt runs ONE prefill
    forward over ONE token (23 skipped; tests/test_serve.py) and its stream
    is bitwise the cold one."""
    cfg, _ = _params(arch)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, 24).tolist()
    cold_eng = _engine(arch, kv_quant=kvq)
    cold = _wave(cold_eng, [prompt]) + _wave(cold_eng, [prompt])
    hot_eng = _engine(arch, kv_quant=kvq, prefix_cache=True)
    assert _wave(hot_eng, [prompt]) == cold[:1]
    steps0 = hot_eng.stats["prefill_steps"]
    tokens0 = hot_eng.stats["prefill_tokens"]
    assert _wave(hot_eng, [prompt]) == cold[1:]
    assert hot_eng.stats["prefill_steps"] - steps0 == 1
    assert hot_eng.stats["prefill_tokens"] - tokens0 == 1
    assert hot_eng.stats["prefill_skipped_tokens"] == 23
    assert hot_eng.stats["prefix_hits"] == 1


@pytest.mark.parametrize("arch,kvq", ARCHS, ids=ARCH_IDS)
def test_cow_at_divergence_bitwise(arch, kvq):
    """A prompt diverging inside a cached block reuses the in-block common
    prefix by copy-on-write: prefill covers exactly the 14 unmatched
    tokens, and the stream is bitwise cold."""
    cfg, _ = _params(arch)
    rng = np.random.RandomState(3)
    base = rng.randint(0, cfg.vocab, 24).tolist()
    fork = base[:10] + rng.randint(0, cfg.vocab, 14).tolist()
    cold = _wave(_engine(arch, kv_quant=kvq), [fork])
    hot_eng = _engine(arch, kv_quant=kvq, prefix_cache=True)
    _wave(hot_eng, [base])
    t0 = hot_eng.stats["prefill_tokens"]
    assert _wave(hot_eng, [fork]) == cold
    assert hot_eng.stats["prefill_tokens"] - t0 == 14
    assert hot_eng.stats["prefill_skipped_tokens"] == 10


@pytest.mark.parametrize("arch,kvq", ARCHS, ids=ARCH_IDS)
def test_spill_hot_stream_bitwise_with_no_prefix_prefill(arch, kvq):
    """cold == device-hot == spill-hot (tests/test_prefix_tiers.py): the
    spilled blocks swap back in byte for byte (a PackedKV pool's as packed
    uint8), and the spill-hot request runs the device-hot run's prefill
    steps, none over the 16 matched tokens."""
    cfg, _ = _params(arch)
    rng = np.random.RandomState(4)
    shared = rng.randint(0, cfg.vocab, 16).tolist()
    warm = shared + rng.randint(0, cfg.vocab, 5).tolist()
    probe = shared + rng.randint(0, cfg.vocab, 7).tolist()
    kw = dict(kv_quant=kvq, block_size=8)
    cold = _wave(_engine(arch, **kw), [probe])

    def hot(spill):
        eng = _engine(arch, prefix_cache=True, prefix_spill=spill, **kw)
        _wave(eng, [warm])
        if spill:
            assert eng.cache.evict(None, 999) >= 2
            assert eng.cache.cached_blocks() == 0 and eng.cache.host_nodes() >= 2
            node = next(iter(eng.cache.root.children.values()))
            assert all(t.dtype == (torch.uint8 if kvq else torch.bfloat16)
                       for t in token_leaves(node.host.stages))
        s0, t0 = eng.stats["prefill_steps"], eng.stats["prefill_tokens"]
        out = _wave(eng, [probe])
        return (out, eng.stats["prefill_steps"] - s0,
                eng.stats["prefill_tokens"] - t0, eng)

    dev_hot, dev_steps, dev_toks, _ = hot(False)
    spill_hot, sp_steps, sp_toks, eng = hot(True)
    assert dev_hot == cold and spill_hot == cold
    assert (sp_steps, sp_toks) == (dev_steps, dev_toks)
    assert sp_toks == len(probe) - 16
    assert eng.cache.stats["swapped_in_blocks"] == 2
    live = int((eng.pool._ref > 0).sum())
    assert eng.pool.free_block_count + live == eng.pool.n_blocks


def test_follow_up_turn_extending_a_stream_is_bitwise_cold():
    """A multi-turn follow-up whose prompt is the last request's prompt,
    its 3 generated tokens and a new turn: the finished stream is 16 tokens
    (4 full blocks), of which the pool holds 15 (the last sampled token is
    never fed), so 3 blocks are cached and the follow-up's stream is
    bitwise cold."""
    cfg, _ = _params("llama_200m")
    rng = np.random.RandomState(6)
    first = rng.randint(0, cfg.vocab, 13).tolist()
    eng = _engine("llama_200m", prefix_cache=True)
    (gen,) = _wave(eng, [first], max_new=3)
    assert eng.cache.stats["inserted_blocks"] == 3
    follow = first + gen + rng.randint(0, cfg.vocab, 5).tolist()
    cold = _wave(_engine("llama_200m"), [follow])
    assert _wave(eng, [follow]) == cold
    assert eng.stats["prefill_skipped_tokens"] == 12


def test_engine_config_validation():
    cfg, params = _params("llama_200m")
    with pytest.raises(ValueError):
        ServeEngine(cfg, params, EngineConfig(device="cpu", prefix_spill=True))
    eng = ServeEngine(cfg, params, EngineConfig(
        device="cpu", prefix_cache=True, prefix_spill=True,
        scheduler=LatencyPolicy()))
    assert eng.cache is not None and eng.cache.spill
    assert isinstance(eng.sched, LatencyPolicy)
    # replication is ported; with one shard it has no peer to copy into
    eng = ServeEngine(cfg, params, EngineConfig(
        device="cpu", prefix_cache=True, prefix_spill=True, replicate_hits=2))
    assert eng.cache.replicate_hits == 2 and eng.cache.replicate_hot() == 0


# --------------------------------------------------------------------------
# the engine against the reference's
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_weights():
    jcfg = jregistry.get("llama_200m").reduced()
    return jcfg, jlm.init(jcfg, jax.random.PRNGKey(0))


def _shared_prompts(vocab):
    """Two system prompts, eight requests over them with their own tails.
    Every prompt + max_new is off a block boundary, where the two engines
    cache the same blocks (the reference also caches a full block that ends
    on the never-fed last token; see the module docstring)."""
    rng = np.random.RandomState(7)
    systems = [rng.randint(0, vocab, n).tolist() for n in (12, 9)]
    tails = (5, 2, 7, 3, 9, 4, 3, 7)
    return [systems[i % 2] + rng.randint(0, vocab, t).tolist()
            for i, t in enumerate(tails)]


@pytest.mark.parametrize("spill", [False, True], ids=["drop", "spill"])
def test_engine_matches_reference_engine(spill):
    """The port's engine with the prefix cache against the reference's,
    same weights, a 14-block pool under pressure: bf16 greedy streams equal
    up to reference near-ties, engine and cache counts equal exactly."""
    jcfg, jparams = _jax_weights()
    cfg = registry.get("llama_200m").reduced()
    prompts = _shared_prompts(cfg.vocab)
    max_new = 6
    assert all((len(p) + max_new) % 4 for p in prompts)
    kw = dict(n_slots=2, max_len=32, block_size=4, n_blocks=14,
              prefill_chunk=8, scheme="bf16", prefix_cache=True,
              prefix_spill=spill)
    want, margins, jeng = run_jax_engine(jcfg, jparams, prompts, max_new, **kw)
    got, eng = run_port(cfg, jparams, prompts, max_new, **kw)
    assert_equal_up_to_bf16_ties(got, want, margins, len(prompts), max_new)
    assert {k: eng.stats[k] for k in ENGINE_COUNTS} == \
        {k: jeng.stats[k] for k in ENGINE_COUNTS}
    assert {k: eng.cache.stats[k] for k in CACHE_COUNTS} == \
        {k: jeng.cache.stats[k] for k in CACHE_COUNTS}
    assert eng.cache.stats["hits"] >= 4 and eng.cache.stats["evicted_blocks"]
    if spill:
        assert eng.cache.stats["swapped_in_blocks"]
        assert eng.cache.host_bytes == jeng.cache.host_bytes


def test_launch_serve_shared_prefix_on_cpu(capsys):
    out = launch_serve.main(["--arch", "llama_200m", "--device", "cpu",
                             "--reduced", "--shared-prefix", "3",
                             "--prompt-len", "20", "--tokens", "4"])
    assert out["requests"] == 3 and out["device"] == "cpu"
    assert out["prefill_skipped_tokens"] == 3 * 16   # 20 tokens, blocks of 16
    assert out["prefix_hits"] == 3 and out["hit_rate"] == 1.0
    text = capsys.readouterr().out
    assert "[cpu]" in text and "skipped" in text and "hit rate" in text
