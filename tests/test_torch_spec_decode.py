"""The port's self-speculative decoding against the JAX reference, and the
engine's `cancel` and `token_hook`.

Same weights (JAX init, converted with `repro_torch.convert`), reduced
llama-200m and deepseek-v3 (capacity_factor 8.0, so no MoE row is dropped
and bf16 rows stay independent of the step shape). Tolerances:
  - `prefix_specs` / `prefix_stage_params`: equal to the reference's (the
    stage parameters bitwise), the same ValueError outside 0 < n < total;
  - `forward_prefix` in decode mode over a prefix-shaped pool (chunk,
    decode and verify-shaped steps, an inactive row) against the
    reference's jitted draft step under bf16: every logit within
    BF16_ROW_ULPS = 2 bf16 ulps of its row's largest logit (measured 2.0:
    XLA's reciprocal multiplies and f32 sums in another order; the
    engine-stream tests' premise);
  - `forward_prefix` in train mode (llama) against the reference's run
    EAGERLY under quartet2: bit-identical or within Q2_REL_RMS = 1e-5
    relative RMS, as the whole-step tests are (under jax.jit XLA turns a
    division by a constant into a multiplication by its reciprocal, which
    moves absmaxes);
  - `forward_prefix` at n layers against `forward` of the config cut to n
    layers with the same weights: bitwise (the same layers, ids and seeds);
  - `speculative_resample` in law (the port draws from a torch.Generator,
    the reference from threefry): the total-variation distance of 20,000
    seeded draws to the analytic target below 0.02 (first emission) and
    0.03 (second, given the first draft accepted), the bounds of
    tests/test_spec_decode.py;
  - engine streams under bf16, greedy: the port's spec stream against its
    own non-spec stream and against the reference's spec engine, each row
    equal up to its first reference near-tie of 2 bf16 ulps with at least
    half the tokens compared (`tests/_torch_streams.py`; margins from the
    reference's non-spec run, which its spec run equals bitwise);
  - quartet2 spec streams: two runs bitwise equal, and prequant against
    per-step quantization bitwise (the per-tensor absmax couples the verify
    chunk's rows, so they are not held against the non-spec stream);
  - exact: every block of both pools free at the end, the admission margin,
    config validation, the draft's catch-up over a prefix-cache hit,
    `cancel` and the token hook's order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_streams import assert_equal_up_to_bf16_ties, run_jax, run_port
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve import kv_pool as jkv
from repro.serve import sampling as jsampling
from repro_torch.configs import registry
from repro_torch.convert import _convert, params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve import prequant
from repro_torch.serve import sampling
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kv_pool import KVPool, token_leaves

ARCHS = ("llama_200m", "deepseek_v3_671b")
SEED = np.array([7, 7], np.uint32)
BF16_ROW_ULPS = 2
Q2_REL_RMS = 1e-5
PROMPT_LENS = (19, 5, 11, 8, 3)
MAX_NEW = 8
KW = dict(n_slots=2, max_len=48, prefill_chunk=8)
SPEC = dict(spec_k=3, draft_layers=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = _no_drop(jregistry.get(arch).reduced())
    return jcfg, jlm.init(jcfg, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port(arch):
    jcfg, jparams = _weights(arch)
    cfg = _no_drop(registry.get(arch).reduced())
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _serve(cfg, params, prompts, max_new, sampling_params=None, **kw):
    """{req_id: tokens} of one port engine run, and the engine; every block
    of both pools is free at the end (or held by the prefix cache)."""
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", **{**KW, **kw}))
    for j, p in enumerate(prompts):
        sp = sampling_params[j] if sampling_params else sampling.SamplingParams()
        eng.submit(Request(p, max_new, sp))
    res = {r.req_id: r.tokens for r in eng.run()}
    held = eng.cache.cached_blocks() if eng.cache is not None else 0
    assert eng.pool.free_block_count + held == eng.pool.n_blocks
    if eng.draft is not None:
        assert eng.draft.pool.free_block_count == eng.draft.pool.n_blocks
    return res, eng


# --------------------------------------------------------------------------
# the draft stack: prefix plans, parameters, forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_specs_and_stage_params_match_reference(arch):
    jcfg, jparams = _weights(arch)
    cfg, params = _port(arch)
    total = lm.total_layers(cfg)
    assert total == jlm.total_layers(jcfg) == cfg.n_layers
    for n in range(1, total):
        assert lm.prefix_specs(cfg, n) == jlm.prefix_specs(jcfg, n)
        want = _convert(jax.tree.map(np.asarray, jlm.prefix_stage_params(
            jparams, jcfg, n)), "cpu")
        got = lm.prefix_stage_params(params, cfg, n)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        strict=True):
            assert a.shape == b.shape and torch.equal(a, b)
    for n in (0, total, total + 1):
        with pytest.raises(ValueError):
            lm.prefix_specs(cfg, n)
        with pytest.raises(ValueError):
            jlm.prefix_specs(jcfg, n)


def _prefix_schedule(vocab):
    """(tokens, pos, active) steps for 2 slots: both rows prefill an 8-token
    chunk, then a decode step with row 1 inactive (token 0 at position 0),
    then a 4-token verify-shaped chunk of both rows."""
    rng = np.random.RandomState(2)
    return [
        (rng.randint(0, vocab, (2, 8)), np.array([0, 0]), np.array([True, True])),
        (np.array([[rng.randint(vocab)], [0]]), np.array([8, 0]),
         np.array([True, False])),
        (rng.randint(0, vocab, (2, 4)), np.array([9, 8]), np.array([True, True])),
    ]


def _row_ulp(logits):
    """One bf16 ulp of each row's largest |logit| (B, S, 1)."""
    top = np.abs(logits).max(axis=-1, keepdims=True)
    return 2.0 ** (np.floor(np.log2(np.maximum(top, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefix_decode_matches_jax(arch):
    jcfg, jparams = _weights(arch)
    cfg, params = _port(arch)
    jpool = jkv.KVPool(jcfg, 2, 32, paged=True, block_size=4,
                       specs=jlm.prefix_specs(jcfg, 1))
    tpool = KVPool(cfg, 2, 32, block_size=4, device="cpu",
                   specs=lm.prefix_specs(cfg, 1))
    for pool in (jpool, tpool):
        for s in (0, 1):
            pool.commit(s, 16)
            pool.ensure(s, 16)

    @jax.jit
    def jstep(caches, tokens, table, pos, active):
        logits, caches, _ = jlm.forward_prefix(
            jparams, jcfg, {"tokens": tokens}, "bf16", jnp.asarray(SEED),
            n_prefix=1, caches=caches, mode="decode", pos=pos,
            active=active, block_table=table)
        return logits, caches

    caches = jpool.caches
    for toks, pos, act in _prefix_schedule(cfg.vocab):
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        jl, caches = jstep(caches, jnp.asarray(toks), jpool.table_device(),
                           jnp.asarray(pos), jnp.asarray(act))
        tl, _ = lm.forward_prefix(
            params, cfg, {"tokens": torch.from_numpy(toks)}, "bf16", SEED,
            n_prefix=1, caches=tpool.caches, mode="decode",
            pos=torch.from_numpy(pos), active=torch.from_numpy(act),
            block_table=tpool.tables_device())
        jl, tl = np.asarray(jl.astype(jnp.float32)), tl.float().numpy()
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        d = np.abs(tl - jl)[act]
        assert (d <= BF16_ROW_ULPS * _row_ulp(jl)[act]).all(), d.max()


def test_forward_prefix_train_mode_matches_eager_jax_quartet2():
    jcfg, jparams = _weights("llama_200m")
    cfg, params = _port("llama_200m")
    toks = np.random.RandomState(4).randint(0, cfg.vocab, (2, 12))
    with jax.disable_jit():
        jl, _, _ = jlm.forward_prefix(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks)},
                                      "quartet2", jnp.asarray(SEED),
                                      n_prefix=1, mode="train")
    tl, _ = lm.forward_prefix(params, cfg, {"tokens": torch.from_numpy(toks)},
                              "quartet2", SEED, n_prefix=1, mode="train")
    jl, tl = np.asarray(jl.astype(jnp.float32)), tl.float().numpy()
    assert tl.shape == jl.shape
    assert np.sqrt(((tl - jl) ** 2).mean() / (jl ** 2).mean()) <= Q2_REL_RMS


@pytest.mark.parametrize("sq", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefix_equals_the_cut_model(arch, sq):
    """The first layer of the 2-layer model through `forward_prefix` equals
    `forward` of the config cut to one layer over the same (sliced)
    parameters, bit for bit, under quartet2 with packed weights."""
    cfg, params = _port(arch)
    params = prequant.prequantize(params, cfg, "quartet2")
    cut = dataclasses.replace(cfg, n_layers=1)
    cut_params = {**params,
                  "stages": lm.prefix_stage_params(params, cfg, 1)}
    toks = torch.from_numpy(np.random.RandomState(sq).randint(
        0, cfg.vocab, (2, sq)))
    pos = torch.tensor([3, 0], dtype=torch.int32)
    act = torch.tensor([True, False])
    outs = []
    for run_cfg, fwd in ((cfg, "prefix"), (cut, "forward")):
        pool = KVPool(run_cfg, 2, 16, block_size=4, device="cpu",
                      specs=lm.prefix_specs(cfg, 1))
        pool.commit(0, 16)
        pool.ensure(0, 3 + sq)
        kw = dict(caches=pool.caches, mode="decode", pos=pos, active=act,
                  block_table=pool.tables_device())
        if fwd == "prefix":
            logits, _ = lm.forward_prefix(params, cfg, {"tokens": toks},
                                          "quartet2", SEED, n_prefix=1, **kw)
        else:
            logits, _ = lm.forward(cut_params, cut, {"tokens": toks},
                                   "quartet2", SEED, **kw)
        # the readable blocks (the scratch block takes dropped writes)
        outs.append((logits, [t[:, :-1] for t in token_leaves(pool.caches)]))
    (a, ca), (b, cb) = outs
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb, strict=True))


# --------------------------------------------------------------------------
# acceptance and the speculative sampler
# --------------------------------------------------------------------------

def test_greedy_acceptance_semantics():
    for fn in (sampling.accept_greedy, jsampling.accept_greedy):
        assert fn([5, 6, 7], [5, 6, 7, 9]) == 3
        assert fn([5, 6, 7], [5, 8, 7, 9]) == 1
        assert fn([5, 6, 7], [4, 6, 7, 9]) == 0
        assert fn([], [4]) == 0
    logits = np.random.RandomState(0).randn(2, 4, 16).astype(np.float32)
    logits[0, 1, 3] = logits[0, 1, 5] = 9.0         # a tie: the first index
    t = torch.from_numpy(logits).bfloat16()
    want = np.asarray(jsampling.greedy_targets(
        jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)))
    got = sampling.greedy_targets(t)
    assert got.shape == (2, 4) and np.array_equal(got.numpy(), want)
    assert int(got[0, 1]) == 3
    # sampling_probs: the reference's law, per-row or scalar parameters
    q = sampling.sampling_probs(torch.from_numpy(logits[0]), 0.7, 3)
    jq = np.asarray(jsampling.sampling_probs(jnp.asarray(logits[0]), 0.7, 3))
    np.testing.assert_allclose(q.numpy(), jq, rtol=1e-5, atol=1e-7)
    assert ((q > 0).sum(dim=-1) == 3).all()


def _tv(emp, q):
    return 0.5 * np.abs(emp - q).sum()


def test_resample_point_mass_draft_keeps_target_law():
    """A deterministic draft: the first emission's marginal is q_0, and
    given draft 0 accepted the second emission follows q_1."""
    v, draws, temp = 8, 20_000, 0.8
    rng = np.random.RandomState(0)
    tl = torch.from_numpy((rng.randn(3, v) * 2).astype(np.float32))
    q = sampling.sampling_probs(tl, temp, 0).numpy()
    np.testing.assert_allclose(
        q, np.asarray(jsampling.sampling_probs(jnp.asarray(tl.numpy()), temp,
                                               0)), rtol=1e-5, atol=1e-7)
    draft = torch.tensor([3, 5])
    gen = torch.Generator().manual_seed(1)
    first, second = np.zeros(v), np.zeros(v)
    counts = np.zeros(3, int)
    for _ in range(draws):
        toks, cnt = sampling.speculative_resample(draft, None, tl, gen,
                                                  temperature=temp)
        counts[cnt - 1] += 1
        first[int(toks[0])] += 1
        if cnt >= 2 and int(toks[0]) == 3:
            second[int(toks[1])] += 1
    assert _tv(first / draws, q[0]) < 0.02
    assert _tv(second / second.sum(), q[1]) < 0.03
    assert counts.min() > 0     # every count of accepted drafts occurs


def test_resample_general_draft_keeps_target_law():
    """A sampled draft (d ~ p, accept with min(1, q/p), residual max(q - p,
    0)) still emits exactly q, under a top-k filter."""
    v, draws, temp, topk = 8, 20_000, 1.2, 5
    rng = np.random.RandomState(2)
    tl = torch.from_numpy(rng.randn(2, v).astype(np.float32))
    dl = torch.from_numpy(rng.randn(1, v).astype(np.float32))
    q = sampling.sampling_probs(tl, temp, topk).numpy()
    p = sampling.sampling_probs(dl, temp, topk)
    gen = torch.Generator().manual_seed(3)
    emp = np.zeros(v)
    for _ in range(draws):
        d = torch.multinomial(p[0], 1, generator=gen)
        toks, _ = sampling.speculative_resample(d, dl, tl, gen,
                                                temperature=temp, top_k=topk)
        emp[int(toks[0])] += 1
    assert _tv(emp / draws, q[0]) < 0.02


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_spec_streams_match_nonspec_and_jax(arch):
    jcfg, jparams = _weights(arch)
    cfg, _ = _port(arch)
    prompts = _prompts(cfg.vocab)
    base, margins = run_jax(jcfg, jparams, prompts, MAX_NEW, scheme="bf16",
                            **KW)
    jspec, _ = run_jax(jcfg, jparams, prompts, MAX_NEW, scheme="bf16",
                       **SPEC, **KW)
    assert jspec == base  # the reference's own claim, so its margins hold
    nonspec, _ = run_port(cfg, jparams, prompts, MAX_NEW, scheme="bf16", **KW)
    spec, eng = run_port(cfg, jparams, prompts, MAX_NEW, scheme="bf16",
                         **SPEC, **KW)
    n = len(prompts)
    assert_equal_up_to_bf16_ties(spec, nonspec, margins, n, MAX_NEW)
    assert_equal_up_to_bf16_ties(spec, jspec, margins, n, MAX_NEW)
    st = eng.stats
    assert st["spec_rounds"] > 0 and st["draft_tokens"] > 0
    assert 0 <= st["accepted_tokens"] <= st["draft_tokens"]
    assert eng.draft.pool.free_block_count == eng.draft.pool.n_blocks


def test_quartet2_spec_streams_bitwise_repeatable():
    cfg, params = _port("llama_200m")
    prompts = _prompts(cfg.vocab, (9, 13))
    a, _ = _serve(cfg, params, prompts, 6, scheme="quartet2", **SPEC)
    b, _ = _serve(cfg, params, prompts, 6, scheme="quartet2", **SPEC)
    c, _ = _serve(cfg, params, prompts, 6, scheme="quartet2",
                  prequant=False, **SPEC)
    assert a == b == c


def test_continuous_batching_reclaims_both_pools():
    """More requests than slots: retirement releases both pools and every
    stream equals the non-speculative engine's (bf16, CPU: bitwise)."""
    cfg, params = _port("llama_200m")
    prompts = _prompts(cfg.vocab, (9, 13, 7, 11, 5))
    base, _ = _serve(cfg, params, prompts, 4, scheme="bf16")
    spec, eng = _serve(cfg, params, prompts, 4, scheme="bf16", **SPEC)
    assert spec == base
    assert eng.stats["finished"] == 5 and not eng.has_work()


def test_admission_margin():
    """A verify chunk writes up to spec_k positions past the final token:
    9 + 20 + 3 == 32 == max_len is served (and matches non-spec), 9 + 23
    fits only without the margin and is rejected at submit."""
    cfg, params = _port("llama_200m")
    prompts = _prompts(cfg.vocab, (9,))
    kw = dict(n_slots=1, max_len=32, scheme="bf16")
    base, _ = _serve(cfg, params, prompts, 20, **kw)
    spec, _ = _serve(cfg, params, prompts, 20, **kw, **SPEC)
    assert spec == base
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", **{**KW, **kw},
                                                **SPEC))
    with pytest.raises(ValueError):   # Unservable, as the reference's
        eng.submit(Request(prompts[0], 23))


@pytest.mark.parametrize("option", [
    dict(spec_k=2, draft_layers=0), dict(spec_k=2, draft_layers=2),
    dict(spec_k=2, draft_layers=5), dict(spec_k=2, draft_layers=1,
                                         kv_quant=True)],
    ids=["no_draft", "draft_is_whole_model", "draft_too_deep", "kv_quant"])
def test_spec_config_validation(option):
    cfg, params = _port("llama_200m")
    with pytest.raises(ValueError):
        ServeEngine(cfg, params, EngineConfig(device="cpu", **option))


def test_draft_catches_up_after_a_prefix_hit():
    """A prefix-cache hit skips 16 prompt tokens of the full model; the
    draft pool, which never aliases, catches up over them in two 8-token
    chunks before the prompt's rest, and the hot stream equals the cold one
    (bf16, block-aligned match: bitwise)."""
    cfg, params = _port("llama_200m")
    system = _prompts(cfg.vocab, (16,), seed=5)[0]
    tails = _prompts(cfg.vocab, (5, 7), seed=6)
    prompts = [system + t for t in tails]
    kw = dict(scheme="bf16", block_size=4, **SPEC)
    cold, _ = _serve(cfg, params, prompts, 6, **kw)
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", prefix_cache=True,
                                                **{**KW, **kw}))
    eng.submit(Request(list(system) + [1], 1))   # primes 16 cached tokens
    eng.run()
    ids = [eng.submit(Request(p, 6)) for p in prompts]
    res = {r.req_id: r.tokens for r in eng.run()}
    st = eng.stats
    assert st["prefill_skipped_tokens"] == 32 and st["prefix_hits"] == 2
    assert (st["draft_catchup_tokens"], st["draft_catchup_steps"]) == (32, 4)
    assert [res[i] for i in ids] == [cold[0], cold[1]]
    assert eng.draft.pool.free_block_count == eng.draft.pool.n_blocks


def test_cancel_queued_in_flight_and_unknown():
    cfg, params = _port("llama_200m")
    prompts = _prompts(cfg.vocab, (12, 9, 10))
    eng = ServeEngine(cfg, params, EngineConfig(
        device="cpu", scheme="bf16", prefix_cache=True, block_size=4,
        **{**KW, **SPEC}))
    ids = [eng.submit(Request(p, 8)) for p in prompts]
    assert eng.cancel(ids[2])                      # queued: leaves the queue
    while len(eng.slots[0].generated) < 3:
        eng.step()
    assert eng.pool.length(0) >= len(prompts[0])
    assert eng.cancel(ids[0])                      # in flight, in decode
    assert not eng.cancel(ids[0]) and not eng.cancel(99)
    assert eng.stats["cancelled"] == 2
    assert eng.slots[0].req is None
    results = eng.run()
    assert [r.req_id for r in results] == [ids[1]]
    # both pools freed; the cancelled stream's fed tokens stay cached
    cached = eng.cache.cached_blocks()
    assert eng.pool.free_block_count + cached == eng.pool.n_blocks
    assert eng.draft.pool.free_block_count == eng.draft.pool.n_blocks
    # a resubmission of the cancelled prompt hits the cache
    before = eng.stats["prefill_skipped_tokens"]
    eng.submit(Request(prompts[0], 2))
    eng.run()
    # all but the last prompt token, whose logits give the first token
    assert eng.stats["prefill_skipped_tokens"] - before == len(prompts[0]) - 1


@pytest.mark.parametrize("spec", [False, True], ids=["nonspec", "spec"])
def test_token_hook_delivers_each_token_once_result_last(spec):
    cfg, params = _port("llama_200m")
    prompts = _prompts(cfg.vocab, (9, 13, 6))
    calls = []
    eng = ServeEngine(cfg, params, EngineConfig(
        device="cpu", scheme="bf16",
        token_hook=lambda req, new, res: calls.append((req.req_id, new, res)),
        **{**KW, **(SPEC if spec else {})}))
    for p in prompts:
        eng.submit(Request(p, 6))
    results = {r.req_id: r for r in eng.run()}
    for rid, r in results.items():
        mine = [(new, res) for i, new, res in calls if i == rid]
        assert [t for new, _ in mine for t in new] == r.tokens
        assert all(res is None for _, res in mine[:-1])
        assert mine[-1][1] is r and all(new for new, _ in mine[:-1])
    # reassigning the hook post-construction takes effect
    late = []
    eng.token_hook = lambda req, new, res: late.append(new)
    eng.submit(Request(prompts[0], 3))
    eng.run()
    assert sum(len(n) for n in late) == 3


def test_stochastic_spec_requests_reproduce_and_spare_greedy_rows():
    """Sampled requests speculate through the rejection sampler: full
    streams, reproducible for a fixed base_seed, and a greedy neighbour's
    stream bitwise the all-greedy engine's (bf16 rows are independent)."""
    cfg, params = _port("llama_200m")
    prompts = _prompts(cfg.vocab, (9, 13))
    greedy, _ = _serve(cfg, params, prompts, 6, scheme="bf16", **SPEC)
    sp = [sampling.SamplingParams(), sampling.SamplingParams(0.9, 4)]
    a, _ = _serve(cfg, params, prompts, 6, sp, scheme="bf16", base_seed=3,
                  **SPEC)
    b, _ = _serve(cfg, params, prompts, 6, sp, scheme="bf16", base_seed=3,
                  **SPEC)
    assert a == b and len(a[1]) == 6
    assert a[0] == greedy[0]


def test_launch_serve_speculative_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--tokens", "5",
                             "--spec-k", "3", "--draft-layers", "1"])
    assert out["requests"] == 2 and out["free_blocks"] == out["n_blocks"]
    assert 0 <= out["acceptance_rate"] <= 1
    assert 1 <= out["tokens_per_round"] <= 4
    assert "tokens a slot a round" in capsys.readouterr().out
