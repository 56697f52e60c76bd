"""The port's fixed-batch generation path against the JAX reference:
`chunked_sdpa`, `lm.forward(mode="prefill")` into dense caches, the dense
branches of `gqa_decode` / `mla_decode`, `KVPool(paged=False)`,
`greedy_generate`, and the engine over dense caches. The checks that take
an arch run here on llama-200m and in tests/test_torch_generate_mla.py on
deepseek-v3 (two files, so the two eager-JAX halves run on two workers).

Same weights (JAX init, converted with `repro_torch.convert`), same numpy
inputs. Tolerances, each where it is used:
  - `chunked_sdpa` with Q_BLOCK = KV_BLOCK = 16 patched into both packages,
    64 tokens: the reference's within CHUNK_ATOL (the same block
    arithmetic; f32 sums in another order); the port's own `sdpa` within
    PLAIN_ATOL, the reference's bar (tests/test_archs.py);
  - prefill against the reference run EAGERLY (under `jax.jit` XLA turns a
    division by a constant into a multiplication by its reciprocal):
    bf16 logits and caches within one bf16 ulp of the tensor's largest
    value, quartet2 within Q2_REL_RMS relative RMS; deepseek-v3 on the
    tokens no MoE router near-tie reaches (`_clean_tokens`);
  - prefill + decode against a full forward over the same tokens: within
    5% of max|logit|, the reference's bar (tests/test_archs.py);
  - one dense decode layer (active mask, negative positions): caches and
    outputs within one bf16 ulp of the tensor's largest value (RoPE's
    cos/sin come from another libm);
  - `greedy_generate` against the reference's, eager: llama bf16 ragged
    streams equal; quartet2 and deepseek-v3 equal up to the first step at
    which some row of the reference has a top-2 logit margin under
    EAGER_LOGIT_TOL (`assert_equal_up_to_narrow_margin`). Against EAGER
    JAX the prefill logits agree within Q2_REL_RMS (quartet2) or an ulp
    (bf16), two orders below this margin; the jitted engine's 0.25
    (tests/test_torch_engine.py) covers XLA's reciprocal gap, which eager
    runs do not have, and would claim nothing on this model (its margins
    are 0.02-0.09). Under bf16 a ragged batch's rows equal each row
    generated alone;
  - engines under bf16: dense streams bitwise the paged pool's (both end in
    `decode_sdpa` over max_len keys), with and without speculation, and
    `prefix_cache=True` on a dense pool runs without a cache, bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_streams import assert_equal_up_to_narrow_margin
from test_torch_kv_pool import _both
from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.serve import decode as jdecode
from repro.serve import kv_pool as jkv
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.models import mla
from repro_torch.serve import decode
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kv_pool import KVPool, OutOfBlocks, SlotError

CHUNK_ATOL = 1e-5
PLAIN_ATOL = 2e-3
Q2_REL_RMS = 1e-5
ROUTER_TIE = 1e-6            # tests/test_torch_moe.py's near-tie of scores
FULL_FORWARD_FRACTION = 0.05
EAGER_LOGIT_TOL = 1e-3
SEED = np.array([7, 7], np.uint32)
SCHEMES = ("bf16", "quartet2")
SPEC = ({}, dict(spec_k=3, draft_layers=1))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _no_drop(cfg):
    """MoE capacity 8: capacity depends on B*S, so comparisons across batch
    shapes hold only where no token is dropped (the reference's rule)."""
    if not cfg.moe:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(reference cfg, port cfg, reference params, port params): the port's
    seeded init (the reference's layout) handed to both packages."""
    jcfg = _no_drop(jregistry.get(arch).reduced())
    cfg = _no_drop(registry.get(arch).reduced())
    tree = _numpy_tree(lm.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, "cpu"))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of the tensor's largest |want|: one ulp
    of difference upstream (the port's f32 sums run in another order) moves
    a value near zero by many of its own ulps, but by less than one ulp of
    the tensor's scale."""
    top = max(float(np.abs(want).max()), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got - want).max() <= ulp, float(np.abs(got - want).max())


def _rel_rms(got, want):
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def _agree(scheme, got, want):
    """bf16: within one ulp; quartet2: within Q2_REL_RMS relative RMS."""
    if scheme == "bf16":
        _within_bf16_ulp(got, want)
    elif want.size:
        assert _rel_rms(got, want) <= Q2_REL_RMS


# ---- chunked_sdpa and the attend dispatch ----

def _qkv(rng, b=2, s=64, h=4, kv=2, hd=16):
    return [rng.randn(b, s, n, hd).astype(np.float32) for n in (h, kv, kv)]


@pytest.mark.parametrize("window", [None, 24])
def test_chunked_sdpa_matches_reference(window, monkeypatch):
    for mod in (jattn, A):
        monkeypatch.setattr(mod, "Q_BLOCK", 16)
        monkeypatch.setattr(mod, "KV_BLOCK", 16)
    q, k, v = _qkv(np.random.RandomState(0))
    want = np.asarray(jattn.chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = A.chunked_sdpa(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CHUNK_ATOL)
    plain = A.sdpa(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=PLAIN_ATOL)


def test_attend_takes_chunked_sdpa_above_the_threshold(monkeypatch):
    """Above CHUNK_THRESHOLD `attend` is `chunked_sdpa`, also through
    autograd (train mode): its gradients within PLAIN_ATOL of plain sdpa's."""
    monkeypatch.setattr(A, "CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(A, "Q_BLOCK", 16)
    monkeypatch.setattr(A, "KV_BLOCK", 16)
    calls = []
    chunked = A.chunked_sdpa
    monkeypatch.setattr(A, "chunked_sdpa",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or chunked(*a, **kw))
    rng = np.random.RandomState(1)
    short = [torch.from_numpy(a) for a in _qkv(rng, s=32)]
    assert torch.equal(A.attend(*short), A.sdpa(*short)) and not calls
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(rng))
    out = A.attend(q, k, v)
    assert calls == [64]
    assert torch.equal(out, chunked(q, k, v))
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(A.sdpa(q, k, v), (q, k, v), g)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PLAIN_ATOL)


# ---- greedy_generate and its prefill against the eager reference ----

RAGGED = (9, 4, 12)
MAX_NEW = 5


def _ragged(vocab):
    rng = np.random.RandomState(6)
    toks = np.zeros((len(RAGGED), max(RAGGED)), np.int32)
    for i, n in enumerate(RAGGED):
        toks[i, :n] = rng.randint(0, vocab, n)
    return toks, np.asarray(RAGGED, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, scheme, max_new=MAX_NEW):
    """The reference's greedy_generate over `_ragged`, run eagerly, with its
    prefill step's logits and filled caches and its top-2 margins
    {(row, token index): (step, margin, top)} recorded at every step."""
    jcfg, cfg, jparams, _ = _weights(arch)
    toks, lens = _ragged(cfg.vocab)
    margins, calls, prefilled = {}, [0], []

    def record(rows_logits):
        lf = np.asarray(rows_logits.astype(jnp.float32))
        for i, row in enumerate(lf):
            top2 = np.sort(row)[-2:]
            margins[(i, calls[0])] = (calls[0], float(top2[1] - top2[0]),
                                      float(top2[1]))
        calls[0] += 1

    make_prefill, make_step = jdecode.make_prefill_step, jdecode.make_serve_step

    def prefill_step(c, sch):
        fn = make_prefill(c, sch)

        def run(params, cache, batch):
            logits, cache = fn(params, cache, batch)
            prefilled.append((logits, cache))
            record(logits[jnp.arange(len(lens)), jnp.asarray(lens) - 1])
            return logits, cache
        return run

    def serve_step(c, sch):
        fn = make_step(c, sch)

        def run(params, cache, tokens, pos):
            logits, cache = fn(params, cache, tokens, pos)
            record(logits[:, -1])
            return logits, cache
        return run

    top_k, scores = jax.lax.top_k, []

    def recording_top_k(x, k):
        if not prefilled:           # the prefill's routers, layer by layer
            scores.append(np.asarray(x))
        return top_k(x, k)

    jdecode.make_prefill_step, jdecode.make_serve_step = prefill_step, serve_step
    jax.lax.top_k = recording_top_k
    try:
        with jax.disable_jit():
            out = jdecode.greedy_generate(
                jparams, jcfg, scheme, jnp.asarray(toks), max_new,
                prompt_lens=jnp.asarray(lens))
    finally:
        jdecode.make_prefill_step, jdecode.make_serve_step = (make_prefill,
                                                              make_step)
        jax.lax.top_k = top_k
    (logits, cache), = prefilled
    return np.asarray(out), margins, logits, cache, _clean_tokens(
        scheme, scores, cfg, toks.shape)


def _clean_tokens(scheme, scores, cfg, shape):
    """Per layer (and one more for the logits), the (B, S) tokens whose
    values no router near-tie of an earlier layer can reach. A token whose
    reference top-k boundary is within ROUTER_TIE may route to another
    expert in the port (the f32 router sums in another order), which moves
    that token; under bf16 causal attention carries it to the later tokens
    of its row, under quartet2 the expert buffers' per-tensor absmax carries
    it to every token."""
    b, s = shape
    clean = np.ones((b, s), bool)
    out = []
    for layer in range(cfg.n_layers):
        out.append(clean.copy())
        if cfg.moe:
            k = cfg.moe.top_k
            srt = np.sort(scores[layer], axis=-1)[:, ::-1]
            tie = (srt[:, k - 1] - srt[:, k] <= ROUTER_TIE).reshape(b, s)
            if scheme == "bf16":
                clean &= ~np.maximum.accumulate(tie, axis=1)
            elif tie.any():
                clean[:] = False
    return out + [clean]


def prefill_matches_eager_jax(arch, scheme):
    """The prefill of `greedy_generate`'s ragged batch (right-padded to 12
    tokens) into dense caches of max_len 25. deepseek-v3 is compared on
    the tokens no router near-tie reaches (`_clean_tokens`; at least half
    of them)."""
    max_new = MAX_NEW if (arch, scheme) != ("deepseek_v3_671b", "quartet2") else 1
    jl, jcache, clean = _jax_greedy(arch, scheme, max_new)[2:]
    assert clean[-1].mean() >= 0.5, clean[-1]
    _, cfg, _, params = _weights(arch)
    toks, _ = _ragged(cfg.vocab)
    max_len = toks.shape[1] + max_new + 8
    tl, tcache = lm.forward(
        params, cfg, {"tokens": torch.from_numpy(toks)}, scheme, SEED,
        caches=lm.init_cache(cfg, len(toks), max_len, device="cpu"),
        mode="prefill")
    got, want = _f32(tl), _f32(jl)
    assert got.shape == want.shape and np.isfinite(got).all()
    leaves = [(t, j) for ts, js in zip(tcache, jcache)
              for lk in js for kind in js[lk]
              for t, j in zip(ts[lk][kind], js[lk][kind])]
    assert len(leaves) == 2
    s = toks.shape[1]
    for t, j in leaves:
        assert t.dtype == torch.bfloat16 and t.shape[2] == max_len + 1
        assert not t[:, :, s:].any()        # past the prompt, scratch: zeros
        for layer, ok in enumerate(clean[:-1]):
            _agree(scheme, _f32(t[layer, :, :s])[ok], _f32(j[layer, :, :s])[ok])
    _agree(scheme, got[clean[-1]], want[clean[-1]])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_prefill_logits_and_caches_match_eager_jax(scheme):
    prefill_matches_eager_jax("llama_200m", scheme)


def prefill_then_decode_matches_a_full_forward(arch):
    """The reference's test_decode_matches_full_forward on the port: prefill
    16 tokens, decode 3, against one train-mode forward over all 19."""
    _, cfg, _, params = _weights(arch)
    b, s, extra = 2, 16, 3
    toks = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab, (b, s + extra)))
    full, _ = lm.forward(params, cfg, {"tokens": toks}, "bf16", SEED,
                         mode="train")
    full = full.float()
    tol = FULL_FORWARD_FRACTION * float(full.abs().max())
    cache = lm.init_cache(cfg, b, s + 8, device="cpu")
    pf, cache = lm.forward(params, cfg, {"tokens": toks[:, :s]}, "bf16", SEED,
                           caches=cache, mode="prefill")
    assert float((pf.float() - full[:, :s]).abs().max()) < tol
    for step in range(extra):
        dl, cache = lm.forward(params, cfg,
                               {"tokens": toks[:, s + step: s + step + 1]},
                               "bf16", SEED, caches=cache, mode="decode",
                               pos=s + step)
        err = float((dl[:, 0].float() - full[:, s + step]).abs().max())
        assert err < tol, (step, err)


def test_prefill_then_decode_matches_a_full_forward():
    prefill_then_decode_matches_a_full_forward("llama_200m")


# ---- one dense decode layer ----

def _bf16(a):
    """(port bf16 tensor, JAX bf16 array) of the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def dense_decode_layer_matches_jax(arch, scheme):
    """One decode token per row over dense caches holding garbage (the
    step shapes of `greedy_generate`'s decode, max_len 25): row 0 at
    position 5, row 1 at -1 (its write dropped), row 2 inactive. The
    scratch position takes the dropped writes; below it the caches equal
    the reference's within one ulp. Row 1's query has no key: both packages then
    average the whole cache (a uniform softmax over NEG_INF scores), a mean
    of garbage in another f32 order, so its output is not compared."""
    jcfg, cfg, jparams, params = _weights(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["stages"][0]["l0"]["mix"])
    tp = lm.layer_params(params["stages"][0]["l0"]["mix"], 0)
    rng = np.random.RandomState(4)
    cap = max(RAGGED) + MAX_NEW + 8
    feats = ([(cfg.mla.kv_lora_rank,), (cfg.mla.qk_rope_head_dim,)]
             if cfg.mla else [(cfg.n_kv_heads, cfg.hd)] * 2)
    jcache, tcache = [], []
    for f in feats:
        t, j = _bf16(rng.randn(3, cap + 1, *f) * 0.5)
        jcache.append(j[:, :cap])
        tcache.append(t)
    x, jx = _bf16(rng.randn(3, 1, cfg.d_model))
    pos = np.asarray([5, -1, 7], np.int32)
    active = np.asarray([True, True, False])
    jstep, tstep = ((jmla.mla_decode, mla.mla_decode) if cfg.mla
                    else (jattn.gqa_decode, A.gqa_decode))
    with jax.disable_jit():
        jout, jnew = jstep(jp, jx, jcfg, scheme, jnp.asarray(SEED), 0,
                           tuple(jcache), jnp.asarray(pos),
                           active=jnp.asarray(active))
    out, new = tstep(tp, x, cfg, scheme, SEED, 0, tuple(tcache),
                     torch.from_numpy(pos), active=torch.from_numpy(active))
    for t, j in zip(new, jnew):
        _within_bf16_ulp(_f32(t[:, :cap]), _f32(j))
    o, jo = _f32(out), _f32(jout)
    assert out.dtype == torch.bfloat16 and o.shape == jo.shape
    assert not o[2].any()                       # inactive: attention zeroed
    _within_bf16_ulp(o[[0, 2]], jo[[0, 2]])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dense_decode_layer_matches_jax(scheme):
    dense_decode_layer_matches_jax("llama_200m", scheme)


# ---- KVPool(paged=False) against the reference's dense pool ----

def _dense_pair(n_slots=3, max_len=32):
    jcfg = jregistry.get("llama_200m").reduced()
    ref = jkv.KVPool(jcfg, n_slots, max_len, paged=False, block_size=4)
    port = KVPool(registry.get("llama_200m").reduced(), n_slots, max_len,
                  paged=False, block_size=4, device="cpu")
    return ref, port


def test_dense_pool_state_machine_matches_reference():
    """The reference's dense-mode walk (tests/test_kv_pool.py): commit,
    ensure, truncate and release on both pools, the same results or the
    same errors, lengths and admission equal after each; no block moves."""
    ref, port = _dense_pair()
    rng = np.random.RandomState(5)
    ops = ["commit", "ensure", "truncate", "release"]
    seen = dict.fromkeys(ops, 0)
    for step in range(300):
        op, s = ops[rng.randint(4)], int(rng.randint(3))
        arg = {"commit": lambda: (s, int(rng.randint(1, 41))),
               "ensure": lambda: (s, int(rng.randint(1, 41))),
               "truncate": lambda: (s, int(rng.randint(0, 34))),
               "release": lambda: (s,)}[op]()
        _both(ref, port, op, *arg)
        seen[op] += 1
        assert ref._lengths == port._lengths and ref._bound == port._bound
        for total in (1, 20, 32, 33):
            assert ref.can_admit(total) == port.can_admit(total)
            assert ref.can_ever_admit(total) == port.can_ever_admit(total)
            assert port.admission_shortfall(total) == 0
    assert min(seen.values()) >= 50, seen
    assert port.tables_device() is None and ref.tables_device() is None
    assert port.utilization() == ref.utilization()
    assert port.free_block_count == port.n_blocks and port.window is None


def test_dense_pool_layout_and_block_operations_raise():
    _, port = _dense_pair()
    k, v = port.caches[0]["l0"]["kv"]
    cfg = port.cfg
    assert k.shape == (cfg.n_layers, 3, 33, cfg.n_kv_heads, cfg.hd)
    assert k.dtype == torch.bfloat16 and k.data_ptr() != v.data_ptr()
    port.commit(0, 8)
    port.ensure(0, 8)
    with pytest.raises(OutOfBlocks):
        port.ensure(0, 33)
    for name, args in (("adopt_prefix", (0, [0], 4)), ("cow_block", (0, 0)),
                       ("read_block_host", (0,)),
                       ("write_block_host", (0, None))):
        with pytest.raises(SlotError):
            getattr(port, name)(*args)
    with pytest.raises(ValueError):
        KVPool(cfg, 2, 32, paged=False, block_size=4, device="cpu",
               quantized=True)


# ---- greedy_generate ----

def greedy_generate_matches_eager_jax(arch, scheme):
    _, cfg, _, params = _weights(arch)
    toks, lens = _ragged(cfg.vocab)
    want, margins = _jax_greedy(arch, scheme)[:2]
    got = decode.greedy_generate(params, cfg, scheme, toks, MAX_NEW,
                                 prompt_lens=lens, device="cpu")
    assert got.shape == (len(RAGGED), MAX_NEW) and got.device.type == "cpu"
    got = got.numpy()
    if (arch, scheme) == ("llama_200m", "bf16"):
        np.testing.assert_array_equal(got, want)
    else:
        assert_equal_up_to_narrow_margin(
            {i: list(r) for i, r in enumerate(got)},
            {i: list(r) for i, r in enumerate(want)}, margins,
            EAGER_LOGIT_TOL, MAX_NEW)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_greedy_generate_matches_eager_jax(scheme):
    greedy_generate_matches_eager_jax("llama_200m", scheme)


def test_ragged_rows_equal_rows_generated_alone():
    """bf16 rows are independent: each row of a right-padded batch equals
    the row generated alone at its own length."""
    _, cfg, _, params = _weights("llama_200m")
    toks, lens = _ragged(cfg.vocab)
    batch = decode.greedy_generate(params, cfg, "bf16", toks, MAX_NEW,
                                   prompt_lens=lens, device="cpu")
    for i, n in enumerate(RAGGED):
        alone = decode.greedy_generate(params, cfg, "bf16", toks[i:i + 1, :n],
                                       MAX_NEW, device="cpu")
        assert torch.equal(batch[i], alone[0]), i


def test_greedy_generate_refuses_what_the_reference_refuses():
    _, cfg, _, params = _weights("llama_200m")
    toks = np.zeros((2, 4), np.int32)
    with pytest.raises(NotImplementedError):
        decode.greedy_generate(params, dataclasses.replace(cfg, enc_dec=True),
                               "bf16", toks, 2, device="cpu")
    with pytest.raises(NotImplementedError):
        decode.greedy_generate(params, dataclasses.replace(cfg, family="ssm"),
                               "bf16", toks, 2, prompt_lens=[4, 2],
                               device="cpu")


# ---- the engine over dense caches ----

PROMPT_LENS = (19, 5, 11, 8, 3)
KW = dict(n_slots=2, max_len=48, prefill_chunk=8, scheme="bf16",
          device="cpu")


def _serve(arch, **kw):
    _, cfg, _, params = _weights(arch)
    rng = np.random.RandomState(0)
    eng = ServeEngine(cfg, params, EngineConfig(**{**KW, **kw}))
    for n in PROMPT_LENS:
        eng.submit(Request(rng.randint(0, cfg.vocab, n).tolist(), MAX_NEW))
    return {r.req_id: r.tokens for r in eng.run()}, eng


def dense_engine_streams_equal_the_paged_engine(arch, spec):
    dense, eng = _serve(arch, paged=False, **spec)
    paged, _ = _serve(arch, **spec)
    assert not eng.pool.paged and eng.pool.tables_device() is None
    assert len(dense) == len(PROMPT_LENS)
    assert dense == paged
    if spec:
        assert not eng.draft.pool.paged and eng.stats["draft_tokens"] > 0


@pytest.mark.parametrize("spec", SPEC, ids=["plain", "spec_k3"])
def test_dense_engine_streams_equal_the_paged_engine(spec):
    dense_engine_streams_equal_the_paged_engine("llama_200m", spec)


def test_prefix_cache_on_a_dense_pool_runs_without_a_cache():
    cached, eng = _serve("llama_200m", paged=False, prefix_cache=True)
    plain, _ = _serve("llama_200m", paged=False)
    assert eng.cache is None and eng.stats["prefix_hits"] == 0
    assert cached == plain


def test_launch_serve_dense_and_legacy_on_cpu(capsys):
    common = ["--arch", "llama_200m", "--device", "cpu", "--reduced",
              "--batch", "2", "--prompt-len", "12", "--tokens", "3"]
    dense = launch_serve.main(common + ["--dense"])
    assert dense["requests"] == 2 and dense["decode_tok_s"] > 0
    legacy = launch_serve.main(common + ["--legacy"])
    assert legacy["legacy"] and legacy["tok_s"] > 0
    assert len(legacy["tokens"]) == 2 and len(legacy["tokens"][0]) == 3
    out = capsys.readouterr().out
    assert "[cpu] llama-200m-smoke quartet2 legacy loop" in out
    with pytest.raises(SystemExit):
        launch_serve.main(common + ["--dense", "--prefix-cache"])
