"""Serving the recurrent families with the port: reduced rwkv6-7b (time-mix +
channel-mix, the wkv / tm_prev / cm_prev state kinds) and reduced
recurrentgemma-9b (RG-LRU blocks with the lru state kind, sliding-window
lattn layers whose window of 32 reclaims pool blocks mid-sequence).

Same weights (the reference's init, converted), same requests and the same
FIFO / chunking schedule as the JAX reference engine
(`tests/_torch_streams.py`). Tolerances, each where it is used:
  - bf16 greedy streams against the reference engine's: each row equal up to
    its first reference near-tie of BF16_TIE_ULPS = 2 bf16 ulps, at least
    half the tokens compared (the port's bf16 logits sit within 1-2 ulps of
    the jitted reference's: its gates' and decays' exp / tanh / sigmoid are
    XLA's polynomials); ragged prompts, more requests than slots, a prompt
    tail fed token by token;
  - quartet2: prequantized weights serve the per-step quantization's
    streams bitwise (the reduced models' logits are nearly flat, so the
    reference's first quartet2 sample already has a top-2 margin of 0.02:
    tests/test_torch_archs.py holds the quartet2 logits to the reference by
    its noise rule instead);
  - exact: the dense pool's streams bitwise the paged pool's (bf16), the
    speculative engine's streams bitwise the non-speculative one's (bf16,
    one thread: rows independent of the step shape, and rwkv's verify chunk
    on the per-token WKV path), over both pools, every block of both pools
    free at the end; after a round with rejections the restored state rows
    bitwise the snapshot; `reset_slot` on a bound slot raises;
    `snapshot_states` / `restore_states` round-trip bitwise; the prefix
    cache refused; the rwkv spec_k guard; recurrentgemma's window reclaim
    freeing blocks mid-sequence; `greedy_generate` over ring caches
    bitwise the same loop over full-capacity caches.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_streams import assert_equal_up_to_bf16_ties, run_jax, run_port
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import lm
from repro_torch.serve import decode as serve_decode
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.kv_pool import KVPool, SlotError, state_leaves

ARCHS = ["rwkv6_7b", "recurrentgemma_9b"]
PROMPT_LENS = (19, 5, 11, 40, 3)
MAX_NEW = 6
# block 8 so that recurrentgemma's window of 32 frees blocks of the 40-token
# prompt while it decodes; prefill chunk 8 = rwkv's reduced WKV chunk
KW = dict(n_slots=2, max_len=64, prefill_chunk=8, block_size=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _prompts(vocab, lens=PROMPT_LENS):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jregistry.get(arch).reduced()
    return jcfg, jlm.init(jcfg, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port(arch):
    jcfg, jparams = _weights(arch)
    cfg = registry.get(arch).reduced()
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _serve(arch, prompts, max_new=MAX_NEW, **kw):
    cfg, params = _port(arch)
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu",
                                                **{**KW, **kw}))
    for p in prompts:
        eng.submit(Request(p, max_new))
    res = {r.req_id: r.tokens for r in eng.run()}
    assert eng.pool.free_block_count == eng.pool.n_blocks
    if eng.draft is not None:
        assert eng.draft.pool.free_block_count == eng.draft.pool.n_blocks
    return res, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_streams_equal_jax_up_to_ties(arch):
    jcfg, jparams = _weights(arch)
    want, margins = run_jax(jcfg, jparams, _prompts(jcfg.vocab), MAX_NEW,
                            scheme="bf16", **KW)
    got, _ = run_port(registry.get(arch).reduced(), jparams,
                      _prompts(jcfg.vocab), MAX_NEW, scheme="bf16", **KW)
    assert_equal_up_to_bf16_ties(got, want, margins, len(PROMPT_LENS), MAX_NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_quartet2_prequant_streams_bitwise_per_step_quantization(arch):
    """Quantize-once weights (QUANT_KEYS: wr, w_in, w_gate, w_out, cm_w*
    packed; the f32 LoRA and gate matrices left raw) serve the streams
    that per-step quantization serves, bit for bit."""
    from repro_torch.core.linear import PackedQWeight
    prompts = _prompts(512)
    packed, eng = _serve(arch, prompts, scheme="quartet2")
    raw, _ = _serve(arch, prompts, scheme="quartet2", prequant=False)
    assert packed == raw
    mix = eng.params["stages"][0]["l0"]["mix"]
    keys = (("wr", "wk", "wv", "wg", "wo", "cm_wr", "cm_wk", "cm_wv")
            if arch == "rwkv6_7b" else ("w_in", "w_gate", "w_out"))
    assert all(isinstance(mix[k], PackedQWeight) for k in keys)
    raw_keys = (("mix_w1", "mix_w2", "ww1", "ww2") if arch == "rwkv6_7b"
                else ("wa", "wx", "conv_w"))
    assert all(isinstance(mix[k], torch.Tensor) for k in raw_keys)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_pool_streams_bitwise_paged(arch):
    prompts = _prompts(512)
    paged, _ = _serve(arch, prompts, scheme="bf16")
    dense, eng = _serve(arch, prompts, scheme="bf16", paged=False)
    assert dense == paged
    assert eng.pool.tables_device() is None


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_streams_bitwise_nonspec(arch, paged):
    """The speculative engine (spec_k 3 over a 1-layer draft) emits the
    non-speculative greedy streams bit for bit: rejected rounds restore the
    recurrent state of both pools and replay the accepted tokens."""
    prompts = _prompts(512)
    base, _ = _serve(arch, prompts, max_new=8, scheme="bf16", paged=paged)
    spec, eng = _serve(arch, prompts, max_new=8, scheme="bf16", paged=paged,
                       spec_k=3, draft_layers=1)
    assert spec == base
    st = eng.stats
    assert st["spec_rounds"] > 0 and st["accepted_tokens"] < st["draft_tokens"]


def test_rejected_round_restores_the_snapshot_bitwise(monkeypatch):
    """In a round in which a slot rejects drafts, the rows that
    `restore_states` writes back equal the snapshot taken before the verify
    chunk, bit for bit, before the accepted tokens are replayed."""
    cfg, params = _port("rwkv6_7b")
    eng = ServeEngine(cfg, params, EngineConfig(
        device="cpu", scheme="bf16", spec_k=3, draft_layers=1, **KW))
    restored = []
    real = KVPool.restore_states

    def checked(pool, snapshot, slots):
        real(pool, snapshot, slots)
        if pool is eng.pool and slots:
            rows = list(slots)
            for leaf, snap in zip(state_leaves(pool.caches), snapshot):
                assert torch.equal(leaf[:, rows], snap[:, rows])
            restored.append(rows)

    monkeypatch.setattr(KVPool, "restore_states", checked)
    for p in _prompts(cfg.vocab)[:2]:
        eng.submit(Request(p, 8))
    eng.run()
    assert restored  # some round rejected a draft


def test_reset_slot_and_snapshot_round_trip():
    cfg, _ = _port("recurrentgemma_9b")
    pool = KVPool(cfg, 2, 32, block_size=8, device="cpu")
    assert pool.has_state_kinds and pool.window == cfg.griffin.window
    leaves = state_leaves(pool.caches)
    assert len(leaves) == 4  # (h, conv tail) of the pattern's two rec layers
    g = torch.Generator().manual_seed(0)
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
    snap = pool.snapshot_states()
    assert all(s.data_ptr() != t.data_ptr() for s, t in zip(snap, leaves))
    before = [t.clone() for t in leaves]
    for leaf in leaves:
        leaf.add_(1)
    pool.restore_states(snap, [1])
    for t, b in zip(leaves, before):
        assert torch.equal(t[:, 1], b[:, 1])
        assert not torch.equal(t[:, 0], b[:, 0])
    pool.restore_states(snap, [0])
    assert all(torch.equal(t, b) for t, b in zip(leaves, before))
    pool.reset_slot(0)
    assert all(int(t[:, 0].count_nonzero()) == 0 for t in leaves)
    assert all(torch.equal(t[:, 1], b[:, 1]) for t, b in zip(leaves, before))
    pool.commit(1, 10)
    with pytest.raises(SlotError, match="reset_slot on a bound slot"):
        pool.reset_slot(1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_is_refused_for_state_kinds(arch):
    cfg, params = _port(arch)
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", prefix_cache=True,
                                                **KW))
    assert eng.pool.has_state_kinds and eng.cache is None
    prompt = _prompts(cfg.vocab)[0]
    for _ in range(2):
        eng.submit(Request(prompt, 2))
    eng.run()
    assert eng.stats["prefix_hits"] == 0
    assert eng.stats["prefill_tokens"] == 2 * len(prompt)


def test_rwkv_spec_k_guard():
    cfg, params = _port("rwkv6_7b")
    with pytest.raises(ValueError, match="spec_k \\+ 1 < rwkv.chunk"):
        ServeEngine(cfg, params, EngineConfig(
            device="cpu", spec_k=cfg.rwkv.chunk - 1, draft_layers=1, **KW))
    ServeEngine(cfg, params, EngineConfig(
        device="cpu", spec_k=cfg.rwkv.chunk - 2, draft_layers=1, **KW))


def test_window_reclaim_frees_blocks_mid_sequence():
    """recurrentgemma's pool holds lattn as its only token mixer, so blocks
    older than the window return to the free list while the 40-token
    request still decodes."""
    cfg, params = _port("recurrentgemma_9b")
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", scheme="bf16",
                                                **KW))
    assert eng.pool.window == 32
    eng.submit(Request(_prompts(cfg.vocab, (52,))[0], 8))
    reclaimed = 0
    while eng.has_work():
        eng.step()
        reclaimed = max(reclaimed, eng.pool._live_from[0])
    assert reclaimed >= 2  # (60 + 1 - 32) // 8 blocks freed before the end
    assert eng.pool.free_block_count == eng.pool.n_blocks


def test_greedy_generate_ring_bitwise_full_capacity():
    """The seed loop over window-sized ring caches (a 40-token prompt against
    the window of 32: the prefill rolls, decode wraps) equals the same loop
    over full-capacity caches bit for bit."""
    cfg, params = _port("recurrentgemma_9b")
    toks = torch.tensor(_prompts(cfg.vocab, (40, 40)))
    with torch.no_grad():
        ring = serve_decode.greedy_generate(params, cfg, "bf16", toks, 6,
                                            device="cpu")
        cache = lm.init_cache(cfg, 2, 54, device="cpu", lattn_ring=False)
        logits, cache = lm.forward(params, cfg, {"tokens": toks}, "bf16",
                                   serve_decode.SEED, caches=cache,
                                   mode="prefill")
        tok = logits[:, -1].argmax(-1, keepdim=True)
        flat = [tok]
        for i in range(5):
            logits, cache = lm.forward(
                params, cfg, {"tokens": tok}, "bf16", serve_decode.SEED,
                caches=cache, mode="decode",
                pos=torch.full((2,), 40 + i, dtype=torch.int32))
            tok = logits[:, -1:].argmax(-1)
            flat.append(tok)
    ring_cache = lm.init_cache(cfg, 2, 54, device="cpu")
    assert ring_cache[0]["l2"]["kv"][0].shape[2] == cfg.griffin.window + 1
    assert torch.equal(ring, torch.cat(flat, dim=1))
    with pytest.raises(NotImplementedError, match="ragged prompts"):
        serve_decode.greedy_generate(params, cfg, "bf16", toks, 2,
                                     prompt_lens=[40, 30], device="cpu")


def test_engine_resets_recurrent_state_at_admission(monkeypatch):
    """A request served after another in the same slot gets the stream it
    gets alone: admission zeroes the slot's state in both pools."""
    cfg, params = _port("rwkv6_7b")
    prompts = _prompts(cfg.vocab)
    alone, _ = _serve("rwkv6_7b", prompts[1:2], scheme="bf16", n_slots=1)
    after, _ = _serve("rwkv6_7b", prompts[:2], scheme="bf16", n_slots=1)
    assert after[1] == alone[0]
    calls = []
    monkeypatch.setattr(KVPool, "reset_slot",
                        lambda pool, slot, _real=KVPool.reset_slot:
                        (calls.append(slot), _real(pool, slot))[1])
    _serve("rwkv6_7b", prompts[:2], scheme="bf16", spec_k=3, draft_layers=1)
    assert len(calls) == 4  # the main pool and the draft's, per admission
