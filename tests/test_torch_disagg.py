"""Disaggregated prefill/decode on the CPU: the engine's roles
(`EngineConfig.role`, `Handoff`, `submit_handoff`) and the frontend's
`EnginePair` / `make_disagg_pair` / `_PairStats`.

Reduced llama, 4 slots, max_len 96, prefill chunk 8 (8 requests of 9-64
tokens, so slots and payload buffers recycle). Bars, each where it is used:
  - bf16: the pair's streams equal the port's monolithic engine's BITWISE
    over both pools (bf16 rows are independent, and each request's prefill
    runs the same chunk shapes on the prefill worker as on the single
    engine); against the reference's JAX pair by the bf16 tie rule
    (`tests/_torch_streams.py`: equal before each row's first 2-ulp tie);
  - quartet2: the per-tensor activation absmax couples the rows of a
    decode step, and a handed-off request joins the decode batch one tick
    later than on the single engine, so multi-slot streams are not held
    against the monolithic engine; with ONE slot every decode step holds
    one row on both sides, and the pair's quartet2 stream equals the
    single engine's bitwise. Multi-slot quartet2 streams are held against
    the reference's pair, which has the same batch compositions, up to its
    first narrow top-2 margin (Q2_LOGIT_TOL, as tests/test_torch_engine.py);
  - pools: at the end every block of both pools is free (or held by the
    prefill worker's prefix cache), every payload buffer is back on the
    prefill pool's host free list, and the decode worker ran no prefill
    forward;
  - cancel while a handoff is in transit (exported, not yet shipped; shipped,
    queued on the decode worker), a client's disconnect and drain over the
    bridge conserve both pools; SSE over the pair is bitwise `run()` of the
    single engine;
  - `kv_quant` payloads stay packed (uint8 codes and scale bits).
Each test has a 60 s SIGALRM guard of this file's own.
"""

import asyncio
import dataclasses
import functools
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_streams import (BF16_TIE_ULPS, _bf16_ulp,
                            assert_equal_up_to_narrow_margin)
from test_torch_frontend import WAIT_S, _get, _post, _run, _Serve, _sse, _w
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import frontend as jfrontend
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import (EngineConfig, Handoff, Request,
                                      ServeEngine, Unservable)
from repro_torch.serve.frontend import (H_RETIRED, EnginePair, _PairStats,
                                        make_disagg_pair)
from repro_torch.serve.kv_pool import PackedKV, token_leaves

TEST_TIMEOUT_S = 60
PROMPT_LENS = (16, 23, 40, 9, 33, 64, 17, 50)
MAX_NEW = 8
Q2_LOGIT_TOL = 0.25
KW = dict(n_slots=4, max_len=96, prefill_chunk=8)
ENGINE_TEST_LENS = (19, 5, 11, 8, 3)  # tests/test_torch_engine.py's traffic
ENGINE_TEST_KW = dict(n_slots=2, max_len=48, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _guard():
    torch.set_num_threads(1)

    def fail(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jregistry.get("llama_200m").reduced()
    cfg = registry.get("llama_200m").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _prompts(vocab, lens=PROMPT_LENS):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _econf(**kw):
    return EngineConfig(device="cpu", **{**KW, **kw})


def _serve(eng, prompts, first_new=1):
    """Streams in submission order, MAX_NEW tokens each but the first
    request's `first_new` (1: it retires on the prefill worker without a
    handoff)."""
    ids = [eng.submit(Request(list(p), MAX_NEW if i else first_new))
           for i, p in enumerate(prompts)]
    res = {r.req_id: r for r in eng.run()}
    return [res[i].tokens for i in ids], [res[i] for i in ids]


def _storages(tree):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _storages(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _storages(v)]
    return [tree.data_ptr()]


def _conserved(pair):
    """Both pools: every block free (or held by the prefill worker's cache),
    every payload buffer back on the prefill pool's free list."""
    pe, de = pair.prefill, pair.decode
    held = pe.cache.cached_blocks() if pe.cache is not None else 0
    assert pe.pool.free_block_count + held == pe.pool.n_blocks
    assert de.pool.free_block_count == de.pool.n_blocks
    assert len(pe.pool._host_free) == pe.pool.host_allocs
    assert not de.pool.host_allocs  # the decode pool allocates no payload
    assert not pair.has_work()


# --------------------------------------------------------------------------
# the roles' checks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw,match", [
    ("llama_200m", dict(paged=False), "paged pool"),
    ("rwkv6_7b", {}, "recurrent state"),
    ("llama_200m", dict(spec_k=2, draft_layers=1), "spec_k"),
    ("llama_200m", dict(role="both-ish"), "role must be"),
])
def test_role_checks_raise_as_the_reference(arch, kw, match):
    cfg = registry.get(arch).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    role = kw.pop("role", "prefill")
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, _econf(role=role, **kw))


def test_window_reclaiming_pool_refuses_roles():
    """A pure sliding-window stack reclaims blocks mid-sequence, so whole
    resident blocks cannot travel: the reference's third refusal."""
    base = registry.get("recurrentgemma_9b").reduced()
    cfg = dataclasses.replace(base, griffin=dataclasses.replace(
        base.griffin, pattern=("attn",)))
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ServeEngine(cfg, params, _econf()).pool.window is not None
    with pytest.raises(ValueError, match="sliding-window"):
        ServeEngine(cfg, params, _econf(role="decode"))


def test_decode_worker_takes_handoffs_not_prompts():
    _, cfg, _, params = _weights()
    de = ServeEngine(cfg, params, _econf(role="decode"))
    with pytest.raises(Unservable, match="decode-role") as ei:
        de.submit(Request([1, 2, 3], 4))
    assert ei.value.reason == "wrong_role" and ei.value.retry_after_s is None
    assert de.stats["rejected"] == 1 and not de.has_work()
    pe = ServeEngine(cfg, params, _econf(role="prefill"))
    with pytest.raises(ValueError, match="non-decode-role"):
        pe.submit_handoff(Handoff(Request([1], 2), [0], 1, []))
    with pytest.raises(ValueError, match="roles"):
        EnginePair(de, pe)


# --------------------------------------------------------------------------
# streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_pool", "nvfp4_pool"])
def test_bf16_pair_streams_bitwise_the_single_engine(kv_quant):
    _, cfg, _, params = _weights()
    prompts = _prompts(cfg.vocab)
    mono, _ = _serve(ServeEngine(cfg, params, _econf(scheme="bf16",
                                                      kv_quant=kv_quant)),
                     prompts)
    pair = make_disagg_pair(cfg, params, _econf(scheme="bf16",
                                                kv_quant=kv_quant))
    got, results = _serve(pair, prompts)
    assert got == mono
    # one set of weights: the decode worker's leaves are the prefill's
    assert _storages(pair.decode.params) == _storages(pair.prefill.params)
    assert pair.prefill.stats["handoffs"] == len(prompts) - 1  # max_new > 1
    assert pair.decode.stats["prefill_steps"] == 0
    assert pair.prefill.stats["decode_steps"] == 0
    assert pair.stats["finished"] == len(prompts)
    assert all(r.ttft_s is not None and r.ttft_s >= 0 for r in results)
    # 8 requests over 4 slots: the payload buffers were reused
    exported = sum(-(-n // 16) for n in PROMPT_LENS[1:])
    assert 0 < pair.prefill.pool.host_allocs < exported
    _conserved(pair)


def test_quartet2_pair_one_slot_bitwise_the_single_engine():
    """One slot: every decode step holds the same single row on both sides,
    so the per-tensor activation absmax sees the same tensor."""
    _, cfg, _, params = _weights()
    prompts = _prompts(cfg.vocab, (16, 23, 9))
    kw = dict(scheme="quartet2", n_slots=1)
    mono, _ = _serve(ServeEngine(cfg, params, _econf(**kw)), prompts)
    pair = make_disagg_pair(cfg, params, _econf(**kw))
    assert _serve(pair, prompts)[0] == mono
    _conserved(pair)


def _run_jax_pair(jcfg, jparams, prompts, **econf):
    """The reference's pair: streams {req_id: tokens} and, per (req_id,
    token index), (the sampling call in pair order, its top-2 margin, its
    top logit)."""
    pair = jfrontend.make_disagg_pair(jcfg, jparams,
                                      jengine.EngineConfig(**econf))
    calls, margins = [0], {}
    for eng, state in ((pair.prefill, jengine.PREFILL),
                       (pair.decode, jengine.DECODE)):
        def recording_sample(last_logits, _eng=eng, _state=state,
                             _orig=eng._sample):
            lf = np.asarray(last_logits, np.float32)
            rows = [i for i, s in enumerate(_eng.slots) if s.state == _state]
            if _state == jengine.PREFILL:  # FIFO: the lowest-index one
                rows = rows[:1]
            for i in rows:
                top2 = np.sort(lf[i])[-2:]
                s = _eng.slots[i]
                margins[(s.req.req_id, len(s.generated))] = (
                    calls[0], float(top2[1] - top2[0]), float(top2[1]))
            calls[0] += 1
            return _orig(last_logits)
        eng._sample = recording_sample
    for p in prompts:
        pair.submit(jengine.Request(list(p), MAX_NEW))
    return {r.req_id: r.tokens for r in pair.run()}, margins


@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
def test_pair_streams_match_the_reference_pair(scheme):
    """tests/test_torch_engine.py's traffic and engine shape (5 requests of
    3-19 tokens, 2 slots, max_len 48, chunk 8) over both pairs."""
    jcfg, cfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab, ENGINE_TEST_LENS)
    want, margins = _run_jax_pair(jcfg, jparams, prompts, scheme=scheme,
                                  **ENGINE_TEST_KW)
    pair = make_disagg_pair(cfg, params, EngineConfig(
        device="cpu", scheme=scheme, **ENGINE_TEST_KW))
    ids = [pair.submit(Request(list(p), MAX_NEW)) for p in prompts]
    got = {r.req_id: r.tokens for r in pair.run()}
    assert sorted(got) == sorted(want) == ids
    _conserved(pair)
    if scheme == "quartet2":
        assert_equal_up_to_narrow_margin(got, want, margins, Q2_LOGIT_TOL,
                                         MAX_NEW)
        return
    checked = 0
    for rid in want:
        for j in range(MAX_NEW):
            _, margin, top = margins[(rid, j)]
            if margin <= BF16_TIE_ULPS * _bf16_ulp(top):
                break
            assert got[rid][j] == want[rid][j], (rid, j)
            checked += 1
    assert checked >= len(prompts) * MAX_NEW // 2, checked


def test_kv_quant_payloads_stay_packed():
    """An NVFP4 pool's handoff carries PackedKV uint8 codes and scale bits,
    never dequantized, and imports them byte for byte."""
    _, cfg, _, params = _weights()
    pair = make_disagg_pair(cfg, params, _econf(kv_quant=True))
    rid = pair.submit(Request(_prompts(cfg.vocab, (40,))[0], 4))
    while not pair.prefill.handoffs:
        pair.prefill.step()
    h = pair.prefill.handoffs[0]
    assert h.req.req_id == rid and h.length == 40
    js = [j for j, _ in h.blocks]
    assert js == [0, 1, 2]  # blocks of 16 positions, the tail included
    leaves = token_leaves(h.blocks[0][1].stages)
    assert leaves and all(isinstance(x, PackedKV) for x in
                          h.blocks[0][1].stages[0]["l0"]["kv"])
    assert all(t.dtype == torch.uint8 for t in leaves)
    sent = [[t.clone() for t in token_leaves(p.stages)] for _, p in h.blocks]
    pair.decode.submit_handoff(pair.prefill.handoffs.popleft())
    pair.decode._admit()
    i = next(i for i, s in enumerate(pair.decode.slots) if s.req is h.req)
    for j, want in zip(js, sent):
        blk = int(pair.decode.pool._table[i, j])
        got = [leaf[:, blk] for leaf in token_leaves(pair.decode.pool.caches)]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not h.blocks  # the buffers went back behind the import
    pair.run()
    _conserved(pair)


# --------------------------------------------------------------------------
# cancel, drain, stats
# --------------------------------------------------------------------------

def test_cancel_in_transit_conserves_both_pools():
    _, cfg, _, params = _weights()
    pair = make_disagg_pair(cfg, params, _econf(prefix_cache=True))
    p = _prompts(cfg.vocab, (24,))[0]
    rid = pair.submit(Request(p, 8))
    while not pair.prefill.handoffs:
        pair.prefill.step()  # the export parks in transit ...
    assert pair.cancel(rid)  # ... and dies there
    assert pair.stats["cancelled"] == 1 and not pair.has_work()
    assert pair.decode.stats["finished"] == 0
    _conserved(pair)
    # a handoff queued on the decode worker (every decode slot busy)
    busy = [pair.submit(Request(q, 30)) for q in _prompts(cfg.vocab, (9,) * 4)]
    while pair.decode.free_slots:
        pair.step()
    rid2 = pair.submit(Request(p, 8))  # a prefix hit on the prompt above
    while not pair.decode.handoff_queue:
        pair.step()
    assert pair.cancel(rid2) and pair.stats["cancelled"] == 2
    assert pair.cancel(busy[0])  # mid-decode on the decode worker
    res = pair.run()
    assert sorted(r.req_id for r in res) == busy[1:]
    assert pair.prefill.stats["prefix_hits"] >= 1
    _conserved(pair)


def test_pair_stats_read_sums_and_write_the_prefill_view():
    p = {"ticks": 3, "decode_s": 0.5}
    d = {"ticks": 4, "decode_s": 1.25}
    st = _PairStats(p, d)
    assert st["ticks"] == 7 and st["decode_s"] == 1.75
    assert dict(st) == {"ticks": 7, "decode_s": 1.75} and len(st) == 2
    st["ticks"] = 0
    st["decode_s"] = 2.0
    assert (p, d) == ({"ticks": 0, "decode_s": 2.0},
                      {"ticks": 0, "decode_s": 0.0})
    assert isinstance(d["ticks"], int) and isinstance(d["decode_s"], float)
    with pytest.raises(TypeError):
        del st["ticks"]


def test_sse_over_the_pair_bitwise_run():
    _, cfg, _, params = _weights()
    prompts = _prompts(cfg.vocab, (9, 13, 17))
    ref, _ = _serve(ServeEngine(cfg, params, _econf(scheme="bf16")), prompts)
    pair = make_disagg_pair(cfg, params, _econf(scheme="bf16"))

    async def scenario():
        async with _Serve(pair) as srv:
            res = await _w(asyncio.gather(
                *[_sse(srv.port, p, MAX_NEW if i else 1)
                  for i, p in enumerate(prompts)]))
            return res, await srv.snapshot()

    res, snap = _run(scenario())
    assert all(status == 200 and done for status, _, done, _ in res)
    assert [toks for _, toks, _, _ in res] == ref
    assert snap["stats"]["finished"] == len(prompts)  # the merged stats
    assert pair.prefill.stats["decode_steps"] == 0
    assert pair.decode.stats["prefill_steps"] == 0
    _conserved(pair)


def test_disconnect_on_the_pair_reclaims_both_pools():
    """A client reset mid-stream: the cancel reclaims whichever worker holds
    the request, both pools are conserved, and the exported prompt hot-hits
    the follow-up, which streams as the single engine does."""
    _, cfg, _, params = _weights()
    prompts = _prompts(cfg.vocab, (24,))
    ref, _ = _serve(ServeEngine(cfg, params, _econf(scheme="bf16")), prompts,
                    first_new=MAX_NEW)
    pair = make_disagg_pair(cfg, params, _econf(scheme="bf16",
                                                prefix_cache=True))

    async def scenario():
        async with _Serve(pair) as srv:
            status, toks, done, _ = await _sse(srv.port, prompts[0], MAX_NEW,
                                               kill_after=2)
            assert status == 200 and not done and len(toks) >= 2
            snap = await srv.until_cancelled(1)
            assert snap["live_handles"] == 0
            return await _sse(srv.port, prompts[0], MAX_NEW)

    status, toks, done, _ = _run(scenario())
    assert status == 200 and done and toks == ref[0]
    assert pair.prefill.stats["prefix_hits"] >= 1
    _conserved(pair)


def test_drain_covers_both_roles():
    _, cfg, _, params = _weights()
    prompts = _prompts(cfg.vocab, (9, 13))
    ref, _ = _serve(ServeEngine(cfg, params, _econf(scheme="bf16")), prompts,
                    first_new=MAX_NEW)
    pair = make_disagg_pair(cfg, params, _econf(scheme="bf16"))

    async def scenario():
        async with _Serve(pair) as srv:
            b = srv.bridge
            handles = [await _w(asyncio.wrap_future(
                b.submit(p, MAX_NEW, track_visibility=False))) for p in prompts]
            while not any(h.tokens for h in handles):
                await asyncio.sleep(0.01)
            status, body, _ = await _post(srv.port, "/admin/drain", {})
            assert status == 202 and body["draining"] is True
            st2, body2, _ = await _post(
                srv.port, "/v1/completions",
                {"prompt": prompts[0], "max_tokens": 4, "stream": False})
            assert st2 == 503 and body2["error"]["reason"] == "draining"
            await _w(asyncio.get_running_loop().run_in_executor(
                None, b.drained.wait, WAIT_S))
            assert b.drained.is_set()
            assert all(h.done and h.state == H_RETIRED for h in handles)
            return [h.tokens for h in handles]

    assert _run(scenario()) == ref  # drain truncated no stream
    assert not pair.prefill.handoffs
    _conserved(pair)


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------

def test_launch_serve_disagg_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--reduced", "--disagg",
                             "--batch", "4", "--prompt-len", "20",
                             "--tokens", "6", "--scheme", "bf16"])
    assert out["disagg"] and out["requests"] == 4 and out["handoffs"] == 4
    assert out["free_blocks"] == out["n_blocks"]
    assert out["decode_prefill_steps"] == 0
    assert "handoffs 4" in capsys.readouterr().out


def test_launch_serve_disagg_over_http():
    """`launch.serve --device cpu --reduced --disagg --http 0 --obs` in a
    subprocess: the pair serves a completion and /metrics, exits on
    SIGINT."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--reduced", "--disagg", "--http", "0", "--obs", "--scheme",
         "bf16"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ))
    try:
        line = proc.stdout.readline()
        assert "serving http://127.0.0.1:" in line, line
        port = int(line.rsplit("port ", 1)[1].rstrip(")\n"))

        async def scenario():
            done = await _post(port, "/v1/completions",
                               {"prompt": [1, 2, 3, 4], "max_tokens": 3})
            return done, await _get(port, "/metrics")

        (status, body, _), (mst, text, _) = _run(scenario())
        assert status == 200 and len(body["choices"][0]["tokens"]) == 3
        assert mst == 200 and b"serve_engine_finished_total" in text
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=WAIT_S)
        finally:
            proc.kill()
            proc.stdout.close()
    assert proc.returncode == 0
