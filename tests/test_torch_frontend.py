"""The port's streaming frontend (`repro_torch/serve/frontend.py`): HTTP/SSE,
the engine-thread bridge and the request lifecycles, on the CPU.

Port only (reduced llama, 2 slots, max_len 48, prefill chunk 8, scheme
bf16 unless a test says otherwise):
  - SSE streams are BITWISE the engine's `run()` streams for the same
    prompts (bf16 rows are independent, and a request's chunk sizes do not
    depend on when it arrives), and the bridge's thread computes with the
    one intra-op thread the tests set;
  - the non-streaming completion, 400 on a bad body, 404 elsewhere;
  - a client that resets mid-stream is cancelled ("disconnected"), its
    blocks reclaimed, and a follow-up hot-hits the cached prefix;
  - 429 with Retry-After on queue saturation and on frontend backpressure;
    tenant budgets and rate limits, the token bucket's refill on a fake
    clock; drain under load (in-flight finish, new ones 503, `drained`);
  - visibility-timeout requeue and exact resume on a fake clock, with the
    bridge driven unstarted; a caught-up consumer is never requeued;
  - the token hook's order (the disaggregated pair's SSE, disconnect and
    drain are in tests/test_torch_disagg.py);
  - `launch/serve.py --http 0 --obs` in a subprocess, and the kernel
    library built and loaded once by threads that reach it together.
Against the reference (one JAX engine): one scripted HTTP exchange (a
streamed request, a rate-limited 429, a drain 503) gives the same statuses,
Retry-After headers, JSON keys and token lists from both frontends on the
same static fake clock.

Hangs fail fast: every await runs under asyncio.wait_for, every join has a
timeout, and each test has a 60 s SIGALRM guard of this file's own.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import frontend as jfrontend
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build
from repro_torch.models import lm
from repro_torch.obs import Instrumentation, MetricsRegistry
from repro_torch.serve import frontend as pfrontend
from repro_torch.serve.engine import (EngineConfig, QueueFull, Request,
                                      ServeEngine)
from repro_torch.serve.frontend import (H_REQUEUED, H_RETIRED, EngineBridge,
                                        FrontendConfig, TenantQuota,
                                        _TokenBucket)

TEST_TIMEOUT_S = 60
WAIT_S = 30.0       # any single await / join
KW = dict(n_slots=2, max_len=48, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _guard():
    torch.set_num_threads(1)

    def fail(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT_S} s (a wedged "
                           "stream or bridge?)")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class FakeClock:
    """A clock that moves only when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


_CFG = registry.get("llama_200m").reduced()
_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["p"] = lm.init(_CFG, torch.Generator().manual_seed(0), "cpu")
    return _PARAMS["p"]


def _prompts(lens=(9, 13, 17)):
    rng = np.random.RandomState(1)
    return [list(map(int, rng.randint(0, _CFG.vocab, n))) for n in lens]


def _engine(**kw):
    return ServeEngine(_CFG, _params(), EngineConfig(
        device="cpu", **{**dict(KW, scheme="bf16"), **kw}))


def _reference_tokens(prompts, max_new, **kw):
    eng = _engine(**kw)
    ids = [eng.submit(Request(list(p), max_new)) for p in prompts]
    res = {r.req_id: r.tokens for r in eng.run()}
    return [res[i] for i in ids]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, WAIT_S))


async def _w(aw):
    return await asyncio.wait_for(aw, WAIT_S)


# --------------------------------------------------------------------------
# HTTP client (stdlib asyncio)
# --------------------------------------------------------------------------

async def _read_response(reader):
    status = int((await _w(reader.readline())).split()[1])
    hdrs = {}
    while True:
        h = await _w(reader.readline())
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode().partition(":")
        hdrs[k.strip().lower()] = v.strip()
    return status, hdrs, await _w(reader.read())


async def _post(port, path, obj, headers=None, raw=None):
    reader, writer = await _w(asyncio.open_connection("127.0.0.1", port))
    body = raw if raw is not None else json.dumps(obj).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\n{extra}"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await _w(writer.drain())
    status, hdrs, payload = await _read_response(reader)
    writer.close()
    return status, json.loads(payload) if payload else None, hdrs


async def _get(port, path):
    reader, writer = await _w(asyncio.open_connection("127.0.0.1", port))
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await _w(writer.drain())
    status, hdrs, payload = await _read_response(reader)
    writer.close()
    return status, payload, hdrs


async def _sse(port, prompt, max_new, kill_after=None, tenant=None):
    """Stream a completion: (status, tokens, [DONE] seen, event dicts).
    `kill_after`: reset the socket after that many tokens."""
    reader, writer = await _w(asyncio.open_connection("127.0.0.1", port))
    body = json.dumps({"prompt": prompt, "max_tokens": max_new,
                       "stream": True,
                       **({"user": tenant} if tenant else {})}).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await _w(writer.drain())
    status = int((await _w(reader.readline())).split()[1])
    toks, done, events = [], False, []
    if status != 200:
        writer.close()
        return status, toks, done, events
    while True:
        line = await _w(reader.readline())
        if not line:
            break
        if not line.startswith(b"data: "):
            continue
        payload = line[6:].strip()
        if payload == b"[DONE]":
            done = True
            break
        ev = json.loads(payload)
        events.append(ev)
        toks.extend(ev["choices"][0]["tokens"])
        if kill_after is not None and len(toks) >= kill_after:
            writer.transport.abort()  # RST: the server sees a dead peer
            return status, toks, done, events
    writer.close()
    return status, toks, done, events


class _Serve:
    """Engine thread + frontend on an ephemeral loopback port, torn down
    even when the body raises."""

    def __init__(self, engine, fconf=None, frontend=pfrontend, **bridge_kw):
        self.bridge = frontend.EngineBridge(engine, **bridge_kw)
        self.fe = frontend.CompletionFrontend(self.bridge, fconf)

    async def __aenter__(self):
        self.bridge.start()
        await _w(self.fe.start())
        return self

    async def __aexit__(self, *exc):
        await _w(self.fe.stop())
        self.bridge.stop()
        assert self.bridge._thread is None

    @property
    def port(self):
        return self.fe.port

    async def snapshot(self):
        return await _w(asyncio.wrap_future(self.bridge.snapshot()))

    async def until_cancelled(self, n):
        for _ in range(500):
            snap = await self.snapshot()
            if snap["stats"]["cancelled"] == n:
                return snap
            await asyncio.sleep(0.01)
        raise AssertionError("the disconnect's cancel never landed")


# --------------------------------------------------------------------------
# SSE against run(), the plain completion, bad requests
# --------------------------------------------------------------------------

def test_sse_stream_bitwise_equals_run():
    prompts = _prompts()
    ref = _reference_tokens(prompts, 8)
    eng = _engine()

    async def scenario():
        async with _Serve(eng) as srv:
            threads = await _w(asyncio.wrap_future(
                srv.bridge.call(lambda e: torch.get_num_threads())))
            res = await _w(asyncio.gather(
                *[_sse(srv.port, p, 8) for p in prompts]))
            return threads, res

    threads, res = _run(scenario())
    assert threads == 1  # the bridge's thread computes like the test's
    assert all(status == 200 and done for status, _, done, _ in res)
    assert [toks for _, toks, _, _ in res] == ref
    assert eng.pool.free_block_count == eng.pool.n_blocks
    final = [evs[-1] for _, _, _, evs in res]
    assert all(ev["usage"]["completion_tokens"] == 8 for ev in final)


def test_nonstream_completion_matches_run():
    prompts = _prompts(lens=(9,))
    ref = _reference_tokens(prompts, 6)

    async def scenario():
        async with _Serve(_engine()) as srv:
            return await _post(srv.port, "/v1/completions",
                               {"prompt": prompts[0], "max_tokens": 6,
                                "stream": False})

    status, body, _ = _run(scenario())
    assert status == 200
    assert body["choices"][0]["tokens"] == ref[0]
    assert body["usage"] == {"prompt_tokens": 9, "completion_tokens": 6,
                             "requeues": 0}


def test_bad_requests_rejected():
    async def scenario():
        async with _Serve(_engine()) as srv:
            return [
                await _post(srv.port, "/v1/completions", {"prompt": "text"}),
                await _post(srv.port, "/v1/completions",
                            {"prompt": [1, 2], "max_tokens": 0}),
                await _post(srv.port, "/v1/completions", None, raw=b"{nope"),
                await _post(srv.port, "/v1/completions",
                            {"prompt": [1] * 40, "max_tokens": 9}),
                await _get(srv.port, "/nope"),
                await _get(srv.port, "/metrics")]

    text, zero, garbled, unservable, nope, metrics = _run(scenario())
    assert text[0] == zero[0] == garbled[0] == 400
    assert text[1]["error"]["reason"] == "bad_request"
    assert unservable[0] == 400  # 49 positions > max_len 48
    assert unservable[1]["error"]["reason"] == "unservable"
    assert nope[0] == 404
    assert metrics[0] == 404     # obs off: no /metrics


# --------------------------------------------------------------------------
# disconnect, saturation, tenants, drain
# --------------------------------------------------------------------------

def _throttled(eng, s=0.02):
    """Slow every tick (not its results), so a client's reset lands while
    its request is still running."""
    step = eng.step
    eng.step = lambda: (time.sleep(s), step())[1]
    return eng


def test_disconnect_reclaims_and_prefix_hot_hits():
    prompts = _prompts(lens=(24,))
    ref = _reference_tokens(prompts, 20)
    obs = Instrumentation(registry=MetricsRegistry())
    eng = _throttled(_engine(prefix_cache=True, obs=obs))

    async def scenario():
        async with _Serve(eng) as srv:
            status, toks, done, _ = await _sse(srv.port, prompts[0], 20,
                                               kill_after=2)
            assert status == 200 and not done and len(toks) >= 2
            snap = await srv.until_cancelled(1)
            assert snap["live_handles"] == 0
            held = await _w(asyncio.wrap_future(
                srv.bridge.call(lambda e: e.cache.cached_blocks())))
            assert snap["pool_free_blocks"] + held == \
                snap["pool_total_blocks"]
            _, toks2, done2, _ = await _sse(srv.port, prompts[0], 20)
            metrics = await _get(srv.port, "/metrics")
            return toks2, done2, await srv.snapshot(), metrics

    toks2, done2, snap2, metrics = _run(scenario())
    assert done2 and toks2 == ref[0]
    assert snap2["stats"]["prefix_hits"] >= 1
    assert snap2["stats"]["prefill_skipped_tokens"] > 0
    assert "disconnected" in [t.state for t in obs.trace_sink.traces]
    assert obs.registry.value("serve_cancellations_total", engine=obs.engine_label,
                              reason="disconnected") == 1
    assert metrics[0] == 200 and b"serve_frontend_streamed_tokens_total" in \
        metrics[1]


def test_queue_saturation_429_with_retry_after():
    prompts = _prompts(lens=(9,) * 12)
    obs = Instrumentation(registry=MetricsRegistry())
    eng = _engine(n_slots=1, max_queue=2, obs=obs)

    async def scenario():
        async with _Serve(eng) as srv:
            res = await _w(asyncio.gather(
                *[_sse(srv.port, p, 8) for p in prompts]))
            assert srv.bridge.error is None
            return res, (await _get(srv.port, "/metrics"))[1].decode()

    res, text = _run(scenario())
    ok = [r for r in res if r[0] == 200]
    rejected = [r for r in res if r[0] == 429]
    assert len(ok) + len(rejected) == len(res)
    assert all(done and len(toks) == 8 for _, toks, done, _ in ok)
    assert ok and rejected
    assert eng.stats["rejected"] == len(rejected)
    want = (f'serve_rejections_total{{engine="{obs.engine_label}",'
            f'reason="queue_full"}} {len(rejected)}')
    assert want in text.splitlines()


def test_backpressure_429_carries_retry_hint():
    async def scenario():
        async with _Serve(_engine(), FrontendConfig(max_inflight=0)) as srv:
            return await _post(srv.port, "/v1/completions",
                               {"prompt": [1, 2, 3], "max_tokens": 4})

    status, body, hdrs = _run(scenario())
    assert status == 429 and body["error"]["reason"] == "backpressure"
    assert float(hdrs["retry-after"]) > 0 and body["error"]["retry_after_s"] > 0


def test_tenant_budget_exhaustion():
    fc = FrontendConfig(tenants={"acme": TenantQuota(token_budget=30)})
    prompt = _prompts(lens=(9,))[0]   # 9 + 6 = 15 tokens: two fit

    async def scenario():
        async with _Serve(_engine(), fc) as srv:
            out = [await _post(srv.port, "/v1/completions",
                               {"prompt": prompt, "max_tokens": 6},
                               headers={"x-tenant": "acme"})
                   for _ in range(3)]
            other = await _post(srv.port, "/v1/completions",
                                {"prompt": prompt, "max_tokens": 6})
            return out, other, await _get(srv.port, "/v1/stats")

    out, other, (st, payload, _) = _run(scenario())
    assert [r[0] for r in out] == [200, 200, 429]
    assert out[2][1]["error"]["reason"] == "budget_exhausted"
    assert "retry-after" not in out[2][2]
    assert other[0] == 200 and st == 200
    assert json.loads(payload)["tenant_tokens_spent"]["acme"] == 30


def test_token_bucket_refills_on_the_clock():
    clock = FakeClock()
    bucket = _TokenBucket(TenantQuota(rate_rps=2.0, burst=1), clock)
    assert bucket.try_take() and not bucket.try_take()
    clock.advance(0.5)            # 2 rps: one token back after 0.5 s
    assert bucket.try_take() and not bucket.try_take()


def test_rate_limited_request_rejected():
    fc = FrontendConfig(default_quota=TenantQuota(rate_rps=1e-9, burst=1))
    prompt = _prompts(lens=(9,))[0]

    async def scenario():
        async with _Serve(_engine(), fc) as srv:
            return [await _post(srv.port, "/v1/completions",
                                {"prompt": prompt, "max_tokens": 4})
                    for _ in range(2)]

    r1, r2 = _run(scenario())
    assert r1[0] == 200
    assert r2[0] == 429 and r2[1]["error"]["reason"] == "rate_limited"


def test_drain_under_load():
    prompts = _prompts(lens=(9, 13))
    ref = _reference_tokens(prompts, 8)
    obs = Instrumentation(registry=MetricsRegistry())
    eng = _engine(obs=obs)

    async def scenario():
        async with _Serve(eng) as srv:
            b = srv.bridge
            handles = [await _w(asyncio.wrap_future(
                b.submit(p, 8, track_visibility=False))) for p in prompts]
            while not any(h.tokens for h in handles):
                await asyncio.sleep(0.005)
            status, body, _ = await _post(srv.port, "/admin/drain", {})
            assert status == 202 and body["draining"] is True
            st2, body2, hdrs2 = await _post(
                srv.port, "/v1/completions",
                {"prompt": prompts[0], "max_tokens": 4})
            assert st2 == 503 and body2["error"]["reason"] == "draining"
            assert "retry-after" in hdrs2
            await _w(asyncio.get_running_loop().run_in_executor(
                None, b.drained.wait, WAIT_S))
            assert b.drained.is_set()
            assert all(h.done and h.state == H_RETIRED for h in handles)
            health = await _get(srv.port, "/healthz")
            await _post(srv.port, "/admin/undrain", {})
            st3, _, _ = await _post(srv.port, "/v1/completions",
                                    {"prompt": prompts[0], "max_tokens": 2})
            return [h.tokens for h in handles], health, st3

    toks, (hst, hbody, _), st3 = _run(scenario())
    assert toks == ref
    assert hst == 200 and json.loads(hbody)["status"] == "draining"
    assert st3 == 200
    assert "drained" in [t.state for t in obs.trace_sink.traces]


# --------------------------------------------------------------------------
# visibility timeout (fake clock, the bridge driven unstarted)
# --------------------------------------------------------------------------

def test_visibility_requeue_and_exact_resume():
    prompts = _prompts(lens=(24,))
    ref = _reference_tokens(prompts, 10)
    clock = FakeClock()
    obs = Instrumentation(registry=MetricsRegistry())
    eng = _engine(prefix_cache=True, obs=obs, clock=clock)
    bridge = EngineBridge(eng, visibility_timeout_s=5.0)
    assert bridge.clock is clock
    fut = bridge.submit(prompts[0], 10)
    bridge._drain_commands()
    h = fut.result(timeout=WAIT_S)
    while len(h.tokens) < 2:
        eng.step()
    first, _, _, _ = h.read_new()
    assert first == ref[0][:len(first)]
    while len(h.tokens) < 4:
        eng.step()
    clock.advance(60.0)  # silent with unread tokens, past the timeout
    bridge._check_visibility(clock())
    assert h.state == H_REQUEUED and h.requeues == 1
    assert eng.stats["cancelled"] == 1 and not eng.has_work()
    rfut = bridge.resume(h)
    bridge._drain_commands()
    assert rfut.result(timeout=WAIT_S) is h
    skipped = eng.stats["prefill_skipped_tokens"]
    while eng.has_work():
        eng.step()
    assert h.state == H_RETIRED and h.tokens == ref[0]
    rest, state, result, _ = h.read_new()
    assert first + rest == ref[0] and state == H_RETIRED
    assert result.tokens == ref[0][-len(result.tokens):]
    assert eng.stats["prefill_skipped_tokens"] > skipped
    assert "requeued" in [t.state for t in obs.trace_sink.traces]


def test_caught_up_consumer_is_never_requeued():
    clock = FakeClock()
    eng = _engine(clock=clock)
    bridge = EngineBridge(eng, visibility_timeout_s=5.0)
    fut = bridge.submit(_prompts(lens=(9,))[0], 6)
    bridge._drain_commands()
    h = fut.result(timeout=WAIT_S)
    while len(h.tokens) < 2:
        eng.step()
    h.read_new()  # fully caught up: waiting, not stalled
    clock.advance(1000.0)
    bridge._check_visibility(clock())
    assert h.state != H_REQUEUED and eng.stats["cancelled"] == 0
    while eng.has_work():
        eng.step()
    assert h.state == H_RETIRED


# --------------------------------------------------------------------------
# the hook, the unported pair, the entry point, the library lock
# --------------------------------------------------------------------------

def test_token_hook_streams_every_token_in_order():
    prompts = _prompts(lens=(9, 13))
    ref = _reference_tokens(prompts, 6)
    calls = []
    eng = _engine(token_hook=lambda req, new, res: calls.append(
        (req.req_id, list(new), res)))
    ids = [eng.submit(Request(list(p), 6)) for p in prompts]
    run_res = {r.req_id: r for r in eng.run()}
    for i, rid in enumerate(ids):
        mine = [(new, res) for r, new, res in calls if r == rid]
        assert [t for new, _ in mine for t in new] == ref[i] == \
            run_res[rid].tokens
        assert mine[-1][1] is run_res[rid]
        assert all(res is None for _, res in mine[:-1])


def test_engine_thread_fault_fails_handles_and_commands():
    """A fault on the engine thread errors every live handle and fails each
    later command's future: a caller sees the fault, never a hang."""
    eng = _engine()

    def boom():
        raise RuntimeError("injected step fault")

    eng.step = boom
    with EngineBridge(eng) as bridge:
        h = bridge.submit(_prompts(lens=(9,))[0], 4).result(timeout=WAIT_S)
        deadline = time.monotonic() + WAIT_S
        while bridge.error is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert isinstance(bridge.error, RuntimeError)
        assert h.state == pfrontend.H_ERRORED and h.done
        with pytest.raises(RuntimeError, match="engine thread failed"):
            bridge.snapshot().result(timeout=WAIT_S)


def test_launch_serve_http_entry_point():
    """`python -m repro_torch.launch.serve --device cpu --reduced --http 0
    --obs`: prints the bound port, serves a completion and /metrics, and
    exits on SIGINT."""
    env = dict(os.environ)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--reduced", "--http", "0", "--obs", "--scheme", "bf16"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
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


def test_library_builds_and_loads_once_across_threads(monkeypatch, tmp_path):
    builds, loads = [], []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a slow build: every thread arrives meanwhile
        return tmp_path / "lib.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: loads.append(path) or FakeLib())
    gate = threading.Barrier(8)
    got = []

    def first_launch():
        gate.wait(timeout=WAIT_S)
        got.append(build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert len(builds) == 1 and len(loads) == 1
    assert got[0].fp4_matmul_launch.restype is build.ctypes.c_int


# --------------------------------------------------------------------------
# one scripted exchange against both frontends
# --------------------------------------------------------------------------

def _exchange(frontend, engine):
    """A streamed request of tenant "slow" (1 request a second, burst 1),
    a second one of it (429, rate limited), a drain, a completion while
    draining (503). Returns what the comparison reads."""
    fc = frontend.FrontendConfig(
        tenants={"slow": frontend.TenantQuota(rate_rps=1.0, burst=1)})
    prompt = np.random.RandomState(0).randint(0, _CFG.vocab, 19).tolist()

    async def scenario():
        async with _Serve(engine, fc, frontend=frontend) as srv:
            streamed = await _sse(srv.port, prompt, 6, tenant="slow")
            limited = await _post(srv.port, "/v1/completions",
                                  {"prompt": prompt, "max_tokens": 6,
                                   "user": "slow"})
            drain = await _post(srv.port, "/admin/drain", {})
            closed = await _post(srv.port, "/v1/completions",
                                 {"prompt": prompt, "max_tokens": 6})
            return streamed, limited, drain, closed

    streamed, limited, drain, closed = _run(scenario())
    status, toks, done, events = streamed
    out = {"stream": (status, toks, done,
                      [sorted(ev) for ev in events],
                      sorted(events[-1]["usage"].items()))}
    for name, (st, body, hdrs) in (("limited", limited), ("drain", drain),
                                   ("closed", closed)):
        out[name] = (st, hdrs.get("retry-after"), hdrs.get("content-type"),
                     sorted(body), sorted(body.get("error", {})),
                     body.get("error", {}).get("reason"))
    return out


def test_scripted_exchange_equals_reference():
    jcfg = jregistry.get("llama_200m").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), _CFG, "cpu")
    ref = _exchange(jfrontend, jengine.ServeEngine(
        jcfg, jparams, jengine.EngineConfig(scheme="bf16", clock=FakeClock(),
                                            **KW)))
    port = _exchange(pfrontend, ServeEngine(_CFG, params, EngineConfig(
        device="cpu", scheme="bf16", clock=FakeClock(), **KW)))
    assert port == ref
    assert port["stream"][0] == 200 and len(port["stream"][1]) == 6
    assert port["limited"][:2] == (429, "1.000")
    assert port["closed"][0] == 503 and port["closed"][1] == "0.500"
    assert issubclass(pfrontend.QueueFull, QueueFull)
