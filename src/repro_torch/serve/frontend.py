"""Async streaming frontend: OpenAI-style /v1/completions over SSE, backed
by a ServeEngine ticking on a thread of its own.

Counterpart of `repro/serve/frontend.py`. Two layers, one thread boundary:

  EngineBridge        owns the ENGINE THREAD. All engine, pool, cache and
                      scheduler state is touched from that thread only: the
                      tick loop runs there, and every outside mutation
                      (submit, cancel, resume, drain, stats snapshot)
                      arrives as a closure on a command queue, run between
                      ticks. Results travel back on
                      concurrent.futures.Future. Per-request StreamHandle
                      objects are the read side: internally locked, safe
                      from any thread, woken across threads through
                      `loop.call_soon_threadsafe`. On a card every kernel
                      the engine launches is launched from this thread, on
                      its current stream (the device's default stream:
                      nothing in the engine sets a side stream).

  CompletionFrontend  the asyncio side: an HTTP/1.1 server on stdlib
                      asyncio alone, serving `POST /v1/completions` with
                      per-token SSE streaming, plus /metrics, /healthz,
                      /v1/stats and /admin/drain. It never touches the
                      engine directly.

Request lifecycle:

    queued ──first token──▶ streaming ──▶ retired
      │                        │ ├─ cancelled    (client asked / shutdown)
      │                        │ ├─ disconnected (client vanished mid-read)
      │                        │ └─ requeued ──resume──▶ streaming
      └─ rejected (backpressure / rate limit / budget / drain / unservable)

  * Disconnect: an EOF watcher on the client socket and write errors both
    end in `engine.cancel(reason="disconnected")`, the engine's
    cache-insert-then-release path: the tokens already paid for stay in the
    prefix cache and a follow-up request hot-hits them.
  * Backpressure: admission is bounded (`max_inflight`, the engine's
    `max_queue`); a rejection is HTTP 429 with a Retry-After from the
    queue depth over the observed decode rate
    (ServeEngine.suggested_retry_after_s, QueueFull.retry_after_s).
  * Visibility timeout: a consumer that stops READING (unread tokens older
    than `visibility_timeout_s`) has its engine request cancelled
    (reason="requeued", prefix cached) and its handle parked, so the slot
    goes to someone live. When the consumer reads again the frontend
    resumes it: prompt + generated-so-far is resubmitted with the remaining
    budget; the prefix cache makes the catch-up prefill nearly free, and a
    greedy bf16 stream continues bitwise.
  * Drain: maintenance mode finishes all in-flight work while rejecting new
    arrivals with 503 + Retry-After; `drained` is observable (an event and
    a trace marker) so a restart can wait for it.

Token budgets and rate limits are per tenant (`x-tenant` header, or the
body's `user` field): a token bucket on request admission and a lifetime
prompt + max_new token budget, both charged at admission, so a rejected
request costs nothing.

`EnginePair` (built by `make_disagg_pair`) is the disaggregated
prefill/decode deployment: two role-split ServeEngines behind the engine
surface the bridge drives, so the whole stack above serves a pair
unchanged.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import queue as queue_mod
import threading
from collections.abc import MutableMapping
from dataclasses import dataclass, field, replace

import torch

from repro_torch.serve.engine import (EngineConfig, QueueFull, Request,
                                      ServeEngine, Unservable)
from repro_torch.serve.sampling import SamplingParams

#: StreamHandle lifecycle states (the module docstring's diagram)
H_QUEUED, H_STREAMING, H_REQUEUED = "queued", "streaming", "requeued"
H_RETIRED, H_CANCELLED, H_REJECTED = "retired", "cancelled", "rejected"
H_ERRORED = "errored"
TERMINAL = frozenset({H_RETIRED, H_CANCELLED, H_REJECTED, H_ERRORED})


class StreamHandle:
    """Per-request seam between the engine thread (producer) and one
    consumer coroutine/thread. Internally locked; every field mutation
    happens under `_lock`, and the registered waker is invoked OUTSIDE it
    (a waker that re-enters read_new must not deadlock)."""

    def __init__(self, bridge: "EngineBridge", prompt: list[int],
                 max_new: int, sampling: SamplingParams, tenant: str,
                 track_visibility: bool):
        self._bridge = bridge
        self._lock = threading.Lock()
        self._waker = None
        self.prompt = list(prompt)
        self.max_new = max_new
        self.sampling = sampling
        self.tenant = tenant
        self.track_visibility = track_visibility
        self.req_id = -1          # CURRENT engine req id (changes on resume)
        self.tokens: list[int] = []   # everything generated, across requeues
        self._read_pos = 0
        self.state = H_QUEUED
        self.result = None        # final RequestResult (last leg's)
        self.error: BaseException | None = None
        self.last_read_s = bridge.clock()
        self.requeues = 0
        self.stream_opened = False    # `streamed` span/gauge open (engine thr)

    # ---- consumer side ---------------------------------------------------

    def read_new(self):
        """Drain un-read tokens; returns (new_tokens, state, result, error).
        Stamps `last_read_s` — the liveness signal the visibility-timeout
        reaper checks. Safe from any thread."""
        with self._lock:
            new = self.tokens[self._read_pos:]
            self._read_pos = len(self.tokens)
            self.last_read_s = self._bridge.clock()
            return new, self.state, self.result, self.error

    def set_waker(self, cb) -> None:
        """Register (replace) the callback invoked after every state/token
        update. For asyncio consumers: `loop.call_soon_threadsafe(evt.set)`
        — the waker itself must be cheap and non-blocking."""
        with self._lock:
            self._waker = cb

    @property
    def done(self) -> bool:
        with self._lock:
            return self.state in TERMINAL

    # ---- engine-thread side ----------------------------------------------

    def _push(self, new: list[int]) -> None:
        with self._lock:
            if new:
                self.tokens.extend(new)
                if self.state == H_QUEUED:
                    self.state = H_STREAMING
            waker = self._waker
        if waker is not None:
            waker()

    def _unread_age_s(self, now: float) -> float | None:
        """Seconds the oldest unread token has waited, or None when the
        consumer is fully caught up (then it is WAITING, not stalled)."""
        with self._lock:
            if (not self.track_visibility or self.state in TERMINAL
                    or self.state == H_REQUEUED
                    or self._read_pos >= len(self.tokens)):
                return None
            return now - self.last_read_s

    def _transition(self, state: str, result=None,
                    error: BaseException | None = None,
                    new: list[int] | None = None) -> None:
        with self._lock:
            if self.state in TERMINAL:
                return
            if new:
                self.tokens.extend(new)
            self.state = state
            if result is not None:
                self.result = result
            if error is not None:
                self.error = error
            if state == H_REQUEUED:
                self.requeues += 1
                self.req_id = -1
            waker = self._waker
        if waker is not None:
            waker()


class EngineBridge:
    """Thread-safe submit/poll/cancel boundary around a ServeEngine.

    Owns the engine tick thread: `start()` spawns it, after which nothing
    outside that thread may call engine methods directly. Use `submit`,
    `cancel`, `resume`, `drain` or `call`: each enqueues a closure the tick
    loop runs between steps, resolving a Future. The engine never learns
    it is driven across a thread."""

    def __init__(self, engine: ServeEngine,
                 visibility_timeout_s: float | None = 30.0,
                 idle_wait_s: float = 0.02):
        self.engine = engine
        self.clock = engine.clock
        # the card the engine's tensors live on ("cuda" alone: the current
        # device of the thread building the bridge, as of the engine's)
        dev = getattr(engine, "device", None)
        self._cuda_index = (
            None if dev is None or dev.type != "cuda"
            else dev.index if dev.index is not None
            else torch.cuda.current_device())
        self.obs = engine.obs
        self.visibility_timeout_s = visibility_timeout_s
        self.idle_wait_s = idle_wait_s
        engine.token_hook = self._on_tokens
        self._cmds: queue_mod.Queue = queue_mod.Queue()
        self._by_req: dict[int, StreamHandle] = {}
        self._thread: threading.Thread | None = None
        self._stop = False
        self.draining = False
        self._drain_marked = False
        self.drained = threading.Event()
        self.error: BaseException | None = None
        #: last tick's backpressure hint (engine thread writes, any thread
        #: reads — a float rebind is atomic under the GIL)
        self.retry_hint_s = 1.0

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "EngineBridge":
        assert self._thread is None, "bridge already started"
        self._thread = threading.Thread(target=self._run,
                                        name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the tick loop (in-flight handles are failed, not drained —
        use `drain()` first for a graceful shutdown)."""
        if self._thread is None:
            return
        self._stop = True
        self._cmds.put(lambda: None)  # wake an idle loop
        self._thread.join(timeout=30.0)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- engine thread ---------------------------------------------------

    def _run(self) -> None:
        eng = self.engine
        try:
            if self._cuda_index is not None:
                # the current device is per thread: launch on the engine's
                torch.cuda.set_device(self._cuda_index)
            while not self._stop:
                self._drain_commands()
                if self._stop:
                    break
                if eng.has_work():
                    eng.step()
                    self._check_visibility(self.clock())
                    self.retry_hint_s = eng.suggested_retry_after_s()
                else:
                    if self.draining and not self._drain_marked:
                        # every in-flight request has completed; mark once
                        self._drain_marked = True
                        if self.obs.enabled:
                            self.obs.on_drain(self.clock())
                        self.drained.set()
                    try:
                        cmd = self._cmds.get(timeout=self.idle_wait_s)
                    except queue_mod.Empty:
                        continue
                    self._exec(cmd)
        except BaseException as e:  # engine-thread fault: fail everything
            self.error = e
            for h in list(self._by_req.values()):
                self._close_stream(h)
                h._transition(H_ERRORED, error=e)
            self._by_req.clear()
            # keep servicing the command queue in failed mode: each command
            # sees `self.error` and fails its future immediately, so
            # callers get the fault instead of a hung await
            while not self._stop:
                try:
                    cmd = self._cmds.get(timeout=self.idle_wait_s)
                except queue_mod.Empty:
                    continue
                cmd()

    def _drain_commands(self) -> None:
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue_mod.Empty:
                return
            self._exec(cmd)

    @staticmethod
    def _exec(cmd) -> None:
        # commands resolve their own futures; a raising command is a bug
        # in the bridge itself, so let it propagate to the fault handler
        cmd()

    def _on_tokens(self, req, new, result) -> None:
        """EngineConfig.token_hook: runs inside engine.step() on the engine
        thread. Routes the flush to the owning handle; unknown req_ids
        (direct engine use, already-requeued legs) are ignored."""
        h = self._by_req.get(req.req_id)
        if h is None:
            return
        if new and not h.stream_opened:
            h.stream_opened = True
            if self.obs.enabled:
                self.obs.on_stream_open(req, self.clock())
        if new and self.obs.enabled:
            self.obs.on_stream_tokens(len(new))
        if result is not None:
            self._by_req.pop(req.req_id, None)
            self._close_stream(h)
            h._transition(H_RETIRED, result=result, new=new)
        else:
            h._push(new)

    def _close_stream(self, h: StreamHandle) -> None:
        if h.stream_opened:
            h.stream_opened = False
            if self.obs.enabled:
                self.obs.on_stream_close()

    def _check_visibility(self, now: float) -> None:
        """Requeue handles whose consumer stopped reading: cancel the
        engine request (prefix cached — the work is NOT thrown away) and
        park the handle. The freed slot goes to a live consumer; the
        stalled one resumes from its cached prefix if it ever returns."""
        vt = self.visibility_timeout_s
        if vt is None:
            return
        for rid, h in list(self._by_req.items()):
            age = h._unread_age_s(now)
            if age is not None and age > vt:
                self.engine.cancel(rid, reason="requeued")
                self._by_req.pop(rid, None)
                self._close_stream(h)
                h._transition(H_REQUEUED)

    # ---- commands (any thread; executed on the engine thread) -----------

    def _command(self, fn) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def cmd():
            if self.error is not None:
                fut.set_exception(RuntimeError(
                    f"engine thread failed: {self.error!r}"))
                return
            try:
                fut.set_result(fn())
            except BaseException as e:
                fut.set_exception(e)

        self._cmds.put(cmd)
        return fut

    def call(self, fn) -> concurrent.futures.Future:
        """Run `fn(engine)` on the engine thread; Future of its result.
        The sanctioned way to read engine/pool/cache state from outside."""
        return self._command(lambda: fn(self.engine))

    def submit(self, prompt: list[int], max_new: int,
               sampling: SamplingParams | None = None,
               tenant: str = "default", priority: int = 0,
               deadline_s: float | None = None,
               track_visibility: bool = True) -> concurrent.futures.Future:
        """Future[StreamHandle]; raises (through the future) QueueFull /
        Unservable with structured retry info, or QueueFull("draining")
        while the bridge drains."""
        h = StreamHandle(self, prompt, max_new,
                         sampling or SamplingParams(), tenant,
                         track_visibility)

        def do():
            if self.draining:
                raise QueueFull("draining: not accepting new work",
                                reason="draining",
                                queue_depth=len(self.engine.queue),
                                retry_after_s=self.retry_hint_s)
            rid = self.engine.submit(Request(
                prompt=list(h.prompt), max_new=h.max_new,
                sampling=h.sampling, priority=priority,
                deadline_s=deadline_s))
            h.req_id = rid
            self._by_req[rid] = h
            return h

        return self._command(do)

    def cancel(self, h: StreamHandle,
               reason: str = "cancelled") -> concurrent.futures.Future:
        """Future[bool]: cancel a handle's engine request (prefix cached)
        and finish the handle. `reason` "disconnected" keeps its own
        terminal span; a parked (requeued) handle just finishes."""
        state = H_CANCELLED

        def do():
            if h.state in TERMINAL:
                return False
            if h.req_id >= 0:
                self.engine.cancel(h.req_id, reason=reason)
                self._by_req.pop(h.req_id, None)
            self._close_stream(h)
            h._transition(state)
            return True

        return self._command(do)

    def resume(self, h: StreamHandle) -> concurrent.futures.Future:
        """Future[StreamHandle]: resubmit a REQUEUED handle as
        prompt + generated-so-far with the remaining token budget — the
        prefix cache absorbs the catch-up prefill. No-op for non-parked
        handles; finishes the handle directly when nothing remains."""

        def do():
            if h.state != H_REQUEUED:
                return h
            remaining = h.max_new - len(h.tokens)
            if remaining <= 0:
                h._transition(H_RETIRED)
                return h
            if self.draining:
                h._transition(H_CANCELLED)
                return h
            rid = self.engine.submit(Request(
                prompt=h.prompt + h.tokens, max_new=remaining,
                sampling=h.sampling))
            h.req_id = rid
            self._by_req[rid] = h
            with h._lock:
                h.state = H_QUEUED if not h.tokens else H_STREAMING
            return h

        return self._command(do)

    def drain(self) -> concurrent.futures.Future:
        """Enter maintenance mode: new submits rejected (QueueFull reason
        "draining"), in-flight work runs to completion, then `drained` is
        set and the obs layer records the `drained` marker."""

        def do():
            self.draining = True
            if not self.engine.has_work() and not self._drain_marked:
                self._drain_marked = True
                if self.obs.enabled:
                    self.obs.on_drain(self.clock())
                self.drained.set()
            return True

        return self._command(do)

    def undrain(self) -> concurrent.futures.Future:
        def do():
            self.draining = False
            self._drain_marked = False
            self.drained.clear()
            return True

        return self._command(do)

    def snapshot(self) -> concurrent.futures.Future:
        """Future[dict]: engine stats + occupancy, read on the engine
        thread (so never torn by a concurrent tick)."""

        def do():
            eng = self.engine
            return {
                "stats": dict(eng.stats),
                "queue_depth": len(eng.queue),
                "free_slots": eng.free_slots,
                "pool_free_blocks": eng.pool.free_block_count,
                "pool_total_blocks": eng.pool.n_blocks,
                "live_handles": len(self._by_req),
                "draining": self.draining,
                "retry_after_s": eng.suggested_retry_after_s(),
            }

        return self._command(do)


# ---------------------------------------------------------------------------
# disaggregated prefill/decode
# ---------------------------------------------------------------------------


class _PairStats(MutableMapping):
    """Merged `engine.stats` over a (prefill, decode) pair: a read SUMS the
    two engines' counters (ticks and prefill_* live on the prefill worker,
    decode_* and finished on the decode worker: the sum is what a
    single-engine caller expects); a write puts the value on the prefill
    view and zero on the decode one, so reset loops (`stats[k] = 0`) and
    absolute assignments read back unchanged."""

    __slots__ = ("_p", "_d")

    def __init__(self, p, d):
        self._p = p
        self._d = d

    def __getitem__(self, k):
        return self._p[k] + self._d[k]

    def __setitem__(self, k, v):
        self._p[k] = v
        self._d[k] = v * 0  # 0 or 0.0, the key's type

    def __delitem__(self, k):
        raise TypeError("engine.stats has a fixed key set")

    def __iter__(self):
        return iter(self._p)

    def __len__(self):
        return len(self._p)

    def __repr__(self):
        return repr(dict(self))


class EnginePair:
    """Disaggregated prefill/decode: two role-split ServeEngines behind the
    engine surface EngineBridge drives (submit / cancel / step / has_work /
    run / stats / queue / pool / cache / free_slots / token_hook / clock /
    obs / suggested_retry_after_s), so the bridge, SSE streaming, the
    visibility timeout and drain work over a split deployment unchanged.

    One pair `step()` is one tick of EACH worker: finished prefills cross
    the role boundary first (`prefill.handoffs` -> `decode.submit_handoff`;
    the KV travels as host payloads), then the decode worker ticks, then
    the prefill worker. The decode worker never runs a prefill chunk, so
    its per-token gap does not grow with the prompts arriving at the
    prefill worker. Both engines tick serially on one thread (the bridge's,
    or the caller's), which is what orders every copy of a handoff on that
    thread's current CUDA stream (`serve/engine.py`).

    Cancel finds a request wherever it lives (the prefill queue or slots,
    the in-transit handoffs, the decode worker's handoff queue or slots) and
    reclaims that side's pool state and payloads, so both pools are
    conserved; `has_work` covers both workers and the in-transit handoffs,
    so a drain completes every leg."""

    def __init__(self, prefill: ServeEngine, decode: ServeEngine):
        if prefill.role != "prefill" or decode.role != "decode":
            raise ValueError(
                f"EnginePair wants roles ('prefill', 'decode'), got "
                f"({prefill.role!r}, {decode.role!r})")
        if prefill.clock is not decode.clock:
            raise ValueError(
                "role-split engines must share one clock: arrival stamps "
                "taken on the prefill worker are compared against deadlines "
                "and visibility timeouts on the decode side")
        self.prefill = prefill
        self.decode = decode
        self.clock = prefill.clock
        self.obs = prefill.obs
        self._stats = _PairStats(prefill.stats, decode.stats)

    # ---- the engine surface the bridge drives ----

    @property
    def stats(self):
        return self._stats

    @property
    def queue(self):
        """The admission queue: the prefill worker's (submits land there)."""
        return self.prefill.queue

    @property
    def pool(self):
        """The decode worker's pool, where live sequences sit (the bridge's
        snapshot reports its occupancy)."""
        return self.decode.pool

    @property
    def cache(self):
        """The prefill worker's prefix cache (matching happens at prompt
        admission; the decode worker imports KV and never matches)."""
        return self.prefill.cache

    @property
    def free_slots(self) -> int:
        return min(self.prefill.free_slots, self.decode.free_slots)

    @property
    def token_hook(self):
        return self.prefill.token_hook

    @token_hook.setter
    def token_hook(self, fn) -> None:
        # the prefill worker emits each request's first token, the decode
        # worker the rest; req_id survives the handoff, so the bridge's
        # routing by id sees one stream
        self.prefill.token_hook = fn
        self.decode.token_hook = fn

    def submit(self, request: Request) -> int:
        return self.prefill.submit(request)

    def cancel(self, req_id: int, reason: str = "cancelled") -> bool:
        """Cancel wherever the request lives. A handoff caught in transit is
        dropped and its payloads' buffers returned: the prefill worker
        released its blocks at export and the decode worker allocated
        none."""
        if self.prefill.cancel(req_id, reason=reason):
            return True
        for h in self.prefill.handoffs:
            if h.req.req_id == req_id:
                self.prefill.handoffs.remove(h)
                h.release_payloads()
                self.prefill.stats["cancelled"] += 1
                if self.obs.enabled:
                    self.obs.on_cancel(h.req, self.clock(), reason=reason)
                return True
        return self.decode.cancel(req_id, reason=reason)

    def has_work(self) -> bool:
        return (self.prefill.has_work() or bool(self.prefill.handoffs)
                or self.decode.has_work())

    def suggested_retry_after_s(self) -> float:
        # the decode worker owns the generated-token backlog estimate; the
        # prefill worker's is the 1.0 floor (it never decodes)
        return max(self.prefill.suggested_retry_after_s(),
                   self.decode.suggested_retry_after_s())

    def step(self):
        # ship last tick's exports first, so they admit into decode slots
        # this tick
        while self.prefill.handoffs:
            self.decode.submit_handoff(self.prefill.handoffs.popleft())
        finished = []
        if self.decode.has_work():
            finished.extend(self.decode.step())
        if self.prefill.has_work():
            finished.extend(self.prefill.step())
        return finished

    def run(self):
        """Drain both workers; results in completion order."""
        out = []
        while self.has_work():
            out.extend(self.step())
        return out


def make_disagg_pair(cfg, params, econf: EngineConfig) -> EnginePair:
    """A prefill/decode EnginePair from one EngineConfig.

    The prefill worker takes `econf` with role "prefill" (admission, the
    prefix cache, the caller's obs); the decode worker reuses the prefill
    worker's (packed) `params`, so one set of weights serves both, with
    role "decode", no prefix cache (it admits Handoffs, never prompts) and
    no obs. Both share the prefill worker's clock. Raises what a role-split
    ServeEngine raises (a paged pool, no window reclamation, recurrent state
    or spec_k)."""
    pe = ServeEngine(cfg, params, replace(econf, role="prefill"))
    de = ServeEngine(cfg, pe.params, replace(
        econf, role="decode", prequant=False, obs=None,
        prefix_cache=False, prefix_spill=False, replicate_hits=None))
    return EnginePair(pe, de)


# ---------------------------------------------------------------------------
# tenant quotas
# ---------------------------------------------------------------------------


@dataclass
class TenantQuota:
    """Per-tenant admission limits, both enforced up front (a rejected
    request consumes neither)."""

    rate_rps: float = float("inf")  # request admissions per second
    burst: int = 8                  # token-bucket capacity
    token_budget: int | None = None  # lifetime prompt+max_new tokens


class _TokenBucket:
    """Classic token bucket on the bridge's injectable clock — rate-limit
    tests drive it with a fake clock, no sleeps."""

    def __init__(self, quota: TenantQuota, clock):
        self.rate = quota.rate_rps
        self.capacity = max(quota.burst, 1)
        self.tokens = float(self.capacity)
        self.clock = clock
        self.last = clock()

    def try_take(self) -> bool:
        now = self.clock()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class FrontendConfig:
    host: str = "127.0.0.1"
    port: int = 0                  # 0: ephemeral (read back from .port)
    max_inflight: int = 64         # admitted-but-unfinished handle cap
    default_quota: TenantQuota = field(default_factory=TenantQuota)
    tenants: dict = field(default_factory=dict)  # tenant -> TenantQuota
    #: safety re-check period while awaiting tokens (a lost waker never
    #: wedges a stream, it just degrades to polling at this period)
    stream_wait_s: float = 1.0


# ---------------------------------------------------------------------------
# HTTP frontend
# ---------------------------------------------------------------------------

_JSON = {"Content-Type": "application/json"}


class CompletionFrontend:
    """OpenAI-style /v1/completions over hand-rolled HTTP/1.1 + SSE.

    Endpoints:
      POST /v1/completions   {"prompt": [ints], "max_tokens": n,
                              "temperature": f, "top_k": k,
                              "stream": bool, "user": tenant}
                             SSE (`stream: true`): one `data:` JSON event
                             per token flush, a final event with `usage`,
                             then `data: [DONE]`.
      GET  /healthz          liveness + drain state
      GET  /v1/stats         engine snapshot (read on the engine thread)
      GET  /metrics          Prometheus text (404 when obs is disabled)
      POST /admin/drain      enter maintenance mode; /admin/undrain exits

    Tenancy: `x-tenant` header, else the body's `user` field, else
    "default". All frontend-side accounting (buckets, budgets, inflight)
    lives on the asyncio thread — no locks needed."""

    def __init__(self, bridge: EngineBridge,
                 fconf: FrontendConfig | None = None):
        self.bridge = bridge
        self.fc = fconf or FrontendConfig()
        self.obs = bridge.obs
        self._buckets: dict[str, _TokenBucket] = {}
        self._spent: dict[str, int] = {}
        self._inflight = 0
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    # ---- lifecycle -------------------------------------------------------

    async def start(self) -> "CompletionFrontend":
        self._server = await asyncio.start_server(
            self._serve_conn, self.fc.host, self.fc.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ---- connection handling --------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, headers, body = req
            if method == "POST" and path == "/v1/completions":
                await self._handle_completion(reader, writer, headers, body)
            elif method == "GET" and path == "/healthz":
                snap = await asyncio.wrap_future(self.bridge.snapshot())
                await self._respond(writer, 200, {
                    "status": "draining" if snap["draining"] else "ok",
                    "inflight": self._inflight,
                    "queue_depth": snap["queue_depth"]})
            elif method == "GET" and path == "/v1/stats":
                snap = await asyncio.wrap_future(self.bridge.snapshot())
                snap["tenant_tokens_spent"] = dict(self._spent)
                await self._respond(writer, 200, snap)
            elif method == "GET" and path == "/metrics":
                if not self.obs.enabled:
                    await self._respond(writer, 404,
                                        {"error": "observability disabled"})
                else:
                    text = self.obs.prometheus().encode()
                    await self._respond_raw(
                        writer, 200, text,
                        {"Content-Type": "text/plain; version=0.0.4"})
            elif method == "POST" and path == "/admin/drain":
                await asyncio.wrap_future(self.bridge.drain())
                await self._respond(writer, 202, {"draining": True})
            elif method == "POST" and path == "/admin/undrain":
                await asyncio.wrap_future(self.bridge.undrain())
                await self._respond(writer, 202, {"draining": False})
            else:
                await self._respond(writer, 404, {"error": "no such route"})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away; per-request cancel paths already ran
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _version = line.decode("latin1").split()
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    @staticmethod
    async def _respond_raw(writer, status: int, payload: bytes,
                           headers: dict) -> None:
        reasons = {200: "OK", 202: "Accepted", 400: "Bad Request",
                   404: "Not Found", 429: "Too Many Requests",
                   500: "Internal Server Error", 503: "Service Unavailable"}
        head = [f"HTTP/1.1 {status} {reasons.get(status, 'OK')}"]
        hdrs = {"Content-Length": str(len(payload)),
                "Connection": "close", **headers}
        head += [f"{k}: {v}" for k, v in hdrs.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
        await writer.drain()

    async def _respond(self, writer, status: int, obj,
                       headers: dict | None = None) -> None:
        await self._respond_raw(writer, status,
                                json.dumps(obj).encode(),
                                {**_JSON, **(headers or {})})

    # ---- admission -------------------------------------------------------

    def _quota(self, tenant: str) -> TenantQuota:
        return self.fc.tenants.get(tenant, self.fc.default_quota)

    def _admit(self, tenant: str, cost: int):
        """Frontend-side admission: returns (reason, retry_after_s) on
        rejection, None when admitted (cost charged)."""
        if self.bridge.draining:
            return "draining", self.bridge.retry_hint_s
        if self._inflight >= self.fc.max_inflight:
            return "backpressure", self.bridge.retry_hint_s
        q = self._quota(tenant)
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = _TokenBucket(q, self.bridge.clock)
        if not bucket.try_take():
            return ("rate_limited",
                    1.0 / q.rate_rps if q.rate_rps > 0 else None)
        if q.token_budget is not None and \
                self._spent.get(tenant, 0) + cost > q.token_budget:
            return "budget_exhausted", None
        self._spent[tenant] = self._spent.get(tenant, 0) + cost
        return None

    async def _handle_completion(self, reader, writer, headers,
                                 body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = spec["prompt"]
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError("prompt must be a non-empty list of "
                                 "token ids (no tokenizer is served)")
            max_new = int(spec.get("max_tokens", 16))
            if max_new <= 0:
                raise ValueError("max_tokens must be >= 1")
            sampling = SamplingParams(
                temperature=float(spec.get("temperature", 0.0)),
                top_k=int(spec.get("top_k", 0)))
            stream = bool(spec.get("stream", False))
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            await self._respond(writer, 400, {"error": {
                "reason": "bad_request", "message": str(e)}})
            return
        tenant = headers.get("x-tenant") or spec.get("user") or "default"

        rejected = self._admit(tenant, len(prompt) + max_new)
        if rejected is not None:
            reason, retry = rejected
            if self.obs.enabled:
                self.obs.on_frontend_reject(reason)
            status = 503 if reason == "draining" else 429
            hdrs = {"Retry-After": f"{retry:.3f}"} if retry else {}
            await self._respond(writer, status, {"error": {
                "reason": reason, "message": f"rejected: {reason}",
                "retry_after_s": retry}}, hdrs)
            return

        try:
            handle = await asyncio.wrap_future(self.bridge.submit(
                prompt, max_new, sampling, tenant=tenant,
                track_visibility=stream))
        except Unservable as e:
            if self.obs.enabled:
                self.obs.on_frontend_reject(e.reason)
            await self._respond(writer, 400, {"error": {
                "message": str(e), **e.info()}})
            return
        except QueueFull as e:
            if self.obs.enabled:
                self.obs.on_frontend_reject(e.reason)
            hdrs = ({"Retry-After": f"{e.retry_after_s:.3f}"}
                    if e.retry_after_s else {})
            await self._respond(writer, 429, {"error": {
                "message": str(e), **e.info()}}, hdrs)
            return

        self._inflight += 1
        try:
            if stream:
                await self._stream_completion(reader, writer, handle)
            else:
                await self._plain_completion(reader, writer, handle)
        finally:
            self._inflight -= 1

    # ---- completion delivery --------------------------------------------

    @staticmethod
    def _watch_disconnect(reader, evt: asyncio.Event, flag: list):
        """Task body: the request is fully read, so any further read
        resolving means the client closed (EOF) or reset — either way the
        consumer is gone."""

        async def watch():
            try:
                await reader.read(1)
            except (ConnectionError, OSError):
                pass
            flag[0] = True
            evt.set()

        return asyncio.create_task(watch())

    def _event(self, handle: StreamHandle, tokens: list[int],
               final: bool) -> bytes:
        obj = {"id": f"cmpl-{handle.req_id}", "object": "text_completion",
               "choices": [{"index": 0, "tokens": tokens,
                            "finish_reason": "length" if final else None}]}
        if final:
            obj["usage"] = {"prompt_tokens": len(handle.prompt),
                            "completion_tokens": len(handle.tokens),
                            "requeues": handle.requeues}
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    async def _pump(self, handle: StreamHandle, evt: asyncio.Event,
                    gone: list, on_tokens) -> str:
        """Shared delivery loop: read new tokens, hand them to `on_tokens`
        (may await/write), resume parked handles, until a terminal state or
        disconnect. Returns the handle's final state ("disconnected" when
        the client vanished first)."""
        while True:
            evt.clear()
            new, state, _result, error = handle.read_new()
            if gone[0] and state not in TERMINAL:
                await asyncio.wrap_future(
                    self.bridge.cancel(handle, reason="disconnected"))
                return "disconnected"
            if new:
                try:
                    await on_tokens(new)
                except (ConnectionError, OSError):
                    await asyncio.wrap_future(
                        self.bridge.cancel(handle, reason="disconnected"))
                    return "disconnected"
            if state == H_REQUEUED:
                # this consumer is demonstrably live again (it is here,
                # reading): resume from the cached prefix
                await asyncio.wrap_future(self.bridge.resume(handle))
                continue
            if state in TERMINAL:
                if error is not None and state == H_ERRORED:
                    raise error
                return state
            try:
                await asyncio.wait_for(evt.wait(), self.fc.stream_wait_s)
            except asyncio.TimeoutError:
                pass  # safety poll; the waker is the fast path

    async def _stream_completion(self, reader, writer,
                                 handle: StreamHandle) -> None:
        loop = asyncio.get_running_loop()
        evt = asyncio.Event()
        gone = [False]
        handle.set_waker(lambda: loop.call_soon_threadsafe(evt.set))
        watcher = self._watch_disconnect(reader, evt, gone)
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Connection: close\r\n\r\n")
        try:
            await writer.drain()

            async def emit(new):
                writer.write(self._event(handle, new, final=False))
                await writer.drain()

            state = await self._pump(handle, evt, gone, emit)
            if state == H_RETIRED:
                writer.write(self._event(handle, [], final=True))
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
        except (ConnectionError, OSError):
            await asyncio.wrap_future(
                self.bridge.cancel(handle, reason="disconnected"))
        finally:
            handle.set_waker(None)
            watcher.cancel()

    async def _plain_completion(self, reader, writer,
                                handle: StreamHandle) -> None:
        loop = asyncio.get_running_loop()
        evt = asyncio.Event()
        gone = [False]
        handle.set_waker(lambda: loop.call_soon_threadsafe(evt.set))
        watcher = self._watch_disconnect(reader, evt, gone)
        try:

            async def absorb(new):
                return None  # tokens accumulate on the handle

            state = await self._pump(handle, evt, gone, absorb)
            if state == H_RETIRED:
                await self._respond(writer, 200, {
                    "id": f"cmpl-{handle.req_id}",
                    "object": "text_completion",
                    "choices": [{"index": 0, "tokens": handle.tokens,
                                 "finish_reason": "length"}],
                    "usage": {"prompt_tokens": len(handle.prompt),
                              "completion_tokens": len(handle.tokens),
                              "requeues": handle.requeues}})
            elif state != "disconnected":
                await self._respond(writer, 500, {"error": {
                    "reason": state, "message": f"request {state}"}})
        finally:
            handle.set_waker(None)
            watcher.cancel()


def serve_forever(engine: ServeEngine, fconf: FrontendConfig | None = None,
                  on_ready=None) -> None:
    """Blocking runner: bridge + frontend until the process is interrupted,
    or until the engine thread fails (then it raises the fault).
    `on_ready(port)` is called once the socket is bound (port 0 binds an
    ephemeral one). The entry point of `launch/serve.py --http`; tests
    drive the pieces directly."""

    async def main():
        with EngineBridge(engine) as bridge:
            fe = CompletionFrontend(bridge, fconf)
            await fe.start()
            try:
                if on_ready is not None:
                    on_ready(fe.port)
                while bridge.error is None:
                    await asyncio.sleep(0.05)
                raise RuntimeError(f"engine thread failed: {bridge.error!r}")
            finally:
                await fe.stop()

    asyncio.run(main())
