"""ServeEngine: continuous-batching NVFP4 serving.

Counterpart of `repro/serve/engine.py`. The engine owns a fixed set of
decode SLOTS (the batch dimension of every step), a request queue with
admission control, a paged KV pool, and a quantize-once weight cache. Each
tick:

  1. ADMIT   — offer queued requests free slots in the order the scheduler
               POLICY gives (`serve/scheduler.py`; the default FifoPolicy
               never overtakes the head request) while the pool can back
               prompt + max_new tokens. With the prefix cache
               (`serve/prefix_cache.py`) the longest cached prompt prefix is
               aliased read-only into the slot and its prefill skipped.
  2. PREFILL — one chunk of ONE prefilling slot (the policy picks which): a
               full `prefill_chunk`, or a single token for the prompt's
               trailing remainder, through the same decode-mode forward as
               decoding; other slots are masked inactive.
  3. DECODE  — one batched step over all slots in DECODE state; new requests
               join as finished ones retire, never restarting the batch.
               With `spec_k > 0` the step is a self-speculative round
               (`serve/spec_decode.py`): the first `draft_layers` layers
               propose spec_k tokens a slot and one (n_slots, spec_k + 1)
               chunk verifies them.

Slot states: FREE -> PREFILL -> DECODE -> FREE. Raggedness travels as data
(per-slot position vector, active mask, block tables). Counters live in the
plain `stats` dict; every timestamp comes from `self.clock`. `cancel`
withdraws a queued or in-flight request; `token_hook` streams each slot's
new tokens at tick boundaries.

With `kv_quant=True` the pool stores every token leaf as NVFP4 `PackedKV`
bytes (0.28125x the bf16 bytes) and decode attention runs the packed-operand
kernels. Later slices bring mesh sharding, disaggregated roles and dense
caches; asking for any of them raises NotImplementedError.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.serve import decode as serve_decode
from repro_torch.serve import spec_decode
from repro_torch.serve.kv_pool import KVPool, OutOfBlocks
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.prequant import prequantize
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import FifoPolicy

FREE, PREFILL, DECODE = "free", "prefill", "decode"


class QueueFull(RuntimeError):
    """Admission control: the request queue is at capacity."""


class Unservable(QueueFull, ValueError):
    """A request no pool state can ever back (rejected at submit)."""


@dataclass
class Request:
    prompt: list[int]
    max_new: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    req_id: int = -1          # assigned by submit()
    arrival_s: float = 0.0    # stamped by submit()
    # latency-aware scheduling (LatencyPolicy; FifoPolicy ignores them)
    priority: int = 0                # higher = more urgent
    deadline_s: float | None = None  # seconds after arrival
    queued_ticks: int = 0            # aging counter (engine-owned)
    cached_hint: int = 0             # prefix-cache matched tokens (engine)


@dataclass
class RequestResult:
    req_id: int
    prompt: list[int]
    tokens: list[int]
    arrival_s: float = 0.0
    finish_s: float = 0.0
    ttft_s: float | None = None   # submit -> first sampled token
    deadline_s: float | None = None

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def deadline_met(self) -> bool | None:
        if self.deadline_s is None:
            return None
        return self.latency_s <= self.deadline_s


@dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    max_len: int = 256            # per-sequence capacity (prompt + generated)
    block_size: int = 16
    n_blocks: int | None = None   # pool size; default n_slots * max_len / bs
    prefill_chunk: int = 16
    prequant: bool = True
    scheme: str = "quartet2"
    max_queue: int = 256
    base_seed: int = 0            # seeds the sampling generator
    device: str = "cuda"
    kv_quant: bool = False        # NVFP4 PackedKV pool instead of bf16
    # radix prefix cache: retired streams' blocks stay cached and a new
    # request aliases its longest cached prefix (COW at the divergence),
    # skipping that prefill. Inactive (engine.cache is None) where sharing
    # is unsound: sliding-window pools.
    prefix_cache: bool = False
    # host-RAM tier under the cache (needs prefix_cache): eviction copies
    # blocks to host memory, and a later match swaps them back in
    prefix_spill: bool = False
    host_budget_bytes: int | None = None  # LRU trim of the host tier
    scheduler: Any = None         # serve/scheduler.py policy; None = FIFO
    clock: Any = None             # () -> seconds; None = time.perf_counter
    # self-speculative decoding (serve/spec_decode.py): spec_k tokens a round
    # proposed by the first draft_layers layers, verified in one chunk;
    # 0 disables it. Exact verification is defined against the bf16 cache
    # image, so kv_quant excludes it.
    spec_k: int = 0
    draft_layers: int = 0
    # callable(req, new_tokens, result) at tick boundaries whenever a slot's
    # stream grows (result: the RequestResult at retirement, else None);
    # reassignable as `engine.token_hook`
    token_hook: Any = None
    # options of the reference engine that later slices port
    paged: bool = True
    mesh: Any = None
    role: str = "both"
    replicate_hits: int | None = None


# (field, set?, what, the later slice of ROADMAP.md's Queue 1 that ports it)
_LATER = (
    ("paged", lambda e: not e.paged, "dense per-slot caches", "dense caches"),
    ("mesh", lambda e: e.mesh is not None, "mesh-sharded serving",
     "distribution"),
    ("role", lambda e: e.role != "both", "disaggregated prefill/decode roles",
     "distribution"),
    ("replicate_hits", lambda e: e.replicate_hits is not None,
     "cross-shard replication of hot prefix blocks", "distribution"),
)


@dataclass
class _Slot:
    state: str = FREE
    req: Request | None = None
    cursor: int = 0               # prompt tokens already prefilled
    length: int = 0               # tokens currently in the cache
    last_tok: int = 0
    generated: list[int] = field(default_factory=list)
    emitted: int = 0              # generated tokens already passed to the hook
    draft_len: int = 0            # tokens the speculative draft has consumed
    first_token_s: float | None = None
    cache_nodes: list = field(default_factory=list)  # pinned radix nodes


def _stats_dict() -> dict:
    return {k: 0 for k in ("ticks", "admitted", "finished", "rejected",
                           "prefill_tokens", "prefill_steps",
                           "decode_tokens", "decode_steps",
                           "prefill_skipped_tokens", "prefix_hits",
                           "draft_tokens", "accepted_tokens", "spec_rounds",
                           "draft_catchup_tokens", "draft_catchup_steps",
                           "cancelled")} | {
        "prefill_s": 0.0, "decode_s": 0.0}


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, econf: EngineConfig | None = None):
        self.cfg = cfg
        self.econf = e = econf or EngineConfig()
        for name, bad, what, later in _LATER:
            if bad(e):
                raise NotImplementedError(
                    f"EngineConfig.{name}: {what} is not ported yet; it comes "
                    f"with the '{later}' slice (ROADMAP.md, Queue 1)")
        if e.prefix_spill and not e.prefix_cache:
            raise ValueError("prefix_spill=True requires prefix_cache=True "
                             "(the host tier is a property of the cache)")
        if e.spec_k > 0:
            if e.kv_quant:
                raise ValueError(
                    "kv_quant=True is incompatible with spec_k > 0: exact "
                    "speculative verification is defined against the bf16 "
                    "cache image")
            if e.draft_layers <= 0:
                raise ValueError("spec_k > 0 requires draft_layers >= 1")
            lm.prefix_specs(cfg, e.draft_layers)  # 0 < n < total_layers
        self.clock = e.clock if e.clock is not None else time.perf_counter
        self.device = torch.device(e.device)
        params = _to_device(params, self.device)
        self.params = prequantize(params, cfg, e.scheme) if e.prequant else params
        self.pool = KVPool(cfg, e.n_slots, e.max_len, block_size=e.block_size,
                           n_blocks=e.n_blocks, device=self.device,
                           quantized=e.kv_quant)
        self.draft = (spec_decode.DraftStack(cfg, self.params, e, self.device)
                      if e.spec_k > 0 else None)
        # a verify chunk writes up to spec_k positions past a sequence's
        # final token: admission reserves that margin in both pools
        self._margin = e.spec_k
        # largest per-ensure growth (a prefill chunk, a verify chunk or one
        # decode token)
        self._max_growth = max(e.prefill_chunk, e.spec_k + 1)
        self.token_hook = e.token_hook
        self.slots = [_Slot() for _ in range(e.n_slots)]
        self.queue: deque[Request] = deque()
        self._ids = itertools.count()
        self._step = serve_decode.make_paged_serve_step(cfg, e.scheme)
        self._gen = torch.Generator(device=self.device).manual_seed(e.base_seed)
        self.stats = _stats_dict()
        self.cache = None
        self._matches: dict[int, tuple[int, Any]] = {}  # req_id -> (epoch, Match)
        if e.prefix_cache and PrefixCache.supported(self.pool):
            self.cache = PrefixCache(
                self.pool, spill=e.prefix_spill,
                host_budget_bytes=e.host_budget_bytes, clock=self.clock)
        self.sched = e.scheduler if e.scheduler is not None else FifoPolicy()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; raises Unservable when no pool state can ever
        back it, QueueFull at capacity."""
        total = len(request.prompt) + request.max_new + self._margin
        if not request.prompt or request.max_new < 1:
            self.stats["rejected"] += 1
            raise Unservable("a request needs a prompt and max_new >= 1")
        if not self.pool.can_ever_admit(total, self._max_growth):
            self.stats["rejected"] += 1
            raise Unservable(
                f"request needs {total} positions but the pool serves at "
                f"most max_len={self.econf.max_len} / "
                f"{self.pool.n_blocks} blocks")
        if len(self.queue) >= self.econf.max_queue:
            self.stats["rejected"] += 1
            raise QueueFull(f"queue at capacity ({self.econf.max_queue})")
        request.req_id = next(self._ids)
        request.arrival_s = self.clock()
        self.queue.append(request)
        return request.req_id

    def cancel(self, req_id: int, reason: str = "cancelled") -> bool:
        """Withdraw a request: a QUEUED one leaves the queue; an in-flight
        one frees its slot in both pools, its committed stream first
        inserted into the prefix cache (the tokens were paid for, and a
        resubmission reuses them). `reason` names why ("cancelled",
        "disconnected", "requeued"); the instrumentation that records it
        comes with `obs/`. False when `req_id` is unknown (retired,
        rejected or never submitted)."""
        for r in self.queue:
            if r.req_id == req_id:
                self.queue.remove(r)
                self._matches.pop(req_id, None)
                self.stats["cancelled"] += 1
                return True
        for i, s in enumerate(self.slots):
            if s.req is not None and s.req.req_id == req_id:
                self._release_slot(i)
                self.stats["cancelled"] += 1
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.queue) or any(s.state != FREE for s in self.slots)

    def run(self) -> list[RequestResult]:
        """Drain queue + slots; returns results in completion order."""
        out: list[RequestResult] = []
        while self.has_work():
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------
    # scheduler iteration
    # ------------------------------------------------------------------

    def step(self) -> list[RequestResult]:
        """One scheduler tick: admit, one prefill chunk, one decode step."""
        self.stats["ticks"] += 1
        self._admit()
        self._prefill_tick()
        finished = self._decode_tick()
        if self.cache is not None and self.cache.spill:
            # this tick's swap-ins become plain cached blocks: the stream
            # orders their writes before any later read, nothing waits
            self.cache.complete_swaps()
        return finished

    def _admit(self) -> None:
        for r in self.queue:
            r.queued_ticks += 1  # scheduler aging (LatencyPolicy)
        if not self.queue:
            return
        now = self.clock()
        if self.cache is not None and not self.sched.head_of_line:
            # cache-aware ordering: a large cached prefix is cheap to admit
            for r in self.queue:
                r.cached_hint = self.cache.hint_tokens(self._match(r))
        while self.queue and any(s.state == FREE for s in self.slots):
            admitted = False
            for req in self.sched.admission_order(self.queue, now):
                if self._try_admit(req):
                    self.queue.remove(req)
                    admitted = True
                    break
                if self.sched.head_of_line:
                    return  # FIFO: the head request is never overtaken
            if not admitted:
                return

    def _match(self, req: Request):
        """Cache match of a queued request, memoized until the tree's epoch
        moves (prompts are immutable)."""
        hit = self._matches.get(req.req_id)
        if hit is None or hit[0] != self.cache.epoch:
            hit = (self.cache.epoch, self.cache.match(req.prompt))
            self._matches[req.req_id] = hit
        return hit[1]

    def _try_admit(self, req: Request) -> bool:
        """Place `req` in a FREE slot, aliasing its cached prefix; False
        when the pool cannot back it now."""
        total = len(req.prompt) + req.max_new + self._margin
        plan = pinned = None
        if self.cache is not None:
            m = self._match(req)
            # the last prompt token is always computed (its logits give the
            # first generated token), so the usable match stops below it
            mtoks, adopt, tail = m.plan(len(req.prompt) - 1,
                                        self.pool.block_size)
            if mtoks > 0:
                plan = (mtoks, adopt, tail)
                # pin BEFORE any eviction below can see these nodes unpinned
                pinned = adopt + ([tail] if tail is not None else [])
                self.cache.acquire(pinned)
        i = self._place(total, plan)
        if i is None and plan is not None:
            # the pinned plan cannot be backed: try cold, where eviction
            # may also take the plan's (now unpinned) nodes
            self.cache.release(pinned)
            plan = pinned = None
            i = self._place(total, None)
        if i is None:
            if pinned:
                self.cache.release(pinned)
            return False
        if plan is not None and self.cache.spill:
            # swap spilled blocks of the plan back in (dispatched copies).
            # Only the allocator's shortage is caught: it is raised before
            # any copy of the block is dispatched, and the request is then
            # admitted cold; a failing device copy propagates.
            try:
                self.cache.materialize(pinned, 0)
            except OutOfBlocks:
                self.cache.release(pinned)
                plan = pinned = None
        self.pool.commit(i, total, self._max_growth)
        prefix_len = 0
        nodes: list = []
        if plan is not None:
            mtoks, adopt, tail = plan
            if adopt:
                self.pool.adopt_prefix(i, [n.blocks[0] for n in adopt],
                                       len(adopt) * self.pool.block_size)
            if tail is not None:
                self.pool.cow_block(i, tail.blocks[0])
                self.cache.release([tail])  # private copy made; unpin
            self.pool.ensure(i, mtoks)
            prefix_len = mtoks
            nodes = adopt
            self.stats["prefill_skipped_tokens"] += mtoks
            self.stats["prefix_hits"] += 1
        if self.draft is not None:
            # the draft pool never aliases the cache: _prefill_tick catches
            # the draft up over a skipped prefix
            self.draft.pool.commit(i, total, self._max_growth)
        self.slots[i] = _Slot(state=PREFILL, req=req, cursor=prefix_len,
                              cache_nodes=nodes)
        self.stats["admitted"] += 1
        if self.cache is not None:
            # book once per ADMITTED request; only an adopted match is a hit
            self.cache.record(m if plan is not None else None)
            self._matches.pop(req.req_id, None)
        return True

    def _place(self, total: int, plan) -> int | None:
        """The first FREE slot, if the pool can back `total` positions there
        (evicting unpinned cached prefixes when short). One shard: a plan's
        device-resident blocks are adopted, not allocated."""
        i = next((j for j, s in enumerate(self.slots) if s.state == FREE),
                 None)
        if i is None:
            return None
        cached = 0
        if plan is not None:
            cached = sum(1 for node in plan[1] if 0 in node.blocks)
        return i if self._admissible(i, total, cached) else None

    def _admissible(self, slot: int, total: int, cached: int) -> bool:
        if self.draft is not None and not self.draft.pool.can_admit(
                total, self._max_growth, slot=slot):
            return False
        if self.pool.can_admit(total, self._max_growth, slot=slot,
                               cached_blocks=cached):
            return True
        if self.cache is not None:
            short = self.pool.admission_shortfall(
                total, self._max_growth, slot=slot, cached_blocks=cached)
            if short and self.cache.evict(0, short) >= short:
                return self.pool.can_admit(total, self._max_growth,
                                           slot=slot, cached_blocks=cached)
        return False

    def _prefill_tick(self) -> None:
        e = self.econf
        cands = [(i, s) for i, s in enumerate(self.slots)
                 if s.state == PREFILL]
        if not cands:
            return
        # the policy's preemption point; slots not picked keep aging
        i = self.sched.pick_prefill(cands, self.clock())
        for j, s in cands:
            if j != i:
                s.req.queued_ticks += 1
        slot = self.slots[i]
        prompt = slot.req.prompt
        if self.draft is not None and slot.draft_len < slot.cursor:
            self._draft_catchup(i, slot)
            return  # bounded work: one chunk a tick
        remaining = len(prompt) - slot.cursor
        size = e.prefill_chunk if remaining >= e.prefill_chunk else 1
        self.pool.ensure(i, slot.cursor + size)
        tokens = np.zeros((e.n_slots, size), np.int32)
        tokens[i] = prompt[slot.cursor: slot.cursor + size]
        pos = np.zeros((e.n_slots,), np.int32)
        pos[i] = slot.cursor
        active = np.zeros((e.n_slots,), bool)
        active[i] = True
        t0 = self.clock()
        logits = self._forward(tokens, pos, active)
        if self.draft is not None:
            # the draft's cache covers the prompt too: the same chunk
            # through the prefix stack
            self.draft.pool.ensure(i, slot.cursor + size)
            self.draft.forward(tokens, pos, active)
        done = slot.cursor + size == len(prompt)
        tok = int(self._sample(logits[:, -1])[i]) if done else None
        self._sync()
        now = self.clock()
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += size
        self.stats["prefill_steps"] += 1
        slot.cursor += size
        slot.draft_len = slot.cursor
        if done:
            # prompt fully cached: the first generated token comes from the
            # logits of the prompt's last position
            slot.state = DECODE
            slot.length = len(prompt)
            slot.last_tok = tok
            slot.generated.append(tok)
            slot.first_token_s = now
            self._flush(i)

    def _draft_catchup(self, i: int, slot: _Slot) -> None:
        """One chunk of the draft over prompt tokens a prefix-cache hit let
        the full model skip (a full prefill chunk, or one token of the
        remainder)."""
        e = self.econf
        gap = slot.cursor - slot.draft_len
        size = e.prefill_chunk if gap >= e.prefill_chunk else 1
        tokens = np.zeros((e.n_slots, size), np.int32)
        tokens[i] = slot.req.prompt[slot.draft_len: slot.draft_len + size]
        pos = np.zeros((e.n_slots,), np.int32)
        pos[i] = slot.draft_len
        active = np.zeros((e.n_slots,), bool)
        active[i] = True
        t0 = self.clock()
        self.draft.pool.ensure(i, slot.draft_len + size)
        self.draft.forward(tokens, pos, active)
        self._sync()
        self.stats["prefill_s"] += self.clock() - t0
        self.stats["draft_catchup_tokens"] += size
        self.stats["draft_catchup_steps"] += 1
        slot.draft_len += size

    def _retire_slot(self, i: int) -> RequestResult:
        """Complete slot `i`: pass the result through the hook, then free
        the slot (`_release_slot`)."""
        slot = self.slots[i]
        res = RequestResult(
            slot.req.req_id, list(slot.req.prompt), list(slot.generated),
            arrival_s=slot.req.arrival_s, finish_s=self.clock(),
            ttft_s=slot.first_token_s - slot.req.arrival_s,
            deadline_s=slot.req.deadline_s)
        self._flush(i, res)
        self._release_slot(i)
        self.stats["finished"] += 1
        return res

    def _release_slot(self, i: int) -> None:
        """Cache slot `i`'s stream while the slot still references its
        blocks, then drop its pins and its state in both pools. Only the
        tokens whose K/V the pool holds are cached: the last generated token
        was sampled but never fed (the reference inserts it too at
        retirement, leaving an unwritten position in a cached full block)."""
        slot = self.slots[i]
        if self.cache is not None:
            stream = slot.req.prompt + slot.generated
            self.cache.insert(stream[:self.pool.length(i)], i)
            if slot.cache_nodes:
                self.cache.release(slot.cache_nodes)
        self.pool.release(i)
        if self.draft is not None:
            self.draft.pool.release(i)
        self.slots[i] = _Slot()

    def _decode_tick(self) -> list[RequestResult]:
        e = self.econf
        dec = [i for i, s in enumerate(self.slots) if s.state == DECODE]
        finished: list[RequestResult] = []
        # retire before stepping: a complete request frees its blocks now
        for i in list(dec):
            if len(self.slots[i].generated) >= self.slots[i].req.max_new:
                finished.append(self._retire_slot(i))
                dec.remove(i)
        if not dec:
            return finished
        if e.spec_k > 0:
            t0 = self.clock()
            emitted = spec_decode.spec_round(self, dec)
            self._sync()
            self.stats["decode_s"] += self.clock() - t0
            self.stats["decode_tokens"] += emitted
            self.stats["decode_steps"] += 1
            for i in dec:
                self._flush(i)
            return finished
        tokens = np.zeros((e.n_slots, 1), np.int32)
        pos = np.zeros((e.n_slots,), np.int32)
        active = np.zeros((e.n_slots,), bool)
        for i in dec:
            slot = self.slots[i]
            self.pool.ensure(i, slot.length + 1)
            tokens[i, 0] = slot.last_tok
            pos[i] = slot.length
            active[i] = True
        t0 = self.clock()
        logits = self._forward(tokens, pos, active)
        toks = self._sample(logits[:, -1])
        self.stats["decode_s"] += self.clock() - t0
        self.stats["decode_tokens"] += len(dec)
        self.stats["decode_steps"] += 1
        for i in dec:
            slot = self.slots[i]
            slot.length += 1
            slot.last_tok = toks[i]
            slot.generated.append(slot.last_tok)
            self._flush(i)
        return finished

    def _flush(self, i: int, result: RequestResult | None = None) -> None:
        """Pass slot `i`'s generated tokens not yet emitted to the token
        hook, with the final result at retirement. Called only at tick
        boundaries (after the first token, after a decode step or a round,
        at retirement), so between ticks every token has been emitted and a
        cancel strands none."""
        if self.token_hook is None:
            return
        s = self.slots[i]
        new = s.generated[s.emitted:]
        if new or result is not None:
            s.emitted = len(s.generated)
            self.token_hook(s.req, new, result)

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _forward(self, tokens, pos, active) -> torch.Tensor:
        dev = self.device
        # stacked read/write tables: scatters go through the write view,
        # whose adopted entries hold the sentinel (kv_pool.tables_device)
        logits, _ = self._step(
            self.params, self.pool.caches, self.pool.tables_device(),
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(active).to(dev))
        return logits

    def _sample(self, last_logits: torch.Tensor) -> list[int]:
        """Per-slot sampled token ids (host ints; this is the step's sync)."""
        n = self.econf.n_slots
        temps = np.zeros((n,), np.float32)
        topks = np.zeros((n,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                temps[i] = slot.req.sampling.temperature
                topks[i] = slot.req.sampling.top_k
        dev = self.device
        toks = sample_tokens(last_logits, torch.from_numpy(temps).to(dev),
                             torch.from_numpy(topks).to(dev), self._gen)
        return toks.tolist()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree.to(device)
