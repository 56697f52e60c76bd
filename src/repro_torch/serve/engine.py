"""ServeEngine: continuous-batching NVFP4 serving.

Counterpart of `repro/serve/engine.py`. The engine owns a fixed set of
decode SLOTS (the batch dimension of every step), a FIFO request queue with
admission control, a paged KV pool, and a quantize-once weight cache. Each
tick:

  1. ADMIT   — move queued requests into free slots in FIFO order while the
               pool can back prompt + max_new tokens (the head request is
               never overtaken).
  2. PREFILL — one chunk of ONE prefilling slot (the lowest-index one): a
               full `prefill_chunk`, or a single token for the prompt's
               trailing remainder, through the same decode-mode forward as
               decoding; other slots are masked inactive.
  3. DECODE  — one batched step over all slots in DECODE state; new requests
               join as finished ones retire, never restarting the batch.

Slot states: FREE -> PREFILL -> DECODE -> FREE. Raggedness travels as data
(per-slot position vector, active mask, block table). Counters live in the
plain `stats` dict.

With `kv_quant=True` the pool stores every token leaf as NVFP4 `PackedKV`
bytes (0.28125x the bf16 bytes) and decode attention runs the packed-operand
kernels. Later slices bring speculative decoding, the prefix cache and its
spill tier, mesh sharding, disaggregated roles, dense caches and other
scheduler policies; asking for any of them raises NotImplementedError.
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
from repro_torch.serve import decode as serve_decode
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.prequant import prequantize
from repro_torch.serve.sampling import SamplingParams, sample_tokens

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


@dataclass
class RequestResult:
    req_id: int
    prompt: list[int]
    tokens: list[int]
    arrival_s: float = 0.0
    finish_s: float = 0.0
    ttft_s: float | None = None   # submit -> first sampled token


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
    # options of the reference engine that later slices port
    paged: bool = True
    spec_k: int = 0
    mesh: Any = None
    prefix_cache: bool = False
    prefix_spill: bool = False
    role: str = "both"
    scheduler: Any = None


# (field, set?, what, the later slice of ROADMAP.md's Queue 1 that ports it)
_LATER = (
    ("spec_k", lambda e: e.spec_k > 0, "speculative decoding", "engine features"),
    ("prefix_cache", lambda e: e.prefix_cache, "the prefix cache", "engine features"),
    ("prefix_spill", lambda e: e.prefix_spill, "the prefix cache's spill tier",
     "engine features"),
    ("scheduler", lambda e: e.scheduler is not None,
     "the latency-aware scheduler policies", "engine features"),
    ("paged", lambda e: not e.paged, "dense per-slot caches", "dense caches"),
    ("mesh", lambda e: e.mesh is not None, "mesh-sharded serving",
     "distribution"),
    ("role", lambda e: e.role != "both", "disaggregated prefill/decode roles",
     "distribution"),
)


@dataclass
class _Slot:
    state: str = FREE
    req: Request | None = None
    cursor: int = 0               # prompt tokens already prefilled
    length: int = 0               # tokens currently in the cache
    last_tok: int = 0
    generated: list[int] = field(default_factory=list)
    first_token_s: float | None = None


def _stats_dict() -> dict:
    return {k: 0 for k in ("ticks", "admitted", "finished", "rejected",
                           "prefill_tokens", "prefill_steps",
                           "decode_tokens", "decode_steps")} | {
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
        self.device = torch.device(e.device)
        params = _to_device(params, self.device)
        self.params = prequantize(params, cfg, e.scheme) if e.prequant else params
        self.pool = KVPool(cfg, e.n_slots, e.max_len, block_size=e.block_size,
                           n_blocks=e.n_blocks, device=self.device,
                           quantized=e.kv_quant)
        # largest per-ensure growth (a prefill chunk or one decode token)
        self._max_growth = e.prefill_chunk
        self.slots = [_Slot() for _ in range(e.n_slots)]
        self.queue: deque[Request] = deque()
        self._ids = itertools.count()
        self._step = serve_decode.make_paged_serve_step(cfg, e.scheme)
        self._gen = torch.Generator(device=self.device).manual_seed(e.base_seed)
        self.stats = _stats_dict()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; raises Unservable when no pool state can ever
        back it, QueueFull at capacity."""
        total = len(request.prompt) + request.max_new
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
        request.arrival_s = time.perf_counter()
        self.queue.append(request)
        return request.req_id

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
        return self._decode_tick()

    def _admit(self) -> None:
        while self.queue:
            i = next((j for j, s in enumerate(self.slots) if s.state == FREE),
                     None)
            req = self.queue[0]
            total = len(req.prompt) + req.max_new
            if i is None or not self.pool.can_admit(total, self._max_growth):
                return  # FIFO: the head request is never overtaken
            self.queue.popleft()
            self.pool.commit(i, total, self._max_growth)
            self.slots[i] = _Slot(state=PREFILL, req=req)
            self.stats["admitted"] += 1

    def _prefill_tick(self) -> None:
        e = self.econf
        i = next((j for j, s in enumerate(self.slots) if s.state == PREFILL),
                 None)
        if i is None:
            return
        slot = self.slots[i]
        prompt = slot.req.prompt
        remaining = len(prompt) - slot.cursor
        size = e.prefill_chunk if remaining >= e.prefill_chunk else 1
        self.pool.ensure(i, slot.cursor + size)
        tokens = np.zeros((e.n_slots, size), np.int32)
        tokens[i] = prompt[slot.cursor: slot.cursor + size]
        pos = np.zeros((e.n_slots,), np.int32)
        pos[i] = slot.cursor
        active = np.zeros((e.n_slots,), bool)
        active[i] = True
        t0 = time.perf_counter()
        logits = self._forward(tokens, pos, active)
        done = slot.cursor + size == len(prompt)
        tok = int(self._sample(logits[:, -1])[i]) if done else None
        self._sync()
        now = time.perf_counter()
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += size
        self.stats["prefill_steps"] += 1
        slot.cursor += size
        if done:
            # prompt fully cached: the first generated token comes from the
            # logits of the prompt's last position
            slot.state = DECODE
            slot.length = len(prompt)
            slot.last_tok = tok
            slot.generated.append(tok)
            slot.first_token_s = now

    def _retire_slot(self, i: int) -> RequestResult:
        slot = self.slots[i]
        res = RequestResult(
            slot.req.req_id, list(slot.req.prompt), list(slot.generated),
            arrival_s=slot.req.arrival_s, finish_s=time.perf_counter(),
            ttft_s=slot.first_token_s - slot.req.arrival_s)
        self.pool.release(i)
        self.slots[i] = _Slot()
        self.stats["finished"] += 1
        return res

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
        tokens = np.zeros((e.n_slots, 1), np.int32)
        pos = np.zeros((e.n_slots,), np.int32)
        active = np.zeros((e.n_slots,), bool)
        for i in dec:
            slot = self.slots[i]
            self.pool.ensure(i, slot.length + 1)
            tokens[i, 0] = slot.last_tok
            pos[i] = slot.length
            active[i] = True
        t0 = time.perf_counter()
        logits = self._forward(tokens, pos, active)
        toks = self._sample(logits[:, -1])
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += len(dec)
        self.stats["decode_steps"] += 1
        for i in dec:
            slot = self.slots[i]
            slot.length += 1
            slot.last_tok = toks[i]
            slot.generated.append(slot.last_tok)
        return finished

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _forward(self, tokens, pos, active) -> torch.Tensor:
        dev = self.device
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
