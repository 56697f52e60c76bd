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
               decoding; other slots are masked inactive (so no pad token
               ever enters a recurrent state: rwkv6, griffin).
  3. DECODE  — one batched step over all slots in DECODE state; new requests
               join as finished ones retire, never restarting the batch.
               With `spec_k > 0` the step is a self-speculative round
               (`serve/spec_decode.py`): the first `draft_layers` layers
               propose spec_k tokens a slot and one (n_slots, spec_k + 1)
               chunk verifies them.

Slot states: FREE -> PREFILL -> DECODE -> FREE. Raggedness travels as data
(per-slot position vector, active mask, block tables). Every timestamp
comes from `self.clock`. `cancel` withdraws a queued or in-flight request;
`token_hook` streams each slot's new tokens at tick boundaries (the seam
the HTTP frontend, `serve/frontend.py`, rides).

Observability (`EngineConfig.obs`, an `obs.Instrumentation`): counters move
from the plain `stats` dict into a metrics registry behind the same
mapping, each request gets a lifecycle trace, and the pool, the prefix
cache, the scheduler and the speculative path report through the same
object. Off (`obs=None`, the `NULL` sentinel) every hook site costs one
attribute read; on, the hooks read the host clock and host state only: no
host sync and no device work. One difference from the reference: the port
fills `RequestResult.ttft_s` with obs off too (with obs on it is the
trace's value, as the reference computes it).

With `kv_quant=True` the pool stores every token leaf as NVFP4 `PackedKV`
bytes (0.28125x the bf16 bytes) and decode attention runs the packed-operand
kernels. With `paged=False` the pool holds dense per-slot caches and the
step runs without a block table (the reference's dense layout; no prefix
cache). Enc-dec models (whisper) are not served, as in the reference.

Mesh-sharded serving (`EngineConfig.mesh`, a `launch.mesh.make_serve_mesh`
(data, 1) mesh): one engine in one process over every shard, as the
reference's. The decode slots and the slot-affine pool split over "data"
(`KVPool(n_shards=...)`: slot i homes on shard i // (n_slots / data) and
draws blocks from that shard alone); the parameters are placed once on
each distinct shard device; each step runs once a shard on the shard's
own slots, tree and shard-local tables, on its device
(`serve_decode.make_sharded_serve_step`), and the shards' logits are
gathered on the engine's device, where one sampler call serves every slot.
Placement is occupancy-aware (`_place`); without the host tier a cached
prefix serves only its own shard, with it a match materializes on any
shard, and `replicate_hits` copies hot prefix blocks into peer shards at
tick boundaries. Under bf16 each row's arithmetic is the unsharded
engine's, so the streams are bitwise, on the card too (a step's bf16 GEMMs
sum each output in an order fixed by K alone, at any row count:
`kernels.bf16_matmul`; rmsnorm its squares in one fixed by the width:
`models.blocks.sum_last_fixed`). Under quartet2 each shard's activation absmax
spans its own slots (the reference's contract).

Over a "model" axis > 1 (the dense GQA families, a paged pool, role
"both": anything else raises, naming its ROADMAP item) the parameters are
cut once into a tree per data shard (`dist.sharding.split_serve_params`:
each linear weight's out-features, the embedding's and the head's vocab
rows, one part a model device) and the engine keeps no whole tree. Each
data shard's step and pool stay on its first device; its split linears run
each part on its model device and concatenate the outputs in model order,
so the streams are the unsharded engine's bit for bit.

Disaggregated prefill/decode (`EngineConfig.role`, driven as a pair by
`serve/frontend.py`'s `EnginePair`): a "prefill" worker admits prompts and
runs prefill chunks only; each prompt that finishes (its first token
sampled) leaves as a `Handoff`, its blocks copied to pinned host buffers
and released here. A "decode" worker takes Handoffs (`submit_handoff`),
imports the payloads into blocks of its own pool and decodes; it never
runs a prefill forward and refuses plain prompts (`Unservable`, reason
"wrong_role"). Every copy of a handoff runs on the current CUDA stream of
the one thread that ticks both engines, so the stream orders them: the
export's device-to-host copies come after the prefill forwards that wrote
the blocks and before any later step that reuses the released blocks; the
import's host-to-device copies come after the export's and before the
decode step that reads them. The host never reads a payload; a payload's
buffer goes back to the prefill pool's free list only once the event
recorded behind the last copy that touched it has completed
(`KVPool.release_host`, `poll_host`).
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
from repro_torch.dist.sharding import split_serve_params
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models import lm
from repro_torch.obs.instrumentation import NULL, legacy_stats_dict
from repro_torch.serve import decode as serve_decode
from repro_torch.serve import spec_decode
from repro_torch.serve.kv_pool import KVPool, OutOfBlocks
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.prequant import prequantize
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import FifoPolicy

FREE, PREFILL, DECODE = "free", "prefill", "decode"


class QueueFull(RuntimeError):
    """Admission control: the request queue is at capacity.

    Structured: `reason`, `queue_depth` and `retry_after_s` let the HTTP
    frontend build a 429 with Retry-After, and the obs layer a
    reason-labelled rejection counter, from the exception itself. `info()`
    is the JSON-safe dict both read."""

    reason = "queue_full"

    def __init__(self, msg: str = "", *, reason: str | None = None,
                 queue_depth: int = 0, retry_after_s: float | None = None):
        super().__init__(msg)
        if reason is not None:
            self.reason = reason
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s

    def info(self) -> dict:
        return {"reason": self.reason, "queue_depth": self.queue_depth,
                "retry_after_s": self.retry_after_s}


class Unservable(QueueFull, ValueError):
    """A request no pool state can ever back (rejected at submit). Carries
    QueueFull's fields with `retry_after_s=None`: retrying is pointless.
    QueueFull leads the MRO, so its keyword-aware __init__ wins over
    ValueError's."""

    reason = "unservable"


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
    # from the request's trace when observability is on; None otherwise
    queue_wait_s: float | None = None   # submit -> slot admission
    decode_tok_s: float | None = None   # mean per-token decode latency

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def deadline_met(self) -> bool | None:
        if self.deadline_s is None:
            return None
        return self.latency_s <= self.deadline_s


@dataclass
class Handoff:
    """A finished prefill leaving a prefill-role engine for a decode-role one.

    Carries the ORIGINAL Request (req_id intact: the frontend bridge keeps
    routing streamed tokens by id across the role boundary), the tokens
    generated so far (the first sampled token, from the prompt's last
    position on the prefill worker) and the prompt's KV as host payloads:
    `(logical_block, HostBlock)` pairs in `KVPool.read_block_host` format,
    never modified after the export. A partial tail block travels whole:
    bytes past `length` sit behind the position mask. bf16 payloads import
    bit for bit, so a disaggregated greedy stream equals the single
    engine's. Two fields are the port's own: `first_token_s`, the prefill
    worker's first-token stamp (the decode worker's result carries the TTFT
    with obs off too), and `pool`, the prefill worker's pool, whose host free
    list the payloads' pinned buffers return to once imported or dropped
    (`release_payloads`)."""

    req: Request
    generated: list[int]
    length: int                   # prompt tokens backed by the payloads
    blocks: list                  # [(logical_idx, HostBlock), ...]
    first_token_s: float | None = None
    pool: Any = None

    def release_payloads(self) -> None:
        """Give the payloads' buffers back to the exporting pool; each is
        reused only after the event behind its last copy has completed."""
        for _, payload in self.blocks:
            self.pool.release_host(payload)
        self.blocks = []


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
    # is unsound: dense pools and sliding-window pools.
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
    # observability (obs/instrumentation.py Instrumentation); None disables
    # every hook beyond the plain stats dict
    obs: Any = None
    # False: dense per-slot caches (n_slots, max_len + 1, ...) instead of
    # the paged pool; requires kv_quant=False
    paged: bool = True
    # disaggregated prefill/decode (serve/frontend.py EnginePair): "both" is
    # the single engine; a "prefill" worker admits prompts, prefills them
    # and exports each finished prompt as a Handoff; a "decode" worker
    # admits Handoffs straight into decode slots and never prefills. Split
    # roles need a paged pool without window reclamation or recurrent state
    # (whole resident blocks travel) and spec_k == 0 (the draft pool does
    # not travel)
    role: str = "both"
    # mesh-sharded serving (launch.mesh.make_serve_mesh): decode slots and
    # the slot-affine pool split over the mesh's "data" axis, linear weights
    # over its "model" axis; None serves unsharded. n_slots and the pool's
    # n_blocks must divide by the "data" size
    mesh: ServeMesh | None = None
    # cross-shard replication (needs prefix_spill): prefix nodes matched
    # this many times get copies of their blocks in peer shards' pools
    # through the host tier, one block a tick, into free blocks only (it
    # never evicts). None disables it; one shard has no peers
    replicate_hits: int | None = None


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


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, econf: EngineConfig | None = None):
        if cfg.enc_dec:
            raise NotImplementedError("enc-dec serving: use the explicit "
                                      "encoder path (examples)")
        self.cfg = cfg
        self.econf = e = econf or EngineConfig()
        self.mesh = e.mesh
        self.data_shards = 1
        self.model_shards = 1
        if self.mesh is not None:
            self.data_shards = serve_decode.data_shards(self.mesh)
            self.model_shards = self.mesh.model
            serve_decode.check_model_axis(cfg, self.mesh)
            if self.model_shards > 1 and (not e.paged or e.role != "both"):
                raise NotImplementedError(
                    f"serving over a 'model' axis of {self.model_shards} runs "
                    "the paged pool with role 'both'; dense caches and the "
                    "disaggregated roles over 'model' come with "
                    f"{serve_decode.MODEL_AXIS_ITEM}")
            if e.n_slots % self.data_shards:
                raise ValueError(
                    f"n_slots={e.n_slots} must divide over the mesh 'data' "
                    f"axis ({self.data_shards}): each shard serves an equal "
                    "share of the slots")
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
            if cfg.rwkv is not None and e.spec_k + 1 >= cfg.rwkv.chunk:
                # the (n_slots, spec_k + 1) verify chunk must stay on the
                # per-token WKV path: the chunk-parallel form sums in
                # another order than S = 1 steps, which would break exact
                # verification against the non-speculative engine
                raise ValueError(
                    f"spec_k={e.spec_k} needs spec_k + 1 < rwkv.chunk "
                    f"({cfg.rwkv.chunk}) for exact verification")
        self.clock = e.clock if e.clock is not None else time.perf_counter
        self.device = torch.device(e.device)
        # resolved first, so prequantization can report the raw weights'
        # quantization health through the probe
        self.obs = e.obs if e.obs is not None else NULL
        probe = self.obs.quant_probe if self.obs.enabled else None
        params = _to_device(params, self.device)
        self.params = (prequantize(params, cfg, e.scheme, probe=probe)
                       if e.prequant else params)
        # the parameters each shard's step reads: one copy a distinct shard
        # device (shards sharing a card share it; on the engine's own
        # device, the engine's tree itself); over "model" one tree a data
        # shard, cut by the serving specs, and no whole tree kept
        self.shard_params = None
        if self.model_shards > 1:
            self.shard_params = split_serve_params(self.params, self.mesh)
            self.params = None
        elif self.mesh is not None:
            placed: dict[torch.device, Any] = {}
            for d in self.mesh.devices:
                if d not in placed:
                    placed[d] = _to_device(self.params, d)
            self.shard_params = [placed[d] for d in self.mesh.devices]
        self.pool = KVPool(cfg, e.n_slots, e.max_len, paged=e.paged,
                           block_size=e.block_size, n_blocks=e.n_blocks,
                           device=self.device, quantized=e.kv_quant,
                           n_shards=self.data_shards,
                           devices=self.mesh.devices if self.mesh else None)
        if e.role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', got {e.role!r}")
        if e.role != "both":
            if (not e.paged or self.pool.window is not None
                    or self.pool.has_state_kinds):
                raise ValueError(
                    "disaggregated roles require a paged pool without "
                    "sliding-window reclamation or recurrent state kinds: "
                    "the KV handoff moves whole resident blocks")
            if e.spec_k > 0:
                raise ValueError(
                    "disaggregated roles are incompatible with spec_k > 0 "
                    "(the draft pool does not travel with the handoff)")
        self.role = e.role
        self.handoffs: deque[Handoff] = deque()       # prefill: exported
        self.handoff_queue: deque[Handoff] = deque()  # decode: awaiting slot
        self.draft = (spec_decode.DraftStack(cfg, self.params, e, self.device,
                                             shard_params=self.shard_params)
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
        self._step = (serve_decode.make_sharded_serve_step(
            cfg, e.scheme, self.mesh, out_device=self.device)
            if self.mesh is not None else
            serve_decode.make_paged_serve_step(cfg, e.scheme))
        self._gen = torch.Generator(device=self.device).manual_seed(e.base_seed)
        self.cache = None
        self._matches: dict[int, tuple[int, Any]] = {}  # req_id -> (epoch, Match)
        if e.prefix_cache and PrefixCache.supported(self.pool):
            self.cache = PrefixCache(
                self.pool, spill=e.prefix_spill,
                host_budget_bytes=e.host_budget_bytes,
                replicate_hits=e.replicate_hits, clock=self.clock)
        self.sched = e.scheduler if e.scheduler is not None else FifoPolicy()
        # a plain dict with obs off; registry-backed counters behind the
        # same mapping with obs on
        if self.obs.enabled:
            self._stats = self.obs.stats_view()
            self.pool.obs = self.obs
            if self.cache is not None:
                self.cache.obs = self.obs
        else:
            self._stats = legacy_stats_dict()

    @property
    def stats(self):
        """Engine counters (a dict, or the registry view with obs on)."""
        return self._stats

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; raises Unservable (a QueueFull and a ValueError)
        when no pool state can ever back it or this is a decode-role engine
        (reason "wrong_role": its work arrives as Handoffs), QueueFull (with
        queue depth and a suggested retry_after_s) at capacity."""
        total = len(request.prompt) + request.max_new + self._margin
        exc = None
        if self.role == "decode":
            # a decode worker never prefills: a prompt would wait in PREFILL
            # forever (EnginePair routes submits to the prefill worker)
            exc = Unservable("decode-role engine takes Handoffs, not "
                             "prompts (submit to the prefill worker)",
                             reason="wrong_role",
                             queue_depth=len(self.handoff_queue))
        elif not request.prompt or request.max_new < 1:
            exc = Unservable("a request needs a prompt and max_new >= 1",
                             queue_depth=len(self.queue))
        elif not self.pool.can_ever_admit(total, self._max_growth):
            bound = (f"{self.pool.blocks_per_shard} blocks a shard "
                     f"(slot-affine, {self.pool.n_shards} shards)"
                     if self.pool.n_shards > 1
                     else f"{self.pool.n_blocks} blocks")
            exc = Unservable(
                f"request needs {total} positions but the pool serves at "
                f"most max_len={self.econf.max_len} / {bound}",
                queue_depth=len(self.queue))
        elif len(self.queue) >= self.econf.max_queue:
            # checked after unservability: a permanent rejection must not
            # pass for a transient one (clients would retry forever)
            exc = QueueFull(f"queue at capacity ({self.econf.max_queue})",
                            queue_depth=len(self.queue),
                            retry_after_s=self.suggested_retry_after_s())
        if exc is not None:
            self.stats["rejected"] += 1
            if self.obs.enabled:
                self.obs.on_reject(request, exc.reason, self.clock())
            raise exc
        request.req_id = next(self._ids)
        request.arrival_s = self.clock()
        self.queue.append(request)
        if self.obs.enabled:
            self.obs.on_submit(request, request.arrival_s)
        return request.req_id

    def cancel(self, req_id: int, reason: str = "cancelled") -> bool:
        """Withdraw a request: a QUEUED one leaves the queue; an in-flight
        one frees its slot in both pools, its committed stream first
        inserted into the prefix cache (the tokens were paid for, and a
        resubmission reuses them). `reason` ("cancelled", "disconnected",
        "requeued": the frontend's lifecycle states) labels the trace's
        terminal span and the cancellation counter. False when `req_id` is
        unknown (retired, rejected or never submitted)."""
        t = self.clock()
        for r in self.queue:
            if r.req_id == req_id:
                self.queue.remove(r)
                self._matches.pop(req_id, None)
                self.stats["cancelled"] += 1
                if self.obs.enabled:
                    self.obs.on_cancel(r, t, reason=reason)
                return True
        for h in self.handoff_queue:
            if h.req.req_id == req_id:
                # received, not admitted: the prefill worker released its
                # blocks at export and this engine allocated none, so
                # returning the payloads' buffers reclaims everything
                self.handoff_queue.remove(h)
                h.release_payloads()
                self.stats["cancelled"] += 1
                if self.obs.enabled:
                    self.obs.on_cancel(h.req, t, reason=reason)
                return True
        for i, s in enumerate(self.slots):
            if s.req is not None and s.req.req_id == req_id:
                self._release_slot(i)
                self.stats["cancelled"] += 1
                if self.obs.enabled:
                    self.obs.on_cancel(s.req, t, reason=reason)
                return True
        return False

    def submit_handoff(self, handoff: Handoff) -> None:
        """Hand a finished prefill to this decode-role engine. Nothing is
        allocated until `_admit` finds it a slot, so a queued Handoff
        cancels by dropping it."""
        if self.role != "decode":
            raise ValueError("submit_handoff on a non-decode-role engine")
        self.handoff_queue.append(handoff)

    def suggested_retry_after_s(self) -> float:
        """Backpressure hint for rejected clients: seconds until the engine
        has plausibly worked the backlog down. The queued and in-flight
        tokens still to generate over the decode rate observed so far,
        clamped to [0.5, 60]; 1.0 before any decode step has run."""
        if self.stats["decode_tokens"] <= 0:
            return 1.0
        backlog = sum(r.max_new for r in self.queue)
        for s in self.slots:
            if s.req is not None:
                backlog += max(s.req.max_new - len(s.generated), 0)
        rate = self.stats["decode_tokens"] / max(self.stats["decode_s"], 1e-9)
        return float(min(max(backlog / max(rate, 1e-9), 0.5), 60.0))

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.handoff_queue)
                or any(s.state != FREE for s in self.slots))

    @property
    def free_slots(self) -> int:
        return sum(s.state == FREE for s in self.slots)

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
        """One scheduler tick: admit, one prefill chunk, one decode step.

        Role-split engines run half a tick each: a prefill worker never
        decodes (finished prompts leave as Handoffs), a decode worker never
        prefills (Handoffs admit straight into DECODE)."""
        self.stats["ticks"] += 1
        self._admit()
        if self.role != "decode":
            self._prefill_tick()
        finished = (self._handoff_tick() if self.role == "prefill"
                    else self._decode_tick())
        if self.cache is not None and self.cache.spill:
            # tick-boundary host-tier work: at most one block of hot
            # prefixes copied into a peer shard, then this tick's swap-ins
            # become plain cached blocks (the stream orders their writes
            # before any later read; nothing waits)
            self.cache.replicate_hot()
            self.cache.complete_swaps()
        if self.obs.enabled:
            self.obs.on_tick(self)  # occupancy / pool / cache gauges
        return finished

    def _admit(self) -> None:
        for r in self.queue:
            r.queued_ticks += 1  # scheduler aging (LatencyPolicy)
        if self.obs.enabled:
            # queue depth / aging / slack: the policy knows its urgency model
            self.sched.observe(self.obs, self.queue, self.clock())
        if self.role == "decode":
            # Handoffs admit FIFO straight into DECODE: their KV is computed,
            # so admission is commit + allocate + import the payloads
            while (self.handoff_queue
                   and any(s.state == FREE for s in self.slots)):
                if not self._try_admit_handoff(self.handoff_queue[0]):
                    return
                self.handoff_queue.popleft()
            return
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
                # without the host tier the plan serves only its home shard
                # (slot affinity); with it any shard, where spilled or
                # off-shard blocks materialize
                plan = (mtoks, adopt, tail,
                        None if self.cache.spill else m.shard)
                # pin BEFORE any eviction below can see these nodes unpinned
                pinned = adopt + ([tail] if tail is not None else [])
                self.cache.acquire(pinned)
        i = self._place(total, plan)
        if i is None and plan is not None:
            # the pinned plan cannot be backed (or its home shard has no
            # usable slot): try cold, where eviction may also take the
            # plan's (now unpinned) nodes
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
                self.cache.materialize(pinned, self.pool.shard_of_slot(i))
            except OutOfBlocks:
                self.cache.release(pinned)
                plan = pinned = None
        self.pool.reset_slot(i)  # a new sequence's recurrent state is zero
        self.pool.commit(i, total, self._max_growth)
        prefix_len = 0
        nodes: list = []
        if plan is not None:
            mtoks, adopt, tail, _ = plan
            sh = self.pool.shard_of_slot(i)
            if adopt:
                self.pool.adopt_prefix(i, [n.blocks[sh] for n in adopt],
                                       len(adopt) * self.pool.block_size)
            if tail is not None:
                self.pool.cow_block(i, tail.blocks[sh])
                self.cache.release([tail])  # private copy made; unpin
            self.pool.ensure(i, mtoks)
            prefix_len = mtoks
            nodes = adopt
            self.stats["prefill_skipped_tokens"] += mtoks
            self.stats["prefix_hits"] += 1
        if self.draft is not None:
            # the draft pool never aliases the cache: _prefill_tick catches
            # the draft up over a skipped prefix
            self.draft.pool.reset_slot(i)
            self.draft.pool.commit(i, total, self._max_growth)
        self.slots[i] = _Slot(state=PREFILL, req=req, cursor=prefix_len,
                              cache_nodes=nodes)
        self.stats["admitted"] += 1
        if self.obs.enabled:
            self.obs.on_admit(req, i, prefix_len, self.clock())
        if self.cache is not None:
            # book once per ADMITTED request; only an adopted match is a hit
            self.cache.record(m if plan is not None else None)
            self._matches.pop(req.req_id, None)
        return True

    def _place(self, total: int, plan) -> int | None:
        """A FREE slot for a request of `total` positions, or None.

        Each shard offers its lowest free slot. A plan pinned to a home
        shard (plan[3], without the host tier) can use only that shard's
        slots. A host-tier plan (plan[3] None) ranks every shard by the
        planned blocks already resident there, then by effective free
        blocks, so a shard holding a replica wins over a merely emptier one
        and only the rest swaps in. Cold placement ranks shards by
        effective free blocks (more first), then shard id: one shard gives
        the first free slot. A plan's resident blocks are adopted, not
        allocated; a short shard evicts unpinned cached prefixes before it
        gives up."""
        free_by_shard: dict[int, list[int]] = {}
        for i, s in enumerate(self.slots):
            if s.state == FREE:
                free_by_shard.setdefault(self.pool.shard_of_slot(i),
                                         []).append(i)
        pool = self.pool
        if plan is not None and plan[3] is not None:
            cached = ({plan[3]: len(plan[1])} if plan[3] in free_by_shard
                      else {})
        elif plan is not None:
            # only blocks ALREADY resident on a shard are credited: the rest
            # swap in and draw on the free list as a cold allocation would
            cached = {sh: sum(1 for node in plan[1] if sh in node.blocks)
                      for sh in free_by_shard}
        else:
            cached = dict.fromkeys(free_by_shard, 0)

        def resident(sh):
            tail = plan[2] is not None and sh in plan[2].blocks
            return cached[sh] + tail

        def effective(sh):
            return pool.effective_free_blocks(sh) if pool.paged else 0

        if plan is not None and plan[3] is None:
            order = sorted(cached, key=lambda sh: (-resident(sh),
                                                   -effective(sh), sh))
        else:
            order = sorted(cached, key=lambda sh: (-effective(sh), sh))
        for sh in order:
            i = free_by_shard[sh][0]
            if self._admissible(i, total, cached[sh]):
                return i
        return None

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
            if short and self.cache.evict(self.pool.shard_of_slot(slot),
                                          short) >= short:
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
        t_disp = self.clock() - t0
        done = slot.cursor + size == len(prompt)
        tok = int(self._sample(logits[:, -1])[i]) if done else None
        self._sync()
        now = self.clock()
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += size
        self.stats["prefill_steps"] += 1
        if self.obs.enabled:
            self.obs.on_prefill_step(t_disp, now - t0)
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
            if self.obs.enabled:
                # stamped after the sample, as the reference does: with obs
                # on the result's TTFT is this trace's
                self.obs.on_first_token(slot.req, self.clock())
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
        t_disp = self.clock() - t0
        self._sync()
        t_sync = self.clock() - t0
        self.stats["prefill_s"] += t_sync
        if self.obs.enabled:
            self.obs.on_prefill_step(t_disp, t_sync)
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
        if self.obs.enabled:
            # closes the trace; queue wait, TTFT and per-token decode
            # latency come from it
            self.obs.on_retire(slot.req, res, len(slot.generated),
                               res.finish_s)
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

    def _handoff_tick(self) -> list[RequestResult]:
        """Prefill-role half-tick: every slot whose prompt just finished
        (DECODE state: prompt cached, first token sampled) leaves as a
        Handoff. Its blocks are copied to pinned host payloads by
        non-blocking device-to-host copies on the current stream (each
        payload's `done` event recorded behind them), its prompt alone is
        inserted into this worker's prefix cache (the first token's K/V was
        never written here), and its slot is released; the stream runs the
        copies before any later kernel that writes the released blocks. A
        request its first token completed (max_new 1) retires here."""
        out: list[RequestResult] = []
        for i, s in enumerate(self.slots):
            if s.state != DECODE:
                continue
            if len(s.generated) >= s.req.max_new:
                out.append(self._retire_slot(i))
                continue
            blocks = []
            for j in range(self.pool._alloc_upto[i]):
                blk = int(self.pool._table[i, j])
                if blk == self.pool.sentinel:
                    continue
                payload, _ = self.pool.read_block_host(blk, non_blocking=True)
                blocks.append((j, payload))
            self.handoffs.append(Handoff(
                req=s.req, generated=list(s.generated), length=s.length,
                blocks=blocks, first_token_s=s.first_token_s, pool=self.pool))
            # the pool holds exactly the prompt's K/V, so this caches the
            # prompt, as the reference's export does
            self._release_slot(i)
            self.stats["handoffs"] += 1
        return out

    def _try_admit_handoff(self, h: Handoff) -> bool:
        """Import a Handoff into a FREE slot, straight into DECODE state:
        commit, allocate the prompt's blocks, dispatch the payloads'
        host-to-device copies on the current stream (the next step's reads
        come after them on it; no host wait), then give the buffers back to
        the exporting pool behind the copies' events. The emitted counter
        starts past the handed-off tokens: the prefill worker has already
        passed them to the token hook."""
        req = h.req
        total = len(req.prompt) + req.max_new + self._margin
        i = self._place(total, None)
        if i is None:
            return False
        self.pool.reset_slot(i)
        self.pool.commit(i, total, self._max_growth)
        try:
            self.pool.ensure(i, h.length)
        except OutOfBlocks:
            self.pool.release(i)
            return False
        for j, payload in h.blocks:
            self.pool.write_block_host(int(self.pool._table[i, j]), payload)
        h.release_payloads()
        self.slots[i] = _Slot(state=DECODE, req=req, cursor=len(req.prompt),
                              length=h.length, last_tok=h.generated[-1],
                              generated=list(h.generated),
                              emitted=len(h.generated),
                              first_token_s=h.first_token_s)
        self.stats["admitted"] += 1
        if self.obs.enabled:
            self.obs.on_admit(req, i, 0, self.clock())
        return True

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
            t_disp = self.clock() - t0
            self._sync()
            t_sync = self.clock() - t0
            self.stats["decode_s"] += t_sync
            self.stats["decode_tokens"] += emitted
            self.stats["decode_steps"] += 1
            if self.obs.enabled:
                self.obs.on_decode_step(t_disp, t_sync)
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
        t_disp = self.clock() - t0
        toks = self._sample(logits[:, -1])  # the step's host sync
        t_sync = self.clock() - t0
        self.stats["decode_s"] += t_sync
        self.stats["decode_tokens"] += len(dec)
        self.stats["decode_steps"] += 1
        if self.obs.enabled:
            self.obs.on_decode_step(t_disp, t_sync)
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
        # stacked read/write tables: scatters go through the write view,
        # whose adopted entries hold the sentinel (kv_pool.tables_device);
        # None for a dense pool, whose step runs on the dense caches
        inputs = [torch.from_numpy(a) for a in (tokens, pos, active)]
        if self.mesh is not None:
            # one shard's rows of each input go to its device; the shards'
            # logits come back on the engine's device
            logits, _ = self._step(self.shard_params, self.pool.shard_caches,
                                   self.pool.tables_device(), *inputs)
            return logits
        logits, _ = self._step(
            self.params, self.pool.caches, self.pool.tables_device(),
            *(a.to(self.device) for a in inputs))
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
        for d in {self.device, *self.pool.devices}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree.to(device)
