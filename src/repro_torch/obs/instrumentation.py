"""One observability hook object threaded through the serving engine.

Counterpart of `repro/obs/instrumentation.py`. `Instrumentation` is the one
point every serve-layer component reports into: the engine takes it as
`EngineConfig(obs=...)` and hands it to the KV pool, the prefix cache, the
scheduler and the speculative path it owns. It bundles

  - registry-backed engine counters that replace the plain `engine.stats`
    dict behind a `MutableMapping` view with the same keys (`stats_view`),
  - per-request lifecycle traces (obs/tracing.py) recorded at the engine's
    host transition points, collected in a bounded `TraceSink`,
  - per-tick gauges (slot occupancy, free blocks, pool fragmentation,
    queue depth and aging, cached radix nodes),
  - step-duration histograms split by `phase`: `dispatch` (the host has
    enqueued the step's kernels) against `synced` (the step's existing
    host sync has returned),
  - the speculative acceptance histogram and pool / cache event counters,
  - an optional NVFP4 quantization-health probe (obs/quant_probe.py),
    which `prequantize` runs over the raw weights.

Disabled mode: `EngineConfig(obs=None)` resolves to the `NULL` sentinel, a
slotted singleton whose only attribute is `enabled = False`. Every engine
hook site guards with `if self.obs.enabled:`, so the disabled hot path
costs one attribute read and allocates nothing (no trace objects, no
metric children, no dict churn). No hook adds a host sync or device work.

One `Instrumentation` serves ONE engine (trace lifecycles and the stats
view are per-engine state). Point several engines' Instrumentation at one
shared `MetricsRegistry` to get one combined snapshot; the `engine` label
keeps their series apart.
"""

from __future__ import annotations

import itertools
from collections.abc import MutableMapping

from repro_torch.obs import tracing
from repro_torch.obs.metrics import MetricsRegistry, default_registry

#: `engine.stats` keys, in their dict order (the stats view iterates in
#: this order): the reference's, then the port's draft catch-up counts
#: (speculative decoding over a prefix-cache hit). "handoffs" counts a
#: prefill-role engine's exports (`serve.engine.Handoff`).
STAT_FLOAT_KEYS = ("prefill_s", "decode_s")
STAT_INT_KEYS = ("prefill_tokens", "decode_tokens", "decode_steps", "ticks",
                 "admitted", "rejected", "finished", "spec_rounds",
                 "draft_tokens", "accepted_tokens", "prefill_steps",
                 "prefill_skipped_tokens", "prefix_hits", "cancelled",
                 "handoffs", "draft_catchup_tokens", "draft_catchup_steps")
STAT_KEYS = STAT_FLOAT_KEYS + STAT_INT_KEYS


def legacy_stats_dict() -> dict:
    """The plain-dict stats store used when observability is disabled."""
    d = {k: 0.0 for k in STAT_FLOAT_KEYS}
    d.update({k: 0 for k in STAT_INT_KEYS})
    return d


class NullInstrumentation:
    """Disabled-mode sentinel: engine hook sites check `.enabled` and do
    nothing else. Slotted and attribute-free so any accidental use as a
    real Instrumentation fails loudly instead of silently recording."""

    __slots__ = ()
    enabled = False


NULL = NullInstrumentation()

_ENGINE_IDS = itertools.count()

#: spec-decode acceptance histogram buckets: accepted DRAFT tokens per
#: (slot, round) — small integers, one bucket each up to 16.
_SPEC_BUCKETS = tuple(float(i) for i in range(17))


class Instrumentation:
    enabled = True

    def __init__(self, registry: MetricsRegistry | None = None,
                 engine_label: str | None = None, max_traces: int = 4096,
                 quant_probe=None):
        self.registry = registry if registry is not None else default_registry()
        self.engine_label = (engine_label if engine_label is not None
                             else str(next(_ENGINE_IDS)))
        self.reg = self.registry.child(engine=self.engine_label)
        self.quant_probe = quant_probe
        self.trace_sink = tracing.TraceSink(max_traces=max_traces)
        self._live: dict[int, tracing.RequestTrace] = {}
        reg = self.reg

        # -- engine stat counters (legacy engine.stats, registry-backed) --
        self._stat_cells = {}
        for k in STAT_KEYS:
            unit = "seconds" if k in STAT_FLOAT_KEYS else None
            name = (f"serve_engine_{k[:-2]}_seconds_total" if unit
                    else f"serve_engine_{k}_total")
            c = reg.counter(name, f"engine stat '{k}'")
            self._stat_cells[k] = c.labels()  # materialize the series now

        # -- request lifecycle histograms ---------------------------------
        self.queue_wait_hist = reg.histogram(
            "serve_request_queue_wait_seconds",
            "submit -> slot admission")
        self.ttft_hist = reg.histogram(
            "serve_request_ttft_seconds",
            "submit -> first sampled token")
        self.decode_tok_hist = reg.histogram(
            "serve_request_decode_token_seconds",
            "mean per-token decode latency of a retired request")
        self.latency_hist = reg.histogram(
            "serve_request_latency_seconds",
            "submit -> retirement (RequestResult.latency_s)")

        # -- step durations: dispatch (enqueue returned) vs synced (device
        #    done, KV-cache writes included) -------------------------------
        self.prefill_step_hist = reg.histogram(
            "serve_prefill_step_seconds",
            "one prefill chunk; phase=dispatch|synced", labels=("phase",))
        self.decode_step_hist = reg.histogram(
            "serve_decode_step_seconds",
            "one batched decode step; phase=dispatch|synced",
            labels=("phase",))

        # -- per-tick gauges ----------------------------------------------
        self.queue_depth = reg.gauge(
            "serve_queue_depth", "queued requests at tick start")
        self.queue_age = reg.gauge(
            "serve_queue_age_ticks", "max queued_ticks over the queue")
        self.queue_slack = reg.gauge(
            "serve_queue_min_slack_seconds",
            "tightest deadline slack in the queue (LatencyPolicy)")
        self.slots_gauge = reg.gauge(
            "serve_slots", "slots by state", labels=("state",))
        self.pool_free_blocks = reg.gauge(
            "serve_pool_free_blocks", "free blocks per shard",
            labels=("shard",))
        self.pool_frag_tokens = reg.gauge(
            "serve_pool_fragmentation_tokens",
            "allocated-but-unoccupied token capacity (internal frag)")
        self.pool_frag_ratio = reg.gauge(
            "serve_pool_fragmentation_ratio",
            "fragmentation_tokens / allocated token capacity")
        self.cache_nodes = reg.gauge(
            "serve_prefix_cache_nodes", "radix nodes (cached blocks)")

        # -- pool / cache event counters ----------------------------------
        self.pool_alloc = reg.counter(
            "serve_pool_blocks_allocated_total", "blocks taken from free lists")
        self.pool_freed = reg.counter(
            "serve_pool_blocks_freed_total", "blocks returned to free lists")
        self.pool_reclaimed = reg.counter(
            "serve_pool_blocks_reclaimed_total",
            "out-of-window blocks reclaimed mid-sequence")
        self.pool_cow = reg.counter(
            "serve_pool_cow_total", "copy-on-write block copies")
        self.cache_lookups = reg.counter(
            "serve_prefix_cache_lookups_total", "admissions consulting the cache")
        self.cache_hits = reg.counter(
            "serve_prefix_cache_hits_total", "admissions that adopted a prefix")
        self.cache_hit_tokens = reg.counter(
            "serve_prefix_cache_hit_tokens_total", "prompt tokens served from cache")
        self.cache_inserted = reg.counter(
            "serve_prefix_cache_inserted_blocks_total", "blocks newly cached")
        self.cache_evicted = reg.counter(
            "serve_prefix_cache_evicted_blocks_total", "cached blocks evicted")

        # -- hierarchical cache tiers / disaggregation ---------------------
        self.cache_spilled = reg.counter(
            "serve_prefix_cache_spilled_blocks_total",
            "evicted blocks snapshotted to the host tier instead of dropped")
        self.cache_swapped_in = reg.counter(
            "serve_prefix_cache_swapped_in_blocks_total",
            "host-tier blocks copied back into device pools")
        self.cache_swapin_hist = reg.histogram(
            "serve_prefix_cache_swap_in_seconds",
            "host->device swap-in dispatch time per materialize call")
        self.cache_replicated = reg.counter(
            "serve_prefix_cache_replicated_blocks_total",
            "hot-prefix blocks copied into peer shards via the host tier")
        self.host_tier_bytes = reg.gauge(
            "serve_prefix_cache_host_bytes",
            "bytes held by host-RAM prefix snapshots")

        # -- speculative decoding -----------------------------------------
        self.spec_accepted_hist = reg.histogram(
            "serve_spec_accepted_per_round",
            "accepted draft tokens per (slot, round)",
            buckets=_SPEC_BUCKETS)

        # -- structured rejections / cancellations (reason-labelled; the
        #    legacy stats view keeps its fixed key set, so per-reason
        #    breakdown lives here instead of new stats keys) ---------------
        self.reject_reasons = reg.counter(
            "serve_rejections_total",
            "engine admission rejections by reason "
            "(queue_full | unservable)", labels=("reason",))
        self.cancel_reasons = reg.counter(
            "serve_cancellations_total",
            "engine cancellations by reason "
            "(cancelled | disconnected | requeued)", labels=("reason",))

        # -- streaming frontend (serve/frontend.py) -----------------------
        self.streams_open = reg.gauge(
            "serve_frontend_streams_open", "live SSE streams")
        self.streamed_tokens = reg.counter(
            "serve_frontend_streamed_tokens_total",
            "tokens flushed to SSE streams")
        self.frontend_rejects = reg.counter(
            "serve_frontend_rejections_total",
            "frontend-side rejections by reason (backpressure | "
            "rate_limited | budget_exhausted | draining)",
            labels=("reason",))

    # ---- engine.stats compatibility -------------------------------------

    def stats_view(self) -> "_StatsView":
        return _StatsView(self._stat_cells)

    # ---- request lifecycle ----------------------------------------------

    def on_submit(self, req, t: float) -> None:
        tr = tracing.RequestTrace(req.req_id)
        tr.begin(tracing.QUEUED, t)
        self._live[req.req_id] = tr

    def on_reject(self, req, reason: str, t: float) -> None:
        self.reject_reasons.labels(reason=reason).inc()
        tr = tracing.RequestTrace(req.req_id)  # -1: rejected pre-id
        tr.finish(tracing.REJECTED, t)
        tr.spans[-1].attrs["reason"] = reason
        self.trace_sink.append(tr)

    def on_admit(self, req, slot: int, skipped: int, t: float) -> None:
        tr = self._live.get(req.req_id)
        if tr is None:
            return
        tr.end(tracing.QUEUED, t)
        self.queue_wait_hist.observe(t - tr.span(tracing.QUEUED).t0)
        if skipped:
            tr.event("prefill_skipped", t, tokens=skipped)
        tr.begin(tracing.PREFILL, t, slot=slot)

    def on_first_token(self, req, t: float) -> None:
        tr = self._live.get(req.req_id)
        if tr is None:
            return
        tr.end(tracing.PREFILL, t)
        tr.begin(tracing.DECODE, t)
        ttft = tr.ttft_s
        if ttft is not None:
            self.ttft_hist.observe(ttft)

    def on_retire(self, req, result, n_tokens: int, t: float) -> None:
        """Close the trace and surface its latencies on the result."""
        tr = self._live.pop(req.req_id, None)
        if tr is None:
            return
        tr.end(tracing.DECODE, t, tokens=n_tokens)
        tr.finish(tracing.RETIRED, t)
        result.queue_wait_s = tr.queue_wait_s
        result.ttft_s = tr.ttft_s
        result.decode_tok_s = tr.decode_tok_s(n_tokens)
        if result.decode_tok_s is not None:
            self.decode_tok_hist.observe(result.decode_tok_s)
        self.latency_hist.observe(result.latency_s)
        self.trace_sink.append(tr)

    def on_cancel(self, req, t: float, reason: str = "cancelled") -> None:
        """Cancellation terminal. `reason` picks the terminal span name:
        "disconnected" / "requeued" (the frontend's lifecycle states) map
        to their own spans, anything else lands as `cancelled`."""
        self.cancel_reasons.labels(reason=reason).inc()
        tr = self._live.pop(req.req_id, None)
        if tr is None:
            return
        state = {"disconnected": tracing.DISCONNECTED,
                 "requeued": tracing.REQUEUED}.get(reason, tracing.CANCELLED)
        tr.finish(state, t)
        self.trace_sink.append(tr)

    # ---- streaming frontend (serve/frontend.py) --------------------------
    # Trace-touching hooks (`_live`) are engine-thread-only: the frontend
    # bridge invokes them from the engine tick thread (token hook, command
    # queue). Metric-only hooks are lock-protected and safe from the asyncio
    # thread.

    def on_stream_open(self, req, t: float) -> None:
        """First token delivered to a live consumer: opens the `streamed`
        span (auto-closed by whichever terminal transition follows —
        retire, disconnect, requeue, cancel). Engine-thread only."""
        self.streams_open.inc(1)
        tr = self._live.get(req.req_id)
        if tr is not None and tr.span(tracing.STREAMED) is None:
            tr.begin(tracing.STREAMED, t)

    def on_stream_close(self) -> None:
        self.streams_open.inc(-1)

    def on_stream_tokens(self, n: int) -> None:
        if n:
            self.streamed_tokens.inc(n)

    def on_frontend_reject(self, reason: str) -> None:
        """Frontend-side rejection: no engine Request exists yet (drain
        mode, tenant rate limit/budget, admission backpressure), so this
        books only the reason-labelled counter — no trace."""
        self.frontend_rejects.labels(reason=reason).inc()

    def on_drain(self, t: float) -> None:
        """Drain completed (engine thread): point `drained` marker trace."""
        tr = tracing.RequestTrace(-1)
        tr.finish(tracing.DRAINED, t)
        self.trace_sink.append(tr)

    # ---- step timing -----------------------------------------------------

    def on_prefill_step(self, dispatch_s: float, synced_s: float) -> None:
        self.prefill_step_hist.labels(phase="dispatch").observe(dispatch_s)
        self.prefill_step_hist.labels(phase="synced").observe(synced_s)

    def on_decode_step(self, dispatch_s: float, synced_s: float) -> None:
        self.decode_step_hist.labels(phase="dispatch").observe(dispatch_s)
        self.decode_step_hist.labels(phase="synced").observe(synced_s)

    # ---- per-tick gauges -------------------------------------------------

    def on_tick(self, eng) -> None:
        """Engine tick boundary: refresh occupancy/pool/cache gauges.
        Host-side reads only: no device interaction."""
        counts = {"free": 0, "prefill": 0, "decode": 0}
        for s in eng.slots:
            counts[s.state] += 1
        for state, n in counts.items():
            self.slots_gauge.labels(state=state).set(n)
        u = eng.pool.utilization()
        for sh, n in enumerate(u["free_by_shard"]):
            self.pool_free_blocks.labels(shard=str(sh)).set(n)
        self.pool_frag_tokens.set(u["frag_tokens"])
        self.pool_frag_ratio.set(u["frag_ratio"])
        if eng.cache is not None:
            self.cache_nodes.set(eng.cache.cached_blocks())
            if eng.cache.spill:
                self.host_tier_bytes.set(eng.cache.host_bytes)

    # ---- pool / cache / spec events -------------------------------------

    def on_pool_alloc(self, n: int) -> None:
        self.pool_alloc.inc(n)

    def on_pool_free(self, n: int = 1) -> None:
        self.pool_freed.inc(n)

    def on_pool_reclaim(self, n: int) -> None:
        self.pool_reclaimed.inc(n)

    def on_pool_cow(self) -> None:
        self.pool_cow.inc()

    def on_cache_record(self, hit: bool, tokens: int) -> None:
        self.cache_lookups.inc()
        if hit:
            self.cache_hits.inc()
            self.cache_hit_tokens.inc(tokens)

    def on_cache_insert(self, blocks: int) -> None:
        if blocks:
            self.cache_inserted.inc(blocks)

    def on_cache_evict(self, blocks: int) -> None:
        if blocks:
            self.cache_evicted.inc(blocks)

    def on_cache_spill(self, blocks: int, bytes_: int) -> None:
        if blocks:
            self.cache_spilled.inc(blocks)

    def on_cache_swap_in(self, blocks: int, seconds: float) -> None:
        if blocks:
            self.cache_swapped_in.inc(blocks)
            self.cache_swapin_hist.observe(seconds)

    def on_cache_replicate(self, blocks: int) -> None:
        if blocks:
            self.cache_replicated.inc(blocks)

    # ---- exposition ------------------------------------------------------

    def prometheus(self) -> str:
        return self.registry.to_prometheus()

    def snapshot(self) -> dict:
        return self.registry.snapshot()


class _StatsView(MutableMapping):
    """`engine.stats` backed by registry counters: same keys, same int/float
    value types, same iteration order as the legacy dict — existing callers
    (`stats[k] += n`, bench reset loops `stats[k] = 0`) work unchanged while
    every mutation lands in the metrics registry."""

    __slots__ = ("_cells",)

    def __init__(self, cells):
        self._cells = cells  # key -> metric child (insertion-ordered)

    def __getitem__(self, k):
        v = self._cells[k].get()
        return v if k in STAT_FLOAT_KEYS else int(v)

    def __setitem__(self, k, v):
        self._cells[k].set(v)

    def __delitem__(self, k):
        raise TypeError("engine.stats has a fixed key set")

    def __iter__(self):
        return iter(self._cells)

    def __len__(self):
        return len(self._cells)

    def __repr__(self):
        return repr(dict(self))
