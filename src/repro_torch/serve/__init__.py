"""NVFP4 serving: ServeEngine, paged KV pool, prefix cache, scheduler,
prequant weights, sampling.

Modules (import them directly):

    engine        — ServeEngine: policy-ordered admission, chunked prefill,
                    continuous batching over fixed decode slots
    kv_pool       — block-based paged KV pool (bf16 or NVFP4), refcounted
                    blocks, per-sequence read/write block tables, host copies
    prefix_cache  — radix prefix cache with copy-on-write and a host tier
    scheduler     — FIFO and latency-aware admission / prefill policies
    prequant      — quantize-once NVFP4 weight cache
    sampling      — greedy / temperature / top-k sampling
    decode        — the engine's paged step builder
    spec_decode   — self-speculative decoding (truncated-stack draft)
    frontend      — streaming HTTP frontend (SSE) over an engine-thread
                    bridge, tenant quotas, drain
"""
