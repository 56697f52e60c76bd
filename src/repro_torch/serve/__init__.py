"""NVFP4 serving: ServeEngine, paged KV pool, prequant weights, sampling.

Modules (import them directly):

    engine    — ServeEngine: FIFO admission, chunked prefill, continuous
                batching over fixed decode slots
    kv_pool   — block-based paged bf16 KV pool + per-sequence block tables
    prequant  — quantize-once NVFP4 weight cache
    sampling  — greedy / temperature / top-k sampling
    decode    — the engine's paged step builder
"""
