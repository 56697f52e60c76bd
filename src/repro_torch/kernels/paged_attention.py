"""Paged GQA flash-decode: plain version and kernel launch.

Replaces the TPU kernel `repro/kernels/paged_attention.py:paged_gqa_call`.
The plain version is the serving reference path the kernel stands in for:
materialize `gather_view` of both pools and run `decode_sdpa` over the full
table capacity, in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30  # matches models.attention.NEG_INF
BLOCK_SIZES = (4, 8, 16, 32)  # pool block sizes the kernel is built for
MAX_HEAD_DIM = 128
MAX_SQ = 16


def sqrt_hd(hd: int) -> float:
    """The f32 sqrt(hd) decode_sdpa divides scores by."""
    return float(np.sqrt(np.float32(hd)))


def paged_gqa_plain(q, k_pool, v_pool, table, pos, window=None):
    """q (B, Sq, H, hd) vs pools (P, BS, KV, hd/vd) -> f32 (B, Sq, H, vd)."""
    from repro_torch.models.attention import decode_sdpa
    from repro_torch.serve.kv_pool import gather_view
    return decode_sdpa(q.float(), gather_view(k_pool, table),
                       gather_view(v_pool, table), pos, window=window)


def launch(q, k_pool, v_pool, table, pos, out, window) -> None:
    """Enqueue the CUDA kernel on the current stream (output preallocated)."""
    b, sq, h, hd = q.shape
    n_blocks, bs, kv = k_pool.shape[:3]
    vd = v_pool.shape[3]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.library().paged_gqa_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
        v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, sq, h, kv, hd, vd, n_blocks, bs, table.shape[1],
        0 if window is None else int(window), sqrt_hd(hd), stream)
    build.check(status, "paged_gqa")
