"""Four-over-Six NVFP4 quantization: plain version, launch geometry and
kernel launch.

Replaces the TPU kernel `repro/kernels/nvfp4_quant.py:nvfp4_fos_quant`,
together with the absmax its wrapper takes outside the `pallas_call`. The
output is the serving form: codes packed two per byte (M, K/2) uint8, e4m3
scales as raw bits (M, K/16) uint8, and the f32 per-tensor gscale.

On the card `csrc/nvfp4_quant.cu` computes the absmax as well, in one of two
regimes that `plan` picks from the shape alone: up to SMALL_MAX_CHUNKS
chunks of 8 elements (every decode call) one launch of one thread-block
cluster of up to 16 CTAs that holds x in registers from the absmax to the
encode; above it an absmax-partials kernel and an encode kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.kernels import build

# f32 images of the constants quant_four_over_six divides by, so the kernel
# and the plain version round against identical scalars
S6 = float(np.float32(Q.S_EDEN))
S4 = float(np.float32(Q.S_EDEN * 4.0 / 6.0))
GDIV = float(np.float32((Q.S_EDEN * 4.0 / 6.0) * F.FP8_MAX))

CHUNK = 8              # elements of one lane (two lanes hold a 16-group)
SMALL_THREADS = 512    # most threads of one CTA of the cluster regime
MAX_CLUSTER = 16       # CTAs of one cluster (Hopper's non-portable maximum)
CLUSTER_SPREAD = 64    # chunks a cluster CTA takes at least
SMALL_MAX_CHUNKS = MAX_CLUSTER * SMALL_THREADS   # one chunk a thread
THREADS = 256          # threads of one CTA of the two-pass kernels
SMS = 132              # H100 SXM: the two-pass grids are sized to it
ABSMAX_LOADS = 4       # chunks a thread of the absmax kernel keeps in flight

# launches of each regime (ops.LAUNCHES counts both as "nvfp4_fos_quant")
REGIME_LAUNCHES = {"cluster": 0, "two_pass": 0}


class Plan(NamedTuple):
    """Launch geometry of one call: the regime ("cluster" or "two_pass");
    `ctas`, the cluster's CTAs or the encode kernel's grid; `threads` of one
    CTA; `partial_ctas`, the absmax kernel's grid and partial count (0 for a
    cluster)."""
    regime: str
    ctas: int
    threads: int
    partial_ctas: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cluster_plan(chunks: int) -> Plan:
    """One cluster over `chunks` chunks (at most SMALL_MAX_CHUNKS), one chunk
    a thread: CTAs of whole warps, about CLUSTER_SPREAD chunks each or more
    (up to MAX_CLUSTER CTAs), none of them empty."""
    ctas = max(1, min(MAX_CLUSTER, _cdiv(chunks, CLUSTER_SPREAD)))
    threads = _cdiv(_cdiv(chunks, ctas), 32) * 32
    return Plan("cluster", _cdiv(chunks, threads), threads, 0)


def two_pass_plan(chunks: int) -> Plan:
    """The absmax kernel at ABSMAX_LOADS chunks a thread over at most 2 CTAs
    an SM, the encode kernel at one chunk a thread over at most the 4 CTAs an
    SM holds at once (its registers allow 4)."""
    return Plan("two_pass", min(_cdiv(chunks, THREADS), 4 * SMS), THREADS,
                min(_cdiv(chunks, THREADS * ABSMAX_LOADS), 2 * SMS))


def plan(m: int, k: int) -> Plan:
    """The geometry of an (M, K) call, from its M * K / 8 chunks alone: one
    cluster up to SMALL_MAX_CHUNKS (every decode call), two passes above."""
    chunks = m * k // CHUNK
    return cluster_plan(chunks) if chunks <= SMALL_MAX_CHUNKS else two_pass_plan(chunks)


def nvfp4_fos_quant_plain(x: torch.Tensor):
    """x (M, K) -> (packed u8 (M, K/2), scale bits u8 (M, K/16), gscale f32)."""
    qt = Q.quant_four_over_six(x)
    return F.pack_fp4(qt.codes), F.e4m3_to_bits(qt.scales), qt.gscale


def launch(x, packed, scale_bits, gscale, p: Plan | None = None) -> None:
    """Enqueue the regime `plan` picks (or `p`) on the current stream
    (outputs preallocated; the two-pass partials allocated here)."""
    m, k = x.shape
    p = p or plan(m, k)
    partials = (torch.empty((p.partial_ctas,), dtype=torch.float32,
                            device=x.device) if p.partial_ctas else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = build.library().nvfp4_fos_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
        scale_bits.data_ptr(), gscale.data_ptr(),
        None if partials is None else partials.data_ptr(), m, k,
        0 if p.regime == "cluster" else 1, p.ctas, p.threads, p.partial_ctas,
        GDIV, S6, S4, stream)
    build.check(status, f"nvfp4_fos_quant ({p.regime})")
    REGIME_LAUNCHES[p.regime] += 1
