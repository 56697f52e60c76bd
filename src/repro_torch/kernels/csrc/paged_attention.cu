// Block-table flash-decode attention over the paged KV pools for Hopper
// (sm_90a): GQA over the bf16 pool (#5) and the NVFP4 pool (#6), and the
// absorbed-form MLA latent decode over bf16 (#7) and NVFP4 (#8) latent pools.
//
// ---- GQA: paged_gqa_split_kernel + paged_gqa_merge_kernel -----------------
// Replaces: src/repro/kernels/paged_attention.py:paged_gqa_call (Pallas body
// _gqa_kernel via _gqa_sweep and _online_update) and, with kPacked,
// paged_gqa_q_call (_gqa_q_kernel, whose _dequant_tile decodes the packed
// block in VMEM). Computes, for each batch row b and query head h, softmax
// attention of the Sq query tokens at absolute positions pos[b] + s over the
// keys the row's block table maps, without gathering a dense view:
//   - skipped blocks: OOB sentinel entries (>= n_blocks), blocks entirely
//     past the newest query position, and with a window, blocks entirely
//     older than the OLDEST query's window (horizon pos[b]);
//   - per-key masks: kj <= qpos and, with a window, kj > qpos - window;
//   - scores divide by the f32 sqrt(hd) (an IEEE division, as decode_sdpa
//     does), masked scores are NEG_INF = -1e30, exp of a masked lane is
//     exactly 0, P.V accumulates in fp32, and a row with l == 0 returns
//     exact zeros.
//
// Bound on the H100: at serving shapes, latency and occupancy, not bytes. A
// llama-200m decode call reads ~0.15 MB (NVFP4) or ~0.5 MB (bf16) of K/V,
// under 0.2 us at 3.35 TB/s; what costs is the chain table -> block ->
// bytes -> scores -> softmax of each row, and how few of the 132 SMs a
// (row, head) grid keeps busy (40 blocks at 4 slots x 10 heads).
//
// Design, point by point:
//   - split-KV (flash decoding): one 128-thread CTA per (row b, KV head g,
//     split), a split being a fixed run of logical blocks from
//     kernels/paged_attention.py:plan (shape-only, so a call's bits never
//     depend on timing). Each CTA writes a partial (m, l, acc) per query row;
//     a split with no live block writes (NEG_INF, 0) and leaves. The second
//     kernel merges the partials in split order (no atomics: two calls are
//     bitwise equal); it takes about a third of a llama-200m decode call's
//     device time (PERF.md), the price of a fixed order without counters.
//     With one split the CTA writes the output itself.
//   - every warp busy at Sq = 1: the CTA's R = Sq x (H/KV) query rows are
//     spread over `row_groups` (1, 2 or 4) warp groups and the keys of each
//     block over the remaining 4 / row_groups warps (key t goes to key group
//     t mod key_groups). Each warp keeps its own (m, l, acc) for up to 4 rows
//     and scores 4 keys x 4 rows at once: a transposed butterfly (16
//     shuffles, not 80) leaves each lane pair with one whole score, so the
//     division, mask and exp run once per score spread over the lanes, not
//     on every lane; the probabilities reach the P.V lanes through shared
//     memory. The key groups merge through shared memory in fixed warp
//     order.
//   - GQA: the CTA serves all H/KV query heads of its KV head, so each K/V
//     block is loaded, and decoded, once per KV head.
//   - vector loads: a (token, head) row comes in as 16-byte cp.async chunks
//     (8 bf16, or 32 NVFP4 codes); the packed pool is decoded once per
//     16-group (one 8-byte code load, one scale byte decoded once, 16
//     nibbles by bit arithmetic) to bf16 in shared memory. e2m1 x e4m3 has
//     <= 6 significant bits, so the decode is exact and both pools leave the
//     same bf16 operands that the plain version's gather dequantizes to.
//   - overlap: the table entries of the split are read once into shared
//     memory, every live block of the split is put in flight at once (one
//     cp.async group each), and block k is computed as soon as its group
//     lands while the later blocks still arrive. Splits are short (16 keys
//     at serving shapes, one block at BS 16 and 32: measured faster on the
//     card than 32 or 64, PERF.md), so the bytes of one CTA overlap the
//     math of the others on its SM: a CTA holds 8 KB of bf16 tiles (2.3 KB
//     more of packed rows) and 8.5 KB of merge buffers, and four fit an SM
//     by registers.
// expf and division are the IEEE versions (no fast math).
//
// ---- MLA over the bf16 latent pool (#7): paged_mla_tc_kernel<TR, BS> +
// paged_mla_merge_kernel ----------------------------------------------------
// Replaces: src/repro/kernels/paged_attention.py:paged_mla_call (_mla_kernel
// via _mla_sweep). For each row b, query s and head h: scores s_t =
// (q_abs.cc_t + q_rope.kc_t) * scale (the two dots summed first, then
// MULTIPLIED by the f32 1/sqrt(qk_dim)), causal mask t <= pos[b] + s (masked
// scores NEG_INF), online softmax in f32 (IEEE expf and division), and the
// readout over cc itself: o_lat (B, Sq, H, lora) f32 for the caller's W_uv
// absorption. No window; a row with l == 0 (inactive: all-sentinel table)
// returns exact zeros.
//
// Bound on the H100: all H heads share one latent row per token (lora + rope
// = 576 bf16, 1,152 B), read once from HBM, while each (query, head, token)
// takes 2 (lora + rope) + 2 lora = 2,176 flops: ~240 flops a byte at H = 128,
// Sq = 1. That is a matrix product (M = Sq H pairs, K = 576, N = keys; then
// M, K = keys, N = lora), which the card runs on its tensor cores at 989
// TFLOP/s, against 67 for f32 on the CUDA cores. At 4 rows x 4,096 tokens a
// call reads 18.9 MB (5.6 us at 3.35 TB/s) and does 4.56 GFLOP (4.6 us on the
// tensor cores; 3 bf16 terms a product make it 13.7 GFLOP, 13.8 us).
//
// Exactness: an f32 x splits into hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid); each residual is exact in f32 and the three terms hold
// 8 + 8 + 8 significant bits, so hi + mid + lo == x for every normal x whose
// residuals stay normal (|x| >= 2^-110; below that the error is under 2^-126
// absolute). A bf16 x bf16 product is exact in f32. So with q_abs, an f32
// q_rope and the unnormalised probabilities P split that way (a bf16 q_rope
// is its own hi), every product the tensor cores form equals the plain
// version's, and only the order of the f32 sums differs: the attention bar
// |o - o_plain| <= 5e-6 + 1e-5 |o_plain| is unchanged.
//
// Design, point by point:
//   - split-KV: one 256-thread CTA per (row b, tile of 16 (query, head)
//     pairs, split), the splits from kernels/paged_attention.py:plan_mla with
//     wave = MLA_TC_WAVE (shapes only): the most splits that keep b x tiles x
//     splits within one wave of 264 CTAs (2 a SM on 132 SMs), so that the
//     f32 partials stay small: at 4 rows x 4,096 tokens 8 splits of 32 blocks
//     (256 CTAs, 8.4 MB of partials against #8's 29 splits and 30.5 MB); at
//     the engine's 256-token table 8 splits of 2 blocks; at 4 rows x Sq 16
//     one split (512 CTAs), no partials. paged_mla_merge_kernel sums the
//     partials in split order (no atomics: two calls are bitwise equal).
//   - loads: a step is 16 keys (the readout's k16); their cc and kc rows come
//     in as bf16 by 16-byte cp.async into a 4-stage ring (keys of a sentinel
//     block or past the split's end are zero-filled and masked), rows padded
//     by 16 B so the 8 rows of every ldmatrix fall on distinct banks. No f32
//     staging, no per-element loader.
//   - scores on the tensor cores (mma.sync m16n8k16 bf16 -> f32): the 8 warps
//     split the score's K: warp w takes the latent k16 steps w + 8 i (q_abs
//     split once per CTA: hi and mid held in registers, lo in shared
//     memory) and, for w < rope / 16, rope k16 step w (q_rope's terms split
//     once into shared memory). Each k16 step's three terms accumulate from zero and are added
//     in f32 in step order; the warps' latent and rope tiles meet in shared
//     memory, where every warp sums them in warp order (the same bits in
//     every warp), then (lat + rope) * scale.
//   - readout on the tensor cores: the score's two m16n8 C fragments are the
//     A fragment of O += P.cc over the step's 16 keys, split into P's three
//     bf16 terms in registers (no trip through shared memory); B comes by
//     ldmatrix.trans from the same cc tile. The 8 warps split the readout's
//     lora columns (warp w: units of 16 columns w + 8 i), so a lane holds 32
//     f32 accumulators at lora 512; each step's product starts from zero and
//     is added as o = o * corr + d.
//   - registers: at most 128 a thread (__launch_bounds__(256, 2)): q_abs's
//     hi and mid terms (32), the accumulators (32), P's terms (12); with
//     q_abs's lo term in registers too ptxas spilled. Shared memory: 109.3 KB
//     a CTA at deepseek-v3's widths (the ring 74.3 KB, q_rope's terms 6.8 KB,
//     q_abs's lo term 16.3 KB, the partial score tiles 12 KB), so two CTAs
//     fit an SM.

// ---- MLA over NVFP4 latent pools (#8): paged_mla_split_kernel<TR, BS> +
// paged_mla_merge_kernel ----------------------------------------------------
// Replaces: src/repro/kernels/paged_attention.py:paged_mla_q_call
// (_mla_q_kernel). #7's function over the PackedKV leaves of cc and kc (e2m1
// code pairs and e4m3 scale bytes), bound the same way: by its f32
// operations at long contexts, by the latency of each row's chain (table ->
// packed block -> decode -> scores -> softmax) at serving ones. The first
// port's kernel read every element as two byte loads and a decode, and each of a
// row's 32 head tiles repeated that (H = 128); that is what this design
// removes:
//   - split-KV: one 128-thread CTA per (row b, tile of 16 (query, head)
//     pairs, split), a split being a run of logical blocks from
//     kernels/paged_attention.py:plan_mla (shapes only). Each CTA writes a
//     partial (m, l, acc) per pair, and paged_mla_merge_kernel sums them in
//     split order (no atomics: two calls are bitwise equal); with one split
//     the CTA writes o_lat itself. A split costs (lora + 2) x 4 = 2,056 B of
//     f32 scratch per (query, head) at lora 512, and plan_mla caps a call's
//     scratch at MLA_SCRATCH_BYTES = 32 MiB, 31 splits a row at 4 rows x 128
//     heads x Sq 1: splits of one 16-token block over deepseek-v3's serving
//     table (16 blocks), 29 splits of 9 blocks at 4,096 tokens, and one split
//     (no scratch) at 4 rows x Sq 16, the engine's prefill chunks.
//   - loads: a block's four packed runs (cc codes and scales, kc codes and
//     scales; contiguous in the pool, 324 B a token) come in by 16-byte
//     cp.async into a ring of kMlaStages = 4 stages, so up to 4 blocks of a
//     split are in flight while the CTA computes (at serving shapes a split
//     is one block, and every live block of a row is in flight at once in
//     CTAs of its own).
//   - decode once per 16-group (decode_group16: one 8-byte code load, the
//     scale byte decoded once) to bf16 in shared memory; exact, so the
//     operands equal what the plain version's gather dequantizes to. A
//     block is decoded once per CTA, 8 times per row at H = 128, Sq = 1.
//   - a warp carries 4 pairs and scores 4 keys at once: the 16 (pair, key)
//     partial dots are reduced by the transposed butterfly of the GQA kernel
//     (fold), once for the latent sum and once for the rope sum (32
//     shuffles for 16 scores; the first port's kernel spent 160), then (lat + rope) * scale
//     in the reference's order; the division, mask and expf run once per
//     score, spread over the lanes. A lane owns latent dims 4 lane + 128 c +
//     e (4 runs of 4: 8-byte bf16 loads) and rope dims 2 lane + e, and holds
//     its 4 pairs' q (72 floats) and accumulators (64) in registers.
// Softmax and readout in fp32, expf and division the IEEE versions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;                 // head dim / value dim cap
constexpr int kMaxSq = 16;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kRowChunk = 4;        // query rows one warp carries at once
constexpr int kKeyGroup = 4;        // keys one warp scores together
constexpr int kPairs = kRowChunk * kKeyGroup;  // scores of one group: 16
constexpr int kMaxSplitKeys = 64;   // keys of one split (blocks x BS)
constexpr int kMaxSplitBlocks = 16; // blocks of one split (<= 32: one ballot)

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t hi16) {
  return __uint_as_float(hi16 << 16);
}

// 4 consecutive bf16 from shared memory (8-byte aligned) as f32.
__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float o[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = bf16_bits_to_f32(w.x & 0xffffu);
  o[1] = __uint_as_float(w.x & 0xffff0000u);
  o[2] = bf16_bits_to_f32(w.y & 0xffffu);
  o[3] = __uint_as_float(w.y & 0xffff0000u);
}

// E2M1 code -> f32 by its bits: magnitudes 0, 0.5, then (k + 252) << 22
// for k >= 2 (1, 1.5, 2, 3, 4, 6); bit 3 is the sign.
__device__ __forceinline__ float e2m1_value(uint32_t c) {
  const uint32_t k = c & 7u;
  const uint32_t mag = k >= 2u ? (k + 252u) << 22 : (k ? 0x3F000000u : 0u);
  return __uint_as_float(mag | ((c & 8u) << 28));
}

// Raw float8_e4m3fn bits -> f32: (1 + m/8) 2^(e-7), subnormal m 2^-9.
__device__ __forceinline__ float e4m3_value(uint32_t b) {
  const uint32_t e = (b >> 3) & 15u, m = b & 7u;
  const float mag = e ? __uint_as_float(((e + 120u) << 23) | (m << 20))
                      : (float)m * 0.001953125f;
  return (b & 0x80u) ? -mag : mag;
}

// One 16-group of the NVFP4 pool (8 code bytes, one scale byte) -> 16 bf16,
// exact: the scale is decoded once, each nibble's value times it has <= 6
// significant bits.
__device__ __forceinline__ void decode_group16(uint2 w, uint32_t sbyte,
                                               __nv_bfloat16* dst) {
  const float sc = e4m3_value(sbyte);
  uint32_t o[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t x = half ? w.y : w.x;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(
          e2m1_value(x >> (4 * e)) * sc, e2m1_value(x >> (4 * e + 4)) * sc);
      o[half * 4 + e / 2] = *reinterpret_cast<const uint32_t*>(&pr);
    }
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// One `chunk`-byte piece global -> shared: cp.async for 16/8/4 bytes (both
// addresses aligned to it), a synchronous byte copy below that.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           int chunk) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (chunk == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src) : "memory");
  } else if (chunk == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" :: "r"(d), "l"(src) : "memory");
  } else if (chunk == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
  } else {
    for (int i = 0; i < chunk; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight (a
// smaller immediate than n only waits longer).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// One step of the transposed butterfly over 2 kHalf values a lane: lanes
// whose bit `o` is set keep the upper half, the others the lower, each
// adding its partner's copy of the half it keeps.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[kPairs], int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    const float send = up ? v[t] : v[t + kHalf];
    const float keep = up ? v[t + kHalf] : v[t];
    v[t] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The (token t, KV head g) rows of pool block `blk` of one leaf (row_bytes
// each, `kv` heads per token) -> dst[t * row_bytes], by the whole CTA.
template <int BS>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                           int64_t blk, int kv, int g,
                                           int row_bytes, int chunk) {
  const int per_row = row_bytes / chunk;
  for (int i = threadIdx.x; i < BS * per_row; i += kThreads) {
    const int t = i / per_row, c = (i - t * per_row) * chunk;
    copy_chunk(dst + t * row_bytes + c,
               src + ((blk * BS + t) * kv + g) * (int64_t)row_bytes + c, chunk);
  }
}

__host__ __device__ constexpr int64_t align16(int64_t n) { return (n + 15) & ~15; }

// Shared-memory layout of one split of sk keys: the bf16 K and V tiles the
// warps read, then (packed) the raw code and scale rows cp.async lands.
struct GqaSmem {
  int64_t ktile, vtile, kc, ks, vc, vs, bytes;
  __host__ __device__ GqaSmem(int64_t sk, int64_t hd, int64_t vd, bool packed) {
    ktile = 0;
    vtile = align16(sk * hd * 2);
    kc = vtile + align16(sk * vd * 2);
    ks = kc + (packed ? align16(sk * hd / 2) : 0);
    vc = ks + (packed ? align16(sk * hd / 16) : 0);
    vs = vc + (packed ? align16(sk * vd / 2) : 0);
    bytes = vs + (packed ? align16(sk * vd / 16) : 0);
  }
};

// The copy chunk (bytes) of each leaf: K codes or bf16 rows, K scales, V
// codes or bf16 rows, V scales (see chunk_for).
struct Chunks {
  int k, ks, v, vs;
};

template <typename TQ, int BS, bool kPacked>
__global__ void __launch_bounds__(kThreads)
paged_gqa_split_kernel(const TQ* __restrict__ q, const uint8_t* __restrict__ kp,
                       const uint8_t* __restrict__ k_scales,
                       const uint8_t* __restrict__ vp,
                       const uint8_t* __restrict__ v_scales,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int sq, int h_total, int kv, int hd, int vd,
                       int64_t n_blocks, int maxb, int window, float sqrt_hd,
                       int bps, int n_splits, int row_groups, Chunks chunks) {
  extern __shared__ __align__(16) uint8_t gqa_smem[];
  __shared__ __align__(16) float red_acc[kWarps][kRowChunk][kMaxD];
  __shared__ float red_ml[kWarps][kRowChunk][2];
  __shared__ __align__(16) float pbuf[kWarps][kPairs];     // a group's p
  __shared__ __align__(16) float cbuf[kWarps][kRowChunk];  // its rows' corr
  __shared__ int64_t live_blk[kMaxSplitBlocks];
  __shared__ int live_j[kMaxSplitBlocks];
  __shared__ int n_live;

  const int split = blockIdx.x % n_splits;
  const int g = (blockIdx.x / n_splits) % kv;
  const int b = blockIdx.x / n_splits / kv;
  const int rep = h_total / kv;
  const int rows = sq * rep;  // r = s * rep + i: query token s, head g*rep+i
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = pos[b];
  const int pmax = p0 + sq - 1;
  const int j0 = split * bps;
  const int nj = min(bps, maxb - j0);
  auto out_row = [&](int r) -> int64_t {
    const int s = r / rep;
    return ((int64_t)b * sq + s) * h_total + (int64_t)g * rep + (r - s * rep);
  };

  // the split's table entries, once: live blocks compacted in logical order
  if (warp == 0) {
    bool live = false;
    int64_t blk = 0;
    if (lane < nj) {
      const int j = j0 + lane;
      blk = table[(int64_t)b * maxb + j];
      live = blk >= 0 && blk < n_blocks && (int64_t)j * BS <= pmax;
      if (window > 0)
        live = live && ((int64_t)(j + 1) * BS - 1 > (int64_t)p0 - window);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int k = __popc(mask & ((1u << lane) - 1u));
      live_blk[k] = blk;
      live_j[k] = j0 + lane;
    }
    if (lane == 0) n_live = __popc(mask);
  }
  __syncthreads();
  const int nl = n_live;

  if (nl == 0) {  // no live key: (NEG_INF, 0), or exact zeros with one split
    if (n_splits > 1) {
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        float* ml = part_ml + (out_row(r) * n_splits + split) * 2;
        ml[0] = kNegInf;
        ml[1] = 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < rows * vd; i += kThreads)
        out[out_row(i / vd) * vd + i % vd] = 0.f;
    }
    return;
  }

  // every live block in flight at once, one cp.async group each
  const int sk = bps * BS;
  const GqaSmem lay(sk, hd, vd, kPacked);
  __nv_bfloat16* ktile = reinterpret_cast<__nv_bfloat16*>(gqa_smem + lay.ktile);
  __nv_bfloat16* vtile = reinterpret_cast<__nv_bfloat16*>(gqa_smem + lay.vtile);
  for (int k = 0; k < nl; ++k) {
    const int64_t blk = live_blk[k];
    if constexpr (kPacked) {
      stage_rows<BS>(gqa_smem + lay.kc + k * BS * (hd / 2), kp, blk, kv, g, hd / 2, chunks.k);
      stage_rows<BS>(gqa_smem + lay.ks + k * BS * (hd / 16), k_scales, blk, kv, g, hd / 16, chunks.ks);
      stage_rows<BS>(gqa_smem + lay.vc + k * BS * (vd / 2), vp, blk, kv, g, vd / 2, chunks.v);
      stage_rows<BS>(gqa_smem + lay.vs + k * BS * (vd / 16), v_scales, blk, kv, g, vd / 16, chunks.vs);
    } else {
      stage_rows<BS>(reinterpret_cast<uint8_t*>(ktile + k * BS * hd), kp, blk, kv, g, hd * 2, chunks.k);
      stage_rows<BS>(reinterpret_cast<uint8_t*>(vtile + k * BS * vd), vp, blk, kv, g, vd * 2, chunks.v);
    }
    cp_async_commit();
  }

  const int rg = warp % row_groups, kg = warp / row_groups;
  const int key_groups = kWarps / row_groups;
  const int keys_per_warp = BS / key_groups;  // BS >= 4 >= key_groups
  const int per_group = (rows + row_groups - 1) / row_groups;
  const int n_chunks = (per_group + kRowChunk - 1) / kRowChunk;
  const int d0 = lane * 4;  // a lane owns dims d0 .. d0 + 3
  const bool lane_k = d0 < hd, lane_v = d0 < vd;
  // the (row, key) pair of a group whose score this lane computes
  const int jl = (lane & 16 ? 8 : 0) | (lane & 8 ? 4 : 0) | (lane & 4 ? 2 : 0) |
                 (lane & 2 ? 1 : 0);
  const int il = jl / kKeyGroup, ul = jl % kKeyGroup;

  for (int c = 0; c < n_chunks; ++c) {
    // this warp's rows of the chunk: rg + row_groups * (c * kRowChunk + i)
    const int r_first = rg + row_groups * c * kRowChunk;
    const bool any = r_first < rows;  // warp-uniform, as is nr
    const int nr = any ? min(kRowChunk, (rows - r_first + row_groups - 1) / row_groups) : 0;
    float qr[kRowChunk][4], acc[kRowChunk][4];
    float m_l = kNegInf, l_l = 0.f;  // running max and sum of this lane's row il
#pragma unroll
    for (int i = 0; i < kRowChunk; ++i) {
      const int r = r_first + row_groups * i;
      const int64_t qrow = i < nr ? out_row(r) : 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][e] = 0.f;
        qr[i][e] = (i < nr && d0 + e < hd) ? to_f32<TQ>(q[qrow * hd + d0 + e]) : 0.f;
      }
    }

    for (int k = 0; k < nl; ++k) {
      if (c == 0) {  // CTA-uniform: block k lands (then, packed, decodes)
        cp_async_wait_pending(nl - 1 - k);
        __syncthreads();
        if constexpr (kPacked) {
          const int kgr = hd / 16, vgr = vd / 16, nk = BS * kgr;
          for (int i = threadIdx.x; i < nk + BS * vgr; i += kThreads) {
            const bool isk = i < nk;
            const int groups = isk ? kgr : vgr;
            const int ii = isk ? i : i - nk;
            const int row = k * BS + ii / groups, grp = ii % groups;
            const uint8_t* codes = gqa_smem + (isk ? lay.kc : lay.vc) + row * groups * 8 + grp * 8;
            const uint32_t sbyte = gqa_smem[(isk ? lay.ks : lay.vs) + row * groups + grp];
            decode_group16(*reinterpret_cast<const uint2*>(codes), sbyte,
                           (isk ? ktile : vtile) + row * groups * 16 + grp * 16);
          }
          __syncthreads();
        }
      }
      if (!any) continue;
      const int kj0 = live_j[k] * BS;
      const __nv_bfloat16* kt = ktile + k * BS * hd;
      const __nv_bfloat16* vt = vtile + k * BS * vd;
      for (int u0 = 0; u0 < keys_per_warp; u0 += kKeyGroup) {
        const int kn = min(kKeyGroup, keys_per_warp - u0);  // keys present
        float x[kKeyGroup][4];
#pragma unroll
        for (int u = 0; u < kKeyGroup; ++u) {
          const int t = kg + key_groups * (u0 + u);
          if (u < kn && lane_k) {
            load_bf16x4(kt + t * hd + d0, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[u][e] = 0.f;
          }
        }
        // the 16 (row i, key u) partial dots, pair j = 4 i + u, summed over
        // the warp by a transposed butterfly: the lane pair 2k, 2k + 1 ends
        // with the full dot of pair jl (lane bits 16, 8, 4, 2 -> j bits 3..0)
        float v[kPairs];
#pragma unroll
        for (int i = 0; i < kRowChunk; ++i)
#pragma unroll
          for (int u = 0; u < kKeyGroup; ++u)
            v[i * kKeyGroup + u] = i < nr ? qr[i][0] * x[u][0] + qr[i][1] * x[u][1] +
                                            qr[i][2] * x[u][2] + qr[i][3] * x[u][3]
                                          : 0.f;
        fold<8>(v, lane, 16);
        fold<4>(v, lane, 8);
        fold<2>(v, lane, 4);
        fold<1>(v, lane, 2);
        const float dot = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
        // this lane's score (row il, key ul), its row's running max m_l and
        // sum l_l, then the probabilities: one division and two expf a lane
        const int kjl = kj0 + kg + key_groups * (u0 + ul);
        const int qpos_l = p0 + (r_first + row_groups * il) / rep;
        bool ok = ul < kn && il < nr && kjl <= qpos_l;
        if (window > 0) ok = ok && kjl > qpos_l - window;
        const float sc = ok ? __fdiv_rn(dot, sqrt_hd) : kNegInf;
        float smax = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 4));
        smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 2));
        const float m_new = fmaxf(m_l, smax);
        const float corr = expf(m_l - m_new);
        const float p = ok ? expf(sc - m_new) : 0.f;
        float psum = p + __shfl_xor_sync(0xffffffffu, p, 2);
        psum += __shfl_xor_sync(0xffffffffu, psum, 4);
        l_l = l_l * corr + psum;
        m_l = m_new;
        __syncwarp();  // the previous group's readers of pbuf are done
        if ((lane & 1) == 0) {
          pbuf[warp][jl] = p;
          if (ul == 0) cbuf[warp][il] = corr;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kKeyGroup; ++u) {
          const int t = kg + key_groups * (u0 + u);
          if (u < kn && lane_v) {
            load_bf16x4(vt + t * vd + d0, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[u][e] = 0.f;
          }
        }
        const float4 c4 = *reinterpret_cast<const float4*>(cbuf[warp]);
        const float cr[kRowChunk] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < kRowChunk; ++i) {
          if (i >= nr) break;
          const float4 p4 = *reinterpret_cast<const float4*>(&pbuf[warp][i * kKeyGroup]);
          const float pr[kKeyGroup] = {p4.x, p4.y, p4.z, p4.w};
          float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int u = 0; u < kKeyGroup; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[e] += pr[u] * x[u][e];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = acc[i][e] * cr[i] + pv[e];
        }
      }
    }
    // (m, l) of each row, from the lane 8 i that holds its key 0
    float m[kRowChunk], l[kRowChunk];
#pragma unroll
    for (int i = 0; i < kRowChunk; ++i) {
      m[i] = __shfl_sync(0xffffffffu, m_l, 8 * i);
      l[i] = __shfl_sync(0xffffffffu, l_l, 8 * i);
    }

    // the chunk's rows: partial (m, l, acc) per split, or the output itself
    auto emit = [&](int r, float mm, float ll, float4 acc4) {
      const float a[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
      const int64_t o = out_row(r);
      if (n_splits == 1) {
        const float denom = fmaxf(ll, 1e-30f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < vd) out[o * vd + d0 + e] = __fdiv_rn(a[e], denom);
      } else {
        float* pa = part_acc + (o * n_splits + split) * vd;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < vd) pa[d0 + e] = a[e];
        if (lane == 0) {
          part_ml[(o * n_splits + split) * 2] = mm;
          part_ml[(o * n_splits + split) * 2 + 1] = ll;
        }
      }
    };
    if (key_groups == 1) {
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i)
        if (i < nr)
          emit(r_first + row_groups * i, m[i], l[i],
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      continue;
    }
    // key groups of one row group merge in fixed warp order (kg = 0, 1, ..)
    if (any) {
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        if (lane_v)
#pragma unroll
          for (int e = 0; e < 4; ++e) red_acc[warp][i][d0 + e] = acc[i][e];
        if (lane == 0) {
          red_ml[warp][i][0] = m[i];
          red_ml[warp][i][1] = l[i];
        }
      }
    }
    __syncthreads();
    if (kg == 0 && any) {
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        if (i >= nr) continue;
        float mm = kNegInf;
        for (int x = 0; x < key_groups; ++x) {
          const int w = rg + row_groups * x;
          if (red_ml[w][i][1] > 0.f) mm = fmaxf(mm, red_ml[w][i][0]);
        }
        float ll = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int x = 0; x < key_groups; ++x) {
          const int w = rg + row_groups * x;
          const float lw = red_ml[w][i][1];
          if (!(lw > 0.f)) continue;
          const float f = expf(red_ml[w][i][0] - mm);
          ll += lw * f;
          if (lane_v)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += red_acc[w][i][d0 + e] * f;
        }
        emit(r_first + row_groups * i, mm, ll, make_float4(a[0], a[1], a[2], a[3]));
      }
    }
    __syncthreads();
  }
}

// Merge of the splits' partials of one output row (b, s, h), in split
// order: M = max m over splits with l > 0, w = e^(m - M) (0 where l == 0),
// L = sum l w, o = (sum acc w) / max(L, 1e-30). A split with l == 0 has no
// live key and adds nothing; a row with none at all gets exact zeros. The
// (m, l) pairs come in at once into shared memory and the weights are
// computed once; thread d then sums value dim d (vd <= 128).
__global__ void __launch_bounds__(kThreads)
paged_gqa_merge_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml, float* __restrict__ out,
                       int n_splits, int vd) {
  extern __shared__ float merge_smem[];  // w[n_splits], l[n_splits]
  __shared__ float denom_s;
  float* w = merge_smem;
  float* ls = merge_smem + n_splits;
  const int64_t o = blockIdx.x;
  const float* ml = part_ml + o * n_splits * 2;
  for (int s = threadIdx.x; s < n_splits; s += kThreads) {
    w[s] = ml[2 * s];
    ls[s] = ml[2 * s + 1];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float mm = kNegInf;
    for (int s = threadIdx.x; s < n_splits; s += 32)
      if (ls[s] > 0.f) mm = fmaxf(mm, w[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    for (int s = threadIdx.x; s < n_splits; s += 32)
      w[s] = ls[s] > 0.f ? expf(w[s] - mm) : 0.f;
    __syncwarp();
    if (threadIdx.x == 0) {
      float ll = 0.f;
      for (int s = 0; s < n_splits; ++s) ll += ls[s] * w[s];
      denom_s = fmaxf(ll, 1e-30f);
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= vd) return;
  const float* pa = part_acc + o * n_splits * vd + d;
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s)
    if (w[s] > 0.f) a += pa[(int64_t)s * vd] * w[s];
  out[o * vd + d] = __fdiv_rn(a, denom_s);
}

// The largest of 16, 8, 4, 2, 1 bytes dividing a leaf's row and base address.
int chunk_for(const void* p, int64_t row_bytes) {
  int c = 16;
  while (c > 1 && (((uintptr_t)p % c) != 0 || row_bytes % c != 0)) c >>= 1;
  return c;
}

template <typename TQ, bool kPacked>
int launch_gqa(const void* q, const void* kp, const void* ks, const void* vp,
               const void* vs, const void* table, const void* pos, void* out,
               void* part_acc, void* part_ml, int64_t b, int64_t sq, int64_t h,
               int64_t kv, int64_t hd, int64_t vd, int64_t n_blocks, int64_t bs,
               int64_t maxb, int64_t window, float sqrt_hd, int64_t bps,
               int64_t n_splits, int64_t row_groups, cudaStream_t st) {
  const unsigned grid = (unsigned)(b * kv * n_splits);
  const size_t smem = (size_t)GqaSmem(bps * bs, hd, vd, kPacked).bytes;
  const Chunks chunks = kPacked
      ? Chunks{chunk_for(kp, hd / 2), chunk_for(ks, hd / 16),
               chunk_for(vp, vd / 2), chunk_for(vs, vd / 16)}
      : Chunks{chunk_for(kp, hd * 2), 0, chunk_for(vp, vd * 2), 0};
#define REPRO_GQA_CASE(BS_)                                                    \
  case BS_: {                                                                  \
    auto kern = paged_gqa_split_kernel<TQ, BS_, kPacked>;                      \
    if (smem > 32 * 1024) {                                                    \
      const cudaError_t err = cudaFuncSetAttribute(                            \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
      if (err != cudaSuccess) return (int)err;                                 \
    }                                                                          \
    kern<<<grid, kThreads, smem, st>>>(                                        \
        (const TQ*)q, (const uint8_t*)kp, (const uint8_t*)ks,                  \
        (const uint8_t*)vp, (const uint8_t*)vs, (const int32_t*)table,         \
        (const int32_t*)pos, (float*)out, (float*)part_acc, (float*)part_ml,   \
        (int)sq, (int)h, (int)kv, (int)hd, (int)vd, n_blocks, (int)maxb,       \
        (int)window, sqrt_hd, (int)bps, (int)n_splits, (int)row_groups,        \
        chunks);                                                               \
    break;                                                                     \
  }
  switch (bs) {
    REPRO_GQA_CASE(4)
    REPRO_GQA_CASE(8)
    REPRO_GQA_CASE(16)
    REPRO_GQA_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_GQA_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const size_t merge_smem = (size_t)n_splits * 2 * sizeof(float);
  if (merge_smem > 40 * 1024) {
    err = cudaFuncSetAttribute(paged_gqa_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)merge_smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_gqa_merge_kernel<<<(unsigned)(b * sq * h), kThreads, merge_smem, st>>>(
      (const float*)part_acc, (const float*)part_ml, (float*)out,
      (int)n_splits, (int)vd);
  return (int)cudaGetLastError();
}

constexpr int kMlaWarps = 4;
constexpr int kMlaThreads = kMlaWarps * 32;
constexpr int kMaxLora = 512;
constexpr int kMaxRope = 64;
constexpr int kLoraPerLane = kMaxLora / 32;

// ---- #8: split-KV MLA decode over NVFP4 latent pools ------------------------
constexpr int kMlaPairs = 16;   // (query, head) pairs of one CTA: 4 a warp
constexpr int kMlaStages = 4;   // packed blocks in flight in one CTA

// Byte sizes of one pool block's four packed runs, and the shared-memory
// layout of a CTA: the bf16 latent and rope tiles of the block being
// computed, the ring of packed stages, and the split's live-block list.
struct MlaSmem {
  int64_t cc_codes, cc_scales, kc_codes, kc_scales;   // run bytes a block
  int64_t st_cs, st_kc, st_ks, stage;                 // offsets in a stage
  int64_t tile_c, tile_k, ring, live, bytes;
  __host__ __device__ MlaSmem(int64_t bs, int64_t lora, int64_t rope, int64_t bps) {
    cc_codes = bs * lora / 2;
    cc_scales = bs * lora / 16;
    kc_codes = bs * rope / 2;
    kc_scales = bs * rope / 16;
    st_cs = align16(cc_codes);
    st_kc = st_cs + align16(cc_scales);
    st_ks = st_kc + align16(kc_codes);
    stage = st_ks + align16(kc_scales);
    tile_c = 0;
    tile_k = align16(bs * lora * 2);
    ring = tile_k + align16(bs * rope * 2);
    live = ring + kMlaStages * stage;
    bytes = live + 2 * bps * (int64_t)sizeof(int);
  }
};

// The copy chunk (bytes) of each packed run (see chunk_for).
struct MlaChunks {
  int cc, cs, kc, ks;
};

// `bytes` contiguous bytes global -> shared by the whole CTA, `chunk` at a time.
__device__ __forceinline__ void stage_run(uint8_t* dst, const uint8_t* src,
                                          int64_t bytes, int chunk) {
  for (int64_t i = (int64_t)threadIdx.x * chunk; i < bytes;
       i += (int64_t)kMlaThreads * chunk)
    copy_chunk(dst + i, src + i, chunk);
}

template <typename TR, int BS>
__global__ void __launch_bounds__(kMlaThreads)
paged_mla_split_kernel(const float* __restrict__ q_abs, const TR* __restrict__ q_rope,
                       const uint8_t* __restrict__ cc_codes,
                       const uint8_t* __restrict__ cc_scales,
                       const uint8_t* __restrict__ kc_codes,
                       const uint8_t* __restrict__ kc_scales,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int sq, int h_total, int lora, int rope, int64_t n_blocks,
                       int maxb, int bps, int n_splits, int tiles, float scale,
                       MlaChunks chunks) {
  extern __shared__ __align__(16) uint8_t mla_smem[];
  __shared__ __align__(16) float pbuf[kMlaWarps][kPairs];     // a group's p
  __shared__ __align__(16) float cbuf[kMlaWarps][kRowChunk];  // its pairs' corr
  __shared__ int n_live;

  const int tile = blockIdx.x % tiles;
  const int split = (blockIdx.x / tiles) % n_splits;
  const int b = blockIdx.x / tiles / n_splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pairs = sq * h_total;  // pair r = s * H + h: query s, head h
  const int r0 = tile * kMlaPairs + warp * kRowChunk;  // this warp's first pair
  const int np = max(0, min(kRowChunk, n_pairs - r0));  // warp-uniform
  const int64_t row0 = (int64_t)b * n_pairs;            // o_lat row of pair 0
  const int p0 = pos[b];
  const int pmax = p0 + sq - 1;
  const int j0 = split * bps;
  const int nj = min(bps, maxb - j0);
  const MlaSmem lay(BS, lora, rope, bps);
  int* live_blk = reinterpret_cast<int*>(mla_smem + lay.live);
  int* live_j = live_blk + bps;

  // the split's table entries, once: live blocks compacted in logical order
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < nj; base += 32) {
      const int j = j0 + base + lane;
      int blk = 0;
      bool live = false;
      if (base + lane < nj) {
        blk = table[(int64_t)b * maxb + j];
        live = blk >= 0 && blk < n_blocks && (int64_t)j * BS <= pmax;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int k = count + __popc(mask & ((1u << lane) - 1u));
        live_blk[k] = blk;
        live_j[k] = j;
      }
      count += __popc(mask);
    }
    if (lane == 0) n_live = count;
  }
  __syncthreads();
  const int nl = n_live;

  if (nl == 0) {  // no live key: (NEG_INF, 0), or exact zeros with one split
    for (int i = threadIdx.x; i < kMlaPairs; i += kMlaThreads) {
      const int r = tile * kMlaPairs + i;
      if (r >= n_pairs) break;
      if (n_splits > 1) {
        float* ml = part_ml + ((row0 + r) * n_splits + split) * 2;
        ml[0] = kNegInf;
        ml[1] = 0.f;
      }
    }
    if (n_splits == 1) {
      const int rows = min(kMlaPairs, n_pairs - tile * kMlaPairs);
      float* o = out + (row0 + tile * kMlaPairs) * lora;
      for (int i = threadIdx.x; i < rows * lora; i += kMlaThreads) o[i] = 0.f;
    }
    return;
  }

  // blocks 0 .. kMlaStages-1 in flight, one cp.async group each (empty
  // groups past the split's end keep the count of groups uniform)
  uint8_t* ring = mla_smem + lay.ring;
  auto stage_block = [&](int slot, int64_t blk) {
    uint8_t* st = ring + slot * lay.stage;
    stage_run(st, cc_codes + blk * lay.cc_codes, lay.cc_codes, chunks.cc);
    stage_run(st + lay.st_cs, cc_scales + blk * lay.cc_scales, lay.cc_scales, chunks.cs);
    stage_run(st + lay.st_kc, kc_codes + blk * lay.kc_codes, lay.kc_codes, chunks.kc);
    stage_run(st + lay.st_ks, kc_scales + blk * lay.kc_scales, lay.kc_scales, chunks.ks);
  };
#pragma unroll
  for (int k = 0; k < kMlaStages; ++k) {
    if (k < nl) stage_block(k, live_blk[k]);
    cp_async_commit();
  }

  // this warp's pairs: q in registers (latent dims 4 lane + 128 c + e, rope
  // dims 2 lane + e), the causal limit of each, and the accumulators
  float qa[kRowChunk][kLoraPerLane], qr[kRowChunk][2], acc[kRowChunk][kLoraPerLane];
#pragma unroll
  for (int i = 0; i < kRowChunk; ++i) {
    const int64_t qrow = row0 + r0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * lane + 128 * c + e;
        acc[i][4 * c + e] = 0.f;
        qa[i][4 * c + e] = (i < np && d < lora) ? q_abs[qrow * lora + d] : 0.f;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 2 * lane + e;
      qr[i][e] = (i < np && d < rope) ? to_f32<TR>(q_rope[qrow * rope + d]) : 0.f;
    }
  }
  // the (pair, key) of a group whose score this lane computes
  const int jl = (lane & 16 ? 8 : 0) | (lane & 8 ? 4 : 0) | (lane & 4 ? 2 : 0) |
                 (lane & 2 ? 1 : 0);
  const int il = jl / kKeyGroup, ul = jl % kKeyGroup;
  const int qpos_l = p0 + (r0 + il) / h_total;  // newest key pair il sees
  float m_l = kNegInf, l_l = 0.f;  // running max and sum of this lane's pair il

  const __nv_bfloat16* tc = reinterpret_cast<const __nv_bfloat16*>(mla_smem + lay.tile_c);
  const __nv_bfloat16* tk = reinterpret_cast<const __nv_bfloat16*>(mla_smem + lay.tile_k);
  const int gc = BS * (lora / 16), gk = BS * (rope / 16);
  for (int k = 0; k < nl; ++k) {
    cp_async_wait_pending(kMlaStages - 1);  // block k has landed
    __syncthreads();  // ... for every thread; the tiles' readers are done
    const uint8_t* st = ring + (k % kMlaStages) * lay.stage;
    for (int i = threadIdx.x; i < gc + gk; i += kMlaThreads) {
      const bool isc = i < gc;
      const int dim = isc ? lora : rope;
      const int groups = dim / 16, ii = isc ? i : i - gc;
      const int row = ii / groups, grp = ii - row * groups;
      const uint8_t* codes = st + (isc ? 0 : lay.st_kc) + row * (dim / 2) + grp * 8;
      const uint32_t sbyte = st[(isc ? lay.st_cs : lay.st_ks) + row * groups + grp];
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
          mla_smem + (isc ? lay.tile_c : lay.tile_k)) + row * dim + grp * 16;
      decode_group16(*reinterpret_cast<const uint2*>(codes), sbyte, dst);
    }
    __syncthreads();  // the tiles are decoded; stage k % kMlaStages is free
    if (k + kMlaStages < nl) stage_block(k % kMlaStages, live_blk[k + kMlaStages]);
    cp_async_commit();
    if (np == 0) continue;

    const int kj0 = live_j[k] * BS;
    for (int t0 = 0; t0 < BS; t0 += kKeyGroup) {
      // the 16 (pair i, key u) partial dots, pair j = 4 i + u, latent and
      // rope apart, each summed over the warp by the transposed butterfly
      float vl[kPairs], vr[kPairs];
#pragma unroll
      for (int u = 0; u < kKeyGroup; ++u) {
        float x[kLoraPerLane], xr[2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = 4 * lane + 128 * c;
          if (d < lora) {
            load_bf16x4(tc + (t0 + u) * lora + d, &x[4 * c]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[4 * c + e] = 0.f;
          }
        }
        if (2 * lane < rope) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(tk + (t0 + u) * rope + 2 * lane);
          xr[0] = bf16_bits_to_f32(w & 0xffffu);
          xr[1] = __uint_as_float(w & 0xffff0000u);
        } else {
          xr[0] = xr[1] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowChunk; ++i) {
          float sl = 0.f;
#pragma unroll
          for (int e = 0; e < kLoraPerLane; ++e) sl += qa[i][e] * x[e];
          vl[i * kKeyGroup + u] = sl;
          vr[i * kKeyGroup + u] = qr[i][0] * xr[0] + qr[i][1] * xr[1];
        }
      }
      fold<8>(vl, lane, 16);
      fold<4>(vl, lane, 8);
      fold<2>(vl, lane, 4);
      fold<1>(vl, lane, 2);
      fold<8>(vr, lane, 16);
      fold<4>(vr, lane, 8);
      fold<2>(vr, lane, 4);
      fold<1>(vr, lane, 2);
      const float lat = vl[0] + __shfl_xor_sync(0xffffffffu, vl[0], 1);
      const float rp = vr[0] + __shfl_xor_sync(0xffffffffu, vr[0], 1);
      // this lane's score (pair il, key ul), its pair's running max and sum,
      // then the probabilities: one division-free score and two expf a lane
      const bool ok = il < np && kj0 + t0 + ul <= qpos_l;
      const float sc = ok ? __fmul_rn(__fadd_rn(lat, rp), scale) : kNegInf;
      float smax = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 4));
      smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 2));
      const float m_new = fmaxf(m_l, smax);
      const float corr = expf(m_l - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      float psum = p + __shfl_xor_sync(0xffffffffu, p, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l_l = l_l * corr + psum;
      m_l = m_new;
      __syncwarp();  // the previous group's readers of pbuf are done
      if ((lane & 1) == 0) {
        pbuf[warp][jl] = p;
        if (ul == 0) cbuf[warp][il] = corr;
      }
      __syncwarp();
      const float4 c4 = *reinterpret_cast<const float4*>(cbuf[warp]);
      const float cr[kRowChunk] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i)
#pragma unroll
        for (int e = 0; e < kLoraPerLane; ++e) acc[i][e] *= cr[i];
#pragma unroll
      for (int u = 0; u < kKeyGroup; ++u) {
        float x[kLoraPerLane];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = 4 * lane + 128 * c;
          if (d < lora) {
            load_bf16x4(tc + (t0 + u) * lora + d, &x[4 * c]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[4 * c + e] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kRowChunk; ++i) {
          const float pr = pbuf[warp][i * kKeyGroup + u];
#pragma unroll
          for (int e = 0; e < kLoraPerLane; ++e) acc[i][e] += pr * x[e];
        }
      }
    }
  }
  if (np == 0) return;

  // (m, l) of each pair, from the lane 8 i that holds its key 0; then the
  // pairs' partials, or o_lat itself with one split
#pragma unroll
  for (int i = 0; i < kRowChunk; ++i) {
    const float m = __shfl_sync(0xffffffffu, m_l, 8 * i);
    const float l = __shfl_sync(0xffffffffu, l_l, 8 * i);
    if (i >= np) continue;
    const int64_t o = row0 + r0 + i;
    const float denom = fmaxf(l, 1e-30f);
    float* dst = n_splits == 1 ? out + o * lora
                               : part_acc + (o * n_splits + split) * lora;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d >= lora) continue;
      const float* a = &acc[i][4 * c];
      *reinterpret_cast<float4*>(dst + d) = n_splits == 1
          ? make_float4(__fdiv_rn(a[0], denom), __fdiv_rn(a[1], denom),
                        __fdiv_rn(a[2], denom), __fdiv_rn(a[3], denom))
          : make_float4(a[0], a[1], a[2], a[3]);
    }
    if (n_splits > 1 && lane == 0) {
      part_ml[(o * n_splits + split) * 2] = m;
      part_ml[(o * n_splits + split) * 2 + 1] = l;
    }
  }
}

// Merge of the splits' partials of one o_lat row (b, s, h), in split order:
// the arithmetic of paged_gqa_merge_kernel, a thread summing 4 latent dims
// at a time (lora <= 512, a multiple of 4).
__global__ void __launch_bounds__(kMlaThreads)
paged_mla_merge_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml, float* __restrict__ out,
                       int n_splits, int lora) {
  extern __shared__ float mla_merge_smem[];  // w[n_splits], l[n_splits]
  __shared__ float denom_s;
  float* w = mla_merge_smem;
  float* ls = mla_merge_smem + n_splits;
  const int64_t o = blockIdx.x;
  const float* ml = part_ml + o * n_splits * 2;
  for (int s = threadIdx.x; s < n_splits; s += kMlaThreads) {
    w[s] = ml[2 * s];
    ls[s] = ml[2 * s + 1];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float mm = kNegInf;
    for (int s = threadIdx.x; s < n_splits; s += 32)
      if (ls[s] > 0.f) mm = fmaxf(mm, w[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    for (int s = threadIdx.x; s < n_splits; s += 32)
      w[s] = ls[s] > 0.f ? expf(w[s] - mm) : 0.f;
    __syncwarp();
    if (threadIdx.x == 0) {
      float ll = 0.f;
      for (int s = 0; s < n_splits; ++s) ll += ls[s] * w[s];
      denom_s = fmaxf(ll, 1e-30f);
    }
  }
  __syncthreads();
  for (int d = 4 * threadIdx.x; d < lora; d += 4 * kMlaThreads) {
    const float* pa = part_acc + o * n_splits * lora + d;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < n_splits; ++s) {
      if (!(w[s] > 0.f)) continue;
      const float4 v = *reinterpret_cast<const float4*>(pa + (int64_t)s * lora);
      a[0] += v.x * w[s];
      a[1] += v.y * w[s];
      a[2] += v.z * w[s];
      a[3] += v.w * w[s];
    }
    *reinterpret_cast<float4*>(out + o * lora + d) = make_float4(
        __fdiv_rn(a[0], denom_s), __fdiv_rn(a[1], denom_s),
        __fdiv_rn(a[2], denom_s), __fdiv_rn(a[3], denom_s));
  }
}

// After a split kernel of #7 or #8: with n_splits > 1 the merge kernel over
// the `rows` o_lat rows; the launch error of the split kernel otherwise.
int launch_mla_merge(void* part_acc, void* part_ml, void* out, int64_t rows,
                     int64_t n_splits, int64_t lora, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const size_t merge_smem = (size_t)n_splits * 2 * sizeof(float);
  if (merge_smem > 40 * 1024) {
    err = cudaFuncSetAttribute(paged_mla_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)merge_smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_mla_merge_kernel<<<(unsigned)rows, kMlaThreads, merge_smem, st>>>(
      (const float*)part_acc, (const float*)part_ml, (float*)out, (int)n_splits,
      (int)lora);
  return (int)cudaGetLastError();
}

template <typename TR>
int launch_mla_q(const void* q_abs, const void* q_rope, const void* ccc,
                 const void* ccs, const void* kcc, const void* kcs,
                 const void* table, const void* pos, void* out, void* part_acc,
                 void* part_ml, int64_t b, int64_t sq, int64_t h, int64_t lora,
                 int64_t rope, int64_t n_blocks, int64_t bs, int64_t maxb,
                 int64_t bps, int64_t n_splits, int64_t tiles, float scale,
                 cudaStream_t st) {
  const unsigned grid = (unsigned)(b * tiles * n_splits);
  const MlaSmem lay(bs, lora, rope, bps);
  const size_t smem = (size_t)lay.bytes;
  const MlaChunks chunks{chunk_for(ccc, lay.cc_codes), chunk_for(ccs, lay.cc_scales),
                         chunk_for(kcc, lay.kc_codes), chunk_for(kcs, lay.kc_scales)};
#define REPRO_MLA_Q_CASE(BS_)                                                  \
  case BS_: {                                                                  \
    auto kern = paged_mla_split_kernel<TR, BS_>;                               \
    if (smem > 40 * 1024) {                                                    \
      const cudaError_t err = cudaFuncSetAttribute(                            \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
      if (err != cudaSuccess) return (int)err;                                 \
    }                                                                          \
    kern<<<grid, kMlaThreads, smem, st>>>(                                     \
        (const float*)q_abs, (const TR*)q_rope, (const uint8_t*)ccc,           \
        (const uint8_t*)ccs, (const uint8_t*)kcc, (const uint8_t*)kcs,         \
        (const int32_t*)table, (const int32_t*)pos, (float*)out,               \
        (float*)part_acc, (float*)part_ml, (int)sq, (int)h, (int)lora,         \
        (int)rope, n_blocks, (int)maxb, (int)bps, (int)n_splits, (int)tiles,   \
        scale, chunks);                                                        \
    break;                                                                     \
  }
  switch (bs) {
    REPRO_MLA_Q_CASE(4)
    REPRO_MLA_Q_CASE(8)
    REPRO_MLA_Q_CASE(16)
    REPRO_MLA_Q_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MLA_Q_CASE
  return launch_mla_merge(part_acc, part_ml, out, b * sq * h, n_splits, lora, st);
}

// ---- #7: tensor-core split-KV MLA decode over the bf16 latent pool ---------
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcPairs = 16;   // (query, head) pairs of one CTA: every mma's m16
constexpr int kTcKeys = 16;    // keys of one step: the readout's k16
constexpr int kTcStages = 4;   // steps in the cp.async ring
constexpr int kTcPad = 8;      // bf16 padding of a shared-memory row (16 B)
constexpr int kTcLatSteps = kMaxLora / 16 / kTcWarps;  // latent k16 steps a warp
constexpr int kTcUnits = kMaxLora / 16 / kTcWarps;     // readout 16-column units a warp

// Shared-memory layout of one #7 CTA: the ring of steps (16 cc rows, then 16
// kc rows, bf16 with rows padded by 16 B, then the 16 keys' positions),
// q_rope's three bf16 terms ([term][pair][rope], padded rows), q_abs's lo
// term ([pair][lora], padded rows), and the warps' partial score tiles
// (float4 [tile][2][32]: tiles 0-7 latent, 8-11 rope). Pitches in bf16,
// offsets in bytes.
struct MlaTcSmem {
  int cc_row, kc_row, kpos, stage, qr, qlo, red, bytes;
  __host__ __device__ MlaTcSmem(int lora, int rope) {
    cc_row = lora + kTcPad;
    kc_row = rope + kTcPad;
    kpos = kTcKeys * (cc_row + kc_row) * 2;
    stage = kpos + kTcKeys * (int)sizeof(int);
    qr = kTcStages * stage;
    qlo = qr + 3 * kTcPairs * kc_row * 2;
    red = qlo + kTcPairs * cc_row * 2;
    bytes = red + (kTcWarps + kMaxRope / 16) * 2 * 32 * (int)sizeof(float4);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared by cp.async; bytes = 0 fills the 16 with zeros.
__device__ __forceinline__ void cp_async16_fill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a b on the tensor cores: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values -> their three bf16 terms, as bf16x2 (x0 in the low half):
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); each residual is
// exact in f32, so hi + mid + lo == x (see the head note).
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 = __fsub_rn(x0, __low2float(h));
  x1 = __fsub_rn(x1, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 = __fsub_rn(x0, __low2float(m));
  x1 = __fsub_rn(x1, __high2float(m));
  hi = bf162_bits(h);
  mid = bf162_bits(m);
  lo = bf162_bits(__floats2bfloat162_rn(x0, x1));
}

template <typename TR, int BS>
__global__ void __launch_bounds__(kTcThreads, 2)
paged_mla_tc_kernel(const float* __restrict__ q_abs, const TR* __restrict__ q_rope,
                    const __nv_bfloat16* __restrict__ cc,
                    const __nv_bfloat16* __restrict__ kc,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ pos, float* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int sq, int h_total, int lora, int rope, int64_t n_blocks,
                    int maxb, int bps, int n_splits, int tiles, float scale) {
  constexpr int kRopeTerms = std::is_same<TR, float>::value ? 3 : 1;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __shared__ int n_live;

  const MlaTcSmem lay(lora, rope);
  const int tile = blockIdx.x % tiles;
  const int split = (blockIdx.x / tiles) % n_splits;
  const int b = blockIdx.x / tiles / n_splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment rows g, g + 8; columns 2t, 2t + 1
  const int n_pairs = sq * h_total;      // pair r = s * H + h: query s, head h
  const int r0 = tile * kTcPairs;
  const int64_t row0 = (int64_t)b * n_pairs;  // o_lat row of pair 0
  const int p0 = pos[b];
  const int pmax = p0 + sq - 1;
  const int j0 = split * bps;
  const int nj = min(bps, maxb - j0);

  // the split's live blocks (neither sentinel nor past the newest query), counted
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < nj; base += 32) {
      const int j = j0 + base + lane;
      bool live = false;
      if (base + lane < nj) {
        const int blk = table[(int64_t)b * maxb + j];
        live = blk >= 0 && blk < n_blocks && (int64_t)j * BS <= pmax;
      }
      count += __popc(__ballot_sync(0xffffffffu, live));
    }
    if (lane == 0) n_live = count;
  }
  __syncthreads();
  if (n_live == 0) {  // no live key: (NEG_INF, 0), or exact zeros with one split
    const int rows = min(kTcPairs, n_pairs - r0);
    if (n_splits > 1) {
      for (int i = threadIdx.x; i < rows; i += kTcThreads) {
        float* ml = part_ml + ((row0 + r0 + i) * n_splits + split) * 2;
        ml[0] = kNegInf;
        ml[1] = 0.f;
      }
    } else {
      float* o = out + (row0 + r0) * lora;
      for (int i = threadIdx.x; i < rows * lora; i += kTcThreads) o[i] = 0.f;
    }
    return;
  }

  // the split's keys: logical positions kbeg .. kend - 1, 16 a step
  const int kbeg = j0 * BS;
  const int kend = min((j0 + nj) * BS, pmax + 1);
  const int nsteps = (kend - kbeg + kTcKeys - 1) / kTcKeys;
  const int cc_chunks = lora / 8, row_chunks = (lora + rope) / 8;
  const int ld_key = threadIdx.x / 16, ld_c0 = threadIdx.x % 16;  // 16 threads a key
  // the pool block holding this thread's key of `step`; -1 when the key is
  // past the split or its block is a sentinel
  auto block_of = [&](int step) -> int {
    const int kp = kbeg + step * kTcKeys + ld_key;
    if (step >= nsteps || kp >= kend) return -1;
    const int blk = table[(int64_t)b * maxb + kp / BS];
    return (blk >= 0 && blk < n_blocks) ? blk : -1;
  };
  auto stage_step = [&](int step, int blk) {
    uint8_t* st = tc_smem + (step % kTcStages) * lay.stage;
    const int kp = kbeg + step * kTcKeys + ld_key;
    const int64_t tok = blk >= 0 ? (int64_t)blk * BS + kp % BS : 0;
    for (int c = ld_c0; c < row_chunks; c += 16) {
      const bool isc = c < cc_chunks;
      const __nv_bfloat16* src = isc ? cc + tok * lora + c * 8
                                     : kc + tok * rope + (c - cc_chunks) * 8;
      const int off = isc ? ld_key * lay.cc_row + c * 8
                          : kTcKeys * lay.cc_row + ld_key * lay.kc_row + (c - cc_chunks) * 8;
      cp_async16_fill(smem_u32(st + 2 * off), src, blk >= 0 ? 16 : 0);
    }
    if (ld_c0 == 0) reinterpret_cast<int*>(st + lay.kpos)[ld_key] = blk >= 0 ? kp : 0x7fffffff;
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nsteps) stage_step(s, block_of(s));
    cp_async_commit();
  }

  // q_abs's hi and mid terms in registers, as A fragments of this warp's
  // latent k16 steps ks = warp + 8 i (pair rows g and g + 8); its lo term in
  // shared memory, read back by ldmatrix (registers hold at most 128)
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool va = ra < n_pairs, vb = rb < n_pairs;
  const int nks = lora / 16, nrs = rope / 16;
  __nv_bfloat16* qlo_s = reinterpret_cast<__nv_bfloat16*>(tc_smem + lay.qlo);
  uint32_t qa[kTcLatSteps][2][4];
#pragma unroll
  for (int i = 0; i < kTcLatSteps; ++i) {
    const int ks = warp + kTcWarps * i;
    float2 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a-regs: (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
      const bool on = ks < nks && ((e & 1) ? vb : va);
      const int64_t r = row0 + ((e & 1) ? rb : ra);
      x[e] = on ? *reinterpret_cast<const float2*>(q_abs + r * lora + ks * 16 + 2 * t + (e >> 1) * 8)
                : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo;
      split_bf16x3(x[e].x, x[e].y, qa[i][0][e], qa[i][1][e], lo);
      if (ks < nks)
        *reinterpret_cast<uint32_t*>(qlo_s + (g + (e & 1) * 8) * lay.cc_row + ks * 16 +
                                     2 * t + (e >> 1) * 8) = lo;
    }
  }
  // q_rope's terms in shared memory, once per CTA
  __nv_bfloat16* qr_s = reinterpret_cast<__nv_bfloat16*>(tc_smem + lay.qr);
  const int half_rope = rope / 2;
  for (int i = threadIdx.x; i < kTcPairs * half_rope; i += kTcThreads) {
    const int r = i / half_rope, d = 2 * (i - r * half_rope);
    float x0 = 0.f, x1 = 0.f;
    if (r0 + r < n_pairs) {
      const TR* src = q_rope + (row0 + r0 + r) * rope + d;
      x0 = to_f32<TR>(src[0]);
      x1 = to_f32<TR>(src[1]);
    }
    uint32_t w[3];
    split_bf16x3(x0, x1, w[0], w[1], w[2]);
#pragma unroll
    for (int term = 0; term < 3; ++term)
      *reinterpret_cast<uint32_t*>(qr_s + (term * kTcPairs + r) * lay.kc_row + d) = w[term];
  }

  float o[kTcUnits][2][4];
#pragma unroll
  for (int i = 0; i < kTcUnits; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // rows g, g + 8
  const int qpos[2] = {p0 + ra / h_total, p0 + rb / h_total};
  const bool vrow[2] = {va, vb};
  float4* red = reinterpret_cast<float4*>(tc_smem + lay.red);
  // ldmatrix row addresses: lane 8 m + r gives row r of matrix m
  const int lm = lane / 8, lr = lane % 8;
  const int sb_key = (lm >> 1) * 8 + lr, sb_dim = (lm & 1) * 8;  // score B: keys x dims
  const int rb_key = (lm & 1) * 8 + lr, rb_col = (lm >> 1) * 8;  // readout B (trans)
  const int a_row = (lm & 1) * 8 + lr, a_dim = (lm >> 1) * 8;    // A: pairs x dims

  for (int k = 0; k < nsteps; ++k) {
    const int blk_next = block_of(k + kTcStages - 1);
    cp_async_wait_pending(kTcStages - 2);
    __syncthreads();  // step k has landed for all; step k - 1's readers are done
    if (k + kTcStages - 1 < nsteps) stage_step(k + kTcStages - 1, blk_next);
    cp_async_commit();
    const uint8_t* st = tc_smem + (k % kTcStages) * lay.stage;
    const uint32_t s_cc = smem_u32(st);
    const uint32_t s_kc = s_cc + kTcKeys * lay.cc_row * 2;

    // scores: rope k16 step `warp` (warps below rope / 16) ...
    if (warp < nrs) {
      uint32_t bf[4];
      ldsm_x4(bf, s_kc + (sb_key * lay.kc_row + 16 * warp + sb_dim) * 2);
      float sr[2][4] = {};
#pragma unroll
      for (int term = 0; term < kRopeTerms; ++term) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(qr_s + (term * kTcPairs + a_row) * lay.kc_row + 16 * warp + a_dim));
        mma_bf16(sr[0], a, bf[0], bf[1]);
        mma_bf16(sr[1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
        red[((kTcWarps + warp) * 2 + n) * 32 + lane] =
            make_float4(sr[n][0], sr[n][1], sr[n][2], sr[n][3]);
    }
    // ... and latent k16 steps warp + 8 i, each from zero, added in step order
    float sl[2][4] = {};
#pragma unroll
    for (int i = 0; i < kTcLatSteps; ++i) {
      const int ks = warp + kTcWarps * i;
      if (ks >= nks) continue;
      uint32_t bf[4], lo[4];
      ldsm_x4(bf, s_cc + (sb_key * lay.cc_row + 16 * ks + sb_dim) * 2);
      ldsm_x4(lo, smem_u32(qlo_s + a_row * lay.cc_row + 16 * ks + a_dim));
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, qa[i][0], bf[2 * n], bf[2 * n + 1]);
        mma_bf16(d, qa[i][1], bf[2 * n], bf[2 * n + 1]);
        mma_bf16(d, lo, bf[2 * n], bf[2 * n + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) sl[n][e] = __fadd_rn(sl[n][e], d[e]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
      red[(warp * 2 + n) * 32 + lane] = make_float4(sl[n][0], sl[n][1], sl[n][2], sl[n][3]);
    __syncthreads();

    // every warp sums the tiles in warp order (the same bits in every warp),
    // then (lat + rope) * scale, masked
    const int* kpos_s = reinterpret_cast<const int*>(st + lay.kpos);
    float s[2][4];
    bool ok[2][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float4 lat = red[n * 32 + lane];
#pragma unroll
      for (int w = 1; w < kTcWarps; ++w) {
        const float4 v = red[(w * 2 + n) * 32 + lane];
        lat = make_float4(__fadd_rn(lat.x, v.x), __fadd_rn(lat.y, v.y),
                          __fadd_rn(lat.z, v.z), __fadd_rn(lat.w, v.w));
      }
      float4 rp = red[(kTcWarps * 2 + n) * 32 + lane];
      for (int w = 1; w < nrs; ++w) {
        const float4 v = red[((kTcWarps + w) * 2 + n) * 32 + lane];
        rp = make_float4(__fadd_rn(rp.x, v.x), __fadd_rn(rp.y, v.y),
                         __fadd_rn(rp.z, v.z), __fadd_rn(rp.w, v.w));
      }
      const float lv[4] = {lat.x, lat.y, lat.z, lat.w};
      const float rv[4] = {rp.x, rp.y, rp.z, rp.w};
      const int kp[2] = {kpos_s[n * 8 + 2 * t], kpos_s[n * 8 + 2 * t + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e: row (e >> 1), column n * 8 + 2t + (e & 1)
        ok[n][e] = vrow[e >> 1] && kp[e & 1] <= qpos[e >> 1];
        s[n][e] = ok[n][e] ? __fmul_rn(__fadd_rn(lv[e], rv[e]), scale) : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    // online softmax of rows g and g + 8 over the step's 16 keys (a quad)
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m_run[row], mx[row]);
      corr[row] = expf(m_run[row] - m_new);
      m_run[row] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ok[n][e] ? expf(s[n][e] - m_run[e >> 1]) : 0.f;
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 1);
      rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 2);
      l_run[row] = __fmaf_rn(l_run[row], corr[row], rs[row]);
    }

    // P's three terms as the A fragment of keys 0-15: the two C fragments
    uint32_t pa[3][4];
    split_bf16x3(s[0][0], s[0][1], pa[0][0], pa[1][0], pa[2][0]);
    split_bf16x3(s[0][2], s[0][3], pa[0][1], pa[1][1], pa[2][1]);
    split_bf16x3(s[1][0], s[1][1], pa[0][2], pa[1][2], pa[2][2]);
    split_bf16x3(s[1][2], s[1][3], pa[0][3], pa[1][3], pa[2][3]);
    // readout: this warp's 16-column units warp + 8 i, o = o * corr + P.cc
#pragma unroll
    for (int i = 0; i < kTcUnits; ++i) {
      const int u = warp + kTcWarps * i;
      if (u >= nks) continue;
      uint32_t bf[4];
      ldsm_x4_trans(bf, s_cc + (rb_key * lay.cc_row + 16 * u + rb_col) * 2);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int term = 0; term < 3; ++term) mma_bf16(d, pa[term], bf[2 * n], bf[2 * n + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] = __fmaf_rn(o[i][n][e], corr[e >> 1], d[e]);
      }
    }
  }

  // o_lat itself with one split, else the split's partials; (m, l) by warp 0
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (!vrow[row]) continue;
    const int64_t orow = row0 + (row ? rb : ra);
    const float denom = fmaxf(l_run[row], 1e-30f);
    float* dst = n_splits == 1 ? out + orow * lora
                               : part_acc + (orow * n_splits + split) * lora;
#pragma unroll
    for (int i = 0; i < kTcUnits; ++i) {
      const int u = warp + kTcWarps * i;
      if (u >= nks) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float a0 = o[i][n][2 * row], a1 = o[i][n][2 * row + 1];
        *reinterpret_cast<float2*>(dst + 16 * u + 8 * n + 2 * t) = n_splits == 1
            ? make_float2(__fdiv_rn(a0, denom), __fdiv_rn(a1, denom))
            : make_float2(a0, a1);
      }
    }
    if (n_splits > 1 && warp == 0 && t == 0) {
      part_ml[(orow * n_splits + split) * 2] = m_run[row];
      part_ml[(orow * n_splits + split) * 2 + 1] = l_run[row];
    }
  }
}

template <typename TR>
int launch_mla(const void* q_abs, const void* q_rope, const void* cc,
               const void* kc, const void* table, const void* pos, void* out,
               void* part_acc, void* part_ml, int64_t b, int64_t sq, int64_t h,
               int64_t lora, int64_t rope, int64_t n_blocks, int64_t bs,
               int64_t maxb, int64_t bps, int64_t n_splits, int64_t tiles,
               float scale, cudaStream_t st) {
  const unsigned grid = (unsigned)(b * tiles * n_splits);
  const size_t smem = (size_t)MlaTcSmem((int)lora, (int)rope).bytes;
#define REPRO_MLA_CASE(BS_)                                                    \
  case BS_: {                                                                  \
    auto kern = paged_mla_tc_kernel<TR, BS_>;                                  \
    const cudaError_t err = cudaFuncSetAttribute(                              \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);         \
    if (err != cudaSuccess) return (int)err;                                   \
    kern<<<grid, kTcThreads, smem, st>>>(                                      \
        (const float*)q_abs, (const TR*)q_rope, (const __nv_bfloat16*)cc,      \
        (const __nv_bfloat16*)kc, (const int32_t*)table, (const int32_t*)pos,  \
        (float*)out, (float*)part_acc, (float*)part_ml, (int)sq, (int)h,       \
        (int)lora, (int)rope, n_blocks, (int)maxb, (int)bps, (int)n_splits,    \
        (int)tiles, scale);                                                    \
    break;                                                                     \
  }
  switch (bs) {
    REPRO_MLA_CASE(4)
    REPRO_MLA_CASE(8)
    REPRO_MLA_CASE(16)
    REPRO_MLA_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MLA_CASE
  return launch_mla_merge(part_acc, part_ml, out, b * sq * h, n_splits, lora, st);
}

}  // namespace

// The GQA decode: the split kernel over plan's grid (b * kv * n_splits
// CTAs), then with n_splits > 1 the merge kernel over the b * sq * h output
// rows. part_acc (rows x n_splits x vd) and part_ml (rows x n_splits x 2)
// are the f32 scratch of the partials (unused with one split).
extern "C" int paged_gqa_launch(const void* q, int q_is_bf16, int packed,
                                const void* k_pool, const void* k_scales,
                                const void* v_pool, const void* v_scales,
                                const void* table, const void* pos, void* out,
                                void* part_acc, void* part_ml,
                                int64_t b, int64_t sq, int64_t h, int64_t kv,
                                int64_t hd, int64_t vd, int64_t n_blocks,
                                int64_t bs, int64_t maxb, int64_t window,
                                float sqrt_hd, int64_t bps, int64_t n_splits,
                                int64_t row_groups, void* stream) {
  if (hd > kMaxD || vd > kMaxD || hd < 8 || vd < 8 || hd % 8 || vd % 8 ||
      sq > kMaxSq || sq < 1 || kv < 1 || h % kv || maxb < 1)
    return (int)cudaErrorInvalidValue;
  if (packed && (hd % 16 || vd % 16 || !k_scales || !v_scales))
    return (int)cudaErrorInvalidValue;
  if (bps < 1 || bps > kMaxSplitBlocks || bps * bs > kMaxSplitKeys ||
      n_splits != (maxb + bps - 1) / bps ||
      (row_groups != 1 && row_groups != 2 && row_groups != 4) ||
      (n_splits > 1 && (!part_acc || !part_ml)) ||
      b * kv * n_splits > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_GQA_ARGS                                                         \
  q, k_pool, k_scales, v_pool, v_scales, table, pos, out, part_acc, part_ml,   \
      b, sq, h, kv, hd, vd, n_blocks, bs, maxb, window, sqrt_hd, bps,          \
      n_splits, row_groups, st
  if (q_is_bf16)
    return packed ? launch_gqa<__nv_bfloat16, true>(REPRO_GQA_ARGS)
                  : launch_gqa<__nv_bfloat16, false>(REPRO_GQA_ARGS);
  return packed ? launch_gqa<float, true>(REPRO_GQA_ARGS)
                : launch_gqa<float, false>(REPRO_GQA_ARGS);
#undef REPRO_GQA_ARGS
}

// #7: the tensor-core kernel over plan_mla's grid with wave = MLA_TC_WAVE
// (b * tiles * n_splits CTAs), then with n_splits > 1 the merge kernel over
// the b * sq * h o_lat rows. part_acc (rows x n_splits x lora) and part_ml
// (rows x n_splits x 2) are the f32 scratch of the partials (unused with one
// split). The pools' rows come by 16-byte cp.async and q_abs by 8-byte loads,
// so cc and kc must be 16-byte aligned and q_abs 8-byte aligned.
extern "C" int paged_mla_launch(const void* q_abs, const void* q_rope,
                                int q_rope_is_bf16, const void* cc_pool,
                                const void* kc_pool, const void* table,
                                const void* pos, void* out, void* part_acc,
                                void* part_ml, int64_t b, int64_t sq,
                                int64_t h, int64_t lora, int64_t rope,
                                int64_t n_blocks, int64_t bs, int64_t maxb,
                                int64_t bps, int64_t n_splits, int64_t tiles,
                                float scale, void* stream) {
  if (lora > kMaxLora || rope > kMaxRope || lora < 16 || rope < 16 ||
      lora % 16 || rope % 16 || sq > kMaxSq || sq < 1 || h < 1 || maxb < 1 ||
      ((uintptr_t)cc_pool | (uintptr_t)kc_pool) % 16 || (uintptr_t)q_abs % 8)
    return (int)cudaErrorInvalidValue;
  if (bps < 1 || n_splits != (maxb + bps - 1) / bps ||
      tiles != (sq * h + kTcPairs - 1) / kTcPairs ||
      (n_splits > 1 && (!part_acc || !part_ml)) ||
      b * tiles * n_splits > 0x7fffffff ||
      MlaTcSmem((int)lora, (int)rope).bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_MLA_ARGS                                                         \
  q_abs, q_rope, cc_pool, kc_pool, table, pos, out, part_acc, part_ml, b, sq,  \
      h, lora, rope, n_blocks, bs, maxb, bps, n_splits, tiles, scale, st
  if (q_rope_is_bf16) return launch_mla<__nv_bfloat16>(REPRO_MLA_ARGS);
  return launch_mla<float>(REPRO_MLA_ARGS);
#undef REPRO_MLA_ARGS
}

// #8: the split kernel over plan_mla's grid (b * tiles * n_splits CTAs),
// then with n_splits > 1 the merge kernel over the b * sq * h o_lat rows.
// part_acc (rows x n_splits x lora) and part_ml (rows x n_splits x 2) are
// the f32 scratch of the partials (unused with one split).
extern "C" int paged_mla_q_launch(const void* q_abs, const void* q_rope,
                                  int q_rope_is_bf16, const void* cc_codes,
                                  const void* cc_scales, const void* kc_codes,
                                  const void* kc_scales, const void* table,
                                  const void* pos, void* out, void* part_acc,
                                  void* part_ml, int64_t b, int64_t sq,
                                  int64_t h, int64_t lora, int64_t rope,
                                  int64_t n_blocks, int64_t bs, int64_t maxb,
                                  int64_t bps, int64_t n_splits, int64_t tiles,
                                  float scale, void* stream) {
  if (lora > kMaxLora || rope > kMaxRope || lora < 16 || rope < 16 ||
      lora % 16 || rope % 16 || sq > kMaxSq || sq < 1 || h < 1 || maxb < 1 ||
      !cc_scales || !kc_scales)
    return (int)cudaErrorInvalidValue;
  if (bps < 1 || n_splits != (maxb + bps - 1) / bps ||
      tiles != (sq * h + kMlaPairs - 1) / kMlaPairs ||
      (n_splits > 1 && (!part_acc || !part_ml)) ||
      b * tiles * n_splits > 0x7fffffff || MlaSmem(bs, lora, rope, bps).bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_MLA_Q_ARGS                                                       \
  q_abs, q_rope, cc_codes, cc_scales, kc_codes, kc_scales, table, pos, out,    \
      part_acc, part_ml, b, sq, h, lora, rope, n_blocks, bs, maxb, bps,        \
      n_splits, tiles, scale, st
  if (q_rope_is_bf16) return launch_mla_q<__nv_bfloat16>(REPRO_MLA_Q_ARGS);
  return launch_mla_q<float>(REPRO_MLA_Q_ARGS);
#undef REPRO_MLA_Q_ARGS
}
