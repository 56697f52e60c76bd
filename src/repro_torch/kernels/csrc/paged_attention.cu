// Block-table flash-decode attention over the paged KV pools for Hopper
// (sm_90a): GQA over the bf16 pool (#5) and the NVFP4 pool (#6), and the
// absorbed-form MLA latent decode over bf16 (#7) and NVFP4 (#8) latent pools.
//
// ---- GQA: paged_gqa_kernel<TQ, BS, kPacked> ------------------------------
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
// Bound on the H100: memory bytes. Each live K/V block is read once per
// query head (GQA groups re-read it from L2) and the flops per byte are ~Sq;
// at decode (Sq = 1) the sweep is a pure stream of the row's cache. The
// packed pool moves 0.28125x the bf16 bytes (d/2 code bytes + d/16 scale
// bytes per token row).
//
// Design: one 128-thread block per (batch row, query head). The block reads
// its own table[b, j] and pos[b] (no scalar prefetch) and loops over the
// logical blocks; a live block's K and V are staged once in shared memory as
// fp32 by the loader: a bf16 cast, or for the packed pool an arithmetic
// e2m1 x e4m3 decode (exact in f32, so the kernel sees bit-identical
// operands to the gather path's bf16 dequant). Each of the 4 warps owns
// query rows s = warp, warp + 4, ... (Sq <= 16); a lane owns head dims
// lane + 32 i, so a score is a warp reduction and the running (m, l, acc)
// of the online softmax stay in registers. expf and division are the IEEE
// versions (no fast math).
//
// ---- MLA: paged_mla_kernel<TR, BS, kPacked> ------------------------------
// Replaces: src/repro/kernels/paged_attention.py:paged_mla_call (_mla_kernel
// via _mla_sweep) and, with kPacked, paged_mla_q_call (_mla_q_kernel). For
// each row b, query s and head h: scores s_t = (q_abs.cc_t + q_rope.kc_t) *
// scale (a MULTIPLICATION by the f32 1/sqrt(qk_dim)), causal mask
// t <= pos[b] + s, online softmax, and the readout over cc itself: o_lat
// (B, Sq, H, lora) f32 for the caller's W_uv absorption. No window; a row
// with l == 0 (inactive: all-sentinel table) returns exact zeros.
//
// Bound on the H100: f32 operations. All H heads share one latent row per
// token (lora + rope = 576 values: 1,152 bf16 bytes, 324 packed bytes), read
// once from HBM, while each (query, head, token) takes 2 (lora + rope) +
// 2 lora = 2,176 flops: at H = 128, Sq = 1 that is ~240 flops per bf16 byte,
// far above the ~20 at which the CUDA cores' 67 TFLOP/s and 3.35 TB/s
// balance.
//
// Design: #5's layout does not fit (a 512-wide accumulator per head, 128
// heads sharing one latent block). The grid splits each row's (Sq x H)
// query-head pairs into tiles of 4, one per warp of a 128-thread block; a
// live (BS, lora + rope) latent block is staged ONCE per CUDA block in
// dynamic shared memory as f32 (<= 36.9 KB at BS 16) by the same loader as
// #5/#6 (rope 64 -> 4 scale groups when packed), and the block's 4 heads all
// sweep it from there (the row's other head tiles read it again from L2;
// 4 heads per block keep ~1 wave of blocks on the 132 SMs at 4 decode rows). A lane owns latent dims lane + 32 i (16 of 512) and rope dims
// lane + 32 i (2 of 64), so (m, l) and the 16-float accumulator stay in
// registers; each score is two warp reductions (latent, rope), added and
// then multiplied by the scale, as the reference does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;                 // head dim / value dim cap
constexpr int kPerLane = kMaxD / 32;
constexpr int kMaxSq = 16;
constexpr int kRowsPerWarp = kMaxSq / kWarps;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E2M1 code -> value, arithmetically: (1 + m/2) 2^(e-1), subnormal m/2.
__device__ __forceinline__ float e2m1_decode(uint32_t c) {
  const int e = (c >> 1) & 3;
  const float m = (float)(c & 1u);
  const float mag = e == 0 ? 0.5f * m : ldexpf(1.f + 0.5f * m, e - 1);
  return (c & 8u) ? -mag : mag;
}

// Raw float8_e4m3fn bits -> value: (8 + m) 2^(e-10), subnormal m 2^-9.
__device__ __forceinline__ float e4m3_decode(uint32_t b) {
  const int e = (b >> 3) & 0xF;
  const int m = b & 0x7;
  const float mag = e == 0 ? (float)m * 0.001953125f
                           : ldexpf((float)(8 + m), e - 10);
  return (b & 0x80u) ? -mag : mag;
}

// Element d of token row `row` of a pool leaf with feature width `dim`: a
// bf16 value, or (kPacked) the e2m1 code of nibble d of the row's code
// bytes times its 16-group's e4m3 scale. Both are exact in f32.
template <bool kPacked>
__device__ __forceinline__ float load_elem(const void* __restrict__ data,
                                           const uint8_t* __restrict__ scales,
                                           int64_t row, int d, int dim) {
  if constexpr (kPacked) {
    const uint8_t byte = ((const uint8_t*)data)[row * (dim / 2) + (d >> 1)];
    const uint32_t code = (d & 1) ? (byte >> 4) : (byte & 0xFu);
    return e2m1_decode(code) * e4m3_decode(scales[row * (dim / 16) + (d >> 4)]);
  } else {
    return __bfloat162float(((const __nv_bfloat16*)data)[row * dim + d]);
  }
}

template <typename TQ, int BS, bool kPacked>
__global__ void __launch_bounds__(kThreads)
paged_gqa_kernel(const TQ* __restrict__ q, const void* __restrict__ kp,
                 const uint8_t* __restrict__ k_scales,
                 const void* __restrict__ vp,
                 const uint8_t* __restrict__ v_scales,
                 const int32_t* __restrict__ table,
                 const int32_t* __restrict__ pos, float* __restrict__ out,
                 int sq, int h_total, int kv, int hd, int vd,
                 int64_t n_blocks, int maxb, int window, float sqrt_hd) {
  __shared__ float ks[BS][kMaxD];
  __shared__ float vs[BS][kMaxD];
  const int b = blockIdx.x / h_total;
  const int h = blockIdx.x % h_total;
  const int g = h / (h_total / kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = pos[b];
  const int pmax = p0 + sq - 1;

  float qr[kRowsPerWarp][kPerLane];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int s = warp + kWarps * i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int d = lane + 32 * e;
      acc[i][e] = 0.f;
      qr[i][e] = (s < sq && d < hd)
          ? to_f32<TQ>(q[(((int64_t)b * sq + s) * h_total + h) * hd + d]) : 0.f;
    }
  }

  for (int j = 0; j < maxb; ++j) {
    const int64_t blk = table[(int64_t)b * maxb + j];
    bool live = blk >= 0 && blk < n_blocks && (int64_t)j * BS <= pmax;
    if (window > 0) live = live && ((int64_t)(j + 1) * BS - 1 > (int64_t)p0 - window);
    if (!live) continue;  // uniform over the block: every thread read blk

    __syncthreads();      // the previous live block's readers are done
    for (int i = threadIdx.x; i < BS * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      ks[t][d] = load_elem<kPacked>(kp, k_scales, (blk * BS + t) * kv + g, d, hd);
    }
    for (int i = threadIdx.x; i < BS * vd; i += kThreads) {
      const int t = i / vd, d = i % vd;
      vs[t][d] = load_elem<kPacked>(vp, v_scales, (blk * BS + t) * kv + g, d, vd);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int s = warp + kWarps * i;
      if (s >= sq) continue;  // warp-uniform
      const int qpos = p0 + s;
      float sc[BS];
      float smax = kNegInf;
#pragma unroll
      for (int t = 0; t < BS; ++t) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) part += qr[i][e] * ks[t][d];
        }
        const int kj = j * BS + t;
        bool ok = kj <= qpos;
        if (window > 0) ok = ok && kj > qpos - window;
        const float v = __fdiv_rn(warp_sum(part), sqrt_hd);
        sc[t] = ok ? v : kNegInf;
        smax = fmaxf(smax, sc[t]);
      }
      const float m_new = fmaxf(m[i], smax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
      float pv[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) pv[e] = 0.f;
#pragma unroll
      for (int t = 0; t < BS; ++t) {
        const int kj = j * BS + t;
        bool ok = kj <= qpos;
        if (window > 0) ok = ok && kj > qpos - window;
        const float p = ok ? expf(sc[t] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          const int d = lane + 32 * e;
          if (d < vd) pv[e] += p * vs[t][d];
        }
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[i][e] = acc[i][e] * corr + pv[e];
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int s = warp + kWarps * i;
    if (s >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < vd)
        out[(((int64_t)b * sq + s) * h_total + h) * vd + d] =
            __fdiv_rn(acc[i][e], denom);
    }
  }
}

template <typename TQ, bool kPacked>
int launch_gqa(const void* q, const void* kp, const void* ks, const void* vp,
               const void* vs, const void* table, const void* pos, void* out,
               int64_t b, int64_t sq, int64_t h, int64_t kv, int64_t hd,
               int64_t vd, int64_t n_blocks, int64_t bs, int64_t maxb,
               int64_t window, float sqrt_hd, cudaStream_t st) {
  const unsigned grid = (unsigned)(b * h);
#define REPRO_GQA_CASE(BS_)                                                    \
  case BS_:                                                                    \
    paged_gqa_kernel<TQ, BS_, kPacked><<<grid, kThreads, 0, st>>>(             \
        (const TQ*)q, kp, (const uint8_t*)ks, vp, (const uint8_t*)vs,          \
        (const int32_t*)table, (const int32_t*)pos, (float*)out, (int)sq,      \
        (int)h, (int)kv, (int)hd, (int)vd, n_blocks, (int)maxb, (int)window,   \
        sqrt_hd);                                                              \
    break;
  switch (bs) {
    REPRO_GQA_CASE(4)
    REPRO_GQA_CASE(8)
    REPRO_GQA_CASE(16)
    REPRO_GQA_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_GQA_CASE
  return (int)cudaGetLastError();
}

constexpr int kMlaWarps = 4;
constexpr int kMlaThreads = kMlaWarps * 32;
constexpr int kMaxLora = 512;
constexpr int kMaxRope = 64;
constexpr int kLoraPerLane = kMaxLora / 32;
constexpr int kRopePerLane = kMaxRope / 32;

template <typename TR, int BS, bool kPacked>
__global__ void __launch_bounds__(kMlaThreads)
paged_mla_kernel(const float* __restrict__ q_abs, const TR* __restrict__ q_rope,
                 const void* __restrict__ cc,
                 const uint8_t* __restrict__ cc_scales,
                 const void* __restrict__ kc,
                 const uint8_t* __restrict__ kc_scales,
                 const int32_t* __restrict__ table,
                 const int32_t* __restrict__ pos, float* __restrict__ out,
                 int sq, int h_total, int lora, int rope, int64_t n_blocks,
                 int maxb, int tiles, float scale) {
  extern __shared__ float smem[];
  float* cs = smem;              // [BS][lora] latent block
  float* ks = smem + BS * lora;  // [BS][rope] rope block
  const int b = blockIdx.x / tiles;
  const int pair = (blockIdx.x % tiles) * kMlaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has = pair < sq * h_total;  // warp-uniform
  const int s = has ? pair / h_total : 0;
  const int h = has ? pair % h_total : 0;
  const int p0 = pos[b];
  const int pmax = p0 + sq - 1;
  const int qpos = p0 + s;
  const int64_t qrow = ((int64_t)b * sq + s) * h_total + h;

  float qa[kLoraPerLane], acc[kLoraPerLane], qr[kRopePerLane];
  float m = kNegInf, l = 0.f;
#pragma unroll
  for (int e = 0; e < kLoraPerLane; ++e) {
    const int d = lane + 32 * e;
    acc[e] = 0.f;
    qa[e] = (has && d < lora) ? q_abs[qrow * lora + d] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kRopePerLane; ++e) {
    const int d = lane + 32 * e;
    qr[e] = (has && d < rope) ? to_f32<TR>(q_rope[qrow * rope + d]) : 0.f;
  }

  for (int j = 0; j < maxb; ++j) {
    const int64_t blk = table[(int64_t)b * maxb + j];
    if (!(blk >= 0 && blk < n_blocks && (int64_t)j * BS <= pmax)) continue;

    __syncthreads();  // the previous live block's readers are done
    for (int i = threadIdx.x; i < BS * lora; i += kMlaThreads) {
      const int t = i / lora, d = i % lora;
      cs[i] = load_elem<kPacked>(cc, cc_scales, blk * BS + t, d, lora);
    }
    for (int i = threadIdx.x; i < BS * rope; i += kMlaThreads) {
      const int t = i / rope, d = i % rope;
      ks[i] = load_elem<kPacked>(kc, kc_scales, blk * BS + t, d, rope);
    }
    __syncthreads();
    if (!has) continue;

    float sc[BS];
    float smax = kNegInf;
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      float lat = 0.f, rp = 0.f;
#pragma unroll
      for (int e = 0; e < kLoraPerLane; ++e) {
        const int d = lane + 32 * e;
        if (d < lora) lat += qa[e] * cs[t * lora + d];
      }
#pragma unroll
      for (int e = 0; e < kRopePerLane; ++e) {
        const int d = lane + 32 * e;
        if (d < rope) rp += qr[e] * ks[t * rope + d];
      }
      const float v = __fmul_rn(__fadd_rn(warp_sum(lat), warp_sum(rp)), scale);
      sc[t] = (j * BS + t <= qpos) ? v : kNegInf;
      smax = fmaxf(smax, sc[t]);
    }
    const float m_new = fmaxf(m, smax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    float pv[kLoraPerLane];
#pragma unroll
    for (int e = 0; e < kLoraPerLane; ++e) pv[e] = 0.f;
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      const float p = (j * BS + t <= qpos) ? expf(sc[t] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int e = 0; e < kLoraPerLane; ++e) {
        const int d = lane + 32 * e;
        if (d < lora) pv[e] += p * cs[t * lora + d];
      }
    }
    l = l * corr + psum;
#pragma unroll
    for (int e = 0; e < kLoraPerLane; ++e) acc[e] = acc[e] * corr + pv[e];
    m = m_new;
  }

  if (!has) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < kLoraPerLane; ++e) {
    const int d = lane + 32 * e;
    if (d < lora) out[qrow * lora + d] = __fdiv_rn(acc[e], denom);
  }
}

template <typename TR, bool kPacked>
int launch_mla(const void* q_abs, const void* q_rope, const void* cc,
               const void* ccs, const void* kc, const void* kcs,
               const void* table, const void* pos, void* out, int64_t b,
               int64_t sq, int64_t h, int64_t lora, int64_t rope,
               int64_t n_blocks, int64_t bs, int64_t maxb, float scale,
               cudaStream_t st) {
  const int64_t tiles = (sq * h + kMlaWarps - 1) / kMlaWarps;
  const unsigned grid = (unsigned)(b * tiles);
  const size_t smem = (size_t)bs * (lora + rope) * sizeof(float);
#define REPRO_MLA_CASE(BS_)                                                    \
  case BS_: {                                                                  \
    auto kern = paged_mla_kernel<TR, BS_, kPacked>;                            \
    if (smem > 48 * 1024) {                                                    \
      const cudaError_t err = cudaFuncSetAttribute(                            \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
      if (err != cudaSuccess) return (int)err;                                 \
    }                                                                          \
    kern<<<grid, kMlaThreads, smem, st>>>(                                     \
        (const float*)q_abs, (const TR*)q_rope, cc, (const uint8_t*)ccs, kc,   \
        (const uint8_t*)kcs, (const int32_t*)table, (const int32_t*)pos,       \
        (float*)out, (int)sq, (int)h, (int)lora, (int)rope, n_blocks,          \
        (int)maxb, (int)tiles, scale);                                         \
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
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_gqa_launch(const void* q, int q_is_bf16, int packed,
                                const void* k_pool, const void* k_scales,
                                const void* v_pool, const void* v_scales,
                                const void* table, const void* pos, void* out,
                                int64_t b, int64_t sq, int64_t h, int64_t kv,
                                int64_t hd, int64_t vd, int64_t n_blocks,
                                int64_t bs, int64_t maxb, int64_t window,
                                float sqrt_hd, void* stream) {
  if (hd > kMaxD || vd > kMaxD || sq > kMaxSq || sq < 1 || kv < 1 || h % kv)
    return (int)cudaErrorInvalidValue;
  if (packed && (hd % 16 || vd % 16 || !k_scales || !v_scales))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_GQA_ARGS                                                         \
  q, k_pool, k_scales, v_pool, v_scales, table, pos, out, b, sq, h, kv, hd,    \
      vd, n_blocks, bs, maxb, window, sqrt_hd, st
  if (q_is_bf16)
    return packed ? launch_gqa<__nv_bfloat16, true>(REPRO_GQA_ARGS)
                  : launch_gqa<__nv_bfloat16, false>(REPRO_GQA_ARGS);
  return packed ? launch_gqa<float, true>(REPRO_GQA_ARGS)
                : launch_gqa<float, false>(REPRO_GQA_ARGS);
#undef REPRO_GQA_ARGS
}

extern "C" int paged_mla_launch(const void* q_abs, const void* q_rope,
                                int q_rope_is_bf16, int packed,
                                const void* cc_pool, const void* cc_scales,
                                const void* kc_pool, const void* kc_scales,
                                const void* table, const void* pos, void* out,
                                int64_t b, int64_t sq, int64_t h, int64_t lora,
                                int64_t rope, int64_t n_blocks, int64_t bs,
                                int64_t maxb, float scale, void* stream) {
  if (lora > kMaxLora || rope > kMaxRope || lora < 1 || rope < 1 ||
      sq > kMaxSq || sq < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  if (packed && (lora % 16 || rope % 16 || !cc_scales || !kc_scales))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_MLA_ARGS                                                         \
  q_abs, q_rope, cc_pool, cc_scales, kc_pool, kc_scales, table, pos, out, b,   \
      sq, h, lora, rope, n_blocks, bs, maxb, scale, st
  if (q_rope_is_bf16)
    return packed ? launch_mla<__nv_bfloat16, true>(REPRO_MLA_ARGS)
                  : launch_mla<__nv_bfloat16, false>(REPRO_MLA_ARGS);
  return packed ? launch_mla<float, true>(REPRO_MLA_ARGS)
                : launch_mla<float, false>(REPRO_MLA_ARGS);
#undef REPRO_MLA_ARGS
}
