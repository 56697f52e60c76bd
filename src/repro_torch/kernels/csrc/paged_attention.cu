// Block-table flash-decode GQA attention over the paged bf16 KV pool for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py:paged_gqa_call (Pallas body
// _gqa_kernel via _gqa_sweep and _online_update). Computes, for each batch
// row b and query head h, softmax attention of the Sq query tokens at
// absolute positions pos[b] + s over the keys the row's block table maps,
// without gathering a dense view:
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
// at decode (Sq = 1) the sweep is a pure stream of the row's cache.
//
// Design: one 128-thread block per (batch row, query head). The block reads
// its own table[b, j] and pos[b] (no scalar prefetch) and loops over the
// logical blocks; a live block's K and V are staged once in shared memory as
// fp32. Each of the 4 warps owns query rows s = warp, warp + 4, ... (Sq <=
// 16); a lane owns head dims lane + 32 i, so a score is a warp reduction and
// the running (m, l, acc) of the online softmax stay in registers. expf and
// division are the IEEE versions (no fast math).

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

template <typename TQ, int BS>
__global__ void __launch_bounds__(kThreads)
paged_gqa_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                 const __nv_bfloat16* __restrict__ vp,
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
      ks[t][d] = __bfloat162float(kp[((blk * BS + t) * kv + g) * hd + d]);
    }
    for (int i = threadIdx.x; i < BS * vd; i += kThreads) {
      const int t = i / vd, d = i % vd;
      vs[t][d] = __bfloat162float(vp[((blk * BS + t) * kv + g) * vd + d]);
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

template <typename TQ>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* pos, void* out, int64_t b, int64_t sq, int64_t h,
           int64_t kv, int64_t hd, int64_t vd, int64_t n_blocks, int64_t bs,
           int64_t maxb, int64_t window, float sqrt_hd, cudaStream_t st) {
  const unsigned grid = (unsigned)(b * h);
#define REPRO_GQA_CASE(BS_)                                                    \
  case BS_:                                                                    \
    paged_gqa_kernel<TQ, BS_><<<grid, kThreads, 0, st>>>(                      \
        (const TQ*)q, (const __nv_bfloat16*)kp, (const __nv_bfloat16*)vp,      \
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

}  // namespace

extern "C" int paged_gqa_launch(const void* q, int q_is_bf16, const void* k_pool,
                                const void* v_pool, const void* table,
                                const void* pos, void* out, int64_t b,
                                int64_t sq, int64_t h, int64_t kv, int64_t hd,
                                int64_t vd, int64_t n_blocks, int64_t bs,
                                int64_t maxb, int64_t window, float sqrt_hd,
                                void* stream) {
  if (hd > kMaxD || vd > kMaxD || sq > kMaxSq || sq < 1 || kv < 1 || h % kv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, pos, out, b, sq, h,
                                 kv, hd, vd, n_blocks, bs, maxb, window,
                                 sqrt_hd, st);
  return launch<float>(q, k_pool, v_pool, table, pos, out, b, sq, h, kv, hd,
                       vd, n_blocks, bs, maxb, window, sqrt_hd, st);
}
