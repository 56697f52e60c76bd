// MS-EDEN re-quantization with post hoc range alignment for Hopper (sm_90a):
// the two phases of the unbiased NVFP4 backward quantizer (paper Section 7).
//
// Replaces: src/repro/kernels/ms_eden_requant.py, both pallas_calls of
// ms_eden_requant — phase 1 (:110, body _phase1_kernel) and phase 2 (:141,
// body _phase2_kernel). Semantics: repro_torch.core.ms_eden.ms_eden_phase1
// and ms_eden_phase2 (the reference's core/ms_eden.py:87 and :107).
//
// Phase 1, per row of x (M, K) f32 and per rotation block of b = 16..128:
//   rot = H_b (x * sign) / sqrt(b), then per 16-group gmax, the E8M3
//   pseudo-scale e8m3(gmax / s), the FP4 codes of rot / pseudo (packed two
//   per byte), the EDEN sums <rot, rot> and <rot, deq>, and the global absmax
//   of rot (atomicMax on the bits of a non-negative float: no host sync).
// Phase 2, per 16-group: gscale = absmax / (s * 256) (0 -> 1), the EDEN factor
//   num / den (den == 0 -> 1), target = clip(S * pseudo / gscale, 0, 448), and
//   stochastic rounding of target onto the e4m3 lattice against a uniforms
//   operand, emitted as raw e4m3 bits.
//
// Bound on the H100: memory bytes, both phases. Phase 1 reads 4 B and writes
// 0.5 + 12/16 B per element; the butterfly below does log2(b) = 7 adds per
// element at b = 128 and the quantizer some 20 more f32 operations, ~1/10 of
// what the card's CUDA cores (67 TFLOP/s) could do in the time the bytes take
// at 3.35 TB/s. (The reference's dense RHT, 2 b = 256 flops per element,
// would be bound by the CUDA cores instead.) Phase 2 moves 17 B per 16-group:
// it reads 16 B (pseudo, num, den, u) and writes one e4m3 scale byte.
//
// Design. Phase 1: one warp per 128 consecutive elements of the flattened
// tensor, 4 per lane, loaded as one float4 (coalesced). Every rotation block
// and every 16-group lies whole inside one warp, because K is a multiple of b
// and b divides 128. The Hadamard is applied as a fast Walsh-Hadamard
// butterfly in registers: strides 1 and 2 inside a lane, strides 4 .. b/2
// across lanes by __shfl_xor_sync. Group maxima and the EDEN sums reduce over
// the 4 lanes of a group by shuffles; the block's absmax reduces in shared
// memory to one atomicMax. Bit-exactness: the butterfly runs in the fixed
// order of core/rht.py, the EDEN sums in the order of core/ms_eden.group_sum,
// and every rounding uses the _rn intrinsics (no FMA contraction; no fast
// math; denormals kept, -ftz=false is nvcc's default), so both phases equal
// their plain PyTorch versions bit for bit. The f32 constants (s, s * 256,
// 1/sqrt(b)) come from Python, so kernel and plain version use identical
// scalars. Phase 2: one thread per group. Any M is accepted (the reference's
// kernel needed M % bm == 0). A later PR can fuse phase 2 into the GEMM's
// operand load.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int fp4_rtn_index(float m) {
  // round-half-to-even thresholds of core/formats.py:fp4_rtn
  return m <= 0.25f ? 0 : m < 0.75f ? 1 : m <= 1.25f ? 2 : m < 1.75f ? 3
       : m <= 2.5f ? 4 : m < 3.5f ? 5 : m <= 5.0f ? 6 : 7;
}

__device__ __forceinline__ float fp4_grid(int idx) {
  const float g[8] = {0.f, 0.5f, 1.f, 1.5f, 2.f, 3.f, 4.f, 6.f};
  return g[idx];
}

__device__ __forceinline__ float e4m3_bits_to_float(uint32_t b) {
  const int e = (b >> 3) & 0xF;
  const int m = b & 0x7;
  const float mag = e == 0 ? (float)m * 0.001953125f        // m/8 * 2^-6
                           : ldexpf((float)(8 + m), e - 10);  // (1+m/8) 2^(e-7)
  return (b & 0x80u) ? -mag : mag;
}

// core/formats.py:e8m3_rtn — 3 mantissa bits, unbounded exponent, mantissa
// rounded half to even (rintf); values <= 0 give 0.
__device__ __forceinline__ float e8m3_rtn(float x) {
  if (x <= 0.f) return 0.f;
  if (isnan(x)) return x;
  int e;
  const float m = frexpf(fmaxf(x, 1e-38f), &e);
  const float mq = __fmul_rn(rintf(__fmul_rn(m, 16.f)), 0.0625f);
  return ldexpf(mq, e);
}

__global__ void __launch_bounds__(kThreads)
ms_eden_phase1_kernel(const float* __restrict__ x,
                      const float* __restrict__ signs,
                      uint8_t* __restrict__ packed,
                      float* __restrict__ pseudo,
                      float* __restrict__ num,
                      float* __restrict__ den,
                      unsigned int* __restrict__ absmax_bits,
                      int64_t n, int b, float s, float inv_sqrt_b) {
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t base = warp * 128 + lane * 4;  // this lane's first element
  const bool active = base < n;  // n % 16 == 0: groups are whole either way

  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    const float4 t = *reinterpret_cast<const float4*>(x + base);
    const int p0 = (lane * 4) & (b - 1);  // position inside the rotation block
    v[0] = __fmul_rn(t.x, signs[p0]);
    v[1] = __fmul_rn(t.y, signs[p0 + 1]);
    v[2] = __fmul_rn(t.z, signs[p0 + 2]);
    v[3] = __fmul_rn(t.w, signs[p0 + 3]);
  }

  // Walsh-Hadamard butterfly, strides 1, 2, ..., b/2: (lo, hi) -> (lo + hi,
  // lo - hi), the order of core/rht.py:_butterfly.
  {
    const float a0 = v[0], a1 = v[1], a2 = v[2], a3 = v[3];
    v[0] = __fadd_rn(a0, a1); v[1] = __fsub_rn(a0, a1);
    v[2] = __fadd_rn(a2, a3); v[3] = __fsub_rn(a2, a3);
  }
  {
    const float a0 = v[0], a1 = v[1], a2 = v[2], a3 = v[3];
    v[0] = __fadd_rn(a0, a2); v[2] = __fsub_rn(a0, a2);
    v[1] = __fadd_rn(a1, a3); v[3] = __fsub_rn(a1, a3);
  }
  for (int h = 4; h < b; h <<= 1) {
    const int lm = h >> 2;  // partner lane holds the element h away
    const bool upper = (lane & lm) != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float o = __shfl_xor_sync(kFull, v[j], lm);
      v[j] = upper ? __fsub_rn(o, v[j]) : __fadd_rn(v[j], o);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(v[j], inv_sqrt_b);

  // 16-group = the 4 lanes of a quad
  float gmax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
  gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, 1));
  gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, 2));
  const float ps = e8m3_rtn(__fdiv_rn(gmax, s));
  const float denom = ps == 0.f ? 1.f : ps;

  uint32_t codes = 0;
  float tn = 0.f, td = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float xs = __fdiv_rn(v[j], denom);
    const int idx = fp4_rtn_index(fabsf(xs));
    const float g = fp4_grid(idx);
    const float q = xs > 0.f ? g : (xs < 0.f ? -g : 0.f);
    // sign bit only for a strictly negative grid value (-0 codes as 0)
    codes |= (uint32_t)(((xs < 0.f && idx > 0) ? 8 : 0) | idx) << (4 * j);
    const float sq = __fmul_rn(v[j], v[j]);
    const float pr = __fmul_rn(v[j], __fmul_rn(q, denom));
    tn = j == 0 ? sq : __fadd_rn(tn, sq);
    td = j == 0 ? pr : __fadd_rn(td, pr);
  }
  tn = __fadd_rn(tn, __shfl_xor_sync(kFull, tn, 1));
  td = __fadd_rn(td, __shfl_xor_sync(kFull, td, 1));
  tn = __fadd_rn(tn, __shfl_xor_sync(kFull, tn, 2));
  td = __fadd_rn(td, __shfl_xor_sync(kFull, td, 2));

  if (active) {
    // two bytes: (c0 | c1 << 4), (c2 | c3 << 4), low nibble = even index
    *reinterpret_cast<uint16_t*>(packed + base / 2) = (uint16_t)codes;
    if ((lane & 3) == 0) {
      const int64_t gi = base / 16;
      pseudo[gi] = ps;
      num[gi] = tn;
      den[gi] = td;
    }
  }

  // absmax of the block: warp shuffles, then shared memory, one atomic
  float am = gmax;
  am = fmaxf(am, __shfl_xor_sync(kFull, am, 4));
  am = fmaxf(am, __shfl_xor_sync(kFull, am, 8));
  am = fmaxf(am, __shfl_xor_sync(kFull, am, 16));
  if (lane == 0) warp_max[threadIdx.x >> 5] = am;
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    // non-negative floats order as their bit patterns
    atomicMax(absmax_bits, __float_as_uint(bm));
  }
}

__global__ void __launch_bounds__(kThreads)
ms_eden_phase2_kernel(const float* __restrict__ absmax,
                      const float* __restrict__ pseudo,
                      const float* __restrict__ num,
                      const float* __restrict__ den,
                      const float* __restrict__ u,
                      uint8_t* __restrict__ scale_bits,
                      float* __restrict__ gscale_out,
                      int64_t n_groups, float gdiv) {
  float gscale = __fdiv_rn(absmax[0], gdiv);
  if (gscale == 0.f) gscale = 1.f;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) gscale_out[0] = gscale;
  if (i >= n_groups) return;

  const float dn = den[i];
  const float eden = dn != 0.f ? __fdiv_rn(num[i], dn) : 1.f;
  float target = __fdiv_rn(__fmul_rn(eden, pseudo[i]), gscale);
  target = fminf(fmaxf(target, 0.f), 448.f);

  // core/formats.py:fp8_sr_pos — the RNE neighbour and the lattice step
  // toward target, capped at 0x7E (448)
  const uint32_t nb = (uint32_t)__nv_cvt_float_to_fp8(target, __NV_SATFINITE,
                                                       __NV_E4M3);
  const float near = e4m3_bits_to_float(nb);
  const uint32_t ob = near < target ? (nb + 1 < 0x7Eu ? nb + 1 : 0x7Eu)
                                    : (nb > 0 ? nb - 1 : 0u);
  const float other = e4m3_bits_to_float(ob);
  const bool near_lo = near <= other;
  const float lo = near_lo ? near : other;
  const float hi = near_lo ? other : near;
  const float span = __fsub_rn(hi, lo);
  float p_up = span > 0.f
      ? __fdiv_rn(__fsub_rn(target, lo), fmaxf(span, 1e-30f)) : 0.f;
  p_up = fminf(fmaxf(p_up, 0.f), 1.f);
  uint32_t out = u[i] < p_up ? (near_lo ? ob : nb) : (near_lo ? nb : ob);
  if (near == target) out = nb;
  scale_bits[i] = (uint8_t)out;
}

}  // namespace

extern "C" int ms_eden_phase1_launch(const void* x, const void* signs,
                                     void* packed, void* pseudo, void* num,
                                     void* den, void* absmax_bits, int64_t m,
                                     int64_t k, int b, float s,
                                     float inv_sqrt_b, void* stream) {
  const int64_t n = m * k;
  const int64_t warps = (n + 127) / 128;
  const int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  ms_eden_phase1_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)signs, (uint8_t*)packed, (float*)pseudo,
      (float*)num, (float*)den, (unsigned int*)absmax_bits, n, b, s,
      inv_sqrt_b);
  return (int)cudaGetLastError();
}

extern "C" int ms_eden_phase2_launch(const void* absmax, const void* pseudo,
                                     const void* num, const void* den,
                                     const void* u, void* scale_bits,
                                     void* gscale_out, int64_t n_groups,
                                     float gdiv, void* stream) {
  const int64_t blocks = n_groups > 0 ? (n_groups + kThreads - 1) / kThreads : 1;
  ms_eden_phase2_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)absmax, (const float*)pseudo, (const float*)num,
      (const float*)den, (const float*)u, (uint8_t*)scale_bits,
      (float*)gscale_out, n_groups, gdiv);
  return (int)cudaGetLastError();
}
