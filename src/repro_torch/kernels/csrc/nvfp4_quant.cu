// Four-over-Six NVFP4 activation/weight quantization for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/nvfp4_quant.py:nvfp4_fos_quant (Pallas body
// _kernel). Computes, per 16-element group along the last axis, the group
// absmax, both scale branches (absmax -> s* and absmax -> s* * 4/6), and
// keeps the branch with the lower squared error (ties go to the 6 branch),
// exactly as repro_torch.core.quant.quant_four_over_six does.
//
// Bound on the H100: memory bytes. Each element is read once (2 B bf16 or
// 4 B f32) and 0.5625 B leave (packed e2m1 codes + one e4m3 scale byte per
// 16); the arithmetic is ~60 flops per element, far below the card's rate.
// At decode shapes (M = 4 rows) the launch itself dominates.
//
// Design: one thread per 16-group, the group held in registers; codes leave
// already packed two per byte (low nibble = even index) and scales leave as
// raw e4m3 bits, the form fp4_matmul and PackedQWeight consume, so no
// dequantized copy is ever written. The per-tensor gscale comes from an
// absmax the wrapper computes before the launch (the JAX wrapper also takes
// it outside the Pallas body). Every multiply, divide and add that feeds a
// rounding decision uses the _rn intrinsics, so no FMA contraction changes
// a rounding against the plain PyTorch version. Any M is handled (no tile
// divisibility requirement).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;

__device__ __forceinline__ int fp4_rtn_index(float m) {
  // round-half-to-even thresholds of core/formats.py:fp4_rtn
  return m <= 0.25f ? 0 : m < 0.75f ? 1 : m <= 1.25f ? 2 : m < 1.75f ? 3
       : m <= 2.5f ? 4 : m < 3.5f ? 5 : m <= 5.0f ? 6 : 7;
}

__device__ __forceinline__ float fp4_grid(int idx) {
  const float g[8] = {0.f, 0.5f, 1.f, 1.5f, 2.f, 3.f, 4.f, 6.f};
  return g[idx];
}

__device__ __forceinline__ float e4m3_bits_to_float(uint8_t b) {
  const int e = (b >> 3) & 0xF;
  const int m = b & 0x7;
  const float mag = e == 0 ? (float)m * 0.001953125f        // m/8 * 2^-6
                           : ldexpf((float)(8 + m), e - 10);  // (1+m/8) 2^(e-7)
  return (b & 0x80) ? -mag : mag;
}

// RNE onto the e4m3 grid after clipping to +-448 (the reference clips first:
// a cast alone does not saturate). Returns the value and its raw bits.
__device__ __forceinline__ float fp8_rtn(float v, uint8_t* bits) {
  v = fminf(fmaxf(v, -448.f), 448.f);
  const __nv_fp8_storage_t s =
      __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  *bits = (uint8_t)s;
  return e4m3_bits_to_float((uint8_t)s);
}

// One branch: scale for grid max `div`, and the group's squared error.
__device__ __forceinline__ float branch(const float (&x)[kGroup], float gmax,
                                        float gscale, float div,
                                        float* scale, uint8_t* bits) {
  *scale = fp8_rtn(__fdiv_rn(gmax, __fmul_rn(gscale, div)), bits);
  const float denom = __fmul_rn(*scale, gscale);
  const float safe = denom == 0.f ? 1.f : denom;
  float err = 0.f;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const float xs = __fdiv_rn(x[i], safe);
    const float g = fp4_grid(fp4_rtn_index(fabsf(xs)));
    const float q = xs > 0.f ? g : (xs < 0.f ? -g : 0.f);
    const float d = __fsub_rn(__fmul_rn(q, denom), x[i]);
    err = __fadd_rn(err, __fmul_rn(d, d));
  }
  return err;
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void nvfp4_fos_quant_kernel(const T* __restrict__ x,
                                       const float* __restrict__ absmax,
                                       uint8_t* __restrict__ packed,
                                       uint8_t* __restrict__ scale_bits,
                                       float* __restrict__ gscale_out,
                                       int64_t n_groups, float gdiv,
                                       float s6, float s4) {
  float gscale = __fdiv_rn(absmax[0], gdiv);
  if (gscale == 0.f) gscale = 1.f;
  const int64_t gi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi == 0) gscale_out[0] = gscale;
  if (gi >= n_groups) return;

  float v[kGroup];
  float gmax = 0.f;
  const T* src = x + gi * kGroup;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    v[i] = load_f32<T>(src + i);
    gmax = fmaxf(gmax, fabsf(v[i]));
  }

  float sc6, sc4;
  uint8_t b6, b4;
  const float e6 = branch(v, gmax, gscale, s6, &sc6, &b6);
  const float e4 = branch(v, gmax, gscale, s4, &sc4, &b4);
  const bool use4 = e4 < e6;
  const float scale = use4 ? sc4 : sc6;
  scale_bits[gi] = use4 ? b4 : b6;

  const float denom = __fmul_rn(scale, gscale);
  const float safe = denom == 0.f ? 1.f : denom;
  uint8_t* dst = packed + gi * (kGroup / 2);
#pragma unroll
  for (int i = 0; i < kGroup; i += 2) {
    uint8_t code[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xs = __fdiv_rn(v[i + h], safe);
      const int idx = fp4_rtn_index(fabsf(xs));
      // sign bit only for a strictly negative grid value (-0 codes as 0)
      code[h] = (uint8_t)(((xs < 0.f && idx > 0) ? 8 : 0) | idx);
    }
    dst[i / 2] = (uint8_t)(code[0] | (code[1] << 4));
  }
}

}  // namespace

extern "C" int nvfp4_fos_quant_launch(const void* x, int x_is_bf16,
                                      const void* absmax, void* packed,
                                      void* scale_bits, void* gscale_out,
                                      int64_t m, int64_t k, float gdiv,
                                      float s6, float s4, void* stream) {
  const int64_t n_groups = m * (k / kGroup);
  const int threads = 256;
  const int64_t blocks = n_groups > 0 ? (n_groups + threads - 1) / threads : 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16) {
    nvfp4_fos_quant_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)absmax, (uint8_t*)packed,
        (uint8_t*)scale_bits, (float*)gscale_out, n_groups, gdiv, s6, s4);
  } else {
    nvfp4_fos_quant_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)x, (const float*)absmax, (uint8_t*)packed,
        (uint8_t*)scale_bits, (float*)gscale_out, n_groups, gdiv, s6, s4);
  }
  return (int)cudaGetLastError();
}
