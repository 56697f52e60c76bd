// NVFP4 GEMM from packed e2m1 codes + e4m3 scales for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fp4_matmul.py:fp4_matmul (Pallas body _kernel),
// whose oracle is the simulated NVFP4 GEMM core/linear.py:_qmm:
//   C[M, N] = (dec(Ac) * As) (dec(Bc) * Bs)^T * (ga * gb)
// with bf16-exact block values (e2m1 x e4m3 has <= 6 significant bits) and
// fp32 accumulation.
//
// Bound on the H100: at the serving shapes (M = 4 decode rows or 64 prefill
// rows, N, K in {1280, 3456}) memory bytes: the weight operand moves 0.5625
// B per element and is read once per M tile, while 2 M flops per weight
// element stay far below the card's rate for M <= 64.
//
// Design: a tiled CUDA-core loop. Hopper has no FP4 tensor-core MMA; the
// block values are decoded once per tile into shared memory as fp32 (exact),
// so the product of two of them is exact and only the fp32 summation order
// differs from the plain version. One 256-thread block owns a 16 x 32 output
// tile and walks K in 64-wide steps (4 scale groups); each thread keeps two
// fp32 accumulators and the global scale ga * gb is applied once at the end.
// Rows past M and columns past N are masked, so any M works. wgmma/TMA tiles
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 16;
constexpr int kBN = 32;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float e2m1_decode(uint32_t c) {
  const float g[8] = {0.f, 0.5f, 1.f, 1.5f, 2.f, 3.f, 4.f, 6.f};
  const float mag = g[c & 7u];
  return (c & 8u) ? -mag : mag;
}

__device__ __forceinline__ float e4m3_bits_to_float(uint32_t b) {
  const int e = (b >> 3) & 0xF;
  const int m = b & 0x7;
  const float mag = e == 0 ? (float)m * 0.001953125f
                           : ldexpf((float)(8 + m), e - 10);
  return (b & 0x80u) ? -mag : mag;
}

// Decode a (rows x kBK) tile of one operand into shared memory as fp32
// block values; out-of-range rows/columns become 0.
__device__ __forceinline__ void load_tile(float (*dst)[kBK + 1], int rows,
                                          const uint8_t* __restrict__ p,
                                          const uint8_t* __restrict__ s,
                                          int64_t r0, int64_t nrows,
                                          int64_t k0, int64_t k) {
  const int pairs = kBK / 2;
  for (int i = threadIdx.x; i < rows * pairs; i += kThreads) {
    const int r = i / pairs;
    const int cp = i % pairs;
    const int64_t gr = r0 + r;
    const int64_t gk = k0 + 2 * cp;
    float v0 = 0.f, v1 = 0.f;
    if (gr < nrows && gk < k) {
      const uint32_t byte = p[gr * (k / 2) + gk / 2];
      const float sc = e4m3_bits_to_float(s[gr * (k / 16) + gk / 16]);
      v0 = e2m1_decode(byte & 0xFu) * sc;
      v1 = e2m1_decode(byte >> 4) * sc;
    }
    dst[r][2 * cp] = v0;
    dst[r][2 * cp + 1] = v1;
  }
}

__global__ void __launch_bounds__(kThreads)
fp4_matmul_kernel(const uint8_t* __restrict__ ap, const uint8_t* __restrict__ as,
                  const uint8_t* __restrict__ bp, const uint8_t* __restrict__ bs,
                  const float* __restrict__ ga, const float* __restrict__ gb,
                  float* __restrict__ c, int64_t m, int64_t n, int64_t k) {
  __shared__ float sa[kBM][kBK + 1];
  __shared__ float sb[kBN][kBK + 1];
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int col = threadIdx.x % kBN;
  const int row = threadIdx.x / kBN;          // 0..7; second row is row + 8
  float acc0 = 0.f, acc1 = 0.f;

  for (int64_t k0 = 0; k0 < k; k0 += kBK) {
    load_tile(sa, kBM, ap, as, m0, m, k0, k);
    load_tile(sb, kBN, bp, bs, n0, n, k0, k);
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kBK; ++kk) {
      const float b = sb[col][kk];
      acc0 += sa[row][kk] * b;
      acc1 += sa[row + 8][kk] * b;
    }
    __syncthreads();
  }

  const float g = __fmul_rn(ga[0], gb[0]);
  const int64_t gc = n0 + col;
  if (gc < n) {
    if (m0 + row < m) c[(m0 + row) * n + gc] = __fmul_rn(acc0, g);
    if (m0 + row + 8 < m) c[(m0 + row + 8) * n + gc] = __fmul_rn(acc1, g);
  }
}

}  // namespace

extern "C" int fp4_matmul_launch(const void* a_packed, const void* a_scale_bits,
                                 const void* b_packed, const void* b_scale_bits,
                                 const void* ga, const void* gb, void* c,
                                 int64_t m, int64_t n, int64_t k, void* stream) {
  const dim3 grid((unsigned)((n + kBN - 1) / kBN), (unsigned)((m + kBM - 1) / kBM));
  fp4_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a_packed, (const uint8_t*)a_scale_bits,
      (const uint8_t*)b_packed, (const uint8_t*)b_scale_bits,
      (const float*)ga, (const float*)gb, (float*)c, m, n, k);
  return (int)cudaGetLastError();
}
