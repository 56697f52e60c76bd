// bf16 GEMM with f32 accumulation on the tensor cores, each output summed in
// one order fixed by K alone, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the bf16 scheme's matmuls
// (core/linear.py:_mm, the LM head's dense) to XLA. It is the port's own,
// added because cuBLAS picks its algorithm, hence each output's summation
// order, from (M, N, K): a serving step's rows then depend on how many rows
// run beside them, and a column on which slice of N a call computes, so a
// step over a data shard's rows, or over a model shard's half of the
// columns, was not bitwise the step over all of them (tools/shard_step_diff.py
// found it at a 16-token prefill chunk: 64 rows against a shard's 32).
//
//   C[M, N] = bf16(A) bf16(B)^T, f32 accumulation; A (M, K), B (N, K), each
//   f32 or bf16, row-major at a row pitch of lda / ldb elements; C (M, N)
//   f32, row pitch N.
//
// An f32 operand is rounded to bf16 on load (round to nearest even, as
// torch's .to(torch.bfloat16)), so the f32 weights of the bf16 scheme are
// read where they lie, with no cast copy.
//
// Order. K is cut into chunks of 32 values, and chunk c into two k16 steps
// of mma.sync m16n8k16 (bf16 -> f32): lane (g, t) = (lane / 4, lane % 4)
// feeds the values 32 c + 8 t + 0, 1, 2, 3 to the first step's k slots 2t,
// 2t + 1, 2t + 8, 2t + 9 and 32 c + 8 t + 4 .. 7 to the second's (the same
// for both operands, so each step sums the products of 16 of the chunk's
// values; zeros past K). Output (m, n) is summed by the 8 warps of one
// block: warp w runs one chain of these steps over the chunks w, w + 8,
// w + 16, ... in increasing order, started from 0; then the 8 chains are
// added in warp order, ((c0 + c1) + c2) + ... + c7, through shared memory.
// An instruction's result for one output is a function of that output's A
// row, B row and accumulator alone, so nothing in this order depends on M,
// N, the tile or the grid: a row's result is the same at any row count, a
// column's at any slice of N. Only the f32 summation inside and between the
// instructions differs from the plain version's (an f32 matmul of the
// bf16-rounded values).
//
// Shape. The weight B is the MMA's B operand (n8 tiles), the activation
// rows its A operand (m16 tiles). A block owns 8 weight rows and MT m16
// tiles of activation rows (MT = 1, 2, 4 by M; grid y over 16 MT row tiles
// beyond 64 rows); its 8 warps split K as above, so a decode step's weight
// stream runs on N warps. A lane reads its 8 values of a row in one 16-byte
// load (two for f32), a warp's loads of kUnroll chunks of the weight in
// flight before its first MMA; the activation rows come through L1 and L2,
// where every block of the row tile finds them. No shared memory but the
// chains' sum, no split-K across blocks: the first version is simple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // K chains of one block (warp w: steps w mod 8)
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;          // K values of one chunk: two k16 steps
constexpr int kUnroll = 8;          // chunks of weight loads in flight a warp

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 values at k index kk .. kk + 7 of one row as four bf16x2 (v[0] the
// values kk, kk + 1, the lower in the low half; v[1] kk + 2, kk + 3; ...);
// zeros for a row past the matrix or values past K. kVec: K is a multiple
// of 8 and every row 16-byte aligned, so the 8 values are inside K together
// and one aligned 16-byte load (two for f32).
template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* __restrict__ row, bool ok,
                                      int64_t k, int64_t kk, uint32_t (&v)[4]);

template <>
__device__ __forceinline__ void load8<float, true>(
    const float* __restrict__ row, bool ok, int64_t k, int64_t kk,
    uint32_t (&v)[4]) {
  if (!ok || kk >= k) {
    v[0] = v[1] = v[2] = v[3] = 0u;
    return;
  }
  const float4 x = __ldg(reinterpret_cast<const float4*>(row + kk));
  const float4 y = __ldg(reinterpret_cast<const float4*>(row + kk + 4));
  v[0] = pack_bf16x2(x.x, x.y);
  v[1] = pack_bf16x2(x.z, x.w);
  v[2] = pack_bf16x2(y.x, y.y);
  v[3] = pack_bf16x2(y.z, y.w);
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16, true>(
    const __nv_bfloat16* __restrict__ row, bool ok, int64_t k, int64_t kk,
    uint32_t (&v)[4]) {
  if (!ok || kk >= k) {
    v[0] = v[1] = v[2] = v[3] = 0u;
    return;
  }
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + kk));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

template <>
__device__ __forceinline__ void load8<float, false>(
    const float* __restrict__ row, bool ok, int64_t k, int64_t kk,
    uint32_t (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t j = kk + 2 * i;
    v[i] = pack_bf16x2(ok && j < k ? row[j] : 0.f,
                       ok && j + 1 < k ? row[j + 1] : 0.f);
  }
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16, false>(
    const __nv_bfloat16* __restrict__ row, bool ok, int64_t k, int64_t kk,
    uint32_t (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t j = kk + 2 * i;
    const uint32_t lo = ok && j < k ? __bfloat16_as_ushort(row[j]) : 0u;
    const uint32_t hi = ok && j + 1 < k ? __bfloat16_as_ushort(row[j + 1]) : 0u;
    v[i] = lo | (hi << 16);
  }
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block (x, y): weight rows 8 x .. 8 x + 7; activation rows 16 MT y ..
// 16 MT (y + 1) - 1; warp w the chunks w, w + 8, .... Lane (g, t) holds
// weight row 8 x + g's values of its chunks, activation rows g and g + 8 of
// each m16 tile at the same k, and outputs (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1) of each tile (the layout of m16n8k16).
template <typename TA, typename TB, bool kVec, int MT>
__global__ void __launch_bounds__(kThreads)
bf16_matmul_kernel(const TA* __restrict__ a, int64_t lda,
                   const TB* __restrict__ b, int64_t ldb,
                   float* __restrict__ c, int64_t m, int64_t n, int64_t k) {
  __shared__ float red[kWarps - 1][MT][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t n0 = (int64_t)blockIdx.x * 8;
  const int64_t m0 = (int64_t)blockIdx.y * 16 * MT;
  const bool bok = n0 + g < n;
  const TB* brow = b + (bok ? n0 + g : 0) * ldb;
  const TA* arow[MT][2];
  bool aok[MT][2];
  int tiles = 0;  // m16 tiles holding rows (block-uniform)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = m0 + 16 * i + g + 8 * h;
      aok[i][h] = r < m;
      arow[i][h] = a + (aok[i][h] ? r : 0) * lda;
    }
    if (m0 + 16 * i < m) tiles = i + 1;
  }
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // this warp's chunks: kChunk (warp + 8 j), j = 0, 1, ...; kUnroll a round
  constexpr int64_t kStep = (int64_t)kChunk * kWarps;
  for (int64_t k0 = (int64_t)kChunk * warp; k0 < k; k0 += kStep * kUnroll) {
    uint32_t bv[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load8<TB, kVec>(brow, bok, k, k0 + kStep * u + 8 * t, bv[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ks = k0 + kStep * u;
      if (ks >= k) break;  // exactly the warp's chunks below K
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= tiles) break;
        uint32_t x0[4], x1[4];
        load8<TA, kVec>(arow[i][0], aok[i][0], k, ks + 8 * t, x0);
        load8<TA, kVec>(arow[i][1], aok[i][1], k, ks + 8 * t, x1);
        mma_bf16(acc[i], x0[0], x1[0], x0[1], x1[1], bv[u][0], bv[u][1]);
        mma_bf16(acc[i], x0[2], x1[2], x0[3], x1[3], bv[u][2], bv[u][3]);
      }
    }
  }
  // the chains of warps 1 .. 7 to shared memory; warp 0 adds them in order
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp - 1][i][j][lane] = acc[i][j];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], red[w][i][j][lane]);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= tiles) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = m0 + 16 * i + g + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t col = n0 + 2 * t + e;
        if (col < n) c[r * n + col] = acc[i][2 * h + e];
      }
    }
  }
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

template <typename TA, typename TB, int MT>
int launch_mt(bool vec, const TA* a, int64_t lda, const TB* b, int64_t ldb,
              float* c, int64_t m, int64_t n, int64_t k, cudaStream_t st) {
  const int64_t rows = 16 * MT;
  if ((m + rows - 1) / rows > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + 7) / 8), (unsigned)((m + rows - 1) / rows));
  if (vec)
    bf16_matmul_kernel<TA, TB, true, MT><<<grid, kThreads, 0, st>>>(
        a, lda, b, ldb, c, m, n, k);
  else
    bf16_matmul_kernel<TA, TB, false, MT><<<grid, kThreads, 0, st>>>(
        a, lda, b, ldb, c, m, n, k);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_typed(const void* a, int64_t lda, const void* b, int64_t ldb,
                 float* c, int64_t m, int64_t n, int64_t k, cudaStream_t st) {
  const bool vec = k % 8 == 0 && aligned(a, 16) && aligned(b, 16) &&
                   (lda * (int64_t)sizeof(TA)) % 16 == 0 &&
                   (ldb * (int64_t)sizeof(TB)) % 16 == 0;
  const TA* pa = (const TA*)a;
  const TB* pb = (const TB*)b;
  if (m <= 16) return launch_mt<TA, TB, 1>(vec, pa, lda, pb, ldb, c, m, n, k, st);
  if (m <= 32) return launch_mt<TA, TB, 2>(vec, pa, lda, pb, ldb, c, m, n, k, st);
  return launch_mt<TA, TB, 4>(vec, pa, lda, pb, ldb, c, m, n, k, st);
}

}  // namespace

// a_bf16 / b_bf16: 1 when the operand is bf16, 0 when f32.
extern "C" int bf16_matmul_launch(const void* a, int64_t lda, int a_bf16,
                                  const void* b, int64_t ldb, int b_bf16,
                                  void* c, int64_t m, int64_t n, int64_t k,
                                  void* stream) {
  if (m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* out = (float*)c;
  if (a_bf16 && b_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, lda, b, ldb, out, m, n, k, st);
  if (a_bf16)
    return launch_typed<__nv_bfloat16, float>(a, lda, b, ldb, out, m, n, k, st);
  if (b_bf16)
    return launch_typed<float, __nv_bfloat16>(a, lda, b, ldb, out, m, n, k, st);
  return launch_typed<float, float>(a, lda, b, ldb, out, m, n, k, st);
}
