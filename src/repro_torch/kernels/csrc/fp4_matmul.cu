// NVFP4 GEMM from packed e2m1 codes + e4m3 scales for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fp4_matmul.py:fp4_matmul (Pallas body _kernel),
// whose oracle is the simulated NVFP4 GEMM core/linear.py:_qmm:
//   C[M, N] = (dec(Ac) * As) (dec(Bc) * Bs)^T * (ga * gb)
// A is (M, K/2) packed codes with (M, K/16) e4m3 scale bits, B N-major the
// same way; C is f32, or bf16 rounded to nearest from the f32 result.
//
// Exactness. A block value e2m1 x e4m3 has at most 6 significant bits and
// lies in [2^-10, 2688], so it is exact in f16 as in bf16, and a product of
// two is exact in f32: the tensor cores (f16 inputs, f32 accumulation) see
// the plain version's values, and only the f32 summation order differs.
// f16 rather than bf16 because Hopper converts e4m3 pairs to f16 pairs in
// one instruction: a nibble's bits, shifted into an e4m3 byte, are the code's
// value times 2^-6, and the f16 scale carries the 2^6 back (decode8 below).
//
// Two regimes, picked by the wrapper from M alone (kernels/fp4_matmul.py):
//
// M <= 16 (decode rows, MoE experts at 8 rows): bound by the bytes of the
// weight operand (0.5625 B an element against 2 M flops). fp4_matmul_gemv_
// kernel computes C^T = B A^T on mma.sync m16n8k16: weight rows fill the
// MMA's M side, the <= 16 activation rows its N side. Each thread decodes
// 16-byte global loads of two weight rows straight into A fragments (one
// 32-value run of its own per row; the K order inside a 128-value chunk is
// permuted, identically for both operands, so that each load is contiguous),
// all of a split's loads in flight before the first MMA. The activation's
// block values for the split's K slice are staged once per block in shared
// memory, in fragment order. K is split so that the card fills (N = 2048
// gives 32 blocks of 64 weight rows for 132 SMs); with more than one split
// each writes f32 partials to a scratch buffer and fp4_matmul_splitk_reduce_
// kernel sums them in split order: no atomics, two calls agree bit for bit.
//
// M > 16 (training, prefill chunks): bound by operations at large M.
// fp4_matmul_mma_kernel runs wgmma m64n128k16 (f16 -> f32) on 128 x 128
// output tiles, K steps of 64: a 4-stage cp.async ring brings the PACKED
// bytes and scale bytes of both tiles (4.5 bits an element); all 256 threads
// decode a stage into f16 tiles in the 128-byte-swizzled layout of the wgmma
// descriptors (double buffered), while the tensor cores run the previous
// stage's wgmma; accumulators stay in registers and the epilogue multiplies
// by g = ga * gb and stores f32 or bf16. Ragged M, N are masked (zero-filled
// copies, masked stores); K not a multiple of 64, or operands not aligned
// for the vector copies, take the same kernel with plain byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- decode

__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  uint32_t r;
  const unsigned short h = (unsigned short)(v & 0xFFFFu);
  asm("{.reg .b16 t;\n mov.b16 t, %1;\n cvt.rn.f16x2.e4m3x2 %0, t;\n}"
      : "=r"(r) : "h"(h));
  return r;
}

__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// An e4m3 scale byte as an f16 pair, times 2^6 (exact: <= 448 * 64 < 65504).
__device__ __forceinline__ uint32_t scale64(uint32_t sbyte) {
  return hmul2(e4m3x2_to_f16x2(sbyte * 0x0101u), 0x54005400u);
}

// Four e2m1 codes (one per byte, low nibble) -> their e4m3 bytes, each the
// code's value times 2^-6: sign to bit 7, (e1 e0 m) to bits 4..2, so the
// e4m3 exponent is e and the mantissa m/2 (the code 0.5 becomes 2^-7).
__device__ __forceinline__ uint32_t codes_to_e4m3(uint32_t x) {
  return ((x << 4) & 0x80808080u) | ((x << 2) & 0x1C1C1C1Cu);
}

// Eight codes of one packed word (code 2i in the low nibble of byte i, code
// 2i + 1 in its high nibble) times the scale s64 -> f16 pairs of codes
// (0, 1), (2, 3), (4, 5), (6, 7).
__device__ __forceinline__ void decode8(uint32_t w, uint32_t s64, uint32_t o[4]) {
  const uint32_t lo = codes_to_e4m3(w & 0x0F0F0F0Fu);
  const uint32_t hi = codes_to_e4m3((w >> 4) & 0x0F0F0F0Fu);
  const uint32_t p0 = __byte_perm(lo, hi, 0x5140);
  const uint32_t p1 = __byte_perm(lo, hi, 0x7362);
  o[0] = hmul2(e4m3x2_to_f16x2(p0), s64);
  o[1] = hmul2(e4m3x2_to_f16x2(p0 >> 16), s64);
  o[2] = hmul2(e4m3x2_to_f16x2(p1), s64);
  o[3] = hmul2(e4m3x2_to_f16x2(p1 >> 16), s64);
}

__device__ __forceinline__ void store_out(void* out, int64_t i, float v,
                                          int out_bf16) {
  if (out_bf16)
    ((__nv_bfloat16*)out)[i] = __float2bfloat16_rn(v);
  else
    ((float*)out)[i] = v;
}

// ------------------------------------------------- M <= 16: weight stream

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvRows = 16 * kGemvWarps;  // weight rows per block
constexpr int kChunk = 128;                 // K values a chunk: 8 k16 steps
constexpr int kMaxChunks = 4;               // chunks a split

__device__ __forceinline__ void mma16816(float d[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 32 codes of one weight row from K index kk (16 bytes) and the scale bytes
// of their two groups; zeros past the row count or past K.
template <bool kVec>
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ p,
                                         const uint8_t* __restrict__ s,
                                         int64_t row, int64_t n, int64_t kk,
                                         int64_t k, uint4& codes,
                                         uint32_t& scales) {
  codes = make_uint4(0u, 0u, 0u, 0u);
  scales = 0u;
  if (row >= n || kk >= k) return;
  const uint8_t* cp = p + row * (k / 2) + kk / 2;
  const uint8_t* sp = s + row * (k / 16) + kk / 16;
  if constexpr (kVec) {  // K % 32 == 0: the whole run lies inside K, aligned
    codes = __ldg((const uint4*)cp);
    scales = __ldg((const unsigned short*)sp);
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int groups = kk + 16 < k ? 2 : 1;
  for (int b = 0; b < 8 * groups; ++b) w[b >> 2] |= (uint32_t)cp[b] << (8 * (b & 3));
  codes = make_uint4(w[0], w[1], w[2], w[3]);
  scales = sp[0] | (groups == 2 ? (uint32_t)sp[1] << 8 : 0u);
}

// NT n8 tiles of activation rows (M <= 8 NT). Block (x, y): weight rows
// 64 x .. 64 x + 63 (16 a warp), K chunks y * cps .. of split y.
template <int NT, bool kVec>
__global__ void __launch_bounds__(kGemvThreads)
fp4_matmul_gemv_kernel(const uint8_t* __restrict__ ap, const uint8_t* __restrict__ as,
                       const uint8_t* __restrict__ bp, const uint8_t* __restrict__ bs,
                       const float* __restrict__ ga, const float* __restrict__ gb,
                       void* __restrict__ out, float* __restrict__ partial,
                       int64_t m, int64_t n, int64_t k, int cps, int out_bf16) {
  // the split's activation block values in fragment order:
  // [chunk][k16 step][n tile][lane] -> 4 f16 (k kk .. kk + 3)
  __shared__ uint2 act[kMaxChunks * 8 * NT * 32];
  const int split = blockIdx.y;
  const int64_t chunks = (k + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)split * cps;
  const int nch = (int)min((int64_t)cps, chunks - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, r = lane >> 2;

  // weight loads first, so they are in flight while the activation stages
  const int64_t row0 = (int64_t)blockIdx.x * kGemvRows + warp * 16 + r;
  uint4 wv[kMaxChunks][2];
  uint32_t sv[kMaxChunks][2];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t kk = (c0 + c) * kChunk + 32 * t;
      load_run<kVec>(bp, bs, row0 + 8 * h, n, c < nch ? kk : k, k, wv[c][h],
                     sv[c][h]);
    }

  for (int i = threadIdx.x; i < nch * 8 * NT * 32; i += kGemvThreads) {
    const int l = i & 31, nt = (i >> 5) % NT, step = (i >> 5) / NT;
    const int64_t row = nt * 8 + (l >> 2);
    const int64_t kk = (c0 + step / 8) * kChunk + 32 * (l & 3) + 4 * (step % 8);
    uint2 v = make_uint2(0u, 0u);
    if (row < m && kk < k) {
      const uint8_t* cp = ap + row * (k / 2) + kk / 2;
      uint32_t o[4];
      decode8(cp[0] | ((uint32_t)cp[1] << 8), scale64(as[row * (k / 16) + kk / 16]), o);
      v = make_uint2(o[0], o[1]);
    }
    act[i] = v;
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c >= nch) break;
    // a[h][j][q]: row r + 8 h, codes 8 j + 2 q, + 1 of this thread's run
    uint32_t a[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t s0 = scale64(sv[c][h] & 0xFFu), s1 = scale64(sv[c][h] >> 8);
      decode8(wv[c][h].x, s0, a[h][0]);
      decode8(wv[c][h].y, s0, a[h][1]);
      decode8(wv[c][h].z, s1, a[h][2]);
      decode8(wv[c][h].w, s1, a[h][3]);
    }
    // k16 step s: MMA k slots (2t, 2t + 1) hold codes 4 s, 4 s + 1 of the
    // run and slots (2t + 8, 2t + 9) codes 4 s + 2, 4 s + 3
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int j = s >> 1, q = 2 * (s & 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = act[((c * 8 + s) * NT + nt) * 32 + lane];
        mma16816(acc[nt], a[0][j][q], a[1][j][q], a[0][j][q + 1],
                 a[1][j][q + 1], b.x, b.y);
      }
    }
  }

  // acc[nt][2 h + e]: weight row row0 + 8 h, activation row 8 nt + 2 t + e
  const float g = __fmul_rn(ga[0], gb[0]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t mm = nt * 8 + 2 * t + e, nn = row0 + 8 * h;
        if (mm >= m || nn >= n) continue;
        if (partial)
          partial[((int64_t)split * m + mm) * n + nn] = acc[nt][2 * h + e];
        else
          store_out(out, mm * n + nn, __fmul_rn(acc[nt][2 * h + e], g), out_bf16);
      }
}

__global__ void __launch_bounds__(256)
fp4_matmul_splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                int64_t mn, const float* __restrict__ ga,
                                const float* __restrict__ gb,
                                void* __restrict__ out, int out_bf16) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= mn) return;
  float s = partial[i];
  for (int j = 1; j < splits; ++j) s = __fadd_rn(s, partial[j * mn + i]);
  store_out(out, i, __fmul_rn(s, __fmul_rn(ga[0], gb[0])), out_bf16);
}

// ---------------------------------------------------- M > 16: wgmma tiles

// A block owns kBM x kBN outputs, two warpgroups of 64 rows each, and walks
// K by kBK. Shared memory holds two f16 buffers of its kBM + kBN tile rows
// (A rows first, kBK values each) and a ring of kStages packed stages of
// them (codes, then scales).
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 4;
constexpr int kRowBytes = kBK / 2;     // packed bytes of one row's K step
constexpr int kRowScales = kBK / 16;   // its scale bytes
constexpr int kMmaThreads = 2 * kBM;
constexpr int kRows = kBM + kBN;
constexpr int kTileBytes = kRows * kBK * 2;
constexpr int kStageBytes = kRows * (kRowBytes + kRowScales);
constexpr int kMmaSmem = 2 * kTileBytes + kStages * kStageBytes + 1024;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// A K-major f16 tile of 64-value (128-byte) rows under the 128-byte swizzle:
// 16-byte chunk j of row r sits at chunk j ^ (r % 8); 8-row groups 1024 B
// apart. The tile base is 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
       | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Stage kt of both operands into ring slot `slot`: tile row r < kBM is A row
// m0 + r, row r >= kBM is B row n0 + r - kBM; rows past the end and K past its
// end read as zeros. kFast (K % 64 == 0, aligned): cp.async, 16 bytes of
// codes and 4 of scales at a time; else byte loads.
template <bool kFast>
__device__ __forceinline__ void load_stage(
    uint8_t* slot, const uint8_t* __restrict__ ap, const uint8_t* __restrict__ as,
    int64_t m, int64_t m0, const uint8_t* __restrict__ bp,
    const uint8_t* __restrict__ bs, int64_t n, int64_t n0, int64_t kt, int64_t k) {
  uint8_t* scales = slot + kRows * kRowBytes;
  if constexpr (kFast) {
    for (int i = threadIdx.x; i < 2 * kRows; i += kMmaThreads) {
      const int r = i >> 1, half = i & 1;
      const bool a = r < kBM;
      const int64_t gr = a ? m0 + r : n0 + r - kBM;
      const bool ok = gr < (a ? m : n);
      const uint8_t* base = a ? ap : bp;
      cp_async16((uint32_t)__cvta_generic_to_shared(slot + r * kRowBytes + half * 16),
                 ok ? base + gr * (k / 2) + kt * kRowBytes + half * 16 : base,
                 ok ? 16 : 0);
    }
    for (int r = threadIdx.x; r < kRows; r += kMmaThreads) {
      const bool a = r < kBM;
      const int64_t gr = a ? m0 + r : n0 + r - kBM;
      const bool ok = gr < (a ? m : n);
      const uint8_t* base = a ? as : bs;
      cp_async4((uint32_t)__cvta_generic_to_shared(scales + r * kRowScales),
                ok ? base + gr * (k / 16) + kt * kRowScales : base, ok ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kRowBytes; i += kMmaThreads) {
      const int r = i / kRowBytes, b = i % kRowBytes;
      const bool a = r < kBM;
      const int64_t gr = a ? m0 + r : n0 + r - kBM, gk = kt * kBK + 2 * b;
      slot[i] = gr < (a ? m : n) && gk < k ? (a ? ap : bp)[gr * (k / 2) + gk / 2] : 0;
    }
    for (int i = threadIdx.x; i < kRows * kRowScales; i += kMmaThreads) {
      const int r = i / kRowScales, g = i % kRowScales;
      const bool a = r < kBM;
      const int64_t gr = a ? m0 + r : n0 + r - kBM, gk = kt * kBK + 16 * g;
      scales[i] = gr < (a ? m : n) && gk < k ? (a ? as : bs)[gr * (k / 16) + gk / 16] : 0;
    }
  }
}

// Decode ring slot `slot` into the swizzled f16 tile rows `tile`: item (row
// r, 16-byte chunk j) = one packed word of 8 codes and its group's scale.
__device__ __forceinline__ void decode_stage(const uint8_t* slot, uint8_t* tile) {
  static_assert(kRows * 8 % kMmaThreads == 0, "whole items per thread");
#pragma unroll
  for (int it = 0; it < kRows * 8 / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i >> 3, j = i & 7;
    const uint32_t w = *(const uint32_t*)(slot + r * kRowBytes + 4 * j);
    const uint32_t sb = slot[kRows * kRowBytes + r * kRowScales + j / 2];
    uint32_t v[4];
    decode8(w, scale64(sb), v);
    *(uint4*)(tile + r * 128 + ((j ^ (r & 7)) * 16)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kFast>
__global__ void __launch_bounds__(kMmaThreads)
fp4_matmul_mma_kernel(const uint8_t* __restrict__ ap, const uint8_t* __restrict__ as,
                      const uint8_t* __restrict__ bp, const uint8_t* __restrict__ bs,
                      const float* __restrict__ ga, const float* __restrict__ gb,
                      void* __restrict__ out, int64_t m, int64_t n, int64_t k,
                      int out_bf16) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* ring = smem + 2 * kTileBytes;  // after the two f16 buffers
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t kts = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kts)
      load_stage<kFast>(ring + s * kStageBytes, ap, as, m, m0, bp, bs, n, n0, s, k);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int64_t kt = 0; kt < kts; ++kt) {
    asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 2) : "memory");
    // every copy of stage kt has landed; every thread is past the decode of
    // stage kt - 1; every wgmma of stage kt - 2 is complete
    __syncthreads();
    const int64_t nxt = kt + kStages - 1;
    if (nxt < kts)
      load_stage<kFast>(ring + (nxt % kStages) * kStageBytes, ap, as, m, m0, bp,
                        bs, n, n0, nxt, k);
    asm volatile("cp.async.commit_group;" ::: "memory");
    uint8_t* tile = smem + (kt & 1) * kTileBytes;
    decode_stage(ring + (kt % kStages) * kStageBytes, tile);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint64_t da = smem_desc((uint32_t)__cvta_generic_to_shared(tile + wg * 64 * 128));
    const uint64_t db = smem_desc((uint32_t)__cvta_generic_to_shared(tile + kBM * 128));
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // k16 step: 32 bytes along the row
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

  // acc[4 i + 2 h + e]: row 16 warp + lane / 4 + 8 h of the warpgroup's 64,
  // column 8 i + 2 (lane % 4) + e
  const float g = __fmul_rn(ga[0], gb[0]);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int64_t mrow = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int64_t ncol = n0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t mm = mrow + 8 * h, nn = ncol + 8 * i + e;
        if (mm < m && nn < n)
          store_out(out, mm * n + nn, __fmul_rn(acc[4 * i + 2 * h + e], g), out_bf16);
      }
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

// regime 0: the weight-streaming kernel on grid (gx, gy = splits) with cps K
// chunks a split (partial: splits x M x N f32 scratch when splits > 1, else
// unused); regime 1: the wgmma kernel on grid (gx, gy). The geometry comes
// from kernels/fp4_matmul.py:plan.
extern "C" int fp4_matmul_launch(const void* a_packed, const void* a_scale_bits,
                                 const void* b_packed, const void* b_scale_bits,
                                 const void* ga, const void* gb, void* c,
                                 void* partial, int64_t m, int64_t n, int64_t k,
                                 int out_bf16, int regime, int gx, int gy,
                                 int cps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* ap = (const uint8_t*)a_packed;
  const uint8_t* as = (const uint8_t*)a_scale_bits;
  const uint8_t* bp = (const uint8_t*)b_packed;
  const uint8_t* bs = (const uint8_t*)b_scale_bits;
  const float* fa = (const float*)ga;
  const float* fb = (const float*)gb;
  if (regime == 0) {
    if (m > 16 || cps > kMaxChunks || (gy > 1) != (partial != nullptr))
      return (int)cudaErrorInvalidValue;
    const bool vec = k % 32 == 0 && aligned(bp, 16) && aligned(bs, 2);
    float* part = (float*)partial;
    const dim3 grid(gx, gy);
    if (m <= 8) {
      if (vec)
        fp4_matmul_gemv_kernel<1, true><<<grid, kGemvThreads, 0, st>>>(
            ap, as, bp, bs, fa, fb, c, part, m, n, k, cps, out_bf16);
      else
        fp4_matmul_gemv_kernel<1, false><<<grid, kGemvThreads, 0, st>>>(
            ap, as, bp, bs, fa, fb, c, part, m, n, k, cps, out_bf16);
    } else {
      if (vec)
        fp4_matmul_gemv_kernel<2, true><<<grid, kGemvThreads, 0, st>>>(
            ap, as, bp, bs, fa, fb, c, part, m, n, k, cps, out_bf16);
      else
        fp4_matmul_gemv_kernel<2, false><<<grid, kGemvThreads, 0, st>>>(
            ap, as, bp, bs, fa, fb, c, part, m, n, k, cps, out_bf16);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || gy == 1) return (int)err;
    const int64_t mn = m * n;
    fp4_matmul_splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
        part, gy, mn, fa, fb, c, out_bf16);
    return (int)cudaGetLastError();
  }
  if (regime != 1 || partial != nullptr) return (int)cudaErrorInvalidValue;
  const bool fast = k % kBK == 0 && aligned(ap, 16) && aligned(bp, 16) &&
                    aligned(as, 4) && aligned(bs, 4);
  static bool attr_set[2] = {false, false};  // dynamic shared memory > 48 KB
  if (!attr_set[fast]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fast ? (const void*)fp4_matmul_mma_kernel<true>
             : (const void*)fp4_matmul_mma_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set[fast] = true;
  }
  const dim3 grid(gx, gy);
  if (fast)
    fp4_matmul_mma_kernel<true><<<grid, kMmaThreads, kMmaSmem, st>>>(
        ap, as, bp, bs, fa, fb, c, m, n, k, out_bf16);
  else
    fp4_matmul_mma_kernel<false><<<grid, kMmaThreads, kMmaSmem, st>>>(
        ap, as, bp, bs, fa, fb, c, m, n, k, out_bf16);
  return (int)cudaGetLastError();
}

