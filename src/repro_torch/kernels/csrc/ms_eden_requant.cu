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
//   stochastic rounding of target onto the e4m3 lattice against a uniform,
//   emitted as raw e4m3 bits. The uniform is hashed in the kernel from the
//   group's flat index and the tag's key pair (core/rng.py:hash_bits), or
//   read from a uniforms operand (the tests inject the reference's draws).
//
// Bound on the H100: memory bytes, both phases. Phase 1 reads 4 B and writes
// 0.5 + 12/16 B per element; the butterfly does log2(b) = 7 adds per element
// at b = 128 and the quantizer some 25 more f32 operations, so at the byte
// time the SMs have ~0.36 issue cycles an element and the instruction count
// matters too (one launch a tensor, 280 a training step, also pays each
// launch's ramp and tail). Phase 2 moves 13 B per 16-group with hashed
// uniforms: it reads 12 B (pseudo, num, den) and writes one e4m3 scale byte
// (17 B with a uniforms operand); at llama-200m training shapes one
// operand is only ~2 MB, so a launch's ramp and tail cost as much as its
// bytes.
//
// Design of phase 1. x is taken where it lies: row-major (x[i, j] at
// i * ld + j) or the transpose of a row-major tensor (x[i, j] at j * ld + i),
// so the backward's E^T, W^T and X^T need no transposing copy. One CTA of 256
// threads takes a tile of 4096 / b rows by one rotation block (b columns):
//  - The tile comes through shared memory by cp.async (16-byte chunks where
//    the pointer and ld allow, else 4-byte ones), each chunk a contiguous run
//    of the source: rows of x, or rows of the transposed source. Rows past M
//    are zero-filled. Row-major tiles keep rows at a pitch of b + 4 (b + 8
//    at b = 64) floats with 16-byte quads XOR-swizzled, transposed tiles keep
//    source rows at a pitch of 4096 / b floats rotated by 512 / b per
//    16-group; either way a warp reads its groups without bank conflicts.
//  - A thread holds one 16-group of one row in registers: butterfly strides
//    1 .. 8 in registers, strides 16 .. b/2 across the b/16 lanes of the row
//    by __shfl_xor_sync (3 shuffles an element at b = 128, 5 before). The
//    group's max, pseudo-scale, codes and EDEN sums stay in that thread.
//  - Codes leave as one 8-byte store a thread, pseudo / num / den as one
//    float a thread: at b = 128 the 8 threads of a row fill whole 32-byte
//    sectors. One atomicMax a CTA; the launch zeroes its target by a memset.
//  - The FP4 grid value of rot / pseudo comes from the f32 rounding of (m +
//    c) - c (see csrc/nvfp4_quant.cu:fp4_rtn_mag), not a threshold chain.
//  - One tile a CTA, many CTAs an SM: measured on the H100 (PERF.md), this
//    beat persistent CTAs that double-buffer tiles, and the IEEE divide beat
//    the reciprocal route of csrc/nvfp4_quant.cu; the same loads and stores
//    without the arithmetic take ~60% of the kernel's time.
// Bit-exactness: the butterfly runs in the fixed order of core/rht.py, the
// EDEN sums in the order of core/ms_eden.group_sum, and every rounding uses
// the _rn intrinsics (no FMA contraction; no fast math; denormals kept,
// -ftz=false is nvcc's default), so both phases equal their plain PyTorch
// versions bit for bit. The f32 constants (s, s * 256, 1/sqrt(b)) come from
// Python, so kernel and plain version use identical scalars. Any M is
// accepted (the reference's kernel needed M % bm == 0).
//
// Design of phase 2. One launch takes both operands of a backward GEMM (or
// one tensor): the grid is operand a's CTAs, then operand b's, and each
// operand keeps its own absmax, gscale and keys (or uniforms), so a training
// step launches it once per GEMM (140) where it launched once per operand.
// A thread takes 4 consecutive groups: one 16-byte load each of pseudo, num
// and den (and u), one 4-byte store of the 4 scale bytes (scalar accesses
// at a ragged end, or where a pointer is not aligned for them). Measured on
// the H100 (PERF.md): 8 or 16 groups a thread were slower, and 128-thread
// CTAs beat 256 and 512; a launch keeps a fixed cost of ~2 us beside its
// bytes, which is why both operands share one. The e4m3 neighbours are
// decoded by their bits, not by ldexpf: the same values in fewer
// instructions. With keys,
// the uniforms never exist in memory: the hash is 2 x 5 uint32 operations
// a group, bitwise core/rng.py's (mix((mix(i ^ k) + k2) mod 2^32) >> 8,
// times 2^-24: exact in f32). The rounding is phase2_plain's, _rn
// intrinsics throughout, so the kernel is bitwise its plain version.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;       // elements of a phase-1 tile: 16 a thread
constexpr int kTileSmem = 5120;   // floats: 256 rows x (16 + 4) at b = 16
constexpr unsigned kFull = 0xffffffffu;

// see csrc/nvfp4_quant.cu: RNE of m >= 0 onto the E2M1 magnitudes, then its
// 3-bit index
__device__ __forceinline__ float fp4_rtn_mag(float m) {
  m = fminf(m, 8.f);
  const uint32_t e = max(__float_as_uint(m) & 0x7F800000u, 0x3F800000u);
  const float c = __uint_as_float(e + (22u << 23));
  return fminf(__fsub_rn(__fadd_rn(m, c), c), 6.f);
}

__device__ __forceinline__ uint32_t fp4_index(float q) {
  return q >= 1.f ? (__float_as_uint(q) >> 22) - 252u : (q > 0.f ? 1u : 0u);
}

// Raw e4m3 bits -> f32, exactly: (1 + m/8) 2^(e-7) built as f32 bits,
// subnormal m/8 * 2^-6.
__device__ __forceinline__ float e4m3_bits_to_float(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xFu, m = b & 0x7u;
  const float mag = e ? __uint_as_float(((e + 120u) << 23) | (m << 20))
                      : (float)m * 0.001953125f;
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// row-major tile: the float offset of element (r, j) (row pitch b + 4, b + 8
// at b = 64; quad Q of a row stored at Q ^ ((Q >> 3) & 3))
__device__ __forceinline__ int rows_offset(int r, int j, int pitch) {
  const int q = j >> 2;
  return r * pitch + ((q ^ ((q >> 3) & 3)) << 2) + (j & 3);
}

// transposed tile: the float offset of source row jj (column j of x), column
// ii (row i of x); each 16-group of source rows rotated by 512 / b
__device__ __forceinline__ int cols_offset(int jj, int ii, int ti, int b) {
  return jj * ti + ((ii + (512 / b) * (jj >> 4)) & (ti - 1));
}

// kTrans: x[i, j] at j * ld + i (else i * ld + j); kVec: 16- or 4-byte
// cp.async chunks (16 needs x and ld aligned to 4 floats).
template <bool kTrans, int kVec>
__global__ void __launch_bounds__(kThreads)
ms_eden_phase1_kernel(const float* __restrict__ x, int64_t ld,
                      const float* __restrict__ signs,
                      uint8_t* __restrict__ packed,
                      float* __restrict__ pseudo,
                      float* __restrict__ num,
                      float* __restrict__ den,
                      unsigned int* __restrict__ absmax_bits,
                      int64_t m, int64_t k, int b, float s, float inv_sqrt_b) {
  __shared__ __align__(16) float tile[kTileSmem];
  __shared__ float warp_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int G = b >> 4;     // threads of a row (16-groups of a block)
  const int ti = kTile / b;  // rows of x in the tile
  const int64_t kblocks = k / b;
  const int64_t rtiles = (m + ti - 1) / ti;
  // consecutive CTAs read neighbouring memory: along K for row-major x,
  // along M for transposed x
  const int64_t rt = kTrans ? blockIdx.x % rtiles : blockIdx.x / kblocks;
  const int64_t kb = (kTrans ? blockIdx.x / rtiles : blockIdx.x % kblocks) * b;
  const int64_t i0 = rt * ti;
  const int pitch = b + (b == 64 ? 8 : 4);

  // ---- the tile into shared memory
  constexpr int kPer = kVec / 4;  // floats of one chunk
#pragma unroll
  for (int u = 0; u < kTile / kPer / kThreads; ++u) {
    const int e = (tid + u * kThreads) * kPer;  // first element of the chunk
    if (kTrans) {
      const int jj = e / ti, ii = e % ti;  // source row, column in the tile
      const int64_t i = i0 + ii;
      const int64_t left = m - i;  // rows of x this chunk may hold
      const int valid = left <= 0 ? 0 : left < kPer ? (int)left : kPer;
      const float* src = valid ? x + (kb + jj) * ld + i : x;
      float* dst = tile + cols_offset(jj, ii, ti, b);
      if (kVec == 16) cp_async16(dst, src, valid * 4);
      else cp_async4(dst, src, valid * 4);
    } else {
      const int r = e / b, j = e % b;
      const int64_t i = i0 + r;
      const bool valid = i < m;
      const float* src = valid ? x + i * ld + kb + j : x;
      float* dst = tile + rows_offset(r, j, pitch);
      if (kVec == 16) cp_async16(dst, src, valid ? 16 : 0);
      else cp_async4(dst, src, valid ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // ---- while it lands: this thread's 16 signs
  const int g = lane % G;  // 16-group inside the block
  const int r = tid / G;   // row of x inside the tile
  float v[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 sg = __ldg(reinterpret_cast<const float4*>(signs) + 4 * g + q);
    v[4 * q] = sg.x; v[4 * q + 1] = sg.y; v[4 * q + 2] = sg.z; v[4 * q + 3] = sg.w;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- x * sign
  if (kTrans) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      v[t] = __fmul_rn(tile[cols_offset(16 * g + t, r, ti, b)], v[t]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 xv = *reinterpret_cast<const float4*>(
          tile + rows_offset(r, 16 * g + 4 * q, pitch));
      v[4 * q] = __fmul_rn(xv.x, v[4 * q]);
      v[4 * q + 1] = __fmul_rn(xv.y, v[4 * q + 1]);
      v[4 * q + 2] = __fmul_rn(xv.z, v[4 * q + 2]);
      v[4 * q + 3] = __fmul_rn(xv.w, v[4 * q + 3]);
    }
  }

  // ---- Walsh-Hadamard butterfly, strides 1, 2, ..., b/2: (lo, hi) -> (lo +
  // hi, lo - hi), the order of core/rht.py:_butterfly. 1 .. 8 in registers,
  // 16 .. b/2 across the lanes of the row.
#pragma unroll
  for (int h = 1; h < 16; h <<= 1) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (t & h) continue;
      const float lo = v[t], hi = v[t + h];
      v[t] = __fadd_rn(lo, hi);
      v[t + h] = __fsub_rn(lo, hi);
    }
  }
  for (int h = 1; h < G; h <<= 1) {  // h in groups: stride 16 h elements
    const bool upper = (g & h) != 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const float o = __shfl_xor_sync(kFull, v[t], h);
      v[t] = upper ? __fsub_rn(o, v[t]) : __fadd_rn(v[t], o);
    }
  }
  float gmax = 0.f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    v[t] = __fmul_rn(v[t], inv_sqrt_b);
    gmax = fmaxf(gmax, fabsf(v[t]));
  }

  // ---- the group: pseudo-scale, codes, EDEN sums in group_sum's order
  const float ps = e8m3_rtn(__fdiv_rn(gmax, s));
  const float denom = ps == 0.f ? 1.f : ps;
  uint64_t codes = 0;
  float tn[4], td[4];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float xs = __fdiv_rn(v[t], denom);
    const float gq = fp4_rtn_mag(fabsf(xs));
    const float q = xs > 0.f ? gq : (xs < 0.f ? -gq : 0.f);
    const uint32_t idx = fp4_index(gq);
    // sign bit only for a strictly negative grid value (-0 codes as 0)
    codes |= (uint64_t)(((xs < 0.f && idx) ? 8u : 0u) | idx) << (4 * t);
    const float sq = __fmul_rn(v[t], v[t]);
    const float pr = __fmul_rn(v[t], __fmul_rn(q, denom));
    tn[t >> 2] = (t & 3) == 0 ? sq : __fadd_rn(tn[t >> 2], sq);
    td[t >> 2] = (t & 3) == 0 ? pr : __fadd_rn(td[t >> 2], pr);
  }
  const float sn = __fadd_rn(__fadd_rn(tn[0], tn[1]), __fadd_rn(tn[2], tn[3]));
  const float sd = __fadd_rn(__fadd_rn(td[0], td[1]), __fadd_rn(td[2], td[3]));

  const int64_t i = i0 + r;
  if (i < m) {
    const int64_t e = i * k + kb + 16 * g;  // first element of the group
    *reinterpret_cast<uint64_t*>(packed + e / 2) = codes;
    pseudo[e / 16] = ps;
    num[e / 16] = sn;
    den[e / 16] = sd;
  }

  // ---- absmax of the tile: warp shuffles, then shared memory, one atomic
  float am = gmax;
#pragma unroll
  for (int o = 16; o; o >>= 1) am = fmaxf(am, __shfl_xor_sync(kFull, am, o));
  if (lane == 0) warp_max[tid >> 5] = am;
  __syncthreads();
  if (tid == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    // non-negative floats order as their bit patterns
    atomicMax(absmax_bits, __float_as_uint(bm));
  }
}

// core/rng.py:_mix in uint32 arithmetic (its int64 products taken mod 2^32)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  return h ^ (h >> 16);
}

// core/rng.py:uniform_from_keys of flat index i: 24 hashed bits times 2^-24
__device__ __forceinline__ float hash_uniform(uint32_t i, uint32_t k,
                                              uint32_t k2) {
  return (float)(mix32(mix32(i ^ k) + k2) >> 8) * 5.9604644775390625e-08f;
}

// One group: EDEN-correct the pseudo-scale against gscale and round it
// stochastically onto the e4m3 lattice with uniform u; the raw e4m3 bits.
__device__ __forceinline__ uint32_t phase2_group(float ps, float nm, float dn,
                                                 float u, float gscale) {
  const float eden = dn != 0.f ? __fdiv_rn(nm, dn) : 1.f;
  float target = __fdiv_rn(__fmul_rn(eden, ps), gscale);
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
  uint32_t out = u < p_up ? (near_lo ? ob : nb) : (near_lo ? nb : ob);
  if (near == target) out = nb;
  return out;
}

constexpr int kP2Threads = 128;              // measured best of 128-512
constexpr int kP2Span = kP2Threads * 4;        // groups a CTA: 4 a thread

// One operand of a phase-2 launch: its phase-1 statistics ((n,) groups),
// its uniforms u or (u == nullptr) the key pair they hash from, its
// outputs, and its CTAs.
struct Phase2Op {
  const float* absmax;
  const float* pseudo;
  const float* num;
  const float* den;
  const float* u;
  uint8_t* scale_bits;
  float* gscale_out;
  int64_t n;
  int64_t blocks;
  uint32_t k, k2;
  int vec;  // 16-byte loads and 4-byte stores allowed
};

__global__ void __launch_bounds__(kP2Threads)
ms_eden_phase2_kernel(Phase2Op a, Phase2Op b, float gdiv) {
  const bool second = blockIdx.x >= a.blocks;
  const Phase2Op op = second ? b : a;
  const int64_t cta = second ? blockIdx.x - a.blocks : blockIdx.x;
  float gscale = __fdiv_rn(op.absmax[0], gdiv);
  if (gscale == 0.f) gscale = 1.f;
  if (cta == 0 && threadIdx.x == 0) op.gscale_out[0] = gscale;
  const int64_t i0 = cta * kP2Span + (int64_t)threadIdx.x * 4;
  if (i0 >= op.n) return;
  const int cnt = op.n - i0 < 4 ? (int)(op.n - i0) : 4;
  const bool vec = op.vec && cnt == 4;

  float ps[4], nm[4], dn[4], uu[4];
  if (vec) {
    const float4 p4 = __ldg(reinterpret_cast<const float4*>(op.pseudo + i0));
    const float4 n4 = __ldg(reinterpret_cast<const float4*>(op.num + i0));
    const float4 d4 = __ldg(reinterpret_cast<const float4*>(op.den + i0));
    ps[0] = p4.x; ps[1] = p4.y; ps[2] = p4.z; ps[3] = p4.w;
    nm[0] = n4.x; nm[1] = n4.y; nm[2] = n4.z; nm[3] = n4.w;
    dn[0] = d4.x; dn[1] = d4.y; dn[2] = d4.z; dn[3] = d4.w;
    if (op.u) {
      const float4 u4 = __ldg(reinterpret_cast<const float4*>(op.u + i0));
      uu[0] = u4.x; uu[1] = u4.y; uu[2] = u4.z; uu[3] = u4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= cnt) break;
      ps[j] = op.pseudo[i0 + j];
      nm[j] = op.num[i0 + j];
      dn[j] = op.den[i0 + j];
      if (op.u) uu[j] = op.u[i0 + j];
    }
  }
  if (!op.u) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      uu[j] = hash_uniform((uint32_t)(i0 + j), op.k, op.k2);
  }

  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cnt) word |= phase2_group(ps[j], nm[j], dn[j], uu[j], gscale) << (8 * j);
  if (vec) {
    *reinterpret_cast<uint32_t*>(op.scale_bits + i0) = word;
  } else {
    for (int j = 0; j < cnt; ++j) op.scale_bits[i0 + j] = (uint8_t)(word >> (8 * j));
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

// A launch's operand: nullptr u takes the uniforms hashed from (k, k2).
int phase2_operand(Phase2Op* op, const void* absmax, const void* pseudo,
                   const void* num, const void* den, const void* u,
                   void* scale_bits, void* gscale_out, int64_t n, int64_t k,
                   int64_t k2) {
  if (n < 0 || (n > 0 && !u && n > 0xFFFFFFFFll) || k < 0 || k > 0xFFFFFFFFll ||
      k2 < 0 || k2 > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  *op = Phase2Op{(const float*)absmax, (const float*)pseudo, (const float*)num,
                 (const float*)den, (const float*)u, (uint8_t*)scale_bits,
                 (float*)gscale_out, n, (n + kP2Span - 1) / kP2Span,
                 (uint32_t)k, (uint32_t)k2,
                 aligned(pseudo, 16) && aligned(num, 16) && aligned(den, 16) &&
                     aligned(u, 16) && aligned(scale_bits, 4)};
  return 0;
}

}  // namespace

// trans: x[i, j] at j * ld + i, else at i * ld + j; vec: 16 or 4 (bytes of
// one cp.async chunk). b in {16, 32, 64, 128} divides k.
extern "C" int ms_eden_phase1_launch(const void* x, int64_t ld, int trans,
                                     int vec, const void* signs, void* packed,
                                     void* pseudo, void* num, void* den,
                                     void* absmax_bits, int64_t m, int64_t k,
                                     int b, float s, float inv_sqrt_b,
                                     void* stream) {
  if (b != 16 && b != 32 && b != 64 && b != 128) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (m + kTile / b - 1) / (kTile / b) * (k / b);
  cudaStream_t st = (cudaStream_t)stream;
  // the atomicMax target starts at +0 (a memset on the stream, no kernel)
  const cudaError_t err = cudaMemsetAsync(absmax_bits, 0, sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  auto kernel = trans ? (vec == 16 ? ms_eden_phase1_kernel<true, 16>
                                   : ms_eden_phase1_kernel<true, 4>)
                      : (vec == 16 ? ms_eden_phase1_kernel<false, 16>
                                   : ms_eden_phase1_kernel<false, 4>);
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const float*)x, ld, (const float*)signs, (uint8_t*)packed,
      (float*)pseudo, (float*)num, (float*)den, (unsigned int*)absmax_bits, m,
      k, b, s, inv_sqrt_b);
  return (int)cudaGetLastError();
}

// Phase 2 over operand a and, with n_b > 0, operand b in one launch. Per
// operand: absmax (1,), pseudo, num, den (n,) f32, u (n,) f32 or nullptr
// (then the uniforms hash from the key pair k, k2 < 2^32, and n < 2^32),
// the scale bits (n,) u8 and the gscale (f32) written.
extern "C" int ms_eden_phase2_launch(
    const void* absmax_a, const void* pseudo_a, const void* num_a,
    const void* den_a, const void* u_a, void* scale_bits_a, void* gscale_a,
    int64_t n_a, int64_t k_a, int64_t k2_a, const void* absmax_b,
    const void* pseudo_b, const void* num_b, const void* den_b,
    const void* u_b, void* scale_bits_b, void* gscale_b, int64_t n_b,
    int64_t k_b, int64_t k2_b, float gdiv, void* stream) {
  Phase2Op a, b;
  int err = phase2_operand(&a, absmax_a, pseudo_a, num_a, den_a, u_a,
                           scale_bits_a, gscale_a, n_a, k_a, k2_a);
  if (!err) err = phase2_operand(&b, absmax_b, pseudo_b, num_b, den_b, u_b,
                                 scale_bits_b, gscale_b, n_b, k_b, k2_b);
  if (err) return err;
  if (a.n < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = a.blocks + b.blocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ms_eden_phase2_kernel<<<(unsigned)blocks, kP2Threads, 0, (cudaStream_t)stream>>>(
      a, b, gdiv);
  return (int)cudaGetLastError();
}
