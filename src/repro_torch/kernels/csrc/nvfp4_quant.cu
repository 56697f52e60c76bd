// Four-over-Six NVFP4 activation/weight quantization for Hopper (sm_90a),
// the per-tensor absmax included.
//
// Replaces: src/repro/kernels/nvfp4_quant.py:nvfp4_fos_quant (Pallas body
// _kernel, and the absmax its wrapper takes before the pallas_call).
// Computes the tensor's absmax and gscale = absmax / (s * 4/6 * 448) (0 ->
// 1); then, per 16-element group along the last axis, the group absmax, both
// scale branches (absmax -> s and absmax -> s * 4/6), and keeps the branch
// with the lower squared error (ties go to the 6 branch), exactly as
// repro_torch.core.quant.quant_four_over_six does.
//
// Bound on the H100: memory bytes in principle (2 B bf16 or 4 B f32 read,
// 0.5625 B written an element), but a decode call moves a few tens of KB, so
// there one launch's latency is the floor; at training sizes the f32 work
// (two branches' rounding and squared error an element, some 60 issue slots)
// exceeds the byte time, so the design counts instructions as well as bytes.
//
// Design (kernels/nvfp4_quant.py:plan picks the regime from the shape):
//  - Work over lanes. A lane takes one chunk of 8 elements (one 16-byte load
//    for bf16, two for f32); the two lanes of a pair hold one 16-group. The
//    pair exchanges the group max and the branch errors by shuffles; a lane
//    leaves its 8 codes as one 32-bit store (a warp writes 128 contiguous
//    bytes) and the even lane writes the group's scale byte.
//  - "cluster" regime, every decode call (up to 16 x 512 chunks): one
//    launch of one thread-block cluster of 1-16 CTAs (above 8 Hopper's
//    non-portable size), spread thin over its SMs. x is read once into
//    registers; each CTA's absmax goes to its shared memory and every CTA
//    reads all of them through distributed shared memory; then each lane
//    encodes the chunks it holds. No atomics, no device scratch, no second
//    read of x.
//  - "two_pass" regime (training activations and weights, prefill,
//    prequant): an absmax kernel writes one partial per CTA, then the encode
//    kernel, whose every CTA reduces those partials itself (no third launch,
//    no atomics); its read of x comes mostly from the 50 MB L2.
//  - No divides on the common path. The plain version rounds fl(x / d) onto
//    the E2M1 grid in each branch; here m = |x * RN(1/d)| (one multiply)
//    lies within 3 ulps of |x / d|, so it rounds the same way unless it lies
//    within 2^-20 of a grid step from a rounding threshold, which the
//    rounding itself reveals; only a lane holding such a value (for random
//    data about one element in 10^5) divides (IEEE __fdiv_rn) as before. The
//    rounding is (m + c) - c with c = 2^22 scaled by m's binade (the sum's
//    ulp is the E2M1 step there: 0.5 below 2, 1 below 4, 2 above), then
//    min(., 6); this equals core/formats.py:fp4_rtn for every float, NaN and
//    inf included. The codes come from the kept branch's grid values, not
//    from a third round of divides.
//  - Every multiply, divide and add that feeds a rounding decision uses the
//    _rn intrinsics (no FMA contraction, no fast math), and the error sum of
//    a group runs over its 16 terms in index order (the even lane's 8, then
//    the odd lane continues from that partial), the order of the earlier
//    one-thread-a-group kernel, so scales equal the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 8;           // elements of one lane
constexpr int kSmallThreads = 512;  // largest CTA of the cluster regime
constexpr int kThreads = 256;       // CTAs of the two-pass regime
constexpr unsigned kFull = 0xffffffffu;

// Round-half-to-even of m >= 0 onto the E2M1 magnitudes {0, .5, 1, 1.5, 2,
// 3, 4, 6}, saturating at 6. c = 2^(22 + max(e, 0)), e the binade of m: the
// ulp of m + c is 0.5 for m < 2, 1 for m < 4 and 2 up to 8, so the f32 sum
// rounds m onto that step (ties to the even multiple, as the grid does).
__device__ __forceinline__ float fp4_rtn_mag(float m) {
  m = fminf(m, 8.f);  // NaN and inf -> 8 (-> 6), and c stays finite
  const uint32_t e = max(__float_as_uint(m) & 0x7F800000u, 0x3F800000u);
  const float c = __uint_as_float(e + (22u << 23));
  return fminf(__fsub_rn(__fadd_rn(m, c), c), 6.f);
}

// fp4_rtn_mag of m, and in *near whether m lies within 2^-20 of a grid
// step from a rounding threshold: m + c rounds m by at most half a step (c *
// 2^-24), so |q - m| above c * (2^-24 - 2^-42) marks it. An m = fl(x * r)
// with r = RN(1/d) is within 3 ulps of x / d, so when not near it rounds as
// fl(x / d) does (the exact divide is then needed only for flagged values).
__device__ __forceinline__ float fp4_rtn_mag_near(float m, bool* near) {
  m = fminf(m, 8.f);
  const uint32_t e = max(__float_as_uint(m) & 0x7F800000u, 0x3F800000u);
  const float c = __uint_as_float(e + (22u << 23));
  const float q = __fsub_rn(__fadd_rn(m, c), c);
  *near = fabsf(__fsub_rn(q, m)) > __fmul_rn(c, __uint_as_float(0x337FFFC0u));
  return fminf(q, 6.f);
}

// grid magnitude -> its 3-bit index: 0, 0.5 -> 0, 1; from 1 up the f32
// exponent and top mantissa bit (1 -> 2, 1.5 -> 3, ..., 6 -> 7)
__device__ __forceinline__ uint32_t fp4_index(float q) {
  return q >= 1.f ? (__float_as_uint(q) >> 22) - 252u : (q > 0.f ? 1u : 0u);
}

// e4m3 bits -> float, exactly: a normal e4m3 (e > 0) is the f32 with
// exponent e - 7 and the 3 mantissa bits on top; a subnormal one is m * 2^-9
__device__ __forceinline__ float e4m3_bits_to_float(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xF, m = b & 0x7;
  const float mag = e == 0 ? (float)m * 0.001953125f
                           : __uint_as_float(((e + 120u) << 23) | (m << 20));
  return (b & 0x80u) ? -mag : mag;
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

// 8 consecutive elements of x as raw registers (zero when not loaded)
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  __device__ __forceinline__ void load(const __nv_bfloat16* x, int64_t c) {
    u = __ldg(reinterpret_cast<const uint4*>(x) + c);
  }
  __device__ __forceinline__ void to_f32(float (&v)[kChunk]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

template <>
struct Chunk<float> {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  __device__ __forceinline__ void load(const float* x, int64_t c) {
    a = __ldg(reinterpret_cast<const float4*>(x) + 2 * c);
    b = __ldg(reinterpret_cast<const float4*>(x) + 2 * c + 1);
  }
  __device__ __forceinline__ void to_f32(float (&v)[kChunk]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <typename T>
__device__ __forceinline__ float chunk_absmax(const Chunk<T>& ch) {
  float v[kChunk];
  ch.to_f32(v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) m = fmaxf(m, fabsf(v[i]));
  return m;
}

// max over the CTA; the result is valid in thread 0
__device__ __forceinline__ float block_max(float v, float* warp_max) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, warp_max[w]);
  return v;
}

// One 16-group held by a lane pair (even lane: elements 0-7, odd lane:
// 8-15). Returns this lane's 8 codes packed (low nibble = even index) and,
// in *bits, the kept branch's e4m3 scale bits (the same on both lanes).
// Every lane of the warp must call it (shuffles over the full mask).
__device__ __forceinline__ uint32_t encode_pair(const float (&v)[kChunk],
                                                bool odd, float gscale,
                                                float gd6, float gd4,
                                                uint8_t* bits) {
  float gm = 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) gm = fmaxf(gm, fabsf(v[i]));
  gm = fmaxf(gm, __shfl_xor_sync(kFull, gm, 1));

  uint8_t b6, b4;
  const float den6 = __fmul_rn(fp8_rtn(__fdiv_rn(gm, gd6), &b6), gscale);
  const float den4 = __fmul_rn(fp8_rtn(__fdiv_rn(gm, gd4), &b4), gscale);
  const float safe6 = den6 == 0.f ? 1.f : den6;
  const float safe4 = den4 == 0.f ? 1.f : den4;

  // grid values of |x / d| from x * RN(1/d); a lane with a value near a
  // rounding threshold (or a reciprocal that overflowed) divides exactly
  const float r6 = __frcp_rn(safe6), r4 = __frcp_rn(safe4);
  float q6[kChunk], q4[kChunk], s6[kChunk], s4[kChunk];
  bool near = isinf(r6) || isinf(r4);
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    bool n6, n4;
    q6[i] = fp4_rtn_mag_near(fabsf(__fmul_rn(v[i], r6)), &n6);
    q4[i] = fp4_rtn_mag_near(fabsf(__fmul_rn(v[i], r4)), &n4);
    near |= n6 | n4;
  }
  if (__any_sync(kFull, near) && near) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      q6[i] = fp4_rtn_mag(fabsf(__fdiv_rn(v[i], safe6)));
      q4[i] = fp4_rtn_mag(fabsf(__fdiv_rn(v[i], safe4)));
    }
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    // q keeps the sign of x (x / d has it; a zero q gives the same square)
    const float d6 = __fsub_rn(__fmul_rn(v[i] < 0.f ? -q6[i] : q6[i], den6), v[i]);
    const float d4 = __fsub_rn(__fmul_rn(v[i] < 0.f ? -q4[i] : q4[i], den4), v[i]);
    s6[i] = __fmul_rn(d6, d6);
    s4[i] = __fmul_rn(d4, d4);
  }
  // the group's squared errors summed in index order 0 .. 15
  float e6 = 0.f, e4 = 0.f;
  if (!odd) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      e6 = __fadd_rn(e6, s6[i]);
      e4 = __fadd_rn(e4, s4[i]);
    }
  }
  const float p6 = __shfl_xor_sync(kFull, e6, 1);
  const float p4 = __shfl_xor_sync(kFull, e4, 1);
  if (odd) {
    e6 = p6;
    e4 = p4;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      e6 = __fadd_rn(e6, s6[i]);
      e4 = __fadd_rn(e4, s4[i]);
    }
  }
  const float t6 = __shfl_xor_sync(kFull, e6, 1);
  const float t4 = __shfl_xor_sync(kFull, e4, 1);
  const bool use4 = odd ? e4 < e6 : t4 < t6;
  *bits = use4 ? b4 : b6;

  uint32_t codes = 0;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const uint32_t idx = fp4_index(use4 ? q4[i] : q6[i]);
    // sign bit only for a strictly negative grid value (-0 codes as 0)
    codes |= (idx | ((v[i] < 0.f && idx) ? 8u : 0u)) << (4 * i);
  }
  return codes;
}

__device__ __forceinline__ float gscale_of(float absmax, float gdiv) {
  const float g = __fdiv_rn(absmax, gdiv);
  return g == 0.f ? 1.f : g;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Cluster regime: chunk c = rank * blockDim.x + thread, held in registers
// from the absmax to the encode.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
nvfp4_fos_quant_cluster_kernel(const T* __restrict__ x,
                               uint8_t* __restrict__ packed,
                               uint8_t* __restrict__ scale_bits,
                               float* __restrict__ gscale_out,
                               int64_t n_chunks, float gdiv, float s6,
                               float s4) {
  __shared__ float warp_max[kSmallThreads / 32];
  __shared__ float cta_max;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ctas = (int)cluster.num_blocks();

  const int64_t c = (int64_t)rank * blockDim.x + threadIdx.x;
  Chunk<T> raw;
  if (c < n_chunks) raw.load(x, c);
  const float am = block_max(chunk_absmax(raw), warp_max);
  if (threadIdx.x == 0) cta_max = am;
  cluster.sync();  // every CTA's max is in its shared memory
  // lane q reads CTA q's max through distributed shared memory
  const int lane = threadIdx.x & 31;
  float absmax = lane < n_ctas ? *cluster.map_shared_rank(&cta_max, lane) : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(kFull, absmax, o));
  cluster_arrive();  // this CTA's remote reads are done

  const float gscale = gscale_of(absmax, gdiv);
  if (rank == 0 && threadIdx.x == 0) gscale_out[0] = gscale;
  const float gd6 = __fmul_rn(gscale, s6), gd4 = __fmul_rn(gscale, s4);
  if (__any_sync(kFull, c < n_chunks)) {  // warp-uniform
    float v[kChunk];
    raw.to_f32(v);
    uint8_t bits;
    const uint32_t codes = encode_pair(v, threadIdx.x & 1, gscale, gd6, gd4,
                                       &bits);
    if (c < n_chunks) {
      reinterpret_cast<uint32_t*>(packed)[c] = codes;
      if (!(threadIdx.x & 1)) scale_bits[c >> 1] = bits;
    }
  }
  cluster_wait();  // no CTA leaves while a peer may still read its max
}

// Two-pass regime, pass 1: one absmax partial per CTA, 4 loads in flight a
// thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nvfp4_fos_quant_absmax_kernel(const T* __restrict__ x,
                              float* __restrict__ partials,
                              int64_t n_chunks) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float am = 0.f;
  for (; c + 3 * stride < n_chunks; c += 4 * stride) {
    Chunk<T> ch[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) ch[u].load(x, c + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) am = fmaxf(am, chunk_absmax(ch[u]));
  }
  for (; c < n_chunks; c += stride) {
    Chunk<T> ch;
    ch.load(x, c);
    am = fmaxf(am, chunk_absmax(ch));
  }
  am = block_max(am, warp_max);
  if (threadIdx.x == 0) partials[blockIdx.x] = am;
}

// Two-pass regime, pass 2: reduce the partials, then encode warp-aligned
// runs of 32 chunks (pairs never straddle a warp: n_chunks is even).
template <typename T>
__global__ void __launch_bounds__(kThreads)
nvfp4_fos_quant_encode_kernel(const T* __restrict__ x,
                              const float* __restrict__ partials,
                              int n_partials, uint8_t* __restrict__ packed,
                              uint8_t* __restrict__ scale_bits,
                              float* __restrict__ gscale_out,
                              int64_t n_chunks, float gdiv, float s6,
                              float s4) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float s_gscale;
  float am = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads)
    am = fmaxf(am, partials[i]);
  am = block_max(am, warp_max);
  if (threadIdx.x == 0) {
    s_gscale = gscale_of(am, gdiv);
    if (blockIdx.x == 0) gscale_out[0] = s_gscale;
  }
  __syncthreads();
  const float gscale = s_gscale;
  const float gd6 = __fmul_rn(gscale, s6), gd4 = __fmul_rn(gscale, s4);
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t wc = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
       wc < n_chunks; wc += stride) {
    const int64_t c = wc + lane;
    Chunk<T> ch;
    if (c < n_chunks) ch.load(x, c);
    float v[kChunk];
    ch.to_f32(v);
    uint8_t bits;
    const uint32_t codes = encode_pair(v, odd, gscale, gd6, gd4, &bits);
    if (c < n_chunks) {
      reinterpret_cast<uint32_t*>(packed)[c] = codes;
      if (!odd) scale_bits[c >> 1] = bits;
    }
  }
}

template <typename T>
cudaError_t launch_cluster(const void* x, void* packed, void* scale_bits,
                           void* gscale_out, int64_t n_chunks, int ctas,
                           int threads, float gdiv, float s6, float s4,
                           cudaStream_t st) {
  static bool wide = false;  // above the portable 8 CTAs (Hopper allows 16)
  if (ctas > 8 && !wide) {
    const cudaError_t err = cudaFuncSetAttribute(
        nvfp4_fos_quant_cluster_kernel<T>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nvfp4_fos_quant_cluster_kernel<T>,
                            (const T*)x, (uint8_t*)packed,
                            (uint8_t*)scale_bits, (float*)gscale_out, n_chunks,
                            gdiv, s6, s4);
}

template <typename T>
cudaError_t launch(const void* x, void* packed, void* scale_bits,
                   void* gscale_out, void* partials, int64_t n_chunks,
                   int regime, int ctas, int threads, int partial_ctas,
                   float gdiv, float s6, float s4, cudaStream_t st) {
  if (regime == 0) {
    if (ctas < 1 || ctas > 16 || threads < 32 || threads > kSmallThreads ||
        threads % 32 || (int64_t)ctas * threads < n_chunks)
      return cudaErrorInvalidValue;
    return launch_cluster<T>(x, packed, scale_bits, gscale_out, n_chunks, ctas,
                             threads, gdiv, s6, s4, st);
  }
  if (partial_ctas < 1 || ctas < 1) return cudaErrorInvalidValue;
  nvfp4_fos_quant_absmax_kernel<T><<<(unsigned)partial_ctas, kThreads, 0, st>>>(
      (const T*)x, (float*)partials, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nvfp4_fos_quant_encode_kernel<T><<<(unsigned)ctas, kThreads, 0, st>>>(
      (const T*)x, (const float*)partials, partial_ctas, (uint8_t*)packed,
      (uint8_t*)scale_bits, (float*)gscale_out, n_chunks, gdiv, s6, s4);
  return cudaGetLastError();
}

}  // namespace

// regime 0: one cluster of `ctas` CTAs (up to 16) of `threads` threads, one
// chunk a thread; regime 1: the absmax kernel over `partial_ctas` CTAs into
// `partials`, then the encode kernel over `ctas` CTAs.
extern "C" int nvfp4_fos_quant_launch(const void* x, int x_is_bf16,
                                      void* packed, void* scale_bits,
                                      void* gscale_out, void* partials,
                                      int64_t m, int64_t k, int regime,
                                      int ctas, int threads, int partial_ctas,
                                      float gdiv, float s6,
                                      float s4, void* stream) {
  const int64_t n_chunks = m * k / kChunk;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      x_is_bf16 ? launch<__nv_bfloat16>(x, packed, scale_bits, gscale_out,
                                        partials, n_chunks, regime, ctas,
                                        threads, partial_ctas, gdiv, s6, s4,
                                        st)
                : launch<float>(x, packed, scale_bits, gscale_out, partials,
                                n_chunks, regime, ctas, threads, partial_ctas,
                                gdiv, s6, s4, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
