// A persistent cooperative-grid design for large nvfp4_fos_quant calls, built
// only by tools/quant_probe.py to time it against the port's two-pass regime
// (csrc/nvfp4_quant.cu). It reuses that file's encode (included whole).
//
// One CTA of 512 threads an SM, co-resident by cudaLaunchCooperativeKernel.
// CTA c copies its run of chunks (a multiple of 32) into dynamic shared
// memory while taking their absmax, writes one partial, meets the other
// CTAs at a grid barrier (a counter that grows by the grid size each call,
// so it needs no reset), reduces every partial and encodes its chunks out of
// shared memory: x is read from device memory once.

#include "../../src/repro_torch/kernels/csrc/nvfp4_quant.cu"

namespace {

constexpr int kCoopThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kCoopThreads, 1)
nvfp4_fos_quant_coop_kernel(const T* __restrict__ x, float* partials,
                            unsigned int* counter, unsigned int target,
                            uint8_t* __restrict__ packed,
                            uint8_t* __restrict__ scale_bits,
                            float* __restrict__ gscale_out, int64_t n_chunks,
                            int64_t per_cta, float gdiv, float s6, float s4) {
  extern __shared__ __align__(16) unsigned char smem[];
  Chunk<T>* held = reinterpret_cast<Chunk<T>*>(smem);
  __shared__ float warp_max[kCoopThreads / 32];
  __shared__ float s_gscale;
  const int64_t c0 = (int64_t)blockIdx.x * per_cta;
  const int64_t n = n_chunks - c0 < per_cta ? n_chunks - c0 : per_cta;
  float am = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kCoopThreads) {
    Chunk<T> ch;
    ch.load(x, c0 + i);
    held[i] = ch;
    am = fmaxf(am, chunk_absmax(ch));
  }
  am = block_max(am, warp_max);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = am;
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
  am = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kCoopThreads)
    am = fmaxf(am, *reinterpret_cast<volatile float*>(partials + i));
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
  for (int64_t w = threadIdx.x & ~31; w < n; w += kCoopThreads) {
    const int64_t i = w + lane;
    Chunk<T> ch;
    if (i < n) ch = held[i];
    float v[kChunk];
    ch.to_f32(v);
    uint8_t bits;
    const uint32_t codes = encode_pair(v, odd, gscale, gd6, gd4, &bits);
    if (i < n) {
      reinterpret_cast<uint32_t*>(packed)[c0 + i] = codes;
      if (!odd) scale_bits[(c0 + i) >> 1] = bits;
    }
  }
}

template <typename T>
int coop(const void* x, void* partials, void* counter, unsigned int target,
         void* packed, void* scale_bits, void* gscale_out, int64_t n_chunks,
         int ctas, int64_t per_cta, float gdiv, float s6, float s4,
         cudaStream_t st) {
  const size_t smem = (size_t)per_cta * sizeof(Chunk<T>);
  cudaError_t err = cudaFuncSetAttribute(
      nvfp4_fos_quant_coop_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* xp = (const T*)x;
  float* pp = (float*)partials;
  unsigned int* cp = (unsigned int*)counter;
  uint8_t* pk = (uint8_t*)packed;
  uint8_t* sb = (uint8_t*)scale_bits;
  float* gs = (float*)gscale_out;
  void* args[] = {&xp, &pp, &cp, &target, &pk, &sb, &gs, &n_chunks, &per_cta,
                  &gdiv, &s6, &s4};
  err = cudaLaunchCooperativeKernel((void*)nvfp4_fos_quant_coop_kernel<T>,
                                    dim3(ctas), dim3(kCoopThreads), args, smem,
                                    st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// ctas CTAs of per_cta chunks each (a multiple of 32); counter must start at
// 0 and grow by ctas per call: target = (call index + 1) * ctas.
extern "C" int nvfp4_fos_quant_coop_launch(
    const void* x, int x_is_bf16, void* partials, void* counter,
    unsigned int target, void* packed, void* scale_bits, void* gscale_out,
    int64_t m, int64_t k, int ctas, int64_t per_cta, float gdiv, float s6,
    float s4, void* stream) {
  const int64_t n_chunks = m * k / kChunk;
  cudaStream_t st = (cudaStream_t)stream;
  return x_is_bf16
      ? coop<__nv_bfloat16>(x, partials, counter, target, packed, scale_bits,
                            gscale_out, n_chunks, ctas, per_cta, gdiv, s6, s4,
                            st)
      : coop<float>(x, partials, counter, target, packed, scale_bits,
                    gscale_out, n_chunks, ctas, per_cta, gdiv, s6, s4, st);
}
