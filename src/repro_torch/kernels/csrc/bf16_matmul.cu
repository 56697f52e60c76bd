// bf16 GEMM with f32 accumulation on Hopper's warpgroup tensor cores (wgmma),
// each output summed in one order fixed by K alone, for sm_90a.
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
// An f32 operand is rounded to bf16 where it is consumed (round to nearest
// even, as torch's .to(torch.bfloat16)), so the f32 weights of the bf16
// scheme are read where they lie, with no cast copy.
//
// Order. K is cut into chunks of 32 values, chunk c into two k16 steps (K
// values 32 c .. 32 c + 15, then 32 c + 16 .. 32 c + 31; zeros past K). 8
// chains: chain j runs wgmma k16 steps (bf16 -> f32) over the chunks j,
// j + 8, j + 16, ... in increasing order, started from 0; the chains are
// added in chain order, ((c0 + c1) + c2) + ... + c7. The instruction is
// m64n8k16 at every activation width below 128 and m64n128k16 at 128, whose
// 128 columns are bitwise the 16 m64n8k16 they stand for (the card tests
// hold a 128-row call against its two 64-row halves on operands of wide
// range and with cancellation). An instruction's result
// for one output is a function of that output's weight row, activation row
// and accumulator alone; so nothing in this order depends on M, N, the tile
// or the grid: a row's result is the same at any row count, a column's at
// any slice of N. Only the f32 summation inside and between the
// instructions differs from the plain version's (an f32 matmul of the
// bf16-rounded values).
//
// What bounds it. A weight element is read once (4 bytes f32, 2 bf16) for
// 2 M operations: with f32 weights the card's 295 operations a byte are
// reached near M = 600. Decode steps (M = 4), prefill chunks (64, 128) and
// a seed-loop prefill (352) are bound by the weight's bytes; a long prompt's
// head (16,384 rows) by the tensor cores.
//
// Design. The roles are swapped: 64 weight rows are wgmma's M side (A, from
// registers) and the activation rows its N side (B, from shared memory), in
// tiles of width 8 .. 128 picked by M (kernels/bf16_matmul.py:plan), so a
// decode step at M = 4 wastes an n8 column, not a 64-row tile. A block of
// 1 or 2 warpgroups owns 64 or 128 weight rows and one activation tile, and
// walks its chains stage by stage: a stage is the chunks c and c + 8 of one
// chain, brought into a ring slot by cp.async (16-byte copies, zero-filled
// past the edges; element loads when K or a row pitch is off 16 bytes): the
// activation rows straight into the bf16 tile in the 128-byte-swizzled
// layout wgmma reads (f32 rows are loaded, rounded and stored there), so an
// activation value comes from L2 once per 64 or 128 weight rows, not once
// per 8; the weight's raw f32 or bf16 rows beside it (padded against bank
// conflicts), which each thread converts into its own bf16 fragments in
// registers, with no bf16 copy in memory. One barrier a stage. One
// accumulator set walks chain 0's stages, then chain 1's, ...; at a chain's
// end it is folded into a running total in chain order and reset. Where the
// weight tiles cannot fill the card (llama's 1,280-wide weights at decode),
// plan splits the 8 chains over the 8 blocks of a thread-block cluster, one
// chain each, and the partials meet in distributed shared memory: at widths
// up to 16 blocks 1 .. 7 store theirs into block 0's shared memory and
// block 0 sums the 8 in chain order after one cluster barrier; at wider
// tiles (too many partials for one block) each block sums an eighth of the
// outputs from the 8 blocks' partials. One launch a call, no scratch in
// device memory.
//
// What it costs (tools/bf16_mm_probe.py; PERF.md rows 9-9e): nemotron-4-15b's
// head streams its weight at 85% of the card's byte rate; a llama-200m
// decode step's 71 GEMMs reach 39% of their bound, their small weights
// paying for the cluster's exchange and each stage's fixed cost (`--shapes
// --variants` times the kernel with each part removed), which the previous
// design (8 warps on 8 weight rows, no exchange between blocks) did not.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kChains = 8;         // chain j: chunks j, j + 8, ...
constexpr int kChunk = 32;         // K values of one chunk: two k16 steps
constexpr int kWgRows = 64;        // weight rows of one warpgroup (wgmma's M)
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kPushWidth = 16;     // widths whose partials go to block 0

// Shared memory of one instantiation: a ring of stages, each the bf16
// activation tile (NA rows of 64 values, 128-byte swizzle, 1024-byte
// aligned) and the weight's kWRows raw rows of 64 values (two chunks) at a
// pitch of 72 values. WG = 1 keeps two blocks to an SM (decode); WG = 2
// takes what one block may have.
template <typename TA, typename TB, int NA, int WG>
struct Geometry {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kWRows = kWgRows * WG;
  static constexpr int kWPitch = 72 * (int)sizeof(TB);
  static constexpr int kTile = NA * 128;            // the tile, then the rows
  static constexpr int kStage = kTile + kWRows * kWPitch;
  // block 0 of a cluster takes the other 7 chains' partials here (NA <= 16)
  static constexpr int kSlots = NA <= kPushWidth ? (kChains - 1) * kWRows * NA * 4 : 0;
  static constexpr int kBudget = WG == 1 ? 112 * 1024 : kSmemMax;
  static constexpr int kFit = (kBudget - 1024 - kSlots) / kStage;
  static constexpr int kStages = kFit < (WG == 1 ? 4 : 6) ? kFit : (WG == 1 ? 4 : 6);
  static constexpr int kSmem = kStages * kStage + kSlots + 1024;
  static_assert(kStages >= 2, "a stage in flight beside the one read");
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kStage % 1024 == 0 && kWPitch % 16 == 0, "aligned tiles, copies");
  static_assert(kWRows * NA * 4 <= kStages * kStage, "partials fit the ring");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(uint8_t* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Chunks of chain j below nch: j, j + 8, ...; its stages are the pairs
// (j + 16 q, j + 16 q + 8), the second absent at the chain's odd end.
__device__ __forceinline__ int chain_stages(int j, int nch) {
  const int chunks = j < nch ? (nch - 1 - j) / kChains + 1 : 0;
  return (chunks + 1) / 2;
}

// The raw rows row0 .. row0 + rows - 1 of one operand (rows past nrows and
// values past K read as zeros) for chunks c0 and c1 (c1 < 0: absent) into
// dst at `pitch` bytes a row: values 0..31 chunk c0, 32..63 chunk c1, in the
// operand's own type. vec: K % 8 == 0 and 16-byte aligned rows, so a 16-byte
// piece lies inside K or past it whole.
template <typename T>
__device__ __forceinline__ void load_rows(uint8_t* dst, int pitch,
                                          const T* __restrict__ src, int64_t ld,
                                          int64_t row0, int rows, int64_t nrows,
                                          int64_t k, int c0, int c1, bool vec,
                                          int tid, int nthreads) {
  if (vec) {
    constexpr int kPieces = kChunk * (int)sizeof(T) / 16;  // of one chunk
    constexpr int kPer = 16 / (int)sizeof(T);              // values a piece
    const int items = rows * 2 * kPieces;
    for (int i = tid; i < items; i += nthreads) {
      const int r = i / (2 * kPieces), h = (i / kPieces) & 1, q = i % kPieces;
      const int cc = h ? c1 : c0;
      if (cc < 0) continue;
      const int64_t gr = row0 + r, kk = (int64_t)cc * kChunk + q * kPer;
      const bool ok = gr < nrows && kk < k;
      cp_async16(dst + r * pitch + (h * kPieces + q) * 16,
                 ok ? (const void*)(src + gr * ld + kk) : (const void*)src,
                 ok ? 16 : 0);
    }
  } else {
    using U = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
    const U* s = reinterpret_cast<const U*>(src);
    const int items = rows * 2 * kChunk;
    for (int i = tid; i < items; i += nthreads) {
      const int r = i / (2 * kChunk), v = i % (2 * kChunk);
      const int cc = v < kChunk ? c0 : c1;
      if (cc < 0) continue;
      const int64_t gr = row0 + r, kk = (int64_t)cc * kChunk + v % kChunk;
      reinterpret_cast<U*>(dst + r * pitch)[v] =
          gr < nrows && kk < k ? s[gr * ld + kk] : (U)0;
    }
  }
}

// The activation rows row0 .. row0 + NA - 1 of chunks c0 and c1 (c1 < 0:
// absent) as bf16 into a stage's tile: row r's 16-byte piece j (values
// 8 j .. 8 j + 7 of its 64: chunk c0's 32, then c1's) at piece j ^ (r % 8),
// 8-row groups 1024 B apart; rows past nrows and values past K zeros. bf16
// rows under vec come by cp.async; f32 rows (or rows off 16 bytes) are
// loaded, rounded to bf16 and stored.
template <typename TA, int NA>
__device__ __forceinline__ void load_x(uint8_t* tile, const TA* __restrict__ a,
                                       int64_t lda, int64_t row0, int64_t nrows,
                                       int64_t k, int c0, int c1, bool vec,
                                       int tid, int nthreads) {
  for (int i = tid; i < NA * 8; i += nthreads) {
    const int r = i >> 3, j = i & 7;
    const int cc = j < 4 ? c0 : c1;
    if (cc < 0) continue;
    const int64_t gr = row0 + r, kk = (int64_t)cc * kChunk + (j & 3) * 8;
    const bool ok = gr < nrows && kk < k;
    uint8_t* dst = tile + r * 128 + ((j ^ (r & 7)) << 4);
    const TA* src = a + gr * lda + kk;
    if constexpr (sizeof(TA) == 2) {
      if (vec) {
        cp_async16(dst, ok ? (const void*)src : (const void*)a, ok ? 16 : 0);
        continue;
      }
    }
    float v[8];
    bool loaded = false;
    if constexpr (sizeof(TA) == 4) {
      if (vec) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 x = ok ? __ldg(reinterpret_cast<const float4*>(src)) : z;
        const float4 y = ok ? __ldg(reinterpret_cast<const float4*>(src) + 1) : z;
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = gr < nrows && kk + e < k ? to_float(src[e]) : 0.f;
    }
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

// Two weight values at row offset v, v + 1 of a raw row as a bf16 pair (the
// lower K index in the low half).
template <typename TB>
__device__ __forceinline__ uint32_t weight_pair(const uint8_t* row, int v) {
  if constexpr (sizeof(TB) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(row + v * 4);
    return pack_bf16x2(x.x, x.y);
  } else {
    return *reinterpret_cast<const uint32_t*>(row + v * 2);
  }
}

// The wgmma descriptor of a K-major bf16 tile of 128-byte rows under the
// 128-byte swizzle (8-row groups 1024 B apart; the base 1024-byte aligned).
__device__ __forceinline__ uint64_t smem_desc(const uint8_t* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
       | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// d += a b: m64n8k16, a (64 x 16 bf16) from registers in the m16n8k16
// fragment layout of each warp's 16 rows, b (8 x 16) from shared memory.
__device__ __forceinline__ void wgmma_n8(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b: m64n128k16, as wgmma_n8 over 128 activation rows.
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b over IW activation rows (8 or 128) from the tile at db.
template <int IW>
__device__ __forceinline__ void wgmma(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (IW == 8)
    wgmma_n8(d, a, db);
  else
    wgmma_n128(d, a, db);
}

// Block (x, y): activation rows NA x ..; weight rows kWRows (y / splits) ..
// (the activation tiles of one weight tile run side by side, so the blocks
// on the card at once share their weight tiles in L2); splits 1: all 8
// chains, folded in registers; splits 8: the cluster (along y) block of
// rank r runs chain r and they sum the 8 partials in chain order.
// Thread (warpgroup wg, warp w, lane (g, t)) holds acc[4 i + 2 h + e]:
// weight row 64 wg + 16 w + g + 8 h of the tile, activation row 8 i + 2 t + e
// (the m64nNk16 accumulator layout: at IW = 8 an instruction for each i).
template <typename TA, typename TB, int NA, int WG, int IW>
__global__ void __launch_bounds__(128 * WG)
bf16_matmul_kernel(const TA* __restrict__ a, int64_t lda,
                   const TB* __restrict__ b, int64_t ldb,
                   float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                   int splits, int vec) {
  using G = Geometry<TA, TB, NA, WG>;
  constexpr int kAcc = NA / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = splits == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int64_t n0 = (int64_t)(blockIdx.y / splits) * G::kWRows;
  const int64_t m0 = (int64_t)blockIdx.x * NA;
  const int nch = (int)((k + kChunk - 1) / kChunk);
  const int j0 = splits == 1 ? 0 : rank, j1 = splits == 1 ? kChains : rank + 1;
  int stages = 0;
  for (int j = j0; j < j1; ++j) stages += chain_stages(j, nch);
  // the producer's cursor: chain pj, its stage pq (empty chains trail)
  int pj = j0, pq = 0, issued = 0;
  auto issue = [&]() {
    if (issued < stages) {
      uint8_t* slot = ring + (issued % G::kStages) * G::kStage;
      const int c0 = pj + 2 * kChains * pq, c1 = c0 + kChains < nch ? c0 + kChains : -1;
      load_x<TA, NA>(slot, a, lda, m0, m, k, c0, c1, vec, tid, G::kThreads);
      load_rows<TB>(slot + G::kTile, G::kWPitch, b, ldb, n0, G::kWRows, n, k, c0,
                    c1, vec, tid, G::kThreads);
      if (++pq == chain_stages(pj, nch)) {
        pq = 0;
        ++pj;
      }
      ++issued;
    }
    cp_async_commit();
  };
  for (int s = 0; s < G::kStages - 1; ++s) issue();

  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = total[i] = 0.f;
  const int wr = kWgRows * wg + 16 * warp + g;  // this thread's weight row g
  int p = 0;
  for (int j = j0; j < j1; ++j) {
    const int ns = chain_stages(j, nch);
    for (int q = 0; q < ns; ++q, ++p) {
      cp_async_wait<G::kStages - 2>();
      // this thread's copies and stores of stage p, seen by wgmma's proxy;
      // after the barrier every thread's are, and every thread is past
      // stage p - 1's reads of the ring and its wgmma, so stage
      // p + kStages - 1 may take that stage's slot
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      issue();
      const uint8_t* slot = ring + (p % G::kStages) * G::kStage;
      const uint64_t desc0 = smem_desc(slot);
      const bool two = j + 2 * kChains * q + kChains < nch;
      const uint8_t* wrow = slot + G::kTile + wr * G::kWPitch;
      uint32_t fa[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= 2 && !two) break;
        const int v = 16 * s + 2 * t;
        fa[s][0] = weight_pair<TB>(wrow, v);
        fa[s][1] = weight_pair<TB>(wrow + 8 * G::kWPitch, v);
        fa[s][2] = weight_pair<TB>(wrow, v + 8);
        fa[s][3] = weight_pair<TB>(wrow + 8 * G::kWPitch, v + 8);
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= 2 && !two) break;
#pragma unroll
        for (int r = 0; r < NA / IW; ++r)  // IW activation rows = 128 IW bytes
          wgmma<IW>(acc + IW / 2 * r, fa[s], desc0 + 2 * s + 8 * IW * r);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // complete before the fragments' registers are written again: wgmma
      // reads its A operand from them asynchronously
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
    }
    if (splits == 1) {  // fold chain j into the total, in chain order
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        total[i] = j == 0 ? acc[i] : __fadd_rn(total[i], acc[i]);
        acc[i] = 0.f;
      }
    }
  }
  cp_async_wait<0>();

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t mm = m0 + 8 * i + 2 * t + e, nn = n0 + wr + 8 * h;
          if (mm < m && nn < n) c[mm * n + nn] = total[4 * i + 2 * h + e];
        }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (NA <= kPushWidth) {
    // splits 8, narrow: blocks 1 .. 7 store their chains into block 0's
    // slots (chain r's element i of thread tid at ((r - 1) kAcc + i)
    // kThreads + tid); after one cluster barrier block 0 sums in chain order
    float* slots = reinterpret_cast<float*>(ring + G::kStages * G::kStage);
    if (rank > 0) {
      float* dst = cluster.map_shared_rank(slots, 0) + (rank - 1) * kAcc * G::kThreads;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) dst[i * G::kThreads + tid] = acc[i];
    }
    cluster.sync();
    if (rank > 0) return;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      float v = acc[i];
#pragma unroll
      for (int r = 1; r < kChains; ++r)
        v = __fadd_rn(v, slots[((r - 1) * kAcc + i) * G::kThreads + tid]);
      const int64_t mm = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int64_t nn = n0 + wr + 8 * ((i >> 1) & 1);
      if (mm < m && nn < n) c[mm * n + nn] = v;
    }
    return;
  }
  // splits 8, wide: this block's chain to its ring (element i of thread tid
  // at i * kThreads + tid); block r sums the 8 partials of its eighth
  float* part = reinterpret_cast<float*>(ring);
  __syncthreads();  // every thread is past its reads of the ring
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i * G::kThreads + tid] = acc[i];
  cluster.sync();
  constexpr int kShare = kAcc * G::kThreads / kChains;
  for (int e = rank * kShare + tid; e < (rank + 1) * kShare; e += G::kThreads) {
    float v = cluster.map_shared_rank(part, 0)[e];
#pragma unroll
    for (int jj = 1; jj < kChains; ++jj)
      v = __fadd_rn(v, cluster.map_shared_rank(part, jj)[e]);
    const int i = e / G::kThreads, th = e % G::kThreads;
    const int tl = th & 31, tt = tl & 3;
    const int row = kWgRows * (th >> 7) + 16 * ((th >> 5) & 3) + (tl >> 2);
    const int64_t mm = m0 + 8 * (i >> 2) + 2 * tt + (i & 1);
    const int64_t nn = n0 + row + 8 * ((i >> 1) & 1);
    if (mm < m && nn < n) c[mm * n + nn] = v;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

template <typename TA, typename TB, int NA, int WG, int IW>
int launch(const TA* a, int64_t lda, const TB* b, int64_t ldb, float* c,
           int64_t m, int64_t n, int64_t k, int splits, int gx, int gy,
           bool vec, cudaStream_t st) {
  using G = Geometry<TA, TB, NA, WG>;
  auto kernel = bf16_matmul_kernel<TA, TB, NA, WG, IW>;
  static bool attr_set = false;  // dynamic shared memory past 48 KB
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (unsigned)gy);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, lda, b, ldb, c, m,
                                             n, k, splits, (int)vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_typed(const void* a, int64_t lda, const void* b, int64_t ldb,
                 float* c, int64_t m, int64_t n, int64_t k, int width,
                 int groups, int splits, int gx, int gy, cudaStream_t st) {
  const bool vec = k % 8 == 0 && aligned(a, 16) && aligned(b, 16) &&
                   (lda * (int64_t)sizeof(TA)) % 16 == 0 &&
                   (ldb * (int64_t)sizeof(TB)) % 16 == 0;
  const TA* pa = (const TA*)a;
  const TB* pb = (const TB*)b;
  if (groups != (width == 128 ? 2 : 1) || (splits != 1 && splits != kChains) ||
      (int64_t)gy != (n + kWgRows * groups - 1) / (kWgRows * groups) * splits ||
      (int64_t)gx != (m + width - 1) / width || gy > 65535)
    return (int)cudaErrorInvalidValue;
  // wgmma's N: m64n8k16 side by side below the 128-row tile, m64n128k16 there
  switch (width) {
    case 8: return launch<TA, TB, 8, 1, 8>(pa, lda, pb, ldb, c, m, n, k, splits, gx, gy, vec, st);
    case 16: return launch<TA, TB, 16, 1, 8>(pa, lda, pb, ldb, c, m, n, k, splits, gx, gy, vec, st);
    case 32: return launch<TA, TB, 32, 1, 8>(pa, lda, pb, ldb, c, m, n, k, splits, gx, gy, vec, st);
    case 64: return launch<TA, TB, 64, 1, 8>(pa, lda, pb, ldb, c, m, n, k, splits, gx, gy, vec, st);
    case 128: return launch<TA, TB, 128, 2, 128>(pa, lda, pb, ldb, c, m, n, k, splits, gx, gy, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a_bf16 / b_bf16: 1 when the operand is bf16, 0 when f32. The geometry
// (activation width, warpgroups, chain splits, grid) comes from
// kernels/bf16_matmul.py:plan.
extern "C" int bf16_matmul_launch(const void* a, int64_t lda, int a_bf16,
                                  const void* b, int64_t ldb, int b_bf16,
                                  void* c, int64_t m, int64_t n, int64_t k,
                                  int width, int groups, int splits, int gx,
                                  int gy, void* stream) {
  if (m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* out = (float*)c;
  if (a_bf16 && b_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, lda, b, ldb, out, m, n, k,
                                                      width, groups, splits, gx, gy, st);
  if (a_bf16)
    return launch_typed<__nv_bfloat16, float>(a, lda, b, ldb, out, m, n, k, width,
                                              groups, splits, gx, gy, st);
  if (b_bf16)
    return launch_typed<float, __nv_bfloat16>(a, lda, b, ldb, out, m, n, k, width,
                                              groups, splits, gx, gy, st);
  return launch_typed<float, float>(a, lda, b, ldb, out, m, n, k, width,
                                    groups, splits, gx, gy, st);
}
