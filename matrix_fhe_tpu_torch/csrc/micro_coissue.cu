// K12: the co-issue probe, int8 tensor-core dots interleaved with u32
// chains, on asynchronous warpgroup products.
//
// Replaces scripts/micro_coissue.py:_kern.  Per cell g of the grid, over
// reps r: acc += d8[g, r % P] @ t8[0, r % Pt] (int8 [N, K] x [K, N] -> int32,
// N = 256, K = 1280 in the script), and u32 "fold" rounds on two planes a, b
// [N, N]:
//
//   dma      the operand tiles stream through shared memory, no products
//   mxu      the dots only (also "dma+mxu": the same kernel body there)
//   vpu      reps rounds (a, b) = round(a, b), no dots
//   both     the dots and the rounds, data-independent
//   dep      round r takes a ^ acc_r: each round consumes dot r's sum
//
// Outputs: o32 = acc (0 for dma and vpu), ou = a after the rounds.
//
// The dots run on wgmma m64n128k32 .s32.s8.s8 (csrc/wgmma8.cuh's s8
// register list at N = 128): a block of two warpgroups owns a 128 x 128
// output tile of a cell, 64 rows a warpgroup, both on one B tile.  K
// advances in 128-byte tiles through a ring of four shared-memory stages
// (32 KB each) filled by cp.async with the 128-byte swizzle, two tiles
// ahead of the tensor cores, over the reps' tiles in turn (K1's ring,
// csrc/stage.cu).  int8 wgmma wants B K-major and t8 is N-major, so a
// transpose pass (coissue_transpose, 32 x 32 byte tiles through shared
// memory, part of every launch but vpu's) first writes t8 as [Pt, N, K]:
// 0.66 MB once, where a transpose inside the ring would redo it for every
// block and rep.
//
// The rounds run on the 64 accumulator elements a thread owns, with a and b
// in registers: 64 s32 sums, 64 + 64 u32 words, which bounds a warpgroup's
// tile to 64 x 128 (64 x 256 would need 384 registers).  They run between
// wgmma.commit_group and wgmma.wait_group, while tensor work is in flight:
// in "both" the rounds of rep r are spread over rep r's K-tiles, 4 elements
// a group, group i after the products of K-tile i KT / 16; in "dep" rep
// r's round consumes acc_r, so at rep r + 1's first K-tile the products are
// drained (wait_group 0) and a ^= acc_r is taken, and rep r's rounds then
// run, spread as in "both", while rep r + 1's products are in flight; the
// last rep's rounds run after the loop.  So the times of both and dep
// against mxu and vpu say whether the card overlaps integer work with
// wgmma.
//
// Bound on the H100: at grid 64, reps 8 the dots are 8.6e10 int8
// operations, 0.043 ms at 1,979 TOP/s; the bytes (d8, t8, a, b read and
// o32, ou written) 0.033 ms at 3.35 TB/s.  Each block reads its 128 rows
// of d8 and 128 of t8 a rep, 0.67 GB from L2 over the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma8.cuh"

namespace {

constexpr int THREADS = 256;       // two warpgroups, 64 rows each
constexpr int BM = 128;            // rows of a cell a block
constexpr int BN = 128;            // columns a block: one wgmma's N
constexpr int BK = 128;            // K bytes a tile (one swizzle row)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + 1024 B alignment
constexpr int E = 64;              // accumulator elements a thread
constexpr int GROUPS = E / 4;      // rounds are spread in groups of 4
static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
enum { DMA = 0, MXU = 1, VPU = 2, BOTH = 3, DEP = 4 };

struct Args {
  const int8_t* d8;        // [G, P, N, K]
  const int8_t* t8t;       // [Pt, N, K]: t8 transposed
  const uint32_t* a;       // [G, N, N]
  const uint32_t* b;
  int32_t* o32;
  uint32_t* ou;
  int N, K, P, Pt, reps;
};

using mfhe::cp_async16;
using mfhe::cp_async_commit;
using mfhe::cp_async_wait;
using mfhe::fence_regs;
using mfhe::smem_desc;

__device__ __forceinline__ void vpu_round(uint32_t& a, uint32_t& b) {
  uint32_t m = (a & 0x0FFFFFFFu) * 0x9E3779B1u;
  uint32_t u = m + (b >> 7);
  uint32_t c = u < m ? 1u : 0u;
  uint32_t v = (u << 4) | (a >> 28);
  uint32_t w = v + c + (m >> 28);
  a = w > 0x7FFFFFFFu ? w - 0x7FFFFFFFu : w;
  b = u;
}

// The rounds of K-tile kt of KT: groups i with i KT / 16 == kt, so each
// element has one round a rep whatever KT is.
__device__ __forceinline__ void spread_rounds(uint32_t (&av)[E], uint32_t (&bv)[E],
                                              int kt, int KT) {
#pragma unroll
  for (int i = 0; i < GROUPS; ++i)
    if (i * KT / GROUPS == kt) {
#pragma unroll
      for (int e = 4 * i; e < 4 * i + 4; ++e) vpu_round(av[e], bv[e]);
    }
}

// t8 [Pt, K, N] -> t8t [Pt, N, K], 32 x 32 byte tiles, K % 32 == N % 32 == 0
__global__ void coissue_transpose(const int8_t* __restrict__ t8,
                                  int8_t* __restrict__ t8t, int K, int N) {
  __shared__ int8_t tile[32][33];
  const long long p = blockIdx.z;
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) tile[i][tx] = t8[(p * K + k0 + i) * N + n0 + tx];
  __syncthreads();
  for (int i = ty; i < 32; i += 8) t8t[(p * N + n0 + i) * K + k0 + tx] = tile[tx][i];
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) coissue_kernel(const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const long long g = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // this thread's elements: e = 4 j + 2 h + i at row rbase + 8 h, column
  // 8 j + 2 (lane % 4) + i of the block tile (wgmma's accumulator fragment)
  const int rbase = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cbase = col0 + 2 * (lane & 3);
  const long long cell = g * p.N * p.N;

  uint32_t av[E], bv[E];
  int acc[E];
#pragma unroll
  for (int j = 0; j < E / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long idx = cell + static_cast<long long>(rbase + 8 * h) * p.N + cbase + 8 * j;
      const uint2 x = *reinterpret_cast<const uint2*>(p.a + idx);
      const uint2 y = *reinterpret_cast<const uint2*>(p.b + idx);
      av[4 * j + 2 * h] = x.x;
      av[4 * j + 2 * h + 1] = x.y;
      bv[4 * j + 2 * h] = y.x;
      bv[4 * j + 2 * h + 1] = y.y;
      acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0;
    }

  if (MODE == VPU) {
    for (int rep = 0; rep < p.reps; ++rep) {
#pragma unroll
      for (int e = 0; e < E; ++e) vpu_round(av[e], bv[e]);
    }
  } else {
    const int KT = (p.K + BK - 1) / BK, T = p.reps * KT;
    auto load = [&](int t) {
      const int rep = t / KT, k0 = (t - rep * KT) * BK;
      const uint32_t sa = sbase + (t % STAGES) * STAGE_BYTES, sb = sa + A_BYTES;
      const int8_t* da = p.d8 + ((g * p.P + rep % p.P) * p.N + row0) * p.K;
      const int8_t* db = p.t8t + (static_cast<long long>(rep % p.Pt) * p.N + col0) * p.K;
      for (int i = tid; i < BM * 8; i += THREADS) {
        const int r = i >> 3, ch = i & 7, kb = k0 + 16 * ch;
        const bool ok = kb < p.K;
        cp_async16(sa + r * BK + ((ch ^ (r & 7)) << 4),
                   ok ? da + static_cast<long long>(r) * p.K + kb : p.d8, ok ? 16 : 0);
      }
      for (int i = tid; i < BN * 8; i += THREADS) {
        const int r = i >> 3, ch = i & 7, kb = k0 + 16 * ch;
        const bool ok = kb < p.K;
        cp_async16(sb + r * BK + ((ch ^ (r & 7)) << 4),
                   ok ? db + static_cast<long long>(r) * p.K + kb : p.t8t, ok ? 16 : 0);
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 2; ++s) {
      if (s < T) load(s);
      cp_async_commit();
    }
    for (int t = 0; t < T; ++t) {
      cp_async_wait<STAGES - 3>();   // this thread's copies of tile t landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();               // everyone's; tile t - 2's products done
      if (t + STAGES - 2 < T) load(t + STAGES - 2);
      cp_async_commit();
      if (MODE == DMA) continue;
      const int rep = t / KT, kt = t - rep * KT;
      if (MODE == DEP && kt == 0 && rep > 0) {
        // rep - 1's round consumes acc after its dot: drain, take a ^= acc
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(acc);
#pragma unroll
        for (int e = 0; e < E; ++e) av[e] ^= static_cast<uint32_t>(acc[e]);
      }
      const uint32_t sa = sbase + (t % STAGES) * STAGE_BYTES + wg * (64 * BK);
      const uint32_t sb = sbase + (t % STAGES) * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        mfhe::wgmma8<4, true>(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk),
                              (t > 0 || kk > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the integer work of this rep (both) or of the last one (dep), with
      // this tile's products in flight
      if (MODE == BOTH || (MODE == DEP && rep > 0)) spread_rounds(av, bv, kt, KT);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(acc);
    }
    if (MODE != DMA) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
    }
    if (MODE == DEP && p.reps > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        av[e] ^= static_cast<uint32_t>(acc[e]);
        vpu_round(av[e], bv[e]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < E / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long idx = cell + static_cast<long long>(rbase + 8 * h) * p.N + cbase + 8 * j;
      const bool dots = MODE == MXU || MODE == BOTH || MODE == DEP;
      *reinterpret_cast<int2*>(p.o32 + idx) =
          make_int2(dots ? acc[4 * j + 2 * h] : 0, dots ? acc[4 * j + 2 * h + 1] : 0);
      *reinterpret_cast<uint2*>(p.ou + idx) =
          make_uint2(av[4 * j + 2 * h], av[4 * j + 2 * h + 1]);
    }
}

template <int MODE>
int launch(const Args& p, int G, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(
      coissue_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(p.N / BN, p.N / BM, G);
  coissue_kernel<MODE><<<grid, THREADS, SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 dma, 1 mxu (and dma+mxu), 2 vpu, 3 both, 4 dep.  d8 [G, P, N, K],
// t8 [1, Pt, K, N] int8, t8t scratch [Pt, N, K]; a, b, o32, ou [G, N, N];
// all 16-byte aligned, N % 128 == 0, K % 32 == 0 (the wrapper checks).  The
// transpose of t8 into t8t, then the probe; vpu reads no int8 operand.
extern "C" int mf_coissue(const void* d8, const void* t8, void* t8t, const void* a,
                          const void* b, void* o32, void* ou, int G, int N, int K,
                          int P, int Pt, int reps, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < DMA || mode > DEP || N % BN || K % 32 || N < BN || K < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != VPU) {
    coissue_transpose<<<dim3(N / 32, K / 32, Pt), dim3(32, 8), 0, s>>>(
        static_cast<const int8_t*>(t8), static_cast<int8_t*>(t8t), K, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args p{static_cast<const int8_t*>(d8), static_cast<const int8_t*>(t8t),
               static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
               static_cast<int32_t*>(o32), static_cast<uint32_t*>(ou), N, K, P, Pt, reps};
  switch (mode) {
    case DMA: return launch<DMA>(p, G, s);
    case MXU: return launch<MXU>(p, G, s);
    case VPU: return launch<VPU>(p, G, s);
    case BOTH: return launch<BOTH>(p, G, s);
    default: return launch<DEP>(p, G, s);
  }
}
