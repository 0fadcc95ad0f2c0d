// K12: the co-issue probe, int8 tensor-core dots interleaved with u32
// chains.
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
// The dot is written by hand on the int8 tensor cores: mma.sync m16n8k32
// s8 x s8 -> s32, a 64 x 64 output tile per block of four warps (32 x 32 a
// warp), K in steps of 32 through shared memory with t8 staged transposed
// (Bs[n][k], the "col" operand).  The u32 rounds run on the 32 elements
// each thread owns in its accumulator fragment.  In "both" the round of
// element e runs after k-step e of the same rep; in "dep" the round of rep
// r runs on a snapshot of acc_r during rep r + 1's k-steps (software
// pipelining), the last one after the loop.  So the compiler may overlap
// the integer work with the tensor-core work wherever the data allow, and
// the times of both and dep against mxu and vpu say whether the card does.
//
// Bound on the H100: at these tile sizes (32 products a byte of shared
// traffic) the dots are bound by shared-memory and L2 bandwidth, not by
// the tensor cores; a faster probe (wgmma, TMA, larger tiles) is later
// work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64, BN = 64, BKS = 32, THREADS = 128, LD = 48;
enum { DMA = 0, MXU = 1, VPU = 2, BOTH = 3, DEP = 4 };

__device__ __forceinline__ void vpu_round(uint32_t& a, uint32_t& b) {
  uint32_t m = (a & 0x0FFFFFFFu) * 0x9E3779B1u;
  uint32_t u = m + (b >> 7);
  uint32_t c = u < m ? 1u : 0u;
  uint32_t v = (u << 4) | (a >> 28);
  uint32_t w = v + c + (m >> 28);
  a = w > 0x7FFFFFFFu ? w - 0x7FFFFFFFu : w;
  b = u;
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (row, col) in the block tile of fragment element e = (mt * 4 + nt) * 4 + i
__device__ __forceinline__ void owned(int e, int warp, int lane, int& r,
                                      int& c) {
  const int mt = e >> 4, nt = (e >> 2) & 3, i = e & 3;
  r = (warp >> 1) * 32 + mt * 16 + (lane >> 2) + (i >> 1) * 8;
  c = (warp & 1) * 32 + nt * 8 + (lane & 3) * 2 + (i & 1);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
coissue_kernel(const int8_t* __restrict__ d8, const int8_t* __restrict__ t8,
               const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
               int32_t* __restrict__ o32, uint32_t* __restrict__ ou, int N,
               int K, int P, int Pt, int reps) {
  __shared__ __align__(16) int8_t As[BM][LD];
  __shared__ __align__(16) int8_t Bs[BN][LD];
  const int g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long cell = (long long)g * N * N;

  uint32_t av[32], bv[32];
  int acc[32], snap[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    int r, c;
    owned(e, warp, lane, r, c);
    const long long idx = cell + (long long)(row0 + r) * N + col0 + c;
    av[e] = A[idx];
    bv[e] = B[idx];
    acc[e] = 0;
    snap[e] = 0;
  }

  if (MODE == VPU) {
    for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
      for (int e = 0; e < 32; ++e) vpu_round(av[e], bv[e]);
    }
  } else {
    const int nsteps = K / BKS;
    const int ar = tid >> 1, ah = tid & 1;   // A tile: row, 16-byte half
    const int bk = tid >> 2, bc = tid & 3;   // B tile: k row, 16-byte chunk
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int gr = lane >> 2, tq = lane & 3;
    for (int rep = 0; rep < reps; ++rep) {
      const int8_t* dA = d8 + (((long long)g * P + rep % P) * N + row0) * K;
      const int8_t* dB = t8 + (long long)(rep % Pt) * K * N + col0;
      if (MODE == DEP) {
#pragma unroll
        for (int e = 0; e < 32; ++e) snap[e] = acc[e];
      }
      for (int ks = 0; ks < nsteps; ks += 32) {
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const int k0 = (ks + u) * BKS;
          if (k0 >= K) break;
          *reinterpret_cast<uint4*>(&As[ar][ah * 16]) =
              *reinterpret_cast<const uint4*>(dA + (long long)ar * K + k0 +
                                              ah * 16);
          const uint4 bw = *reinterpret_cast<const uint4*>(
              dB + (long long)(k0 + bk) * N + bc * 16);
          const uint32_t words[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            Bs[bc * 16 + j][bk] = (int8_t)(words[j >> 2] >> (8 * (j & 3)));
          __syncthreads();
          if (MODE != DMA) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const int8_t* ap = &As[wm + mt * 16 + gr][tq * 4];
              const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
              const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LD);
              const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
              const uint32_t a3 =
                  *reinterpret_cast<const uint32_t*>(ap + 8 * LD + 16);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int8_t* bp = &Bs[wn + nt * 8 + gr][tq * 4];
                mma_s8(&acc[(mt * 4 + nt) * 4], a0, a1, a2, a3,
                       *reinterpret_cast<const uint32_t*>(bp),
                       *reinterpret_cast<const uint32_t*>(bp + 16));
              }
            }
          }
          __syncthreads();
          if (ks == 0) {
            if (MODE == BOTH) vpu_round(av[u], bv[u]);
            if (MODE == DEP && rep > 0) {
              av[u] ^= (uint32_t)snap[u];
              vpu_round(av[u], bv[u]);
            }
          }
        }
      }
      // elements whose round had no k-step of their own (K < 32 * 32)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (e < nsteps) continue;
        if (MODE == BOTH) vpu_round(av[e], bv[e]);
        if (MODE == DEP && rep > 0) {
          av[e] ^= (uint32_t)snap[e];
          vpu_round(av[e], bv[e]);
        }
      }
    }
    if (MODE == DEP && reps > 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        av[e] ^= (uint32_t)acc[e];
        vpu_round(av[e], bv[e]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 32; ++e) {
    int r, c;
    owned(e, warp, lane, r, c);
    const long long idx = cell + (long long)(row0 + r) * N + col0 + c;
    o32[idx] = (MODE == VPU || MODE == DMA) ? 0 : acc[e];
    ou[idx] = av[e];
  }
}

}  // namespace

// mode: 0 dma, 1 mxu (and dma+mxu), 2 vpu, 3 both, 4 dep.  N % 64 == 0,
// K % 32 == 0 (the wrapper checks); grid (N / 64, N / 64, G).
extern "C" int mf_coissue(const void* d8, const void* t8, const void* a,
                          const void* b, void* o32, void* ou, int G, int N,
                          int K, int P, int Pt, int reps, int mode,
                          void* stream) {
  dim3 grid(N / BN, N / BM, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* d = static_cast<const int8_t*>(d8);
  const int8_t* t = static_cast<const int8_t*>(t8);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  int32_t* po = static_cast<int32_t*>(o32);
  uint32_t* pu = static_cast<uint32_t*>(ou);
#define MF_COISSUE(M) \
  coissue_kernel<M><<<grid, THREADS, 0, s>>>(d, t, pa, pb, po, pu, N, K, P, Pt, reps)
  switch (mode) {
    case DMA: MF_COISSUE(DMA); break;
    case MXU: MF_COISSUE(MXU); break;
    case VPU: MF_COISSUE(VPU); break;
    case BOTH: MF_COISSUE(BOTH); break;
    case DEP: MF_COISSUE(DEP); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MF_COISSUE
  return static_cast<int>(cudaGetLastError());
}
