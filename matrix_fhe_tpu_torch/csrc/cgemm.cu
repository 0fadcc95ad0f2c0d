// K6: the trace GEMM, C = scale * A @ B^T mod q_l, complex, per (limb, lane).
//
// Replaces matrix_fhe_tpu/ops/pallas_cgemm.py:_cgemm_kernel (SlicedCGemm):
//   re[l,w,r,c] = scale * sum_t (Ar[r,t] Br[c,t] - Ai[r,t] Bi[c,t]) mod q_l
//   im[l,w,r,c] = scale * sum_t (Ar[r,t] Bi[c,t] + Ai[r,t] Br[c,t]) mod q_l
// on canonical int64 residues [L, W, n, n], q_l < 2^56, n < 2^15.
//
// Bound on the H100: 4 n^3 64 x 64 -> 128-bit integer multiply-adds per
// (limb, lane) on the integer pipes (no tensor core takes 64-bit integers);
// at ref (n = 64, 11 x 512 lanes) 5.9 G of them against ~0.7 GB of traffic.
// The TPU builds the products from int8 digit planes, pre-reduces B per
// digit and folds with R = 2^28 constants.  Here the subtraction is folded
// into the sum instead (-Bi = q - Bi mod q), so each output keeps two lazy
// unsigned 128-bit sums (2n products < 2^112 stay below 2^128) and is
// reduced once; `scale` rides in the reduction's last Montgomery constant
// (consts[l][2] = scale * 2^128 mod q).  Tiles follow stage.cu: 64 x 16
// operand tiles in shared memory, 4 x 4 outputs per thread, one block per
// (64 x 64 output tile, limb, lane).
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;
static_assert(BM == BN, "the tile loader fills A and B rows together");

__global__ void __launch_bounds__(THREADS)
cgemm_kernel(const int64_t* __restrict__ Ar, const int64_t* __restrict__ Ai,
             const int64_t* __restrict__ Br, const int64_t* __restrict__ Bi,
             const int64_t* __restrict__ consts, int64_t* __restrict__ Cr,
             int64_t* __restrict__ Ci, int W, int n) {
  __shared__ uint64_t Ars[BK][BM], Ais[BK][BM], Brs[BK][BN], Bis[BK][BN];
  const int lw = blockIdx.z, l = lw / W;
  const long long base = static_cast<long long>(lw) * n * n;
  const mfhe::LimbConsts c = mfhe::load_consts(consts, l);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const uint64_t* ar = reinterpret_cast<const uint64_t*>(Ar) + base;
  const uint64_t* ai = reinterpret_cast<const uint64_t*>(Ai) + base;
  const uint64_t* br = reinterpret_cast<const uint64_t*>(Br) + base;
  const uint64_t* bi = reinterpret_cast<const uint64_t*>(Bi) + base;

  uint64_t rh[TM][TN], rl[TM][TN], ih[TM][TN], il[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) rh[i][j] = rl[i][j] = ih[i][j] = il[i][j] = 0;

  for (int k0 = 0; k0 < n; k0 += BK) {
    // both operands are row-major with the contraction index last:
    // neighbouring threads read neighbouring t
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int kk = e % BK, rr = e / BK, gk = k0 + kk;
      const int gm = row0 + rr, gn = col0 + rr;
      const bool ka = gm < n && gk < n, kb = gn < n && gk < n;
      Ars[kk][rr] = ka ? ar[static_cast<long long>(gm) * n + gk] : 0;
      Ais[kk][rr] = ka ? ai[static_cast<long long>(gm) * n + gk] : 0;
      Brs[kk][rr] = kb ? br[static_cast<long long>(gn) * n + gk] : 0;
      Bis[kk][rr] = kb ? bi[static_cast<long long>(gn) * n + gk] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      uint64_t a_r[TM], a_i[TM], b_r[TN], b_i[TN], b_n[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a_r[i] = Ars[kk][ty + 16 * i];
        a_i[i] = Ais[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_r[j] = Brs[kk][tx + 16 * j];
        b_i[j] = Bis[kk][tx + 16 * j];
        b_n[j] = c.q - b_i[j];                     // -Bi mod q, in (0, q]
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          mfhe::mac_u128(rh[i][j], rl[i][j], a_r[i], b_r[j]);
          mfhe::mac_u128(rh[i][j], rl[i][j], a_i[i], b_n[j]);
          mfhe::mac_u128(ih[i][j], il[i][j], a_r[i], b_i[j]);
          mfhe::mac_u128(ih[i][j], il[i][j], a_i[i], b_r[j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn >= n) continue;
      const long long o = base + static_cast<long long>(gm) * n + gn;
      Cr[o] = static_cast<int64_t>(mfhe::reduce128(rh[i][j], rl[i][j], c));
      Ci[o] = static_cast<int64_t>(mfhe::reduce128(ih[i][j], il[i][j], c));
    }
  }
}

}  // namespace

extern "C" int mf_cgemm(const int64_t* ar, const int64_t* ai, const int64_t* br,
                        const int64_t* bi, const int64_t* consts, int64_t* cr,
                        int64_t* ci, int L, int W, int n, void* stream) {
  dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM, L * W);
  cgemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ar, ai, br, bi, consts, cr, ci, W, n);
  return static_cast<int>(cudaGetLastError());
}
