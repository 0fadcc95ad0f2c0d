// K7: the gl2 ciphertext GEMM's tensor step, four modular GEMMs in one launch.
//
// Replaces matrix_fhe_tpu/ops/pallas_cgemm.py:_gemm2x2_kernel (SlicedGemm2x2):
//   E_ij[l, w, a, b] = scale * sum_y U_i[l, w, y, a] * V_j[l, w, y, b] mod q_l
// for i, j in {1, 2}, on canonical int64 residues [L, W, y, m] (contraction
// over the second-to-last axis of both), q_l < 2^56, outputs [4, L, W, m, m]
// in the order E00 = U1 V1, E01 = U1 V2, E10 = U2 V1, E11 = U2 V2.
//
// Bound on the H100: 4 m^2 y 64 x 64 -> 128-bit integer multiply-adds per
// (limb, lane) on the integer pipes; at ref (y = 64, m = 128, 11 x 512
// lanes) 23.6 G of them against ~1.5 GB of traffic.  The TPU builds the
// products from int8 digit planes, pre-reduces V per digit and folds with
// R = 2^28 constants; none of that carries over.  What does is the sharing:
// one block loads tiles of U1, U2, V1 and V2 once and every loaded residue
// feeds both products it belongs to.  Each output keeps a lazy unsigned
// 128-bit sum (y <= 2^16 products < 2^112) reduced once, and `scale` rides
// in the reduction's last Montgomery constant (consts[l][2] = scale * 2^128
// mod q).  Tiles: 16-deep slices of a 64-wide U tile and a 32-wide V tile in
// shared memory, 4 x 2 outputs of each of the four products per thread, one
// block per (64 x 32 output tile, limb, lane).
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 64, BN = 32, BK = 16, TM = 4, TN = 2, THREADS = 256;
static_assert(BM == 16 * TM && BN == 16 * TN, "16 x 16 threads cover the tile");

__global__ void __launch_bounds__(THREADS)
gemm2x2_kernel(const int64_t* __restrict__ U1, const int64_t* __restrict__ U2,
               const int64_t* __restrict__ V1, const int64_t* __restrict__ V2,
               const int64_t* __restrict__ consts, int64_t* __restrict__ E,
               int L, int W, int y, int m) {
  __shared__ uint64_t U1s[BK][BM], U2s[BK][BM], V1s[BK][BN], V2s[BK][BN];
  const int lw = blockIdx.z, l = lw / W;
  const long long in_base = static_cast<long long>(lw) * y * m;
  const long long out_base = static_cast<long long>(lw) * m * m;
  const long long plane = static_cast<long long>(L) * W * m * m;
  const mfhe::LimbConsts c = mfhe::load_consts(consts, l);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int a0 = blockIdx.y * BM, b0 = blockIdx.x * BN;
  const uint64_t* u1 = reinterpret_cast<const uint64_t*>(U1) + in_base;
  const uint64_t* u2 = reinterpret_cast<const uint64_t*>(U2) + in_base;
  const uint64_t* v1 = reinterpret_cast<const uint64_t*>(V1) + in_base;
  const uint64_t* v2 = reinterpret_cast<const uint64_t*>(V2) + in_base;

  // hi / lo words of the four products' sums, [product][row][column]
  uint64_t hi[4][TM][TN], lo[4][TM][TN];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) hi[p][i][j] = lo[p][i][j] = 0;

  for (int k0 = 0; k0 < y; k0 += BK) {
    // the output index is the last axis of both operands: neighbouring
    // threads read neighbouring a (b)
    for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
      const int kk = e / BM, aa = e % BM, gk = k0 + kk, ga = a0 + aa;
      const bool ok = gk < y && ga < m;
      const long long o = static_cast<long long>(gk) * m + ga;
      U1s[kk][aa] = ok ? u1[o] : 0;
      U2s[kk][aa] = ok ? u2[o] : 0;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN, bb = e % BN, gk = k0 + kk, gb = b0 + bb;
      const bool ok = gk < y && gb < m;
      const long long o = static_cast<long long>(gk) * m + gb;
      V1s[kk][bb] = ok ? v1[o] : 0;
      V2s[kk][bb] = ok ? v2[o] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      uint64_t x1[TM], x2[TM], z1[TN], z2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        x1[i] = U1s[kk][ty + 16 * i];
        x2[i] = U2s[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        z1[j] = V1s[kk][tx + 16 * j];
        z2[j] = V2s[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          mfhe::mac_u128(hi[0][i][j], lo[0][i][j], x1[i], z1[j]);
          mfhe::mac_u128(hi[1][i][j], lo[1][i][j], x1[i], z2[j]);
          mfhe::mac_u128(hi[2][i][j], lo[2][i][j], x2[i], z1[j]);
          mfhe::mac_u128(hi[3][i][j], lo[3][i][j], x2[i], z2[j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ga = a0 + ty + 16 * i;
    if (ga >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gb = b0 + tx + 16 * j;
      if (gb >= m) continue;
      const long long o = out_base + static_cast<long long>(ga) * m + gb;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        E[p * plane + o] = static_cast<int64_t>(mfhe::reduce128(hi[p][i][j], lo[p][i][j], c));
    }
  }
}

}  // namespace

extern "C" int mf_gemm2x2(const int64_t* u1, const int64_t* u2, const int64_t* v1,
                          const int64_t* v2, const int64_t* consts, int64_t* e,
                          int L, int W, int y, int m, void* stream) {
  dim3 grid((m + BN - 1) / BN, (m + BM - 1) / BM, L * W);
  gemm2x2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      u1, u2, v1, v2, consts, e, L, W, y, m);
  return static_cast<int>(cudaGetLastError());
}
