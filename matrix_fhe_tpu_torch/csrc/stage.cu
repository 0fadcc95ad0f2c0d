// K1: one exact modular matmul stage per RNS limb.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_stage_kernel
// (SlicedStage): C[l] = A[l] @ B[l] mod q_l with canonical int64 output and
// q_l < 2^56.  The W-CRT forward is A = table [L, W, W], B = data [L, W, M];
// the X-NTT ("right" side) is A = data [L, R, n], B = table^T (strides).
//
// Bound on the H100: 64 x 64 -> 128-bit integer multiply-adds (no tensor
// core takes 64-bit integers), about 12 integer instructions each.  The
// design keeps the operands in shared memory tiles (64 x 16 per side) so
// every loaded residue feeds 4 x 4 outputs from registers, accumulates
// lazily in 128 bits (products < 2^112, K <= 512) and reduces once per
// output.  All limbs run in one launch (blockIdx.z = limb).  The TPU's int8
// digit planes, R = 2^28 folds and limb runs have no counterpart here.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
stage_kernel(const int64_t* __restrict__ A, const int64_t* __restrict__ B,
             int64_t* __restrict__ C, const int64_t* __restrict__ consts,
             int M, int N, int K, long long sAl, long long sAm, long long sAk,
             long long sBl, long long sBk, long long sBn) {
  __shared__ uint64_t As[BK][BM];
  __shared__ uint64_t Bs[BK][BN];
  const int l = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const uint64_t* a = reinterpret_cast<const uint64_t*>(A) + l * sAl;
  const uint64_t* b = reinterpret_cast<const uint64_t*>(B) + l * sBl;

  uint64_t hi[TM][TN], lo[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) hi[i][j] = lo[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      int kk = e % BK, mm = e / BK;
      int gm = row0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? a[gm * sAm + gk * sAk] : 0;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      int nn = e % BN, kk = e / BN;
      int gn = col0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? b[gk * sBk + gn * sBn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint64_t av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mfhe::mac_u128(hi[i][j], lo[i][j], av[i], bv[j]);
    }
    __syncthreads();
  }

  const mfhe::LimbConsts c = mfhe::load_consts(consts, l);
  int64_t* out = C + (long long)l * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gn = col0 + tx + 16 * j;
      if (gn < N)
        out[(long long)gm * N + gn] =
            static_cast<int64_t>(mfhe::reduce128(hi[i][j], lo[i][j], c));
    }
  }
}

}  // namespace

extern "C" int mf_stage(const int64_t* A, const int64_t* B, int64_t* C,
                        const int64_t* consts, int L, int M, int N, int K,
                        long long sAl, long long sAm, long long sAk,
                        long long sBl, long long sBk, long long sBn,
                        void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, L);
  stage_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, consts, M, N, K, sAl, sAm, sAk, sBl, sBk, sBn);
  return static_cast<int>(cudaGetLastError());
}
