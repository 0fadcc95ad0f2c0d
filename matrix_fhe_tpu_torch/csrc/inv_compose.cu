// K3: scaled W-CRT inverse fused with the CRT-compose partials (decode).
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_inv_compose_kernel
// (SlicedInvCompose).  For eval residues x [L, W, M] and inverse tables
// with M_l^-1 mod q_l folded in, T' [L, W, W]:
//   r'_l = (T'_l @ x_l) mod q_l
//   acc  = sum_l r'_l * (M_l mod 2^64)  mod 2^64     (wrapping uint64)
//   k    = round(sum_l r'_l / q_l)                   (f64 sum, half-even)
// The host tail (ops/ddfloat.compose_tail_from_partials) takes
// (acc - k * Q) mod 2^64 as a signed integer and divides by Delta.
//
// Bound on the H100: the L x W 128-bit multiply-adds per output, as in K1.
// On the TPU the limb loop is a sequential grid axis carrying the sums in
// VMEM; Hopper blocks carry nothing across the grid, so each block loops
// over all L limbs itself and keeps acc and k in registers, and r' never
// reaches device memory.  The f32 k sums of the TPU kernel become f64.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 16, TM = 2, TN = 4, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
inv_compose_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ t,
                   const int64_t* __restrict__ consts, const int64_t* __restrict__ m64,
                   int64_t* __restrict__ acc_out, int64_t* __restrict__ k_out,
                   int L, int W, int K, int M) {
  __shared__ uint64_t As[BK][BM];
  __shared__ uint64_t Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  uint64_t acc[TM][TN];
  double kf[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0;
      kf[i][j] = 0.0;
    }

  for (int l = 0; l < L; ++l) {
    const uint64_t* a = reinterpret_cast<const uint64_t*>(t) + (long long)l * W * K;
    const uint64_t* b = reinterpret_cast<const uint64_t*>(x) + (long long)l * K * M;
    uint64_t hi[TM][TN], lo[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) hi[i][j] = lo[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        int kk = e % BK, mm = e / BK;
        int gm = row0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < W && gk < K) ? a[(long long)gm * K + gk] : 0;
      }
      for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
        int nn = e % BN, kk = e / BN;
        int gn = col0 + nn, gk = k0 + kk;
        Bs[kk][nn] = (gn < M && gk < K) ? b[(long long)gk * M + gn] : 0;
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
    const uint64_t ml = static_cast<uint64_t>(m64[l]);
    const double qd = static_cast<double>(c.q);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        uint64_t r = mfhe::reduce128(hi[i][j], lo[i][j], c);
        acc[i][j] += r * ml;
        kf[i][j] += static_cast<double>(r) / qd;
      }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gm = row0 + ty + 16 * i;
    if (gm >= W) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gn = col0 + tx + 16 * j;
      if (gn < M) {
        acc_out[(long long)gm * M + gn] = static_cast<int64_t>(acc[i][j]);
        k_out[(long long)gm * M + gn] = static_cast<int64_t>(rint(kf[i][j]));
      }
    }
  }
}

}  // namespace

extern "C" int mf_inv_compose(const int64_t* x, const int64_t* t, const int64_t* consts,
                              const int64_t* m64, int64_t* acc, int64_t* k,
                              int L, int W, int K, int M, void* stream) {
  dim3 grid((M + BN - 1) / BN, (W + BM - 1) / BM);
  inv_compose_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, t, consts, m64, acc, k, L, W, K, M);
  return static_cast<int>(cudaGetLastError());
}
