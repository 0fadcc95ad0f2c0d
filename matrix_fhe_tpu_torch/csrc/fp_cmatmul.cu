// K4: exact fixed-point complex matmul Y = T @ X over scaled integers.
//
// Replaces matrix_fhe_tpu/ops/fpmatmul.py:_fp_cmatmul_kernel
// (ExactComplexMatmul).  T is the table quantized to t_int =
// round(T * 2^t_bits) (|t_int| < 2^34), X the input scaled to |x_int| <=
// 2^37; both arrive as int64.  For each output the kernel forms the exact
// sums  re = sum_k tr*xr - ti*xi  and  im = sum_k tr*xi + ti*xr  in 128-bit
// two's complement (|sum| < 2^81) and writes sign plus 96-bit magnitude as
// the words (m0, m1, m2, sg), each an int64 holding a u32 value, bit-identical
// to the TPU kernel's output planes.
//
// Bound on the H100: 4 signed 64 x 64 -> 128-bit multiply-adds per complex
// term.  The design tiles T and X through shared memory (32 x 16 and 16 x 64)
// so each loaded value feeds 2 x 4 outputs; the TPU's balanced int8 digit
// planes and its Karatsuba diagonal packing are not carried over.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 16, TM = 2, TN = 4, THREADS = 256;

__device__ __forceinline__ void store_words(int64_t* out, long long plane, long long idx,
                                            int64_t hi, uint64_t lo) {
  const bool neg = hi < 0;
  uint64_t mlo = lo, mhi = static_cast<uint64_t>(hi);
  if (neg) {
    mlo = ~lo + 1ull;
    mhi = ~mhi + (lo == 0 ? 1ull : 0ull);
  }
  out[0 * plane + idx] = static_cast<int64_t>(mlo & 0xFFFFFFFFull);
  out[1 * plane + idx] = static_cast<int64_t>(mlo >> 32);
  out[2 * plane + idx] = static_cast<int64_t>(mhi & 0xFFFFFFFFull);
  out[3 * plane + idx] = neg ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
fp_cmatmul_kernel(const int64_t* __restrict__ tr, const int64_t* __restrict__ ti,
                  const int64_t* __restrict__ xr, const int64_t* __restrict__ xi,
                  int64_t* __restrict__ out, int W, int K, int M) {
  __shared__ int64_t Ar[BK][BM], Ai[BK][BM];
  __shared__ int64_t Br[BK][BN], Bi[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  int64_t rhi[TM][TN], ihi[TM][TN];
  uint64_t rlo[TM][TN], ilo[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      rhi[i][j] = ihi[i][j] = 0;
      rlo[i][j] = ilo[i][j] = 0;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      int kk = e % BK, mm = e / BK;
      int gm = row0 + mm, gk = k0 + kk;
      bool ok = gm < W && gk < K;
      Ar[kk][mm] = ok ? tr[(long long)gm * K + gk] : 0;
      Ai[kk][mm] = ok ? ti[(long long)gm * K + gk] : 0;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      int nn = e % BN, kk = e / BN;
      int gn = col0 + nn, gk = k0 + kk;
      bool ok = gn < M && gk < K;
      Br[kk][nn] = ok ? xr[(long long)gk * M + gn] : 0;
      Bi[kk][nn] = ok ? xi[(long long)gk * M + gn] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      int64_t ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = Ar[kk][ty + 16 * i];
        ai[i] = Ai[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = Br[kk][tx + 16 * j];
        bi[j] = Bi[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          mfhe::mac_s128(rhi[i][j], rlo[i][j], ar[i], br[j]);
          mfhe::mac_s128(rhi[i][j], rlo[i][j], -ai[i], bi[j]);
          mfhe::mac_s128(ihi[i][j], ilo[i][j], ar[i], bi[j]);
          mfhe::mac_s128(ihi[i][j], ilo[i][j], ai[i], br[j]);
        }
    }
    __syncthreads();
  }

  const long long plane = (long long)W * M;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gm = row0 + ty + 16 * i;
    if (gm >= W) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gn = col0 + tx + 16 * j;
      if (gn >= M) continue;
      long long idx = (long long)gm * M + gn;
      store_words(out, plane, idx, rhi[i][j], rlo[i][j]);
      store_words(out + 4 * plane, plane, idx, ihi[i][j], ilo[i][j]);
    }
  }
}

}  // namespace

extern "C" int mf_fp_cmatmul(const int64_t* tr, const int64_t* ti, const int64_t* xr,
                             const int64_t* xi, int64_t* out, int W, int K, int M,
                             void* stream) {
  dim3 grid((M + BN - 1) / BN, (W + BM - 1) / BM);
  fp_cmatmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tr, ti, xr, xi, out, W, K, M);
  return static_cast<int>(cudaGetLastError());
}
