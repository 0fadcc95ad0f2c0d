// K1 and K10a: one exact modular matmul stage per RNS limb, optionally
// followed by a per-output Montgomery twiddle.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_stage_kernel
// (SlicedStage): C[l] = A[l] @ B[l] mod q_l with canonical int64 output and
// q_l < 2^56.  The W-CRT forward is A = table [L, W, W], B = data [L, W, M];
// the X-NTT ("right" side) is A = data [L, R, n], B = table^T (strides).
//
// Also replaces pallas_ntt.py:_stage_kernel (PallasStage) with its twiddle:
// the output is multiplied by tw[l, row mod tw_rows, col] in the JAX storage
// form tw * 2^64 mod q, one Montgomery product (R = 2^64) in the epilogue, so
// the result is (sum mod q) * tw mod q.  Side "batched_left" runs the
// leading batch axis of D [L, B, K, M] in the grid (blockIdx.z = l * B + b)
// with the table shared across the batch.  The key switch uses the twiddle
// to fuse an X-NTT with the pointwise product by a key in storage form.
//
// Bound on the H100: 64 x 64 -> 128-bit integer multiply-adds (no tensor
// core takes 64-bit integers), about 12 integer instructions each.  The
// design keeps the operands in shared memory tiles (64 x 16 per side) so
// every loaded residue feeds 4 x 4 outputs from registers, accumulates
// lazily in 128 bits (products < 2^112, so K <= 2^16 terms cannot overflow,
// the bound the wrapper enforces) and reduces once per output.  All limbs
// (and batch entries) run in one launch.  The TPU's int8 digit planes,
// R = 2^28 folds and limb runs have no counterpart here.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
stage_kernel(const int64_t* __restrict__ A, const int64_t* __restrict__ B,
             int64_t* __restrict__ C, const int64_t* __restrict__ consts,
             const int64_t* __restrict__ tw, int M, int N, int K, int batch,
             int tw_rows, long long sAl, long long sAb, long long sAm,
             long long sAk, long long sBl, long long sBb, long long sBk,
             long long sBn) {
  __shared__ uint64_t As[BK][BM];
  __shared__ uint64_t Bs[BK][BN];
  const int z = blockIdx.z;
  const int l = z / batch, bi = z % batch;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const uint64_t* a = reinterpret_cast<const uint64_t*>(A) + l * sAl + bi * sAb;
  const uint64_t* b = reinterpret_cast<const uint64_t*>(B) + l * sBl + bi * sBb;

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
  int64_t* out = C + (long long)z * M * N;
  const uint64_t* twl =
      tw ? reinterpret_cast<const uint64_t*>(tw) + (long long)l * tw_rows * N
         : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gn = col0 + tx + 16 * j;
      if (gn >= N) continue;
      uint64_t v = mfhe::reduce128(hi[i][j], lo[i][j], c);
      if (twl) v = mfhe::mont_mul(v, twl[(long long)(gm % tw_rows) * N + gn], c);
      out[(long long)gm * N + gn] = static_cast<int64_t>(v);
    }
  }
}

}  // namespace

// tw may be null (plain K1); otherwise [L, tw_rows, N] in storage form.
extern "C" int mf_stage(const int64_t* A, const int64_t* B, int64_t* C,
                        const int64_t* consts, const int64_t* tw, int L,
                        int batch, int M, int N, int K, int tw_rows,
                        long long sAl, long long sAb, long long sAm,
                        long long sAk, long long sBl, long long sBb,
                        long long sBk, long long sBn, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, L * batch);
  stage_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, consts, tw, M, N, K, batch, tw_rows, sAl, sAb, sAm, sAk, sBl,
      sBb, sBk, sBn);
  return static_cast<int>(cudaGetLastError());
}
