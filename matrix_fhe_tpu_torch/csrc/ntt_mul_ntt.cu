// K2: fused t = iNTT_X(NTT_X(a) (*) s) mod q_l, the encrypt/decrypt hot path.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_mul_ntt_kernel
// (SlicedNttMulNtt).  a is [L, R, n] rows of X-coefficients, s is the secret
// key in storage form s * 2^64 mod q, [L, W, n], and row r uses key row
// r / rep.  Both X transforms are dense n x n matrices (out = T @ in, the
// JAX table convention), so one Montgomery REDC of v * s_mont gives the
// plain product v * s mod q between them.
//
// Bound on the H100: 2 n^2 64 x 64 -> 128-bit multiply-adds per row; the
// data itself is read and written once.  The design stages both transposed
// n x n tables of one limb in shared memory (64 KB at n = 64, loaded once
// per 256 rows), keeps the row and its spectrum in shared memory between
// the two transforms so the spectrum never reaches device memory, and gives
// each thread one output coefficient with a lazy 128-bit sum reduced once.
// The TPU's block-diagonal 128-lane packing and its 2^-32 inverse-table fold
// are not carried over.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int THREADS = 256, ROWS = 256;

__global__ void __launch_bounds__(THREADS)
ntt_mul_ntt_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ s,
                   const int64_t* __restrict__ fwd, const int64_t* __restrict__ inv,
                   const int64_t* __restrict__ consts, int64_t* __restrict__ out,
                   int R, int W, int n, int rep) {
  extern __shared__ uint64_t smem[];
  const int rb_count = THREADS / n;
  uint64_t* tf = smem;                 // tf[x * n + k] = fwd[l][k][x]
  uint64_t* ti = tf + n * n;           // ti[k * n + x] = inv[l][x][k]
  uint64_t* abuf = ti + n * n;         // [rb_count][n]
  uint64_t* vbuf = abuf + rb_count * n;

  const int l = blockIdx.y;
  const uint64_t* f = reinterpret_cast<const uint64_t*>(fwd) + (long long)l * n * n;
  const uint64_t* g = reinterpret_cast<const uint64_t*>(inv) + (long long)l * n * n;
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    int r = e / n, col = e % n;
    tf[col * n + r] = f[e];
    ti[col * n + r] = g[e];
  }
  const mfhe::LimbConsts c = mfhe::load_consts(consts, l);
  const int rb = threadIdx.x / n, k = threadIdx.x % n;
  const int first = blockIdx.x * ROWS;
  const int last = min(R, first + ROWS);
  const uint64_t* arow = reinterpret_cast<const uint64_t*>(a) + (long long)l * R * n;
  const uint64_t* srow = reinterpret_cast<const uint64_t*>(s) + (long long)l * W * n;
  int64_t* orow = out + (long long)l * R * n;
  __syncthreads();

  for (int r0 = first; r0 < last; r0 += rb_count) {
    const int row = r0 + rb;
    const bool valid = rb < rb_count && row < last;
    if (rb < rb_count) abuf[rb * n + k] = valid ? arow[(long long)row * n + k] : 0;
    __syncthreads();
    uint64_t u = 0;
    if (rb < rb_count) {
      uint64_t hi = 0, lo = 0;
      for (int x = 0; x < n; ++x) mfhe::mac_u128(hi, lo, abuf[rb * n + x], tf[x * n + k]);
      uint64_t v = mfhe::reduce128(hi, lo, c);
      uint64_t sk = valid ? srow[(long long)(row / rep) * n + k] : 0;
      u = mfhe::mont_mul(v, sk, c);
      vbuf[rb * n + k] = u;
    }
    __syncthreads();
    if (valid) {
      uint64_t hi = 0, lo = 0;
      for (int j = 0; j < n; ++j) mfhe::mac_u128(hi, lo, vbuf[rb * n + j], ti[j * n + k]);
      orow[(long long)row * n + k] = static_cast<int64_t>(mfhe::reduce128(hi, lo, c));
    }
  }
}

}  // namespace

extern "C" int mf_ntt_mul_ntt(const int64_t* a, const int64_t* s, const int64_t* fwd,
                              const int64_t* inv, const int64_t* consts, int64_t* out,
                              int L, int R, int W, int n, int rep, void* stream) {
  if (n < 1 || n > THREADS || THREADS % n != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rb_count = THREADS / n;
  size_t bytes = (2 * (size_t)n * n + 2 * (size_t)rb_count * n) * sizeof(uint64_t);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_mul_ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((R + ROWS - 1) / ROWS, L);
  ntt_mul_ntt_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      a, s, fwd, inv, consts, out, R, W, n, rep);
  return static_cast<int>(cudaGetLastError());
}
