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
// data itself is read and written once.  One n x n table of one limb is
// resident in shared memory at a time (two do not fit the 227 KB a block may
// hold at the gl2 ring's n = 128: 256 KB).  A batch of BATCH rows is
// transformed forward with the forward table resident, its spectrum times s
// stays in shared memory, then the inverse table replaces the forward one
// for the inverse pass.  The tables are re-read (from L2) once per batch,
// n^2 loads against BATCH * n^2 multiply-adds; each thread gives one output
// coefficient with a lazy 128-bit sum reduced once.  The table rows are
// padded by one word so the transposing store spreads over the banks.  At
// n = 64 this one-table kernel ran 3.807 ms against 3.876 ms for a kernel
// that kept both tables resident (ref roundtrip shape, H100), so there is
// one kernel for every n.
//
// The TPU's block-diagonal 128-lane packing and its 2^-32 inverse-table fold
// are not carried over.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int THREADS = 512, ROWS = 256, BATCH = 32;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB, the most one block may hold

size_t smem_bytes(int n) {
  return ((size_t)n * (n + 1) + 2 * (size_t)BATCH * n) * sizeof(uint64_t);
}

// tbl[x * (n + 1) + k] = T[k][x]: row e / n, column e % n of the source table
__device__ __forceinline__ void load_transposed(uint64_t* tbl, const uint64_t* t, int n) {
  for (int e = threadIdx.x; e < n * n; e += THREADS)
    tbl[(e % n) * (n + 1) + e / n] = t[e];
}

__global__ void __launch_bounds__(THREADS)
ntt_mul_ntt_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ s,
                   const int64_t* __restrict__ fwd, const int64_t* __restrict__ inv,
                   const int64_t* __restrict__ consts, int64_t* __restrict__ out,
                   int R, int W, int n, int rep) {
  extern __shared__ uint64_t smem[];
  const int ld = n + 1;
  uint64_t* tbl = smem;                        // the resident table, [n][n + 1]
  uint64_t* abuf = tbl + (size_t)n * ld;       // [BATCH][n] input rows
  uint64_t* spec = abuf + BATCH * n;           // [BATCH][n] NTT(a) * s

  const int l = blockIdx.y;
  const uint64_t* f = reinterpret_cast<const uint64_t*>(fwd) + (long long)l * n * n;
  const uint64_t* g = reinterpret_cast<const uint64_t*>(inv) + (long long)l * n * n;
  const mfhe::LimbConsts c = mfhe::load_consts(consts, l);
  const int per_pass = THREADS / n;
  const int rb = threadIdx.x / n, k = threadIdx.x % n;
  const int first = blockIdx.x * ROWS;
  const int last = min(R, first + ROWS);
  const uint64_t* arow = reinterpret_cast<const uint64_t*>(a) + (long long)l * R * n;
  const uint64_t* srow = reinterpret_cast<const uint64_t*>(s) + (long long)l * W * n;
  int64_t* orow = out + (long long)l * R * n;

  for (int b0 = first; b0 < last; b0 += BATCH) {
    const int nb = min(BATCH, last - b0);
    load_transposed(tbl, f, n);
    for (int e = threadIdx.x; e < nb * n; e += THREADS)
      abuf[e] = arow[(long long)b0 * n + e];
    __syncthreads();
    for (int r = rb; r < nb; r += per_pass) {
      uint64_t hi = 0, lo = 0;
      for (int x = 0; x < n; ++x) mfhe::mac_u128(hi, lo, abuf[r * n + x], tbl[x * ld + k]);
      const uint64_t v = mfhe::reduce128(hi, lo, c);
      spec[r * n + k] = mfhe::mont_mul(v, srow[(long long)((b0 + r) / rep) * n + k], c);
    }
    __syncthreads();
    load_transposed(tbl, g, n);
    __syncthreads();
    for (int r = rb; r < nb; r += per_pass) {
      uint64_t hi = 0, lo = 0;
      for (int j = 0; j < n; ++j) mfhe::mac_u128(hi, lo, spec[r * n + j], tbl[j * ld + k]);
      orow[(long long)(b0 + r) * n + k] =
          static_cast<int64_t>(mfhe::reduce128(hi, lo, c));
    }
    __syncthreads();
  }
}

bool fits(int n) {
  return n >= 1 && n <= THREADS && THREADS % n == 0 && smem_bytes(n) <= SMEM_LIMIT;
}

}  // namespace

// Shared memory one launch of K2 needs at this n, or 0 where the kernel
// does not take n; the wrapper asks before a launch and refuses n there.
extern "C" long long mf_ntt_mul_ntt_smem(int n) {
  return fits(n) ? static_cast<long long>(smem_bytes(n)) : 0;
}

extern "C" int mf_ntt_mul_ntt(const int64_t* a, const int64_t* s, const int64_t* fwd,
                              const int64_t* inv, const int64_t* consts, int64_t* out,
                              int L, int R, int W, int n, int rep, void* stream) {
  if (!fits(n)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(n);
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
