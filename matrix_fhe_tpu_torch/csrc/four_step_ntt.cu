// K5: the whole four-step negacyclic NTT, forward or inverse, per (limb,
// polynomial).
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_ntt_kernel
// (SlicedFourStepNTT), and with it the kernels that compute the same
// function there (_sliced_dma_kernel, _fused_ntt_kernel,
// _pipelined_ntt_kernel).  Same output as FourStepNTT.forward / .inverse:
// canonical int64 residues, q < 2^56, the forward in four-step order.
//
// A polynomial of N = m * m residues is an [m, m] matrix (m = n1 = n2).
// Each transform is two passes, each a length-m cyclic DFT of every column
// or every row with an element-wise product before and after it:
//   forward: columns, x * psi^i before, * w_N^(i2 k1) after; then rows
//   inverse: rows, * w_N^-(i2 k1) after; then columns, * n^-1 psi^-i after
// The TPU computes each DFT as a dense [m, m] modular matmul on int8 digit
// planes.  Hopper has 64-bit integer multiplies, so a DFT here is a radix-2
// butterfly network in shared memory: m/2 log2(m) Montgomery products per
// vector instead of m^2 multiply-adds.  Each pass reads and writes the
// [L, B, N] tensor once (1.3 ms of traffic per transform at the bench
// shape); what bounds the kernel is the integer pipe, about 25 instructions
// for each of the 1.5 G Montgomery products of a transform at that shape.
// A block holds up to 16 vectors of m residues (33 KB at m = 256), loads
// them bit-reversed, runs log2(m) butterfly stages and stores in natural
// order.  The second pass works in place on the first pass's output.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VECTORS = 16;
constexpr size_t SMEM_LIMIT = 48 * 1024;  // static limit: no opt-in needed

// shared-memory index of element i: one pad word per 32 spreads the
// bit-reversed scatter over the banks
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

__host__ __device__ inline int row_words(int m) { return m + (m >> 5) + 1; }

template <bool COL>
__global__ void __launch_bounds__(THREADS)
four_step_pass(const int64_t* in, int64_t* out, const int64_t* __restrict__ roots,
               const int64_t* __restrict__ pre, const int64_t* __restrict__ post,
               const int64_t* __restrict__ consts, int B, int m, int log_m,
               int log_g) {
  extern __shared__ uint64_t s[];
  const int g = 1 << log_g;                       // vectors in this block
  const int l = blockIdx.z, b = blockIdx.y, v0 = blockIdx.x * g;
  const long long n = static_cast<long long>(m) * m;
  const long long base = (static_cast<long long>(l) * B + b) * n;
  const long long tbase = static_cast<long long>(l) * n;   // [L, N] tables
  const mfhe::LimbConsts c = mfhe::load_consts(consts, l);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(roots) +
                      static_cast<long long>(l) * (m / 2);
  const int stride = row_words(m);
  const int total = g * m;

  // vector v, element i -> position in the [m, m] matrix (g and m are
  // powers of two: shifts and masks, no integer division)
  auto position = [&](int e, int& v, int& i) -> long long {
    if constexpr (COL) {
      v = e & (g - 1);
      i = e >> log_g;
      return static_cast<long long>(i) * m + (v0 + v);
    } else {
      v = e >> log_m;
      i = e & (m - 1);
      return static_cast<long long>(v0 + v) * m + i;
    }
  };

  for (int e = threadIdx.x; e < total; e += THREADS) {
    int v, i;
    const long long pos = position(e, v, i);
    uint64_t x = static_cast<uint64_t>(in[base + pos]);
    if (pre != nullptr)
      x = mfhe::mont_mul(x, static_cast<uint64_t>(pre[tbase + pos]), c);
    s[v * stride + sidx(__brev(i) >> (32 - log_m))] = x;
  }
  __syncthreads();

  // iterative Cooley-Tukey on bit-reversed input -> natural-order DFT
  const int halves = m / 2;
  for (int lh = 0; lh < log_m; ++lh) {
    const int half = 1 << lh;
    const int tw_shift = log_m - 1 - lh;           // root index = pos * m / (2 half)
    for (int e = threadIdx.x; e < g * halves; e += THREADS) {
      const int v = e >> (log_m - 1), j = e & (halves - 1);
      const int pos = j & (half - 1);
      const int i0 = ((j >> lh) << (lh + 1)) + pos, i1 = i0 + half;
      uint64_t* sv = s + v * stride;
      const uint64_t a = sv[sidx(i0)];
      const uint64_t t = mfhe::mont_mul(sv[sidx(i1)], w[pos << tw_shift], c);
      const uint64_t sum = a + t;
      sv[sidx(i0)] = sum >= c.q ? sum - c.q : sum;
      sv[sidx(i1)] = a >= t ? a - t : a + c.q - t;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += THREADS) {
    int v, i;
    const long long pos = position(e, v, i);
    uint64_t x = s[v * stride + sidx(i)];
    if (post != nullptr)
      x = mfhe::mont_mul(x, static_cast<uint64_t>(post[tbase + pos]), c);
    out[base + pos] = static_cast<int64_t>(x);
  }
}

template <bool COL>
int run_pass(const int64_t* in, int64_t* out, const int64_t* roots,
             const int64_t* pre, const int64_t* post, const int64_t* consts,
             int L, int B, int m, int log_m, cudaStream_t stream) {
  int log_g = 0;
  while ((1 << log_g) < MAX_VECTORS && (1 << log_g) < m) ++log_g;
  const size_t per_vector = static_cast<size_t>(row_words(m)) * sizeof(uint64_t);
  while (log_g > 0 && (per_vector << log_g) > SMEM_LIMIT) --log_g;
  if ((per_vector << log_g) > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(m >> log_g, B, L);
  four_step_pass<COL><<<grid, THREADS, per_vector << log_g, stream>>>(
      in, out, roots, pre, post, consts, B, m, log_m, log_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [L, B, m*m] -> out.  Pass A reads x and writes out; pass B transforms
// out in place.  col_first: pass A is the column pass (forward), else the
// row pass (inverse).  pre/post may be null; tables are [L, m*m] and roots
// [L, m/2], all in Montgomery form.
extern "C" int mf_four_step(const int64_t* x, int64_t* out, const int64_t* consts,
                            int L, int B, int m, int col_first,
                            const int64_t* roots_a, const int64_t* pre_a,
                            const int64_t* post_a, const int64_t* roots_b,
                            const int64_t* pre_b, const int64_t* post_b,
                            void* stream) {
  if (m < 2 || (m & (m - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  int log_m = 0;
  while ((1 << log_m) < m) ++log_m;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = col_first
      ? run_pass<true>(x, out, roots_a, pre_a, post_a, consts, L, B, m, log_m, st)
      : run_pass<false>(x, out, roots_a, pre_a, post_a, consts, L, B, m, log_m, st);
  if (err != 0) return err;
  return col_first
      ? run_pass<false>(out, out, roots_b, pre_b, post_b, consts, L, B, m, log_m, st)
      : run_pass<true>(out, out, roots_b, pre_b, post_b, consts, L, B, m, log_m, st);
}
