// K3's compose pass: the CRT-compose partials of the scaled W-CRT inverse.
//
// Replaces, with K1's digit-plane GEMM before it, matrix_fhe_tpu/ops/
// pallas_ntt.py:_inv_compose_kernel (SlicedInvCompose).  For eval residues
// x [L, W, M] and inverse tables with M_l^-1 mod q_l folded in, T' [L, W, W]:
//   r'_l = (T'_l @ x_l) mod q_l                       (K1's stage_kernel)
//   acc  = sum_l r'_l * (M_l mod 2^64)  mod 2^64      (this pass, wrapping)
//   k    = round(sum_l r'_l / q_l)                    (this pass: f64 sum in
//                                                     limb order, a true
//                                                     division, half-even)
// The host tail (ops/ddfloat.compose_tail_from_partials) takes
// (acc - k * Q) mod 2^64 as a signed integer and divides by Delta.
//
// On the TPU the limb loop is a sequential grid axis carrying the sums in
// VMEM.  Here the matmul is K1's u8 digit-plane GEMM on the int8 tensor
// cores (ops/cuda_ntt.InvCompose runs its split and GEMM under launch keys
// of its own), which writes the canonical r' [L, W, M] to device memory;
// this pass reads the L planes of r' once for each output and writes acc
// and k.  Bound on the H100: its bytes, 8 (L + 2) an output at 3.35 TB/s.
// One thread an output, neighbouring threads on neighbouring columns, so
// each limb's load is a whole 256-byte run a warp; the sum of k stays in
// limb order and divides by (double) q_l as the plain version does, so k is
// the same on every input.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
inv_compose_kernel(const uint64_t* __restrict__ r, const int64_t* __restrict__ consts,
                   const int64_t* __restrict__ m64, int64_t* __restrict__ acc_out,
                   int64_t* __restrict__ k_out, int L, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  uint64_t acc = 0;
  double kf = 0.0;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const uint64_t v = r[l * n + i];
    acc += v * static_cast<uint64_t>(m64[l]);
    kf += static_cast<double>(v) / static_cast<double>(mfhe::load_consts(consts, l).q);
  }
  acc_out[i] = static_cast<int64_t>(acc);
  k_out[i] = static_cast<int64_t>(rint(kf));
}

}  // namespace

// r: the canonical residues r' [L, n] (n = W M), consts [L, 3], m64 [L];
// acc and k: [n] int64.
extern "C" int mf_inv_compose(const int64_t* r, const int64_t* consts,
                              const int64_t* m64, int64_t* acc, int64_t* k,
                              int L, long long n, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  inv_compose_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(r), consts, m64, acc, k, L, n);
  return static_cast<int>(cudaGetLastError());
}
