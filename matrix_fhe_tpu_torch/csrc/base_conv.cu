// The exact RNS base conversion of key switching, with ModDown's exact
// division as an optional epilogue, in one pass (launch key base_conv).
//
// It replaces no Pallas kernel: matrix_fhe_tpu/ops/rns_ext.py is plain jnp,
// left to XLA's fusion on the TPU.  The port ran the same arithmetic as
// int64 PyTorch glue (ops/modmath.mul_mod's Horner loop: ~75 full-tensor
// kernels a modular product), about 3,400 launches a relinearized multiply
// at ref.  For x's residues over a source basis Q_s = prod(q_l), each
// coefficient position is one thread's work (two positions with 16-byte
// loads where the rows allow it):
//
//   r'_l = x_l (Q_s/q_l)^-1 mod q_l                 (Shoup products)
//   k    = rint(sum_l double(r'_l) * (1/q_l))       (limb order, half-even)
//   c_r  = (sum_l r'_l (Q_s/q_l mod r) + k (-Q_s mod r)) mod r
//   out  = c_r, or (y_r - c_r) Q_s^-1 mod r with a dividend y over the
//          targets: round(y / Q_s) mod r, ModDown's and the rescale's
//          exact division.
//
// Bound on the H100: bytes.  A ref digit (3 source limbs to 14 targets)
// reads 3 and writes 14 limb planes of 2^21 int64, 285 MB, 0.085 ms at
// 3.35 TB/s; its (Ls Ld + 2 Ld) 2^21 Shoup products of ~10 IMADs each take
// ~0.07 ms at 1.67e13 IMAD/s.  A ref ModDown with its epilogue moves
// (3 + 11 + 11) planes, 0.125 ms.  So the design moves each byte once: a
// position's source residues stay in registers while all its targets are
// written from them, the per-(l, r) constants (each with its Shoup
// companion floor(w 2^64 / r), built on the host by ops/rns_ext.py) sit in
// shared memory, loaded once a block of a grid-stride loop, and the Ls + 1
// terms of a target are summed lazily in [0, 2r) each (below 2^61 for
// Ls <= 8, r < 2^56) and reduced once by a Shoup product with w = 1.
//
// The quotient k must be the plain version's on every input: the f64 sum
// picks the representative where it lies within rounding of a half-integer
// (x near Q_s / 2).  So the products and sums are __dmul_rn / __dadd_rn,
// which nvcc may not contract into an FMA (a fused a * b + c rounds once,
// the plain version twice), in limb order, and the rounding is rint's
// half-to-even, as torch.round.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LS = 8;          // source limbs held in registers
constexpr int MAX_LD = 64;         // target rows in shared memory
constexpr int SRC_WORDS = 4;       // q, (Q_s/q)^-1 mod q, Shoup, bits of 1/q
constexpr int DST_HEAD = 6;        // r, floor(2^64 / r), -Q_s mod r, Shoup,
                                   // Q_s^-1 mod r, Shoup; then
                                   // (Q_s/q_l mod r, Shoup) per l

// x w mod q up to one q: in [0, 2 q) for any 64-bit x, w < q < 2^63.
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t x, uint64_t w,
                                               uint64_t wp, uint64_t q) {
  return x * w - __umul64hi(x, wp) * q;
}

template <int VEC>
struct Words;
template <>
struct Words<1> {
  __device__ static void load(const uint64_t* p, uint64_t* v) { v[0] = *p; }
  __device__ static void store(uint64_t* p, const uint64_t* v) { *p = v[0]; }
};
template <>
struct Words<2> {
  __device__ static void load(const uint64_t* p, uint64_t* v) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  }
  __device__ static void store(uint64_t* p, const uint64_t* v) {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
  }
};

template <int LS, int VEC>
__global__ void __launch_bounds__(THREADS)
base_conv_kernel(const uint64_t* __restrict__ src,
                 const uint64_t* __restrict__ dividend, uint64_t* __restrict__ out,
                 const uint64_t* __restrict__ src_table,
                 const uint64_t* __restrict__ dst_table, int ld, long long n) {
  static_assert(LS >= 1 && LS <= MAX_LS, "source limbs outside [1, MAX_LS]");
  constexpr int ROW = DST_HEAD + 2 * LS;
  extern __shared__ uint64_t tables[];
  const uint64_t* s_src = tables;
  const uint64_t* s_dst = tables + LS * SRC_WORDS;
  for (int w = threadIdx.x; w < LS * SRC_WORDS + ld * ROW; w += THREADS)
    tables[w] = w < LS * SRC_WORDS ? src_table[w] : dst_table[w - LS * SRC_WORDS];
  __syncthreads();

  const long long groups = n / VEC;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * THREADS) {
    const long long i = g * VEC;
    uint64_t rp[LS][VEC];
#pragma unroll
    for (int l = 0; l < LS; ++l) Words<VEC>::load(src + l * n + i, rp[l]);
    uint64_t k[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      double kf = 0.0;
#pragma unroll
      for (int l = 0; l < LS; ++l) {
        const uint64_t q = s_src[l * SRC_WORDS];
        rp[l][v] = mfhe::shoup_mul(rp[l][v], s_src[l * SRC_WORDS + 1],
                                   s_src[l * SRC_WORDS + 2], q);
        const double term = __dmul_rn(
            __ll2double_rn(static_cast<long long>(rp[l][v])),
            __longlong_as_double(static_cast<long long>(s_src[l * SRC_WORDS + 3])));
        kf = l == 0 ? term : __dadd_rn(kf, term);
      }
      // k is in [0, LS]: the sum of LS fractions r'_l / q_l < 1, rounded
      k[v] = static_cast<uint64_t>(static_cast<long long>(rint(kf)));
    }
    for (int t = 0; t < ld; ++t) {
      const uint64_t* c = s_dst + t * ROW;
      const uint64_t r = c[0];
      uint64_t res[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        uint64_t acc = shoup_lazy(k[v], c[2], c[3], r);   // k (-Q_s) mod r
#pragma unroll
        for (int l = 0; l < LS; ++l)
          acc += shoup_lazy(rp[l][v], c[DST_HEAD + 2 * l], c[DST_HEAD + 2 * l + 1], r);
        uint64_t cr = acc - __umul64hi(acc, c[1]) * r;   // in [0, 2r)
        res[v] = cr >= r ? cr - r : cr;
      }
      if (dividend != nullptr) {
        uint64_t y[VEC];
        Words<VEC>::load(dividend + t * n + i, y);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const uint64_t d = y[v] >= res[v] ? y[v] - res[v] : y[v] + r - res[v];
          res[v] = mfhe::shoup_mul(d, c[4], c[5], r);
        }
      }
      Words<VEC>::store(out + t * n + i, res);
    }
  }
}

template <int LS, int VEC>
int launch(const uint64_t* src, const uint64_t* dividend, uint64_t* out,
           const uint64_t* src_table, const uint64_t* dst_table, int ld,
           long long n, cudaStream_t stream) {
  const auto kernel = base_conv_kernel<LS, VEC>;
  const size_t smem = sizeof(uint64_t) * (LS * SRC_WORDS + ld * (DST_HEAD + 2 * LS));
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const long long need = (n / VEC + THREADS - 1) / THREADS;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (need < blocks) blocks = need;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      src, dividend, out, src_table, dst_table, ld, n);
  return static_cast<int>(cudaGetLastError());
}

template <int LS>
int launch_vec(const uint64_t* src, const uint64_t* dividend, uint64_t* out,
               const uint64_t* src_table, const uint64_t* dst_table, int ld,
               long long n, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n % 2 == 0 && aligned(src) && aligned(dividend) && aligned(out))
    return launch<LS, 2>(src, dividend, out, src_table, dst_table, ld, n, stream);
  return launch<LS, 1>(src, dividend, out, src_table, dst_table, ld, n, stream);
}

}  // namespace

// src [ls, n]: residues x over the source basis; dividend [ld, n] or null;
// out [ld, n]; src_table [ls, 4] and dst_table [ld, 6 + 2 ls] uint64 words
// from ops/rns_ext.BasisExtender (the target rows of the requested slice).
// Returns cudaErrorInvalidValue for ls outside [1, 8] or ld outside [1, 64].
extern "C" int mf_base_conv(const int64_t* src, const int64_t* dividend,
                            int64_t* out, const int64_t* src_table,
                            const int64_t* dst_table, int ls, int ld,
                            long long n, void* stream) {
  const auto* s = reinterpret_cast<const uint64_t*>(src);
  const auto* y = reinterpret_cast<const uint64_t*>(dividend);
  auto* o = reinterpret_cast<uint64_t*>(out);
  const auto* st = reinterpret_cast<const uint64_t*>(src_table);
  const auto* dt = reinterpret_cast<const uint64_t*>(dst_table);
  const auto cs = static_cast<cudaStream_t>(stream);
  if (ld < 1 || ld > MAX_LD || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (ls) {
    case 1: return launch_vec<1>(s, y, o, st, dt, ld, n, cs);
    case 2: return launch_vec<2>(s, y, o, st, dt, ld, n, cs);
    case 3: return launch_vec<3>(s, y, o, st, dt, ld, n, cs);
    case 4: return launch_vec<4>(s, y, o, st, dt, ld, n, cs);
    case 5: return launch_vec<5>(s, y, o, st, dt, ld, n, cs);
    case 6: return launch_vec<6>(s, y, o, st, dt, ld, n, cs);
    case 7: return launch_vec<7>(s, y, o, st, dt, ld, n, cs);
    case 8: return launch_vec<8>(s, y, o, st, dt, ld, n, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
