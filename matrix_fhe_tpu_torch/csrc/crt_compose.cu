// The exact CRT compose of the Delta^2 decode, centred and folded to f64
// (launch key crt_compose): ops/crt.CRTComposer.compose_to_float on the card.
//
// It replaces no Pallas kernel: matrix_fhe_tpu/ops/crt.py's CRTComposer is
// plain jnp, left to XLA's fusion on the TPU.  It is the counterpart of the
// upstream's compose_big_pair_to_complex_by_delta_kernel (HE.cu:1007-1027).
// The port ran the same arithmetic as int64 PyTorch ops on 32-bit digits,
// about 6,600 full-tensor launches a call at ref.  For residues x_l over
// Q = prod(q_l), each coefficient position is one thread's work (two
// positions with 16-byte loads and stores where the rows allow it):
//
//   t_l  = x_l inv_l mod q_l                        (Shoup products)
//   acc  = sum_l M_l t_l mod Q, M_l = Q / q_l       (words-wide, a
//          conditional -Q after each limb, as encoder.cu:130-134)
//   neg  = acc > floor(Q / 2);  mag = neg ? Q - acc : acc
//   v    = fold of mag's words from the most significant down,
//          v 2^64 + (double) word, each word rounded once
//   out  = (neg ? -v : v) / delta                  (IEEE division)
//
// Bound on the H100: integer multiplies.  At ref (11 limbs, 7 words) a
// call on [11, 512, 64, 64] reads 185 MB and writes 17 MB, 0.06 ms at
// 3.35 TB/s, but makes 11 Shoup products and 11 x 7 (lo, hi) 64-bit
// products a position, about 11 (10 + 7 x 7) = 650 IMADs, 1.4e9 for 2^21
// positions: 0.08 ms at 1.67e13 IMAD/s, before the carry chains' adds.
// So the design issues each byte once and keeps every intermediate in
// registers: a position's accumulator words stay in registers across the
// limbs, the next limb's residues are loaded before this limb's products,
// and the per-limb constants (q, inv and its Shoup companion, M_l's words,
// then Q and floor(Q / 2)), the same for every thread, sit in shared
// memory, loaded once a block of a grid-stride loop and read as broadcasts.
//
// The result must be the plain version's bit for bit: the fold's products
// and sums are __dmul_rn / __dadd_rn, which nvcc may not contract into an
// FMA, each u64 word is converted by __ull2double_rn (the plain version's
// hi 2^32 + lo rounds once, the same), and the division is __ddiv_rn by
// delta itself, never a product by its reciprocal.  (The plain version on
// a CUDA tensor divides by the scalar as torch does there, by a product
// with its reciprocal; that is the same division only where delta is a
// power of two, as every caller's is: 1, Delta, Delta^2.  The kernel
// divides as the plain version on the CPU and the JAX package do.)
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_WORDS = 8;       // 64-bit words of Q (ref: 7), in registers
constexpr int MAX_L = 64;          // limbs whose rows fit in shared memory
constexpr int HEAD = 3;            // q, inv, floor(inv 2^64 / q); then M_l

template <int VEC>
struct Words;
template <>
struct Words<1> {
  __device__ static void load(const uint64_t* p, uint64_t* v) { v[0] = *p; }
  __device__ static void store(double* p, const double* v) { *p = v[0]; }
};
template <>
struct Words<2> {
  __device__ static void load(const uint64_t* p, uint64_t* v) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  }
  __device__ static void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// acc += m t for m of W words and t < 2^64, where the sum fits W words.
template <int W>
__device__ __forceinline__ void add_product(uint64_t* acc, const uint64_t* m,
                                            uint64_t t) {
  uint64_t prod_carry = 0, add_carry = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t lo = m[j] * t;
    uint64_t hi = __umul64hi(m[j], t);
    const uint64_t p = lo + prod_carry;
    hi += p < lo;                    // hi < 2^64 - 1, so this cannot wrap
    const uint64_t s = acc[j] + p;
    const uint64_t s2 = s + add_carry;
    add_carry = (s < p) | (s2 < s);  // at most one of the two carries
    acc[j] = s2;
    prod_carry = hi;
  }
}

// d = a - b over W words; returns the final borrow (1 where a < b).
template <int W>
__device__ __forceinline__ uint64_t sub_words(uint64_t* d, const uint64_t* a,
                                              const uint64_t* b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = a[j] - b[j];
    const uint64_t u = t - borrow;
    borrow = (a[j] < b[j]) | (t < borrow);
    d[j] = u;
  }
  return borrow;
}

template <int W, int VEC>
__global__ void __launch_bounds__(THREADS)
crt_compose_kernel(const uint64_t* __restrict__ x, double* __restrict__ out,
                   const uint64_t* __restrict__ table, int L, long long n,
                   double delta) {
  static_assert(W >= 1 && W <= MAX_WORDS, "words outside [1, MAX_WORDS]");
  constexpr int ROW = HEAD + W;
  extern __shared__ uint64_t tab[];
  for (int w = threadIdx.x; w < L * ROW + 2 * W; w += THREADS) tab[w] = table[w];
  __syncthreads();
  const uint64_t* q_big = tab + L * ROW;
  const uint64_t* q_half = q_big + W;

  const long long groups = n / VEC;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * THREADS) {
    const long long i = g * VEC;
    uint64_t acc[VEC][W];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[v][j] = 0;
    uint64_t next[VEC];
    Words<VEC>::load(x + i, next);
    for (int l = 0; l < L; ++l) {
      uint64_t xv[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) xv[v] = next[v];
      if (l + 1 < L) Words<VEC>::load(x + (l + 1) * n + i, next);
      const uint64_t* c = tab + l * ROW;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const uint64_t t = mfhe::shoup_mul(xv[v], c[1], c[2], c[0]);
        add_product<W>(acc[v], c + HEAD, t);       // < 2 Q: no carry out
        uint64_t d[W];
        const uint64_t under = sub_words<W>(d, acc[v], q_big);
#pragma unroll
        for (int j = 0; j < W; ++j) acc[v][j] = under ? acc[v][j] : d[j];
      }
    }
    double res[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      uint64_t d[W];
      const bool neg = sub_words<W>(d, q_half, acc[v]) != 0;   // acc > Q/2
      sub_words<W>(d, q_big, acc[v]);                           // Q - acc
      double f = 0.0;
#pragma unroll
      for (int j = W - 1; j >= 0; --j)
        f = __dadd_rn(__dmul_rn(f, 18446744073709551616.0),
                      __ull2double_rn(neg ? d[j] : acc[v][j]));
      res[v] = __ddiv_rn(neg ? -f : f, delta);
    }
    Words<VEC>::store(out + i, res);
  }
}

template <int W, int VEC>
int launch(const uint64_t* x, double* out, const uint64_t* table, int L,
           long long n, double delta, cudaStream_t stream) {
  const auto kernel = crt_compose_kernel<W, VEC>;
  const size_t smem = sizeof(uint64_t) * (L * (HEAD + W) + 2 * W);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const long long need = (n / VEC + THREADS - 1) / THREADS;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (need < blocks) blocks = need;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      x, out, table, L, n, delta);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_vec(const uint64_t* x, double* out, const uint64_t* table, int L,
               long long n, double delta, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n % 2 == 0 && aligned(x) && aligned(out))
    return launch<W, 2>(x, out, table, L, n, delta, stream);
  return launch<W, 1>(x, out, table, L, n, delta, stream);
}

}  // namespace

// x [L, n]: canonical residues over the composer's moduli; out [n] f64;
// table: L rows of [q, inv, floor(inv 2^64 / q), M_l's words] and then Q's
// and floor(Q / 2)'s words, uint64, least significant word first, from
// ops/crt.CRTComposer.  Returns cudaErrorInvalidValue for L outside
// [1, 64] or words outside [1, 8].
extern "C" int mf_crt_compose(const int64_t* x, double* out,
                              const int64_t* table, int L, int words,
                              long long n, double delta, void* stream) {
  const auto* xs = reinterpret_cast<const uint64_t*>(x);
  const auto* t = reinterpret_cast<const uint64_t*>(table);
  const auto cs = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > MAX_L || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (words) {
    case 1: return launch_vec<1>(xs, out, t, L, n, delta, cs);
    case 2: return launch_vec<2>(xs, out, t, L, n, delta, cs);
    case 3: return launch_vec<3>(xs, out, t, L, n, delta, cs);
    case 4: return launch_vec<4>(xs, out, t, L, n, delta, cs);
    case 5: return launch_vec<5>(xs, out, t, L, n, delta, cs);
    case 6: return launch_vec<6>(xs, out, t, L, n, delta, cs);
    case 7: return launch_vec<7>(xs, out, t, L, n, delta, cs);
    case 8: return launch_vec<8>(xs, out, t, L, n, delta, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
