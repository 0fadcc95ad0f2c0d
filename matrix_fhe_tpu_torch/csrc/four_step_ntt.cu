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
// Each pass reads and writes the [L, B, N] tensor once; the second works in
// place on the first one's output.  The grid is (vectors / G, B, L), limb
// outermost, so one limb's tables stay in L2 across its polynomials.
//
// Products are Shoup products with a fixed operand: every table holds
// pairs (w, w') with w' = floor(w 2^b / q), b the word width, and
// a w mod q = a w - umulhi(a, w') q, exact mod 2^b and in [0, 2q) for any
// a < 2^b.  Values stay lazy in [0, 2q) (differences in (0, 4q) before
// their product; in the 64-bit register DFT sums grow unreduced up to 32q,
// see dif()), with one correction to canonical before the store.  Two
// routes, one source: 64-bit words for any q < 2^56 (4q < 2^58), and
// 32-bit words when every modulus is below 2^30 (4q < 2^32), where a
// product is one __umulhi and two 32-bit low products.  Data stays int64
// in device memory either way; only registers and shared memory hold the
// narrow words.  The host picks the route from the moduli.
//
// m = R * R with R in {2, 4, 8, 16} (the bench's m = 256 is 16 x 16) takes
// the register kernel: R threads a vector each hold R residues of it, run an
// R-point DFT in registers (decimation in frequency), multiply by the inner
// twiddles w_m^(j k1), exchange once through shared memory (a transpose)
// and run a second R-point DFT: one barrier a pass instead of log2 m.  The
// loads and stores are coalesced on both passes by putting the lane-fast
// thread index along the contiguous axis (the element index of a row pass,
// the vector index of a column pass).  The element-wise products are fused
// into the load and the store.  Every other m (2, 8, 32, 128, ..., 4096)
// takes a radix-2 loop through shared memory with the same arithmetic.
//
// Bound on the H100: a pass moves 2 x 8 B an element (1.28 ms of traffic
// a transform at the bench shape, 0.65 ms for the function's own bytes);
// the 64-bit route also issues ~8 Shoup products an element, of several
// IMADs each (chip_smoke.py counts them in the SASS), the 32-bit route a
// few IMADs a product.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename W>
struct Word;

template <>
struct Word<uint64_t> {
  using Pair = ulonglong2;   // an int64 pair [w, w'] of the host's [L, K, 2] table
  __device__ static uint64_t mulhi(uint64_t a, uint64_t b) { return __umul64hi(a, b); }
};

template <>
struct Word<uint32_t> {
  using Pair = uint2;        // one int64 w | w' << 32 of the host's [L, K] table
  __device__ static uint32_t mulhi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
};

template <typename W>
using Pair = typename Word<W>::Pair;

// a w mod q in [0, 2q), for any a < 2^bits(W) and p = (w, w')
template <typename W>
__device__ __forceinline__ W shoup(W a, Pair<W> p, W q) {
  const W w = static_cast<W>(p.x), wp = static_cast<W>(p.y);
  return a * w - Word<W>::mulhi(a, wp) * q;
}

template <typename W>
__device__ __forceinline__ W csub(W a, W bound) { return a >= bound ? a - bound : a; }

template <typename W>
__device__ __forceinline__ Pair<W> load_pair(const void* table, long long i) {
  return __ldg(reinterpret_cast<const Pair<W>*>(table) + i);
}

__host__ __device__ constexpr int bit_reverse(int p, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((p >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int log2_of(int r) { return r <= 1 ? 0 : 1 + log2_of(r / 2); }

// -- the register kernel, m = R * R -------------------------------------------

constexpr int REG_THREADS = 256;

// vectors a block holds: 256 / R threads' worth, at most the m vectors
__host__ __device__ constexpr int reg_vectors(int r) {
  return r * r < REG_THREADS / r ? r * r : REG_THREADS / r;
}

// exchange layout of vector v: [k1][j] rows of R + 1 words, vectors R (R + 1)
// + 1 words apart (the pads spread both directions of the transpose over
// the banks)
template <int R>
__device__ __forceinline__ int xidx(int v, int k1, int j) {
  return v * (R * (R + 1) + 1) + k1 * (R + 1) + j;
}

template <typename W, int R>
__host__ __device__ constexpr size_t reg_smem() {
  return static_cast<size_t>(R) * R * sizeof(Pair<W>) +
         static_cast<size_t>(reg_vectors(R)) * (R * (R + 1) + 1) * sizeof(W);
}

// in-register R-point cyclic DFT with root w_m^R, natural order in,
// bit-reversed order out (x[p] = X[bit_reverse(p)]).  One stage a template
// level, so that every register index is a constant (a loop over the stage
// width left the array in local memory).  Inputs below 2q.  On 32-bit
// words every value is brought back below 2q.  On 64-bit words (GROW) the
// sums are not reduced: stage s takes values below 2^(s+1) q and leaves
// them below 2^(s+2) q (a product's output is below 2q), so R = 16's four
// stages end below 32 q < 2^61.
template <typename W, int R, int LEN, bool GROW>
__device__ __forceinline__ void dif(W (&x)[R], const Pair<W>* rt, W q) {
  constexpr int S = log2_of(R / (2 * LEN));            // this stage's index
  const W bound = GROW ? q << (S + 1) : q + q;         // inputs below it
#pragma unroll
  for (int s0 = 0; s0 < R; s0 += 2 * LEN) {
#pragma unroll
    for (int j = 0; j < LEN; ++j) {
      const W a = x[s0 + j], c = x[s0 + j + LEN];
      const W d = a - c + bound;                       // (0, 2 bound)
      x[s0 + j] = GROW ? a + c : csub<W>(a + c, bound);
      // root w_R^(j R / (2 LEN)) = w_m^(j m / (2 LEN))
      x[s0 + j + LEN] = j != 0 ? shoup<W>(d, rt[j * (R * R / (2 * LEN))], q)
                               : GROW ? d : csub<W>(d, bound);
    }
  }
  if constexpr (LEN > 1) dif<W, R, LEN / 2, GROW>(x, rt, q);
}

// at least 3 blocks an SM on 32-bit words, 2 on 64-bit words (128
// registers a thread: a bound of 3 made them spill, none let them take
// more and run one block an SM); both the faster on the H100
template <typename W, int R, bool COL, bool PRE, bool POST>
__global__ void __launch_bounds__(reg_vectors(R) * R, sizeof(W) == 4 ? 3 : 2)
four_step_reg(const int64_t* in, int64_t* out, const void* __restrict__ roots,
              const void* __restrict__ pre, const void* __restrict__ post,
              const int64_t* __restrict__ moduli, int B) {
  constexpr int M = R * R, G = reg_vectors(R), LOG_R = log2_of(R);
  constexpr bool GROW = sizeof(W) == 8;
  extern __shared__ __align__(16) unsigned char smem[];
  Pair<W>* rt = reinterpret_cast<Pair<W>*>(smem);     // w_m^e, e < m
  W* s = reinterpret_cast<W*>(rt + M);                // the exchange
  const int l = blockIdx.z;
  const W q = static_cast<W>(moduli[l]);
  const long long n = static_cast<long long>(M) * M;
  const long long base = (static_cast<long long>(l) * B + blockIdx.y) * n;
  const long long tbase = static_cast<long long>(l) * n;   // [L, N] tables

  for (int e = threadIdx.x; e < M; e += G * R)
    rt[e] = load_pair<W>(roots, static_cast<long long>(l) * M + e);

  // thread -> (vector v, lane j), lane-fast along the contiguous axis
  const int t = threadIdx.x;
  const int v = COL ? t % G : t / R;
  const int j = COL ? t / G : t % R;
  const int vec = blockIdx.x * G + v;
  auto pos = [&](int i) -> long long {
    return COL ? static_cast<long long>(i) * M + vec
               : static_cast<long long>(vec) * M + i;
  };

  // elements i1 R + j, i1 < R, with the pre-product
  W x[R];
#pragma unroll
  for (int i1 = 0; i1 < R; ++i1) {
    const long long p = pos(i1 * R + j);
    const W a = static_cast<W>(in[base + p]);
    x[i1] = PRE ? shoup<W>(a, load_pair<W>(pre, tbase + p), q) : a;
  }
  __syncthreads();                                    // rt is in

  dif<W, R, R / 2, GROW>(x, rt, q);
  // x[p] = A[k1], k1 = bit_reverse(p); times w_m^(j k1), then the transpose
  // (on 64-bit words k1 = 0 too, by w_m^0 = 1, to come back below 2q)
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const int k1 = bit_reverse(p, LOG_R);
    s[xidx<R>(v, k1, j)] = k1 == 0 && !GROW ? x[p] : shoup<W>(x[p], rt[j * k1], q);
  }
  __syncthreads();

  // this thread now holds k1 = j of vector v, over i2 < R
#pragma unroll
  for (int i2 = 0; i2 < R; ++i2) x[i2] = s[xidx<R>(v, j, i2)];
  dif<W, R, R / 2, GROW>(x, rt, q);
  // x[p] = X[j + R k2], k2 = bit_reverse(p); below 2q after a product
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const long long o = pos(j + R * bit_reverse(p, LOG_R));
    W a = x[p];
    if (POST) a = shoup<W>(a, load_pair<W>(post, tbase + o), q);
    else if (GROW) a = shoup<W>(a, rt[0], q);
    out[base + o] = static_cast<int64_t>(csub<W>(a, q));
  }
}

// -- the radix-2 loop for every other m ----------------------------------------

constexpr int LOOP_THREADS = 256;
constexpr int MAX_VECTORS = 16;
constexpr size_t SMEM_LIMIT = 48 * 1024;  // static limit: no opt-in needed

// shared-memory index of element i: one pad word per 32 spreads the
// bit-reversed scatter over the banks
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

__host__ __device__ inline int row_words(int m) { return m + (m >> 5) + 1; }

template <typename W, bool COL, bool PRE, bool POST>
__global__ void __launch_bounds__(LOOP_THREADS)
four_step_loop(const int64_t* in, int64_t* out, const void* __restrict__ roots,
               const void* __restrict__ pre, const void* __restrict__ post,
               const int64_t* __restrict__ moduli, int B, int m, int log_m,
               int log_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  W* s = reinterpret_cast<W*>(smem);
  const int g = 1 << log_g;                       // vectors in this block
  const int l = blockIdx.z, v0 = blockIdx.x * g;
  const W q = static_cast<W>(moduli[l]), q2 = q + q;
  const long long n = static_cast<long long>(m) * m;
  const long long base = (static_cast<long long>(l) * B + blockIdx.y) * n;
  const long long tbase = static_cast<long long>(l) * n;
  const long long rbase = static_cast<long long>(l) * m;   // [L, m] roots
  const int stride = row_words(m);
  const int total = g * m;

  // vector v, element i -> position in the [m, m] matrix
  auto position = [&](int e, int& v, int& i) -> long long {
    if (COL) {
      v = e & (g - 1);
      i = e >> log_g;
      return static_cast<long long>(i) * m + (v0 + v);
    }
    v = e >> log_m;
    i = e & (m - 1);
    return static_cast<long long>(v0 + v) * m + i;
  };

  for (int e = threadIdx.x; e < total; e += LOOP_THREADS) {
    int v, i;
    const long long p = position(e, v, i);
    W x = static_cast<W>(in[base + p]);
    if (PRE) x = shoup<W>(x, load_pair<W>(pre, tbase + p), q);
    s[v * stride + sidx(__brev(i) >> (32 - log_m))] = x;
  }
  __syncthreads();

  // iterative Cooley-Tukey on bit-reversed input -> natural-order DFT
  const int halves = m / 2;
  for (int lh = 0; lh < log_m; ++lh) {
    const int half = 1 << lh;
    const int tw_shift = log_m - 1 - lh;          // root index pos m / (2 half)
    for (int e = threadIdx.x; e < g * halves; e += LOOP_THREADS) {
      const int v = e >> (log_m - 1), j = e & (halves - 1);
      const int k = j & (half - 1);
      const int i0 = ((j >> lh) << (lh + 1)) + k, i1 = i0 + half;
      W* sv = s + v * stride;
      const W a = sv[sidx(i0)];
      const W t = shoup<W>(sv[sidx(i1)], load_pair<W>(roots, rbase + (k << tw_shift)), q);
      sv[sidx(i0)] = csub<W>(a + t, q2);
      sv[sidx(i1)] = csub<W>(a - t + q2, q2);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += LOOP_THREADS) {
    int v, i;
    const long long p = position(e, v, i);
    W x = s[v * stride + sidx(i)];
    if (POST) x = shoup<W>(x, load_pair<W>(post, tbase + p), q);
    out[base + p] = static_cast<int64_t>(csub<W>(x, q));
  }
}

struct PassArgs {
  const int64_t* in;
  int64_t* out;
  const void *roots, *pre, *post;
  const int64_t* moduli;
  int L, B, m;
  cudaStream_t stream;
};

template <typename W, int R, bool COL, bool PRE, bool POST>
int launch_reg(const PassArgs& a) {
  constexpr int G = reg_vectors(R);
  constexpr size_t smem = reg_smem<W, R>();
  static_assert(smem <= SMEM_LIMIT, "register kernel tile exceeds 48 KB");
  dim3 grid(R * R / G, a.B, a.L);
  four_step_reg<W, R, COL, PRE, POST><<<grid, G * R, smem, a.stream>>>(
      a.in, a.out, a.roots, a.pre, a.post, a.moduli, a.B);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, bool COL, bool PRE, bool POST>
int launch_loop(const PassArgs& a) {
  int log_m = 0;
  while ((1 << log_m) < a.m) ++log_m;
  int log_g = 0;
  while ((1 << log_g) < MAX_VECTORS && (1 << log_g) < a.m) ++log_g;
  const size_t per_vector = static_cast<size_t>(row_words(a.m)) * sizeof(W);
  while (log_g > 0 && (per_vector << log_g) > SMEM_LIMIT) --log_g;
  if ((per_vector << log_g) > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.m >> log_g, a.B, a.L);
  four_step_loop<W, COL, PRE, POST><<<grid, LOOP_THREADS, per_vector << log_g,
                                      a.stream>>>(
      a.in, a.out, a.roots, a.pre, a.post, a.moduli, a.B, a.m, log_m, log_g);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, bool COL, bool PRE, bool POST>
int run_pass(const PassArgs& a) {
  switch (a.m) {
    case 4: return launch_reg<W, 2, COL, PRE, POST>(a);
    case 16: return launch_reg<W, 4, COL, PRE, POST>(a);
    case 64: return launch_reg<W, 8, COL, PRE, POST>(a);
    case 256: return launch_reg<W, 16, COL, PRE, POST>(a);
    default: return launch_loop<W, COL, PRE, POST>(a);
  }
}

// the passes the transforms take: a column pass has a post-product and
// maybe a pre-product (the forward's twist), a row pass no pre-product
template <typename W>
int dispatch(bool col, const PassArgs& a) {
  if (col) {
    if (a.post == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return a.pre != nullptr ? run_pass<W, true, true, true>(a)
                            : run_pass<W, true, false, true>(a);
  }
  if (a.pre != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return a.post != nullptr ? run_pass<W, false, false, true>(a)
                           : run_pass<W, false, false, false>(a);
}

}  // namespace

// x [L, B, m*m] -> out.  Pass A reads x and writes out; pass B transforms
// out in place.  col_first: pass A is the column pass (forward), else the
// row pass (inverse).  moduli [L] int64.  Tables: roots [L, m], pre/post
// [L, m*m] (may be null), as Shoup pairs: with word_bits 64 int64 [.., 2]
// (w, w'), w' = floor(w 2^64 / q); with word_bits 32 one int64 w | w' << 32,
// w' = floor(w 2^32 / q), for moduli below 2^30.
extern "C" int mf_four_step(const int64_t* x, int64_t* out, const int64_t* moduli,
                            int L, int B, int m, int col_first, int word_bits,
                            const void* roots_a, const void* pre_a,
                            const void* post_a, const void* roots_b,
                            const void* pre_b, const void* post_b,
                            void* stream) {
  if (m < 2 || (m & (m - 1)) != 0 || (word_bits != 32 && word_bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PassArgs a{x, out, roots_a, pre_a, post_a, moduli, L, B, m, st};
  const PassArgs b{out, out, roots_b, pre_b, post_b, moduli, L, B, m, st};
  const bool col = col_first != 0;
  int err = word_bits == 32 ? dispatch<uint32_t>(col, a) : dispatch<uint64_t>(col, a);
  if (err != 0) return err;
  return word_bits == 32 ? dispatch<uint32_t>(!col, b) : dispatch<uint64_t>(!col, b);
}
