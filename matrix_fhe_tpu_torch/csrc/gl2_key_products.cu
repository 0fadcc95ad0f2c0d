// The gl2 relinearize's key products, one launch a digit (launch key
// gl2_key_products): models/he_matmul2.Gl2GemmRelin._relin_chunk on the
// card, through ops/key_products.KeyProducts.  For digit i's 2D spectrum
// hat over a chunk of QP limbs, and the two switch keys kb_i, ka_i in their
// storage form k 2^64 mod q, both accumulators are updated in place:
//
//   u0 <- (u0 + mont_mul(hat, kb_i)) mod q
//   u1 <- (u1 + mont_mul(hat, ka_i)) mod q
//
// mont_mul is modarith.cuh's REDC with R = 2^64: hat k 2^64 2^-64 = hat k
// mod q exactly, for canonical operands below q < 2^56, so the sums need
// no 2^-64 factor afterwards.  On the first digit the accumulators are
// written without being read.  Outputs are canonical, in [0, q).
//
// It replaces no Pallas kernel: the JAX package leaves these products to
// XLA as plain jnp.  The port ran them as ops/modmath.mul_mod's Horner
// loop, about 105 int64 PyTorch launches a product, 90% of a ref_gl2.gemm
// request.
//
// Bound on the H100: bytes.  A launch on [Lc, Wb, m, m] reads hat and both
// keys, and reads and writes both accumulators: 7 planes (5 on the first
// digit), 6.6 GB at ref's [14, 512, 128, 128], 1.96 ms at 3.35 TB/s.  Its
// two REDCs an element (~14 IMADs each) take ~0.2 ms at 1.67e13 IMAD/s.  So
// every stream is a 16-byte access by neighbouring threads to neighbouring
// addresses, nothing else touches device memory, and each thread starts
// all of its loads before its first product.
//
// Layout: kb, ka, u0 and u1 are contiguous [Lc, Wb, x1, x2].  hat comes
// either contiguous or as the 2D NTT leaves it (Gl2GemmRelin._ntt2d):
// logically [x1, x2], physically [x2, x1].  A block takes one 32 x 32 tile
// of one (limb, lane) slab.  For the transposed hat it reads the tile
// along x1 (physical rows, 16-byte loads) into shared memory, and after a
// barrier each thread takes its two x2 neighbours of one x1 from there, so
// that the keys and accumulators are read and written along x2 in 16-byte
// pairs; the tile's rows are padded by one word.  No contiguous copy of hat
// is made.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int TILE = 32;                 // a TILE x TILE tile of one slab
constexpr int PAIRS = TILE / 2;          // 16-byte column pairs of a row
constexpr int THREADS = 256;             // PAIRS x ROWS
constexpr int ROWS = THREADS / PAIRS;    // 16: a thread takes rows r, r + 16
constexpr int PER = TILE / ROWS;         // 2 rows a thread

__device__ __forceinline__ ulonglong2 load2(const uint64_t* p) {
  return *reinterpret_cast<const ulonglong2*>(p);
}

__device__ __forceinline__ void store2(uint64_t* p, uint64_t x, uint64_t y) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(x, y);
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

template <bool TRANSPOSED, bool FIRST>
__global__ void __launch_bounds__(THREADS)
gl2_key_products_kernel(const uint64_t* __restrict__ hat,
                        const uint64_t* __restrict__ kb,
                        const uint64_t* __restrict__ ka,
                        uint64_t* __restrict__ u0, uint64_t* __restrict__ u1,
                        const int64_t* __restrict__ consts, int lanes, int m,
                        int tiles) {
  __shared__ uint64_t tile[TRANSPOSED ? TILE : 1][TILE + 1];
  long long b = blockIdx.x;
  const int tc = static_cast<int>(b % tiles);    // x2 tile
  b /= tiles;
  const int tr = static_cast<int>(b % tiles);    // x1 tile
  const long long slab = b / tiles;              // limb * lanes + lane
  const mfhe::LimbConsts c =
      mfhe::load_consts(consts, static_cast<int>(slab / lanes));
  const long long base = slab * m * m;
  const int pair = threadIdx.x % PAIRS;
  const int row = threadIdx.x / PAIRS;
  const int x2 = tc * TILE + 2 * pair;           // m is even: x2 + 1 < m too
  const bool col_in = x2 < m;

  ulonglong2 vkb[PER], vka[PER], vu0[PER], vu1[PER], vh[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int x1 = tr * TILE + row + ROWS * j;
    if (col_in && x1 < m) {
      const long long at = base + static_cast<long long>(x1) * m + x2;
      vkb[j] = load2(kb + at);
      vka[j] = load2(ka + at);
      if (!FIRST) {
        vu0[j] = load2(u0 + at);
        vu1[j] = load2(u1 + at);
      }
      if (!TRANSPOSED) vh[j] = load2(hat + at);
    }
  }
  if (TRANSPOSED) {
    // physical rows x2 of the tile, read along x1
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p2 = tc * TILE + row + ROWS * j;
      const int p1 = tr * TILE + 2 * pair;
      if (p2 < m && p1 < m) {
        const ulonglong2 h = load2(hat + base + static_cast<long long>(p2) * m + p1);
        tile[row + ROWS * j][2 * pair] = h.x;
        tile[row + ROWS * j][2 * pair + 1] = h.y;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      vh[j].x = tile[2 * pair][row + ROWS * j];
      vh[j].y = tile[2 * pair + 1][row + ROWS * j];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int x1 = tr * TILE + row + ROWS * j;
    if (col_in && x1 < m) {
      const long long at = base + static_cast<long long>(x1) * m + x2;
      uint64_t b0 = mfhe::mont_mul(vh[j].x, vkb[j].x, c);
      uint64_t b1 = mfhe::mont_mul(vh[j].y, vkb[j].y, c);
      uint64_t a0 = mfhe::mont_mul(vh[j].x, vka[j].x, c);
      uint64_t a1 = mfhe::mont_mul(vh[j].y, vka[j].y, c);
      if (!FIRST) {
        b0 = add_mod(vu0[j].x, b0, c.q);
        b1 = add_mod(vu0[j].y, b1, c.q);
        a0 = add_mod(vu1[j].x, a0, c.q);
        a1 = add_mod(vu1[j].y, a1, c.q);
      }
      store2(u0 + at, b0, b1);
      store2(u1 + at, a0, a1);
    }
  }
}

template <bool TRANSPOSED, bool FIRST>
int launch(const uint64_t* hat, const uint64_t* kb, const uint64_t* ka,
           uint64_t* u0, uint64_t* u1, const int64_t* consts, int lanes, int m,
           int tiles, unsigned blocks, cudaStream_t stream) {
  gl2_key_products_kernel<TRANSPOSED, FIRST><<<blocks, THREADS, 0, stream>>>(
      hat, kb, ka, u0, u1, consts, lanes, m, tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// hat [limbs, lanes, m, m] (transposed: stored as [limbs, lanes, x2, x1]);
// kb, ka, u0, u1 contiguous [limbs, lanes, m, m]; consts [limbs, 3] from
// ops/modmath.kernel_consts, each q odd and below 2^56.  first != 0 writes
// u0 and u1 without reading them.  Returns cudaErrorInvalidValue for an odd
// m, a pointer that is not 16-byte aligned or a grid past 2^31 - 1 blocks.
extern "C" int mf_gl2_key_products(const int64_t* hat, const int64_t* kb,
                                   const int64_t* ka, int64_t* u0, int64_t* u1,
                                   const int64_t* consts, int limbs, int lanes,
                                   int m, int transposed, int first,
                                   void* stream) {
  if (limbs < 1 || lanes < 1 || m < 2 || m % 2 != 0 || !aligned16(hat) ||
      !aligned16(kb) || !aligned16(ka) || !aligned16(u0) || !aligned16(u1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (m + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(limbs) * lanes * tiles * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto* h = reinterpret_cast<const uint64_t*>(hat);
  const auto* b = reinterpret_cast<const uint64_t*>(kb);
  const auto* a = reinterpret_cast<const uint64_t*>(ka);
  auto* v0 = reinterpret_cast<uint64_t*>(u0);
  auto* v1 = reinterpret_cast<uint64_t*>(u1);
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<unsigned>(blocks);
  if (transposed) {
    return first ? launch<true, true>(h, b, a, v0, v1, consts, lanes, m, tiles, n, cs)
                 : launch<true, false>(h, b, a, v0, v1, consts, lanes, m, tiles, n, cs);
  }
  return first ? launch<false, true>(h, b, a, v0, v1, consts, lanes, m, tiles, n, cs)
               : launch<false, false>(h, b, a, v0, v1, consts, lanes, m, tiles, n, cs);
}
