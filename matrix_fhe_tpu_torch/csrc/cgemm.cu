// K6: the trace GEMM, C = scale * A @ B^T mod q_l, complex, per (limb, lane),
// as u8 digit-plane GEMMs on the int8 tensor cores.
//
// Replaces matrix_fhe_tpu/ops/pallas_cgemm.py:_cgemm_kernel (SlicedCGemm):
//   re[l,w,r,c] = scale * sum_t (Ar[r,t] Br[c,t] - Ai[r,t] Bi[c,t]) mod q_l
//   im[l,w,r,c] = scale * sum_t (Ar[r,t] Bi[c,t] + Ai[r,t] Br[c,t]) mod q_l
// on canonical int64 residues [L, W, n, n], q_l < 2^56, n < 2^15.
//
// The method is K7's (csrc/gemm2x2.cu) on a complex product.  Limb l has
// d = ceil(bits(q) / 8) digits; A = sum_c A_c 2^(8 c), and for each digit c
// the kernel pre-reduces B by one Shoup product, B^(c) = B w_c mod q with
// w_c = scale 2^(8 c) 2^64 mod q (the constant pairs of K7's `vconsts`),
// and cuts it into u8 planes B^(c)_j.  Both real products of an output run
// as one contraction over (c, h, t): h = 0 takes Ar's digits, h = 1 Ai's,
// against
//
//   re: Br^(c) (h = 0) and (-Bi)^(c) = q - Bi^(c) (h = 1; -Bi w_c = Bi (q -
//       w_c) mod q, so the subtraction is one negation of a product the
//       kernel has made anyway, and no digit is signed)
//   im: Bi^(c) (h = 0) and Br^(c) (h = 1),
//
//   diag_j[r, c'] = sum_c sum_h sum_t A_(h,c)[r, t] B^(c)_(h,j)[c', t]
//   out[r, c']    = sum_j diag_j 2^(8 j) 2^-64 mod q    (one REDC an output)
//
// which is canonical with `scale` folded in.  Both operands are K-major as
// int8 wgmma wants (the contraction index t is the last axis of A and B),
// so a thread loads 8 neighbouring t of one row as whole 64-byte runs and
// cuts their digits by an 8 x 8 byte transpose (32 byte permutes) into one
// 8-byte store per plane, with the 128-byte swizzle; no digit plane goes to
// device memory.
//
// Block: one (limb, lane) and 64 rows r of the output, two warpgroups: the
// first makes re, the second im, on one shared A tile (wgmma m64n(32 d)k32
// .s32.u8.u8, N = 32 d: the d planes of 32 output columns, so a thread folds
// the plane sums of its outputs in registers).  The contraction runs in
// chunks of TC terms t (a K extent of 2 TC d bytes: 64 for d <= 6, 32 for
// d = 7, so that A and both B tiles fit), over steps (column tile of 32,
// chunk), chunk fastest.  Each step builds the B tiles of both warpgroups
// from the same Br and Bi elements (d Shoup products an element, which feed
// 2 x 64 rows of products), loaded before the previous step's products so
// that their latency hides behind the tensor work and the epilogue.  A's
// tiles of every chunk stay resident across the column tiles where they
// fit (n <= 96 at d = 6, 128 at d = 5, 112 at d = 7), else each step
// rebuilds its chunk.  The s32 sums are flushed every 4,096 contraction
// terms (digit rows 4,096 d: 255^2 x 28,672 < 2^31), reduced and summed mod
// q into the output, so n may reach 2^15.  Shared memory: A chunks of 64 rows x 2 TC d
// bytes, two B tiles of 32 d rows each: 192 KB at the ref chain's 45-bit
// limb (d = 6, two A chunks resident), 176 KB at d = 7.
//
// Bound on the H100: at ref ([11, 512, 64, 64], scale n) the bytes, Ar, Ai,
// Br, Bi read and re, im written (1.107 GB), 0.330 ms at 3.35 TB/s; the
// function's u8 digit products, 8 W n^3 d_l^2 a limb (3.07e11), 0.155 ms at
// 1,979 TOP/s.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "wgmma8.cuh"

namespace {

constexpr int THREADS = 256;       // two warpgroups: re and im
constexpr int BM = 64;             // output rows a block
constexpr int BN = 32;             // output columns a tile; N = 32 d
constexpr int BK = 128;            // contraction bytes a K-tile (one swizzle row)
constexpr int DMAX = 7;
constexpr int FLUSH_TERMS = 4096;  // contraction terms (h, t) between flushes
constexpr int A_TILE = BM * BK;    // one K-tile of A
constexpr size_t SMEM_BYTES = 232448;   // all of it: one block an SM
static_assert(255LL * 255 * FLUSH_TERMS * DMAX < (1LL << 31),
              "an s32 sum of one flush's u8 products stays exact");

// terms t a chunk, and the chunk's K-tiles (2 TC d bytes, rounded up)
__host__ __device__ constexpr int tc(int d) { return d <= 6 ? 32 : 16; }
__host__ __device__ constexpr int k_steps(int d) { return 2 * tc(d) * d / 32; }
__host__ __device__ constexpr int k_tiles(int d) { return (k_steps(d) + 3) / 4; }
__host__ __device__ constexpr int a_chunk(int d) { return k_tiles(d) * A_TILE; }
__host__ __device__ constexpr int b_tile(int d) { return BN * d * BK; }
__host__ __device__ constexpr int b_bytes(int d) { return k_tiles(d) * b_tile(d); }
// A chunks that fit beside the two B tiles
__host__ __device__ constexpr int a_slots(int d) {
  return static_cast<int>((SMEM_BYTES - 1024 - 2 * b_bytes(d)) / a_chunk(d));
}
static_assert(a_slots(6) >= 2 && a_slots(7) >= 4 && a_slots(1) >= 1,
              "the ref shape keeps A resident; every d fits one chunk");
static_assert(THREADS == BN * 2 * 32 / 8, "one B unit (8 terms of Br or Bi) a thread");

struct Args {
  const uint64_t* ar;
  const uint64_t* ai;
  const uint64_t* br;
  const uint64_t* bi;
  const int64_t* consts;   // [L, 3]: q, -q^-1 mod 2^64, unused
  const uint64_t* vc;      // [L, 8, 2]: w_c = scale 2^(8 c) 2^64 mod q and
                           // floor(w_c 2^64 / q)
  uint64_t* cr;            // [L, W, n, n]
  uint64_t* ci;
  int W, n;
};

using mfhe::byte_planes;
using mfhe::fence_regs;
using mfhe::shoup_mul;
using mfhe::smem_desc;
using mfhe::st_shared8;
using mfhe::swz;

// A's digits of chunk ch on rows r0 .. r0 + 63 into the chunk's K-tiles at
// abase: row r, byte c * 2 TC + h * TC + t' holds byte c of (h ? Ai : Ar)
// [r0 + r, ch TC + t'] (zero past n).  Units of 8 terms, t fastest.
template <int D>
__device__ __forceinline__ void build_a(const Args& p, uint32_t abase, long long lw,
                                       int r0, int ch) {
  constexpr int TC = tc(D), G = TC / 8;
#pragma unroll 2
  for (int u = threadIdx.x; u < BM * 2 * G; u += THREADS) {
    const int g = u % G, rr = (u / G) % BM, h = u / (G * BM);
    const int r = r0 + rr, t0 = ch * TC + 8 * g;
    const uint64_t* src = (h ? p.ai : p.ar) + (lw * p.n + r) * p.n + t0;
    uint64_t x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = (r < p.n && t0 + e < p.n) ? src[e] : 0;
    uint64_t w[8];
    byte_planes(x, w);
#pragma unroll
    for (int c = 0; c < D; ++c)
      st_shared8(swz(abase, A_TILE, rr, c * 2 * TC + h * TC + 8 * g), w[c]);
  }
}

// This thread's 8 elements of the step's B unit: (h ? Bi : Br)[c0 + col,
// ch TC + 8 g + e] (zero past n), unit tid = (h, col, g), g fastest; the
// threads past the 2 x 32 x TC / 8 units (at d = 7) hold none.
template <int D>
__device__ __forceinline__ void load_b(const Args& p, long long lw, int c0, int ch,
                                      uint64_t (&x)[8]) {
  constexpr int TC = tc(D), G = TC / 8;
  const int u = threadIdx.x, g = u % G, col = c0 + (u / G) % BN, h = u / (G * BN);
  const int t0 = ch * TC + 8 * g;
  const bool unit = u < 2 * BN * G;
  const uint64_t* src = (h ? p.bi : p.br) + (lw * p.n + col) * p.n + t0;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = (unit && col < p.n && t0 + e < p.n) ? src[e] : 0;
}

// The B tiles of both warpgroups from this thread's unit: for each digit c,
// X^(c) = X w_c mod q cut into planes j at B row j * 32 + col; Br^(c) goes
// to re at h = 0 and to im at h = 1, Bi^(c) to im at h = 0 and, negated,
// to re at h = 1.
template <int D>
__device__ __forceinline__ void build_b(const Args& p, const mfhe::LimbConsts& c,
                                        uint32_t bre, uint32_t bim, int l,
                                        const uint64_t (&x)[8]) {
  constexpr int TC = tc(D), G = TC / 8;
  const int u = threadIdx.x, g = u % G, col = (u / G) % BN, h = u / (G * BN);
  if (u >= 2 * BN * G) return;
#pragma unroll 1
  for (int cd = 0; cd < D; ++cd) {
    const uint64_t k = p.vc[2 * (8 * l + cd)], kp = p.vc[2 * (8 * l + cd) + 1];
    const int kb = cd * 2 * TC + 8 * g;
    uint64_t xc[8], w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) xc[e] = shoup_mul(x[e], k, kp, c.q);
    byte_planes(xc, w);
    // Br^(c): re at h = 0, im at h = 1; Bi^(c): im at h = 0
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (h == 0) {
        st_shared8(swz(bre, b_tile(D), j * BN + col, kb), w[j]);
        st_shared8(swz(bim, b_tile(D), j * BN + col, kb + TC), w[j]);
      } else {
        st_shared8(swz(bim, b_tile(D), j * BN + col, kb), w[j]);
      }
    }
    if (h == 1) {              // -Bi^(c) = q - Bi^(c) mod q: re at h = 1
#pragma unroll
      for (int e = 0; e < 8; ++e) xc[e] = xc[e] ? c.q - xc[e] : 0;
      byte_planes(xc, w);
#pragma unroll
      for (int j = 0; j < D; ++j)
        st_shared8(swz(bre, b_tile(D), j * BN + col, kb + TC), w[j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void body(const Args& p, uint32_t sbase,
                                     const mfhe::LimbConsts& c, long long lw,
                                     int l) {
  constexpr int KS = k_steps(D);
  const int wg = threadIdx.x >> 7;
  const uint32_t bre = sbase, bim = sbase + b_bytes(D);
  const uint32_t abase = sbase + 2 * b_bytes(D);
  const uint32_t bmine = wg ? bim : bre;
  const int nch = (p.n + tc(D) - 1) / tc(D), nb = (p.n + BN - 1) / BN;
  const bool resident = nch <= a_slots(D);
  const int flush = FLUSH_TERMS / (2 * tc(D));
  const int r0 = static_cast<int>(blockIdx.y) * BM;
  uint64_t* out = (wg ? p.ci : p.cr) + lw * p.n * p.n;

  int acc[16 * D];
#pragma unroll
  for (int i = 0; i < 16 * D; ++i) acc[i] = 0;

  // steps s = (cb, ch), chunk fastest; the next step's B elements load
  // while this step's products and epilogue run
  const int steps = nb * nch;
  uint64_t xb[8];
  load_b<D>(p, lw, 0, 0, xb);
  for (int st = 0; st < steps; ++st) {
    const int cb = st / nch, ch = st % nch;
    const uint32_t sa = abase + (resident ? ch : 0) * a_chunk(D);
    if (!resident || cb == 0) build_a<D>(p, sa, lw, r0, ch);
    build_b<D>(p, c, bre, bim, l, xb);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (st + 1 < steps) load_b<D>(p, lw, (st + 1) / nch * BN, (st + 1) % nch, xb);
    const bool fresh = ch % flush == 0;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mfhe::wgmma8<D, false>(
          acc, smem_desc(sa + (ks >> 2) * A_TILE + 32 * (ks & 3)),
          smem_desc(bmine + (ks >> 2) * b_tile(D) + 32 * (ks & 3)),
          (fresh && ks == 0) ? 0 : 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if ((ch + 1) % flush == 0 || ch == nch - 1)
      mfhe::store_tile<D>(acc, out, p.n, c, r0, cb * BN, ch < flush);
    __syncthreads();                 // both warpgroups' products read the tiles
  }
}

__global__ void __launch_bounds__(THREADS, 1) cgemm_kernel(const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const long long lw = blockIdx.x;
  const int l = static_cast<int>(lw / p.W);
  const mfhe::LimbConsts c = mfhe::load_consts(p.consts, l);
  switch (mfhe::digits_of(c.q)) {
    case 1: body<1>(p, sbase, c, lw, l); break;
    case 2: body<2>(p, sbase, c, lw, l); break;
    case 3: body<3>(p, sbase, c, lw, l); break;
    case 4: body<4>(p, sbase, c, lw, l); break;
    case 5: body<5>(p, sbase, c, lw, l); break;
    case 6: body<6>(p, sbase, c, lw, l); break;
    default: body<7>(p, sbase, c, lw, l); break;
  }
}

}  // namespace

// ar, ai, br, bi: [L, W, n, n] canonical int64; cr, ci: [L, W, n, n], 16-byte
// aligned; consts [L, 3] (q, -q^-1 mod 2^64, ...); vc [L, 8, 2] with
// vc[l][c] = (w, floor(w 2^64 / q_l)), w = scale 2^(8 c) 2^64 mod q_l, the
// Shoup pair of digit c's pre-reduction.  1 <= n < 2^15.
extern "C" int mf_cgemm(const int64_t* ar, const int64_t* ai, const int64_t* br,
                        const int64_t* bi, const int64_t* consts, const int64_t* vc,
                        int64_t* cr, int64_t* ci, int L, int W, int n,
                        void* stream) {
  if (n < 1 || n >= (1 << 15) || L < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      cgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Args p{reinterpret_cast<const uint64_t*>(ar), reinterpret_cast<const uint64_t*>(ai),
               reinterpret_cast<const uint64_t*>(br), reinterpret_cast<const uint64_t*>(bi),
               consts, reinterpret_cast<const uint64_t*>(vc),
               reinterpret_cast<uint64_t*>(cr), reinterpret_cast<uint64_t*>(ci), W, n};
  dim3 grid(static_cast<unsigned>(L) * W, (n + BM - 1) / BM);
  cgemm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
