// K7: the gl2 ciphertext GEMM's tensor step, four modular GEMMs in one
// launch, as u8 digit-plane GEMMs on the int8 tensor cores.
//
// Replaces matrix_fhe_tpu/ops/pallas_cgemm.py:_gemm2x2_kernel (SlicedGemm2x2):
//   E_ij[l, w, a, b] = scale * sum_y U_i[l, w, y, a] * V_j[l, w, y, b] mod q_l
// for i, j in {1, 2}, on canonical int64 residues [L, W, y, m] (contraction
// over the second-to-last axis of both), q_l < 2^56, outputs [4, L, W, m, m]
// in the order E00 = U1 V1, E01 = U1 V2, E10 = U2 V1, E11 = U2 V2.
//
// The method is K1's (csrc/stage.cu) with V_j in the role of the table,
// pre-reduced inside the kernel.  Limb l has d = ceil(bits(q) / 8) digits;
// U = sum_c U_c 2^(8 c), and for each data digit c < d the kernel builds
// V^(c) = V w_c mod q, w_c = scale 2^(8 c) 2^64 mod q (one Shoup product
// by the constant pair (w_c, floor(w_c 2^64 / q)) a digit and element: d
// products an element of V against the 2 m products it feeds) and cuts it
// into u8 planes V^(c)_j.  Then
//
//   diag_j[a, b] = sum_c sum_y U_c[y, a] V^(c)_j[y, b]    (u8 GEMM, s32 sums)
//   E[a, b]      = sum_j diag_j 2^(8 j) 2^-64 mod q       (one REDC an output)
//
// which is canonical with `scale` folded in.  int8 wgmma wants both operands
// K-major, so U's digits are transposed into the A operand (rows a,
// contraction index c * 64 + y) and V's planes into the B operand (rows
// j * 32 + b, N = 32 d, the same contraction index), both with the 128-byte
// swizzle, by the block's threads from int64 loads (8 y values a thread,
// neighbouring threads on neighbouring a or b, so the loads are whole
// 256-byte runs; an 8 x 8 byte transpose in 32 byte permutes gives the 8
// bytes of one digit as one 8-byte store); no digit plane goes to device
// memory.
//
// Block: one (limb, lane) and 128 rows a of E, two warpgroups; warpgroup i
// multiplies U_i's digit tiles, 64 rows a wgmma, so each V_j tile the block
// builds feeds both products it belongs to (E_1j and E_2j) on all 128 rows,
// and each U_i tile, built once while y <= 64, feeds E_i1 and E_i2 over
// every 32-column tile of b.  The contraction runs in chunks of 64 terms
// (d * 64 digit rows); the s32 sums are flushed every 64 chunks (4,096
// terms, at most 28,672 digit rows: 255^2 x 28,672 < 2^31), reduced and
// summed mod q into E, so y may reach 2^16 (every chunk where a warpgroup
// holds two row groups).  Shared memory at d digits, KB = 64 d rounded up
// to 128 bytes: U1 and U2 tiles of 128 rows, 2 x 128 x KB, and the V tile
// 32 d x KB: 168 KB at the ref chain's d = 6 (+ 1 KB alignment).  At d = 7
// that would be 240 KB, so a 55-bit limb's block holds 64 rows of U at a
// time and builds each V tile twice, once for each half (176 KB).  Shared
// memory is sized by the launch's largest need.  Each thread holds one
// product's 16 d s32 sums (112 at d = 7) and the next V tile's 8 elements,
// loaded before a step's products so that their latency hides behind the
// tensor work and the epilogue (254 registers, no spill).
//
// Bound on the H100: at ref (y = 64, m = 128, [11, 512]) the bytes, U1, U2,
// V1, V2 read (1.476 GB) and E written (2.953 GB), 1.322 ms at 3.35 TB/s;
// the function's u8 digit products take 0.621 ms at 1,979 TOP/s.  E is
// written once, two neighbouring outputs a 16-byte store.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "wgmma8.cuh"

namespace {

constexpr int THREADS = 256;       // two warpgroups: U1 and U2
constexpr int BMA = 128;           // rows a of E a block
constexpr int BN = 32;             // columns b a tile; N = 32 d
constexpr int BK = 128;            // contraction bytes a tile (one swizzle row)
constexpr int YC = 64;             // contraction terms a chunk
constexpr int DMAX = 7;
constexpr int FLUSH_CHUNKS = 64;   // 4,096 terms, <= 28,672 digit rows
constexpr int A_TILE = 64 * BK;    // 64 rows of a K-tile: one wgmma's A
constexpr size_t SMEM_LIMIT = 232448;
static_assert(255LL * 255 * FLUSH_CHUNKS * YC * DMAX < (1LL << 31),
              "an s32 sum of one flush's u8 products stays exact");
static_assert(THREADS == BN * YC / 8, "one V unit (8 terms, one b) a thread");

__host__ __device__ constexpr int k_tiles(int d) { return (d * YC + BK - 1) / BK; }
__host__ __device__ constexpr int b_tile(int d) { return BN * d * BK; }
// rows of U1 and of U2 held at a time: all 128 of the block's, but 64 at
// d = 7 (128 would take 240 KB)
__host__ __device__ constexpr int rows_held(int d) { return d <= 6 ? 128 : 64; }
__host__ __device__ constexpr size_t smem_need(int d) {
  return static_cast<size_t>(k_tiles(d)) *
         (2 * rows_held(d) * BK + b_tile(d));
}
constexpr size_t smem_bytes(int dmax) {   // the most any limb's d needs
  size_t most = 0;
  for (int d = 1; d <= dmax; ++d) most = smem_need(d) > most ? smem_need(d) : most;
  return most + 1024;                     // + 1024 B alignment
}
static_assert(smem_bytes(DMAX) <= SMEM_LIMIT, "one block's shared memory");

struct Args {
  const uint64_t* u[2];
  const uint64_t* v[2];
  const int64_t* consts;   // [L, 3]: q, -q^-1 mod 2^64, unused
  const uint64_t* vc;      // [L, 8, 2]: w_c = scale 2^(8 c) 2^64 mod q and
                           // floor(w_c 2^64 / q)
  uint64_t* E;             // [4, L, W, m, m]
  int L, W, y, m;
};

using mfhe::fence_regs;
using mfhe::smem_desc;

using mfhe::byte_planes;
using mfhe::shoup_mul;
using mfhe::st_shared8;
using mfhe::swz;

// U1's and U2's digits of contraction chunk ch on rows a0 .. a0 + R - 1,
// transposed: row group g (64 rows) of U_i is K-tiles at abase + (G i + g)
// KT A_TILE, whose row r, byte c * 64 + y' holds byte c of U_i[y0 + y',
// a0 + 64 g + r] (zero past y and m).
template <int D>
__device__ __forceinline__ void build_u(const Args& p, uint32_t abase, long long lw,
                                       int a0, int ch) {
  constexpr int KT = k_tiles(D), R = rows_held(D), G = R / 64;
#pragma unroll 2
  for (int i = threadIdx.x; i < 2 * R * (YC / 8); i += THREADS) {
    const int which = i / (R * (YC / 8)), r = i % (R * (YC / 8));
    const int aa = r % R, g = r / R, a = a0 + aa, y0 = ch * YC + 8 * g;
    const uint64_t* src = p.u[which] + lw * p.y * p.m + a;
    uint64_t x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = (a < p.m && y0 + e < p.y) ? src[static_cast<long long>(y0 + e) * p.m] : 0;
    const uint32_t base = abase + (G * which + aa / 64) * KT * A_TILE;
    uint64_t w[8];
    byte_planes(x, w);
#pragma unroll
    for (int c = 0; c < D; ++c)
      st_shared8(swz(base, A_TILE, aa % 64, c * YC + 8 * g), w[c]);
  }
}

// This thread's 8 elements of V_j's tile at chunk ch, columns b0 ..
// b0 + 31: V_j[y0 + 8 g + e, b0 + b] (zero past y and m), b = tid % 32,
// g = tid / 32.
__device__ __forceinline__ void load_v(const Args& p, long long lw, int j, int b0,
                                       int ch, uint64_t (&x)[8]) {
  const int bb = threadIdx.x % BN, g = threadIdx.x / BN, b = b0 + bb;
  const int y0 = ch * YC + 8 * g;
  const uint64_t* src = p.v[j] + lw * p.y * p.m + b;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = (b < p.m && y0 + e < p.y) ? src[static_cast<long long>(y0 + e) * p.m] : 0;
}

// V_j's planes of that tile from this thread's elements x: B row
// pj * 32 + b, byte c * 64 + y' holds byte pj of V^(c)[y0 + y', b0 + b].
template <int D>
__device__ __forceinline__ void build_v(const Args& p, const mfhe::LimbConsts& c,
                                        uint32_t bbase, int l,
                                        const uint64_t (&x)[8]) {
  const int bb = threadIdx.x % BN, g = threadIdx.x / BN;
#pragma unroll 1
  for (int cd = 0; cd < D; ++cd) {
    const uint64_t k = p.vc[2 * (8 * l + cd)], kp = p.vc[2 * (8 * l + cd) + 1];
    uint64_t xc[8], w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) xc[e] = shoup_mul(x[e], k, kp, c.q);
    byte_planes(xc, w);
#pragma unroll
    for (int pj = 0; pj < D; ++pj)
      st_shared8(swz(bbase, b_tile(D), pj * BN + bb, cd * YC + 8 * g), w[pj]);
  }
}

template <int D>
__device__ __forceinline__ void body(const Args& p, uint32_t sbase,
                                     const mfhe::LimbConsts& c, long long lw,
                                     int l) {
  constexpr int KT = k_tiles(D), R = rows_held(D), G = R / 64;
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t abase = sbase, bbase = sbase + 2 * R * KT * BK;
  // bytes no build writes (past d * 64 in the last K-tile) stay zero
  for (int i = tid; i < static_cast<int>(smem_need(D) / 16); i += THREADS)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(sbase + 16 * i),
                 "r"(0), "r"(0), "r"(0), "r"(0)
                 : "memory");
  __syncthreads();
  const int nch = (p.y + YC - 1) / YC, nb = (p.m + BN - 1) / BN;
  // with two row groups a warpgroup keeps no sums across chunks: each
  // chunk is reduced and added into E
  const int flush = G > 1 ? 1 : FLUSH_CHUNKS;

  int acc[16 * D];
#pragma unroll
  for (int i = 0; i < 16 * D; ++i) acc[i] = 0;

  // steps s = (cb, j, ch), chunk fastest: V_j's tile of columns cb * 32
  // .. + 31 at chunk ch; the next step's V elements load while this
  // step's products and epilogue run
  const int steps = nb * 2 * nch;
  const int a_end = min(p.m, static_cast<int>(blockIdx.y + 1) * BMA);
  for (int a0 = static_cast<int>(blockIdx.y) * BMA; a0 < a_end; a0 += R) {
    uint64_t xv[8];
    load_v(p, lw, 0, 0, 0, xv);
    for (int st = 0; st < steps; ++st) {
      const int cb = st / (2 * nch), j = st / nch % 2, ch = st % nch;
      if (nch > 1 || st == 0) build_u<D>(p, abase, lw, a0, ch);
      build_v<D>(p, c, bbase, l, xv);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (st + 1 < steps)
        load_v(p, lw, (st + 1) / nch % 2, (st + 1) / (2 * nch) * BN,
               (st + 1) % nch, xv);
      const bool fresh = ch % flush == 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t sa = abase + (G * wg + g) * KT * A_TILE;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            mfhe::wgmma8<D, false>(
                acc, smem_desc(sa + t * A_TILE + 32 * kk),
                smem_desc(bbase + t * b_tile(D) + 32 * kk),
                (fresh && t == 0 && kk == 0) ? 0 : 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(acc);
        if ((ch + 1) % flush == 0 || ch == nch - 1)
          mfhe::store_tile<D>(
              acc, p.E + (static_cast<long long>(2 * wg + j) * p.L * p.W + lw) * p.m * p.m,
              p.m, c, a0 + 64 * g, cb * BN, ch < flush);
      }
      __syncthreads();               // both warpgroups' products read the tiles
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) gemm2x2_kernel(const Args p) {
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

// u1, u2, v1, v2: [L, W, y, m] canonical int64; e: [4, L, W, m, m], 16-byte
// aligned; consts [L, 3] (q, -q^-1 mod 2^64, ...); vc [L, 8, 2] with
// vc[l][c] = (w, floor(w 2^64 / q_l)), w = scale 2^(8 c) 2^64 mod q_l, the
// Shoup pair of digit c's pre-reduction; dmax the largest digit count of
// the limbs (it sizes shared memory).  y <= 65536.
extern "C" int mf_gemm2x2(const int64_t* u1, const int64_t* u2, const int64_t* v1,
                          const int64_t* v2, const int64_t* consts,
                          const int64_t* vc, int64_t* e, int L, int W, int y,
                          int m, int dmax, void* stream) {
  if (dmax < 1 || dmax > DMAX || y < 1 || y > (1 << 16) || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(dmax);
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm2x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Args p{{reinterpret_cast<const uint64_t*>(u1), reinterpret_cast<const uint64_t*>(u2)},
               {reinterpret_cast<const uint64_t*>(v1), reinterpret_cast<const uint64_t*>(v2)},
               consts, reinterpret_cast<const uint64_t*>(vc),
               reinterpret_cast<uint64_t*>(e), L, W, y, m};
  dim3 grid(static_cast<unsigned>(L) * W, (m + BMA - 1) / BMA);
  gemm2x2_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
