// K1 and K10a: one exact modular matmul stage per RNS limb on the int8
// tensor cores, optionally followed by a per-output Montgomery twiddle.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_stage_kernel (:1633,
// SlicedStage) and :_stage_kernel (:460, PallasStage with its twiddle):
// C[l] = A[l] @ B[l] mod q_l, canonical int64 residues, q_l < 2^56.  Side
// "left" (W-CRT) is table [L, W, K] @ data [L, K, M]; "batched_left" runs a
// batch of such data per limb ([L, B, K, M], grid z = l * B + b) against one
// table; "right" (X-NTT) is data [L, R, K] @ table^T.  With a twiddle the
// output is multiplied by tw[l, row mod tw_rows, col] in the JAX storage form
// tw * 2^64 mod q: one Montgomery product (R = 2^64) in the epilogue.
//
// The method is the TPU kernel's, with 8-bit unsigned digits.  Limb l has
// d = ceil(bits(q) / 8) digits.  A data residue is x = sum_c x_c 2^(8 c);
// the table is pre-reduced once per data digit, T^(c) = T 2^(8 c) mod q, and
// cut into digit planes T^(c)_j (u8).  Then
//
//   diag_j[w, m] = sum_c sum_k T^(c)_j[w, k] x_c[k, m]   (u8 GEMM, s32 sums)
//   out[w, m]    = sum_j diag_j[w, m] 2^(8 j) mod q      (128-bit fold, one
//                                                         REDC an output)
//
// The planes are cut from T^(c) 2^64 mod q, so that the Montgomery REDC
// (R = 2^64) of the fold S < 2^80 is the canonical residue: no 64-bit
// division and no second product an output.
//
// The digit-plane layouts (built by ops/cuda_ntt.py): the contraction of
// limb l is a row of KB_l bytes, K-major as int8 wgmma needs both operands.
// Side "right": the data [R, K] viewed as bytes is already [R, 8 K] with the
// contraction index 8 k + c, so it is read as it stands (8 digit slots, the
// top ones zero for a canonical residue).  Sides "left" and "batched_left":
// the data is M-major, so a split pass (stage_split_kernel, launch key
// "stage_split") writes its digit planes transposed, [Z, M, KBx] bytes with
// index c * Kp + k (d slots, Kp = K rounded up to 32).  The table planes are
// [L, ceil(W / 32), Dmax, 32, KBs] bytes in the same contraction order,
// zero past the limb's own digits.  The host takes Kp, KBs, the 32 rows and
// the flush interval from mf_stage_layout, so this file owns the layout.
//
// Bound on the H100: the u8 products, 2 rows cols KB_l d_l operations a
// limb, at 1,979 TOP/s dense int8 (at the key switch's W-CRT [14, 512,
// 4096] 0.42 ms, against 6.9 ms for 64 x 64-bit products at the card's IMAD
// rate), or the bytes at 3.35 TB/s where the contraction is short (the
// X-NTT, K = 64).  The design: a block of two warpgroups owns 128 data rows
// x 32 table rows; each warpgroup issues wgmma m64n(32 d)k32 .s32.u8.u8 with
// the data tile as A and all d table planes of its 32 rows as B (N = 32 d,
// so the d plane sums of one output land in one thread and are folded in
// registers).  K advances in 128-byte tiles through a ring of four
// shared-memory stages filled by cp.async (16 bytes a thread, the 128-byte
// swizzle written by hand), two tiles ahead of the tensor cores.  Each s32
// sum is exact while the contraction is at most 33,025 digit rows (d K 255^2
// < 2^31); longer ones are flushed every 256 tiles (32,768 rows) into the
// output, reduced, and summed mod q, so every contraction the JAX class
// takes runs.  The per-limb d is read from q, so one launch covers limbs of
// every width.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "wgmma8.cuh"

namespace {

constexpr int BM = 128;            // data rows a block (two warpgroups of 64)
constexpr int BW = 32;             // table rows a block; N = 32 d
constexpr int BK = 128;            // contraction bytes a tile (one swizzle row)
constexpr int DMAX = 7;            // digits of a modulus below 2^56
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int FLUSH_TILES = 256;   // 32,768 digit rows: 255^2 * rows < 2^31
constexpr int A_BYTES = BM * BK;
constexpr int STAGE_BYTES = A_BYTES + DMAX * BW * BK;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + 1024 B alignment
static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(255LL * 255 * FLUSH_TILES * BK < (1LL << 31),
              "an s32 sum of one flush's u8 products stays exact");

constexpr int SPLIT_K = 32, SPLIT_M = 64, SPLIT_THREADS = 256;

struct StageArgs {
  const uint8_t* X;      // data digit rows: [Z, rows, ...] bytes
  const uint8_t* T;      // table planes [L, Wt, Dmax, 32, KBs]
  int64_t* out;
  const int64_t* consts;
  const int64_t* tw;     // null, or [L, tw_rows, cols] in storage form
  long long sXz, sXr;    // data strides in bytes: per z, per row
  int batch, rows, W, Kp, left, tw_rows, KBs, Dmax;
};

using mfhe::cp_async16;
using mfhe::cp_async_commit;
using mfhe::cp_async_wait;
using mfhe::fence_regs;
using mfhe::smem_desc;

// Fold the d plane sums of this thread's 16 outputs and reduce each with
// one Montgomery REDC (the planes carry the factor 2^64, and S < q 2^64:
// hi < 2^(8 d - 40) <= q / 2^8), then write (first chunk), or add to what
// an earlier chunk wrote; the twiddle after the last chunk.  Side "right"
// writes each thread's two neighbouring columns as one 16-byte store.
template <int D>
__device__ __forceinline__ void epilogue(const int (&acc)[16 * D],
                                         const StageArgs& p,
                                         const mfhe::LimbConsts& c, int z,
                                         int l, bool first, bool last) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int rbase = blockIdx.x * BM + (tid >> 5) * 16 + (lane >> 2);
  const int wbase = blockIdx.y * BW + 2 * (lane & 3);
  const long long Mo = p.left ? p.W : p.rows, No = p.left ? p.rows : p.W;
  uint64_t* out = reinterpret_cast<uint64_t*>(p.out) + z * Mo * No;
  const uint64_t* tw =
      (last && p.tw) ? reinterpret_cast<const uint64_t*>(p.tw) +
                           static_cast<long long>(l) * p.tw_rows * No
                     : nullptr;
  const bool pairs = !p.left && (p.W & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rbase + 8 * h;
    if (row >= p.rows) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int w = wbase + 8 * t;
      if (w >= p.W) continue;
      uint64_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint64_t hi, lo;
        mfhe::fold<D>(acc, 4 * t + 2 * h + e, hi, lo);
        v[e] = mfhe::mont_redc(hi, lo, c);
      }
      if (pairs && w + 1 < p.W) {     // out[row, w : w + 2], 16-byte aligned
        const long long o = row * No + w;
        ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + o);
        if (!first) {
          const ulonglong2 prev = *dst;
          v[0] += prev.x;
          v[1] += prev.y;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (v[e] >= c.q) v[e] -= c.q;
        }
        if (tw) {
          const ulonglong2 f = *reinterpret_cast<const ulonglong2*>(
              tw + (row % p.tw_rows) * No + w);
          v[0] = mfhe::mont_mul(v[0], f.x, c);
          v[1] = mfhe::mont_mul(v[1], f.y, c);
        }
        *dst = make_ulonglong2(v[0], v[1]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (w + e >= p.W) continue;
        const int orow = p.left ? w + e : row, ocol = p.left ? row : w + e;
        uint64_t* o = out + orow * No + ocol;
        if (!first) {
          v[e] += *o;
          if (v[e] >= c.q) v[e] -= c.q;
        }
        if (tw) v[e] = mfhe::mont_mul(v[e], tw[(orow % p.tw_rows) * No + ocol], c);
        *o = v[e];
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void stage_body(const StageArgs& p, uint32_t sbase,
                                           const mfhe::LimbConsts& c, int z,
                                           int l) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = blockIdx.x * BM;
  const int KB = (p.left ? D : 8) * p.Kp;   // this limb's contraction
  const int nt = (KB + BK - 1) / BK;
  const uint8_t* xa = p.X + z * p.sXz;
  const uint8_t* tb =
      p.T + (static_cast<long long>(l) * gridDim.y + blockIdx.y) * p.Dmax *
                BW * p.KBs;

  auto load = [&](int t) {
    const uint32_t sa = sbase + (t % STAGES) * STAGE_BYTES, sb = sa + A_BYTES;
    const int k0 = t * BK;
    for (int i = tid; i < BM * 8; i += THREADS) {
      const int r = i >> 3, ch = i & 7, kb = k0 + 16 * ch;
      const bool ok = row0 + r < p.rows && kb < KB;
      const uint8_t* src = ok ? xa + (row0 + r) * p.sXr + kb : p.X;
      cp_async16(sa + r * BK + ((ch ^ (r & 7)) << 4), src, ok ? 16 : 0);
    }
    for (int i = tid; i < D * BW * 8; i += THREADS) {
      const int r = i >> 3, ch = i & 7;
      cp_async16(sb + r * BK + ((ch ^ (r & 7)) << 4),
                 tb + static_cast<long long>(r) * p.KBs + k0 + 16 * ch, 16);
    }
  };

  int acc[16 * D];
#pragma unroll
  for (int i = 0; i < 16 * D; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  for (int c0 = 0; c0 < nt; c0 += FLUSH_TILES) {
    const int c1 = min(nt, c0 + FLUSH_TILES);
    for (int t = c0; t < c1; ++t) {
      cp_async_wait<STAGES - 3>();   // this thread's copies of tile t landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();               // everyone's; tile t - 2's products done
      if (t + STAGES - 2 < nt) load(t + STAGES - 2);
      cp_async_commit();
      const uint32_t sa = sbase + (t % STAGES) * STAGE_BYTES + wg * (64 * BK);
      const uint32_t sb = sbase + (t % STAGES) * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        mfhe::wgmma8<D, false>(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk),
                          (t > c0 || kk > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(acc);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    epilogue<D>(acc, p, c, z, l, c0 == 0, c1 == nt);
  }
}

__global__ void __launch_bounds__(THREADS, 1) stage_kernel(const StageArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const int z = blockIdx.z, l = z / p.batch;
  const mfhe::LimbConsts c = mfhe::load_consts(p.consts, l);
  switch (mfhe::digits_of(c.q)) {
    case 1: stage_body<1>(p, sbase, c, z, l); break;
    case 2: stage_body<2>(p, sbase, c, z, l); break;
    case 3: stage_body<3>(p, sbase, c, z, l); break;
    case 4: stage_body<4>(p, sbase, c, z, l); break;
    case 5: stage_body<5>(p, sbase, c, z, l); break;
    case 6: stage_body<6>(p, sbase, c, z, l); break;
    default: stage_body<7>(p, sbase, c, z, l); break;
  }
}

// x [Z, K, M] int64 -> xs[z, m, c * Kp + k] = byte c of x[z, k, m], c < d_l,
// zero for K <= k < Kp.  A 32 x 64 tile goes through shared memory so that
// both the int64 reads (along m) and the 16-byte writes (along k) are whole.
__global__ void __launch_bounds__(SPLIT_THREADS)
stage_split_kernel(const int64_t* __restrict__ x, uint8_t* __restrict__ xs,
                   const int64_t* __restrict__ consts, int batch, int K, int M,
                   int Kp, int KBx) {
  __shared__ uint64_t tile[SPLIT_K][SPLIT_M + 1];
  const int z = blockIdx.z;
  const int d = mfhe::digits_of(mfhe::load_consts(consts, z / batch).q);
  const int k0 = blockIdx.y * SPLIT_K, m0 = blockIdx.x * SPLIT_M;
  const uint64_t* src =
      reinterpret_cast<const uint64_t*>(x) + static_cast<long long>(z) * K * M;
  for (int i = threadIdx.x; i < SPLIT_K * SPLIT_M; i += SPLIT_THREADS) {
    const int kk = i / SPLIT_M, mm = i % SPLIT_M;
    tile[kk][mm] = (k0 + kk < K && m0 + mm < M)
                       ? src[static_cast<long long>(k0 + kk) * M + m0 + mm]
                       : 0;
  }
  __syncthreads();
  uint8_t* dst = xs + static_cast<long long>(z) * M * KBx;
  for (int i = threadIdx.x; i < SPLIT_M * d * 2; i += SPLIT_THREADS) {
    const int half = i & 1, mm = (i >> 1) % SPLIT_M, cd = (i >> 1) / SPLIT_M;
    if (m0 + mm >= M) continue;
    uint32_t word[4];
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v |= static_cast<uint32_t>(
                 (tile[16 * half + 4 * q4 + b][mm] >> (8 * cd)) & 255)
             << (8 * b);
      word[q4] = v;
    }
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(m0 + mm) * KBx +
                              cd * Kp + k0 + 16 * half) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

}  // namespace

// The digit-plane layout of a contraction of K terms whose longest limb has
// dmax digits: layout = {Kp, KBs, table rows a block, digit rows a flush}.
// left: 1 for sides "left" / "batched_left" (d_l planes of Kp = K rounded
// up to SPLIT_K, at index c * Kp + k), 0 for "right" (the int64 data read
// as 8 byte slots, index 8 k + c, Kp = K rounded up to even for 16-byte
// rows).  KBs covers the longest contraction in whole BK-byte tiles.
extern "C" int mf_stage_layout(int K, int dmax, int left, int* layout) {
  const int kp = left ? (K + SPLIT_K - 1) / SPLIT_K * SPLIT_K : K + (K & 1);
  layout[0] = kp;
  layout[1] = ((left ? dmax : 8) * kp + BK - 1) / BK * BK;
  layout[2] = BW;
  layout[3] = FLUSH_TILES * BK;
  return 0;
}

// The split pass of sides "left" and "batched_left": x [Z, K, M] int64 (Z =
// L * batch) into xs [Z, M, KBx] bytes; Kp % 32 == 0, KBx % 16 == 0.
extern "C" int mf_stage_split(const int64_t* x, void* xs, const int64_t* consts,
                              int Z, int batch, int K, int M, int Kp, int KBx,
                              void* stream) {
  dim3 grid((M + SPLIT_M - 1) / SPLIT_M, (K + SPLIT_K - 1) / SPLIT_K, Z);
  stage_split_kernel<<<grid, SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint8_t*>(xs), consts, batch, K, M, Kp, KBx);
  return static_cast<int>(cudaGetLastError());
}

// The digit-plane GEMM.  X: data digit rows (the split buffer, or the int64
// data of side "right" read as bytes), strides sXz and sXr in bytes, 16-byte
// aligned; T: table planes [L, ceil(W / 32), Dmax, 32, KBs] bytes, KBs % 128
// == 0 and >= every limb's contraction; tw null (plain K1) or [L, tw_rows,
// cols] in storage form.  left: 1 for sides "left" / "batched_left" (rows =
// M, output [Z, W, M], contraction d_l * Kp), 0 for "right" (rows = R,
// output [L, R, W], contraction 8 Kp, Kp = K rounded up to even).
extern "C" int mf_stage(const void* X, const void* T, int64_t* out,
                        const int64_t* consts, const int64_t* tw, int L,
                        int batch, int rows, int W, int Kp, int left,
                        int tw_rows, long long sXz, long long sXr, int KBs,
                        int Dmax, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  StageArgs p{static_cast<const uint8_t*>(X), static_cast<const uint8_t*>(T),
              out, consts, tw, sXz, sXr, batch, rows, W, Kp, left, tw_rows,
              KBs, Dmax};
  dim3 grid((rows + BM - 1) / BM, (W + BW - 1) / BW, L * batch);
  stage_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
