// K4: exact fixed-point complex matmul Y = T @ X over scaled integers, as
// balanced s8 digit-plane GEMMs on the int8 tensor cores.
//
// Replaces matrix_fhe_tpu/ops/fpmatmul.py:_fp_cmatmul_kernel
// (ExactComplexMatmul).  T is the table quantized to t_int =
// round(T * 2^t_bits), X the input scaled to |x_int| <= 2^37; both arrive
// as int64.  For each output the kernel forms the exact sums
//   re = sum_k tr*xr - ti*xi,   im = sum_k tr*xi + ti*xr
// (|sum| < 2^81) and writes sign plus 96-bit magnitude as the words
// (m0, m1, m2, sg), each an int64 holding a u32 value, bit-identical to the
// TPU kernel's output planes.
//
// The method.  Every operand is cut into 5 balanced base-256 digits in
// [-128, 127], v = sum_j v_j 2^(8 j) (exact for |v| < 2^39): the table's
// planes tr_i, ti_i and (-ti)_i once (ops/fpmatmul.table_planes), the
// data's dr_j, di_j by a split pass (fp_split_kernel, launch key
// "fp_cmatmul_split").  Then for each digit diagonal s = i + j
//   D_re[s] = sum_{i+j=s} tr_i . dr_j + (-ti)_i . di_j
//   D_im[s] = sum_{i+j=s} tr_i . di_j +    ti_i  . dr_j      (s8 GEMMs, s32)
// and re = sum_s D_re[s] 2^(8 s), folded in 128 bits, likewise im.  A
// product of two digits is at most 2^14 in size, so |D[s]| <= 2 * 5 * K *
// 2^14 < 2^31 for K <= 13,107: every s32 sum is exact.  This is four real
// products on 8-bit digits, 100 digit GEMMs, where the JAX kernel makes 90
// by Karatsuba on 7-bit digits: Karatsuba's P3 = (tr + ti)(dr + di) needs
// dr + di in s8, so 7-bit digits (6 of them for the data, 10 diagonals),
// and three accumulator sets P1, P2, P3 instead of two (re, im).  With a
// warpgroup's 64 x 32 tile that is 240 s32 sums a thread, past the 255
// registers; re and im are 144, one warpgroup each.
//
// Bound on the H100: the function's s8 digit products at 1,979 TOP/s dense
// int8 where the contraction is long (the W-DFT, [512, 512] @ [512, 4096]),
// or its bytes at 3.35 TB/s where it is short (the sigma sandwich, K = 64:
// the 8 words an output it writes).  The design: a block of two warpgroups
// owns 64 data columns x 32 table rows, warpgroup 0 the real part,
// warpgroup 1 the imaginary part, each 9 diagonals x 16 s32 sums a thread.
// The contraction advances one 128-byte k-tile and one data digit j at a
// time: a step loads dr_j and di_j (A, 64 rows) into a ring of four stages,
// and every fifth step the 15 table tiles of the k-tile (B, 32 rows) into
// a ring of two, by cp.async with the 128-byte swizzle (csrc/wgmma8.cuh),
// two steps ahead of the tensor cores.  A step issues, for each table digit
// i, wgmma m64n32k32 .s32.s8.s8 into diagonal i + j, so only the useful
// digit pairs are multiplied.
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma8.cuh"

namespace {

constexpr int TD = 5;              // balanced base-256 digits of every operand
constexpr int NDIAG = 2 * TD - 1;  // digit diagonals s = i + j
constexpr int BM = 64;             // data columns a block (A rows)
constexpr int BW = 32;             // table rows a block (B rows, N)
constexpr int BK = 128;            // contraction bytes a tile (one swizzle row)
constexpr int A_STAGES = 4, B_STAGES = 2, THREADS = 256;
constexpr int A_TILE = BM * BK, B_TILE = BW * BK;
constexpr int A_STAGE = 2 * A_TILE;             // dr_j, di_j
constexpr int B_STAGE = 3 * TD * B_TILE;        // tr_i, ti_i, (-ti)_i
constexpr int SMEM_BYTES = A_STAGES * A_STAGE + B_STAGES * B_STAGE + 1024;
static_assert(A_TILE % 1024 == 0 && B_TILE % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on Hopper");
constexpr int MAX_K = 13107;       // 2 * TD * MAX_K * 2^14 < 2^31
static_assert(2LL * TD * MAX_K * (1 << 14) < (1LL << 31),
              "an s32 diagonal sum stays exact");

constexpr int SPLIT_K = 32, SPLIT_M = 64, SPLIT_THREADS = 256;
constexpr int SPLIT_ROW = SPLIT_K + 16;        // a digit row in shared memory

__device__ __forceinline__ void store_words(int64_t* out, long long plane, long long idx,
                                            int64_t hi, uint64_t lo) {
  const bool neg = hi < 0;
  uint64_t mlo = lo, mhi = static_cast<uint64_t>(hi);
  if (neg) {
    mlo = ~lo + 1ull;
    mhi = ~mhi + (lo == 0 ? 1ull : 0ull);
  }
  out[0 * plane + idx] = static_cast<int64_t>(mlo & 0xFFFFFFFFull);
  out[1 * plane + idx] = static_cast<int64_t>(mlo >> 32);
  out[2 * plane + idx] = static_cast<int64_t>(mhi & 0xFFFFFFFFull);
  out[3 * plane + idx] = neg ? 1 : 0;
}

// sum_s D[s] 2^(8 s) as a signed 128-bit (hi, lo), |D[s]| < 2^31.
__device__ __forceinline__ void fold(const int (&acc)[NDIAG][16], int idx,
                                     int64_t& hi, uint64_t& lo) {
  hi = 0;
  lo = 0;
#pragma unroll
  for (int s = 0; s < NDIAG; ++s) {
    const int64_t d = acc[s][idx];
    uint64_t plo;
    int64_t phi;
    if (s == 0) {
      plo = static_cast<uint64_t>(d);
      phi = d >> 63;
    } else if (8 * s < 64) {
      plo = static_cast<uint64_t>(d) << (8 * s);
      phi = d >> (64 - 8 * s);
    } else {
      plo = 0;
      phi = d << (8 * s - 64);
    }
    lo += plo;
    hi += phi + (lo < plo ? 1 : 0);
  }
}

// tp: table planes [3, TD, Wp, Kp] s8 (tr, ti, -ti); xp: data planes
// [2, TD, M, Kp] s8 (xr, xi); out [2, 4, W, M] words.
__global__ void __launch_bounds__(THREADS, 1)
fp_cmatmul_kernel(const int8_t* __restrict__ tp, const int8_t* __restrict__ xp,
                  int64_t* __restrict__ out, int W, int M, int Wp, int Kp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sa0 = sbase, sb0 = sbase + A_STAGES * A_STAGE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, w0 = blockIdx.y * BW;
  const int nkt = Kp / BK, nsteps = nkt * TD;

  // step t = kt TD + j: dr_j, di_j of k-tile kt; with j = 0 also the
  // table's 15 tiles of k-tile kt.  A thread copies chunk ch of rows ra and
  // ra + 32 of both data tiles and of row ra of each table tile (both rows
  // swizzle alike), from pointers set up once so that few registers stay
  // live beside the 144 sums.
  const int ch = tid & 7, ra = tid >> 3;
  const uint32_t soff = ra * BK + ((ch ^ (ra & 7)) << 4);
  const long long xplane = static_cast<long long>(M) * Kp;
  const long long tplane = static_cast<long long>(Wp) * Kp;
  const int8_t* xa = xp + static_cast<long long>(m0 + ra) * Kp + 16 * ch;
  const int8_t* ta = tp + static_cast<long long>(w0 + ra) * Kp + 16 * ch;
  const bool ok0 = m0 + ra < M, ok1 = m0 + ra + 32 < M;
  auto load = [&](int t) {
    const int kt = t / TD, j = t - kt * TD, k0 = kt * BK;
    const uint32_t sa = sa0 + (t % A_STAGES) * A_STAGE + soff;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int8_t* src = xa + (c * TD + j) * xplane + k0;
      mfhe::cp_async16(sa + c * A_TILE, ok0 ? src : xp, ok0 ? 16 : 0);
      mfhe::cp_async16(sa + c * A_TILE + 32 * BK, ok1 ? src + 32 * Kp : xp,
                       ok1 ? 16 : 0);
    }
    if (j != 0) return;
    const uint32_t sb = sb0 + (kt % B_STAGES) * B_STAGE + soff;
    const int8_t* src = ta + k0;
#pragma unroll 1
    for (int n = 0; n < 3 * TD; ++n, src += tplane)
      mfhe::cp_async16(sb + n * B_TILE, src, 16);
  };

  int acc[NDIAG][16];
#pragma unroll
  for (int s = 0; s < NDIAG; ++s)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[s][i] = 0;

  load(0);
  mfhe::cp_async_commit();
  if (1 < nsteps) load(1);
  mfhe::cp_async_commit();

  // warpgroup 0: D_re += tr . dr + (-ti) . di; warpgroup 1: D_im += tr . di
  // + ti . dr
  const uint32_t a1 = wg ? A_TILE : 0, a2 = wg ? 0 : A_TILE;
  const uint32_t b2 = (wg ? 1 : 2) * TD * B_TILE;
  for (int kt = 0; kt < nkt; ++kt) {
    const uint32_t sb = sb0 + (kt % B_STAGES) * B_STAGE;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int t = kt * TD + j;
      mfhe::cp_async_wait<1>();      // this thread's copies of step t landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();               // everyone's; step t - 2's products done
      if (t + 2 < nsteps) load(t + 2);
      mfhe::cp_async_commit();
      const uint32_t sa = sa0 + (t % A_STAGES) * A_STAGE;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < TD; ++i)
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          mfhe::wgmma8<1, true>(acc[i + j], mfhe::smem_desc(sa + a1 + 32 * kk),
                                mfhe::smem_desc(sb + i * B_TILE + 32 * kk), 1);
          mfhe::wgmma8<1, true>(acc[i + j], mfhe::smem_desc(sa + a2 + 32 * kk),
                                mfhe::smem_desc(sb + b2 + i * B_TILE + 32 * kk), 1);
        }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < NDIAG; ++s) mfhe::fence_regs(acc[s]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < NDIAG; ++s) mfhe::fence_regs(acc[s]);

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const long long plane = static_cast<long long>(W) * M;
  int64_t* o = out + wg * 4 * plane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 16 * warp + (lane >> 2) + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = w0 + 8 * b + 2 * (lane & 3) + e;
        if (w >= W) continue;
        int64_t hi;
        uint64_t lo;
        fold(acc, 4 * b + 2 * h + e, hi, lo);
        store_words(o, plane, static_cast<long long>(w) * M + m, hi, lo);
      }
  }
}

// xr, xi [K, M] int64 -> xp[c, j, m, k] = balanced digit j of x_c[k, m] for
// k < K, zero for K <= k < Kp.  A 32 x 64 tile goes through shared memory so
// that both the int64 reads (along m) and the 16-byte writes (along k) are
// whole.
__global__ void __launch_bounds__(SPLIT_THREADS)
fp_split_kernel(const int64_t* __restrict__ xr, const int64_t* __restrict__ xi,
                int8_t* __restrict__ xp, int K, int M, int Kp) {
  __shared__ __align__(16) int8_t dig[TD][SPLIT_M][SPLIT_ROW];
  const int c = blockIdx.z;
  const int64_t* x = c ? xi : xr;
  const int k0 = blockIdx.y * SPLIT_K, m0 = blockIdx.x * SPLIT_M;
  for (int i = threadIdx.x; i < SPLIT_K * SPLIT_M; i += SPLIT_THREADS) {
    const int kk = i / SPLIT_M, mm = i % SPLIT_M;
    int64_t v = (k0 + kk < K && m0 + mm < M)
                    ? x[static_cast<long long>(k0 + kk) * M + m0 + mm]
                    : 0;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int64_t d = ((v + 128) & 255) - 128;
      dig[j][mm][kk] = static_cast<int8_t>(d);
      v = (v - d) >> 8;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TD * SPLIT_M * 2; i += SPLIT_THREADS) {
    const int half = i & 1, mm = (i >> 1) % SPLIT_M, j = (i >> 1) / SPLIT_M;
    if (m0 + mm >= M) continue;
    *reinterpret_cast<uint4*>(
        xp + ((static_cast<long long>(c) * TD + j) * M + m0 + mm) * Kp + k0 + 16 * half) =
        *reinterpret_cast<const uint4*>(&dig[j][mm][16 * half]);
  }
}

}  // namespace

// The plane layout of a [W, K] table: layout = {Wp, Kp, digits, most K}.
// Table planes are [3, digits, Wp, Kp] s8, data planes [2, digits, M, Kp].
extern "C" int mf_fp_layout(int W, int K, int* layout) {
  layout[0] = (W + BW - 1) / BW * BW;
  layout[1] = (K + BK - 1) / BK * BK;
  layout[2] = TD;
  layout[3] = MAX_K;
  return 0;
}

// The split pass: xr, xi [K, M] int64 into xp [2, TD, M, Kp] s8.
extern "C" int mf_fp_split(const int64_t* xr, const int64_t* xi, void* xp, int K,
                           int M, int Kp, void* stream) {
  dim3 grid((M + SPLIT_M - 1) / SPLIT_M, Kp / SPLIT_K, 2);
  fp_split_kernel<<<grid, SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, static_cast<int8_t*>(xp), K, M, Kp);
  return static_cast<int>(cudaGetLastError());
}

// The digit-plane GEMM: tp [3, TD, Wp, Kp], xp [2, TD, M, Kp] s8 (Kp % 128
// == 0, Wp % 32 == 0), out [2, 4, W, M] int64 words.
extern "C" int mf_fp_cmatmul(const void* tp, const void* xp, int64_t* out, int W,
                             int M, int Wp, int Kp, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      fp_cmatmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((M + BM - 1) / BM, Wp / BW);
  fp_cmatmul_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tp), static_cast<const int8_t*>(xp), out, W, M, Wp,
      Kp);
  return static_cast<int>(cudaGetLastError());
}
