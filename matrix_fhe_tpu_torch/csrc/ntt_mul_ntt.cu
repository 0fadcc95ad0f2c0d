// K2: fused t = iNTT_X(NTT_X(a) (*) s) mod q_l, the encrypt/decrypt hot path,
// as two u8 digit-plane GEMMs on the int8 tensor cores in one launch.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_mul_ntt_kernel
// (SlicedNttMulNtt).  a is [L, R, n] rows of X-coefficients, s is the secret
// key in storage form s * 2^64 mod q, [L, W, n], and row r uses key row
// r / rep.  Both X transforms are dense n x n matrices (out = T @ in, the
// JAX table convention): per limb
//
//   t[r, :] = inv @ ((fwd @ a[r, :]) (*) s[r / rep, :]) mod q.
//
// The method is K1's (csrc/stage.cu, side "right"), twice, with the
// spectrum kept in shared memory.  A canonical int64 residue's little-endian
// bytes are its u8 digits (the top slots zero), so the data rows are read as
// they stand, 8 digit slots a term (contraction index 8 k + c).  The table
// planes are K1's: byte j of T^(c) 2^64 mod q (ops/cuda_ntt.slice_tables,
// side "right", 32-row tiles, rows of KBs bytes).  For each 32-column tile
// of the spectrum a warpgroup issues wgmma m64n(32 d)k32 .s32.u8.u8 with the
// data as A and the d planes of the tile's 32 table rows as B, folds the d
// plane sums of an output in registers and reduces them with one Montgomery
// REDC (the planes carry 2^64), then multiplies by s with one Montgomery
// product (s carries 2^64): v s mod q, canonical.  It writes that as 8 bytes
// into the spectrum tile in shared memory, laid out as the A operand of the
// inverse transform (K-major, the 128-byte swizzle, 8 digit slots a term as
// the data).  The inverse transform runs K1's method on that tile with the
// inverse table's planes, folds, reduces and stores 16 bytes a thread.  The
// spectrum never goes to device memory: one launch, a read of a and a write
// of t.  Contractions are 8 n <= 1,024 digit rows, so the s32 sums never
// need K1's flush.
//
// Bound on the H100: at the ref roundtrip (n = 64, [11, 32768, 64]) the
// bytes, a read and t written, 369 MB, 0.110 ms at 3.35 TB/s (the function's
// u8 digit products, sum_l 2 transforms x 2 R n (d_l n) d_l, take 0.078 ms at
// 1,979 TOP/s); at the gl2 ring's n = 128 the digit products, 0.310 ms.  The
// kernel's 8 byte slots a term do 8 / d_l times the function's tensor work.
//
// Layout and shared-memory budget (227 KB, 232,448 B, a block at most):
//   n <= 64: two warpgroups, 128 data rows a block; a ring of 3 stages of
//     (128 x 128 B data + 7 x 32 x 128 B table) = 3 x 44 KB, and the
//     spectrum, 128 rows x 8 n B (64 KB at n = 64): 196 KB + 1 KB alignment.
//   n = 128: one warpgroup, 64 rows; 4 stages of (64 x 128 B + 28 KB) =
//     4 x 36 KB and a 64 KB spectrum: 208 KB + 1 KB.  (128 rows would need
//     a 128 KB spectrum beside the ring.)
// Stages are filled by cp.async (16 bytes a thread, the swizzle written by
// hand) STAGES - 2 tiles ahead; the global tile sequence runs through the
// forward transform's (column tile, K-tile) pairs, then the inverse's, so
// the inverse table's first tiles load during the last forward products.
// Each thread holds one column tile's 16 d s32 sums at a time (112 at
// d = 7).  The per-limb d is read from q, so one launch covers limbs of
// every width; n must be even and at most 128.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "wgmma8.cuh"

namespace {

constexpr int BW = 32;             // spectrum columns (table rows) a tile
constexpr int BK = 128;            // contraction bytes a tile (one swizzle row)
constexpr int DMAX = 7;            // digits of a modulus below 2^56
constexpr int NMAX = 128;
constexpr int TABLE_BYTES = DMAX * BW * BK;
constexpr size_t SMEM_LIMIT = 232448;

template <int WGS, int S>
struct Cfg {
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BM = 64 * WGS;          // data rows a block
  static constexpr int STAGES = S;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + TABLE_BYTES;
  static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "128-byte swizzle atoms are 1024-byte aligned");
};
using Narrow = Cfg<2, 3>;    // n <= 64
using Wide = Cfg<1, 4>;      // 64 < n <= 128

int plane_bytes(int n) { return (8 * n + BK - 1) / BK * BK; }

template <class C>
size_t smem_bytes(int n) {
  return static_cast<size_t>(C::STAGES) * C::STAGE_BYTES +
         static_cast<size_t>(C::BM) * plane_bytes(n) + 1024;
}

struct Args {
  const uint8_t* a;      // [L, R, n] int64 residues, read as bytes
  const int64_t* s;      // [L, W, n] storage form
  const uint8_t* fwd;    // forward table planes [L, NJ, Dmax, 32, KBs]
  const uint8_t* inv;    // inverse table planes, the same layout
  const int64_t* consts;
  int64_t* out;          // [L, R, n]
  int R, W, n, rep, KBs, Dmax;
};

using mfhe::cp_async16;
using mfhe::cp_async_commit;
using mfhe::cp_async_wait;
using mfhe::fence_regs;
using mfhe::smem_desc;

// One column tile's outputs: fold and REDC each; the forward transform
// multiplies by s and writes the spectrum tile in shared memory, the
// inverse writes t, two neighbouring columns as one 16-byte store.
template <class C, int D>
__device__ __forceinline__ void epilogue(const int (&acc)[16 * D],
                                         const Args& p,
                                         const mfhe::LimbConsts& c, int l,
                                         int jt, bool fwd, uint32_t spec) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int rbase = (tid >> 5) * 16 + (lane >> 2);
  const int cbase = jt * BW + 2 * (lane & 3);
  const int row0 = blockIdx.x * C::BM;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rbase + 8 * h, grow = row0 + row;
    if (grow >= p.R) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = cbase + 8 * t;     // even, and n is even
      if (col >= p.n) continue;
      uint64_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint64_t hi, lo;
        mfhe::fold<D>(acc, 4 * t + 2 * h + e, hi, lo);
        v[e] = mfhe::mont_redc(hi, lo, c);
      }
      if (fwd) {
        const ulonglong2 sv = *reinterpret_cast<const ulonglong2*>(
            p.s + (static_cast<long long>(l) * p.W + grow / p.rep) * p.n + col);
        v[0] = mfhe::mont_mul(v[0], sv.x, c);
        v[1] = mfhe::mont_mul(v[1], sv.y, c);
        const int kb = 8 * col;          // the pair's 16 bytes of the row
        const uint32_t dst = spec + (kb / BK) * C::A_BYTES + row * BK +
                             ((((kb % BK) >> 4) ^ (row & 7)) << 4);
        asm volatile("st.shared.v2.u64 [%0], {%1, %2};\n" ::"r"(dst),
                     "l"(v[0]), "l"(v[1])
                     : "memory");
      } else {
        *reinterpret_cast<ulonglong2*>(
            p.out + (static_cast<long long>(l) * p.R + grow) * p.n + col) =
            make_ulonglong2(v[0], v[1]);
      }
    }
  }
}

template <class C, int D>
__device__ __forceinline__ void body(const Args& p, uint32_t sbase,
                                     const mfhe::LimbConsts& c, int l) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = blockIdx.x * C::BM;
  const int KT = p.KBs / BK;                 // K-tiles of one transform
  const int NJ = (p.n + BW - 1) / BW;        // column tiles
  const int per = NJ * KT, nt = 2 * per;
  const int row_bytes = 8 * p.n;
  const uint8_t* xa = p.a + (static_cast<long long>(l) * p.R + row0) * row_bytes;
  const long long tile_planes = static_cast<long long>(p.Dmax) * BW * p.KBs;
  const uint8_t* tf = p.fwd + l * NJ * tile_planes;
  const uint8_t* ti = p.inv + l * NJ * tile_planes;
  const uint32_t spec = sbase + C::STAGES * C::STAGE_BYTES;   // [KT][BM][BK]

  auto load = [&](int g) {
    const uint32_t sa = sbase + (g % C::STAGES) * C::STAGE_BYTES;
    const uint32_t sb = sa + C::A_BYTES;
    const bool fwd = g < per;
    const int gg = fwd ? g : g - per;
    const int k0 = (gg % KT) * BK;
    if (fwd) {
      for (int i = tid; i < C::BM * 8; i += C::THREADS) {
        const int r = i >> 3, ch = i & 7, kb = k0 + 16 * ch;
        const bool ok = row0 + r < p.R && kb < row_bytes;
        const uint8_t* src = ok ? xa + static_cast<long long>(r) * row_bytes + kb : p.a;
        cp_async16(sa + r * BK + ((ch ^ (r & 7)) << 4), src, ok ? 16 : 0);
      }
    }
    const uint8_t* tb = (fwd ? tf : ti) + (gg / KT) * tile_planes + k0;
    for (int i = tid; i < D * BW * 8; i += C::THREADS) {
      const int r = i >> 3, ch = i & 7;
      cp_async16(sb + r * BK + ((ch ^ (r & 7)) << 4),
                 tb + static_cast<long long>(r) * p.KBs + 16 * ch, 16);
    }
  };

  int acc[16 * D];
#pragma unroll
  for (int i = 0; i < 16 * D; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 2; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  for (int g = 0; g < nt; ++g) {
    cp_async_wait<C::STAGES - 3>();  // this thread's copies of tile g landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                 // everyone's, and the spectrum's stores;
                                     // tile g - 2's products done
    if (g + C::STAGES - 2 < nt) load(g + C::STAGES - 2);
    cp_async_commit();
    const bool fwd = g < per;
    const int gg = fwd ? g : g - per, t = gg % KT;
    const uint32_t stage = sbase + (g % C::STAGES) * C::STAGE_BYTES;
    const uint32_t sa = (fwd ? stage : spec + t * C::A_BYTES) + wg * (64 * BK);
    const uint32_t sb = stage + C::A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      mfhe::wgmma8<D, false>(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk),
                             (t > 0 || kk > 0) ? 1 : 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(acc);
    if (t == KT - 1) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      epilogue<C, D>(acc, p, c, l, gg / KT, fwd, spec);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) ntt_mul_ntt_kernel(const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const int l = blockIdx.y;
  const mfhe::LimbConsts c = mfhe::load_consts(p.consts, l);
  switch (mfhe::digits_of(c.q)) {
    case 1: body<C, 1>(p, sbase, c, l); break;
    case 2: body<C, 2>(p, sbase, c, l); break;
    case 3: body<C, 3>(p, sbase, c, l); break;
    case 4: body<C, 4>(p, sbase, c, l); break;
    case 5: body<C, 5>(p, sbase, c, l); break;
    case 6: body<C, 6>(p, sbase, c, l); break;
    default: body<C, 7>(p, sbase, c, l); break;
  }
}

bool fits(int n) { return n >= 2 && n <= NMAX && (n & 1) == 0; }

size_t smem_for(int n) {
  return n <= 64 ? smem_bytes<Narrow>(n) : smem_bytes<Wide>(n);
}

template <class C>
int launch(const Args& p, int L, void* stream) {
  const size_t bytes = smem_bytes<C>(p.n);
  const cudaError_t attr = cudaFuncSetAttribute(
      ntt_mul_ntt_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.R + C::BM - 1) / C::BM, L);
  ntt_mul_ntt_kernel<C><<<grid, C::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one launch of K2 needs at this n, or 0 where the kernel
// does not take n (odd, or above 128); the wrapper asks before a launch and
// refuses n there.
extern "C" long long mf_ntt_mul_ntt_smem(int n) {
  if (!fits(n) || smem_for(n) > SMEM_LIMIT) return 0;
  return static_cast<long long>(smem_for(n));
}

// a, out: [L, R, n] int64, 16-byte aligned; s: [L, W, n] storage form,
// 16-byte aligned; fwd, inv: table planes [L, ceil(n / 32), Dmax, 32, KBs]
// bytes (K1's side "right" layout, KBs = 8 n rounded up to 128).
extern "C" int mf_ntt_mul_ntt(const void* a, const int64_t* s, const void* fwd,
                              const void* inv, const int64_t* consts,
                              int64_t* out, int L, int R, int W, int n,
                              int rep, int KBs, int Dmax, void* stream) {
  if (mf_ntt_mul_ntt_smem(n) == 0 || KBs != plane_bytes(n) || Dmax > DMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{static_cast<const uint8_t*>(a), s,
               static_cast<const uint8_t*>(fwd),
               static_cast<const uint8_t*>(inv), consts, out, R, W, n, rep,
               KBs, Dmax};
  return n <= 64 ? launch<Narrow>(p, L, stream) : launch<Wide>(p, L, stream);
}
