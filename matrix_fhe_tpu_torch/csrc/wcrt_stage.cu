// K1 on side "left" at long contractions: the W-CRT (a contraction over the
// W = 512 lanes) and K3's GEMM on the scaled tables, as a kernel of their own
// on the int8 tensor cores.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_stage_kernel (:1633,
// SlicedStage) on side "left" where the contraction has 256 to KP_MAX terms
// (ops/cuda_ntt.takes_wcrt).  Per limb
//
//   out[l, w, m] = sum_k T[l, w, k] D[l, k, m] mod q_l.
//
// The arithmetic is csrc/stage.cu's, bit for bit: the split pass's
// transposed data planes (stage_split_kernel, [L, M, KBs] bytes, index
// c Kp + k for the d_l digit slots of limb l), the table planes of
// ops/cuda_ntt.slice_tables (32 table rows a tile, rows of KBs bytes) as B
// of wgmma m64n(32 d)k32 .s32.u8.u8, then mfhe::fold of the d plane sums and
// one mfhe::mont_redc an output.  Every s32 sum is exact without a flush:
// d Kp 255^2 < 2^31 for Kp <= KP_MAX at 7 digits.
//
// Bound on the H100: the u8 products, 2 W M (d_l Kp) d_l a limb.  At the key
// switch's QP W-CRT [14, 512, 4096] they are 8.3e11, 0.418 ms at 1,979
// TOP/s.  What holds a kernel back from that is the bytes its SMs take
// from L2 for them: for a 128-byte K-tile, a block of R data rows x 32
// table rows reads 128 R bytes of data and d 4 KB of table planes for R x
// 32 d x 128 products.  The general kernel's blocks own 128 data rows
// (about 5.8 GB a call at 5 digits), and its 256 threads also issue the
// copies and meet at a block barrier every tile.
//
// The design.  A block owns 256 data rows x 32 table rows: each consumer
// warpgroup two m64 tiles that share one B, 32 d accumulators a thread
// (0.7 of the general kernel's bytes a product at 5 digits).  At 7 digits
// that would be 224 accumulators a thread, which do not fit beside the
// epilogue, so such a limb runs 128-row tiles (one m64 tile a warpgroup).
// A producer thread issues the TMA copies (the 128-byte swizzle applied by
// the copy) into a ring of stages tracked by mbarriers (full: the bytes
// landed; empty: both consumer warpgroups' products on the stage are
// done); the stages are sized by the launch's largest tile (rows 128 + d
// 4 KB), not by 7 digits, so that four fit.  The consumer warpgroups issue
// wgmma on the stages as they land, release each stage as soon as its
// products are done, and never meet at a block barrier.  The blocks are
// persistent, one an SM: they walk the flattened (limb, row tile, table
// tile) order in turns, so the whole card works on a few row tiles of one
// limb at a time (their data and the limb's planes stay in L2), and the
// producer loads the next tile's K-tiles while the consumers run an
// epilogue.  setmaxnreg moves the producer warpgroup's registers to the
// consumers.  One launch covers limbs of every width (d read from q); no
// workspace.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "wgmma8.cuh"

namespace {

constexpr int BW = 32;             // table rows a block; N = 32 d
constexpr int BK = 128;            // contraction bytes a K-tile (one swizzle row)
constexpr int BOX_ROWS = 64;       // data rows a TMA box: one m64 tile
constexpr int DMAX = 7;            // digits of a modulus below 2^56
constexpr int KP_MAX = 4096;       // the longest contraction taken, in terms
constexpr int THREADS = 384;       // the producer warpgroup, two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 8;
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t ALIGN = 1024;     // 128-byte swizzle atoms
constexpr size_t BARRIER_BYTES = 2 * MAX_STAGES * 8;
// setmaxnreg moves registers within what the block holds from its launch:
// __launch_bounds__(384, 1) gives 65,536 / 384 rounded down to 8 a thread
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 168 * THREADS,
              "the warpgroups' registers fit what the block was given");
static_assert(255LL * 255 * DMAX * KP_MAX < (1LL << 31),
              "an s32 plane sum of a whole contraction stays exact");

// m64 tiles a consumer warpgroup holds for a limb of d digits (16 d
// accumulators each), the data rows of a block's tile, and the bytes of a
// ring stage for it.
__host__ __device__ constexpr int subtiles(int d) { return d <= 6 ? 2 : 1; }
__host__ __device__ constexpr int tile_rows(int d) { return 2 * BOX_ROWS * subtiles(d); }
__host__ __device__ constexpr int stage_need(int d) { return (tile_rows(d) + d * BW) * BK; }

// The data [L M rows, KBs bytes] and the table planes [L NJ Dmax 32 rows,
// KBs bytes] come through TMA tensor maps; the rest through Args.
struct Args {
  int64_t* out;          // [L, W, M]
  const int64_t* consts;
  int L, M, W, Kp, Dmax, stages, stage_bytes;
};

struct Smem {
  uint32_t ring, full, empty;
};

using mfhe::fence_regs;
using mfhe::smem_desc;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// An arrival on `bar` that also expects `bytes` of TMA copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box at (byte c0, row c1) of a 2-D tensor map into shared memory at
// dst, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A block's walk over the flattened (limb, row tile, table tile) order,
// unit u = base_l + t NJ + table tile: the limb holding the unit, its first
// unit, its units and digits.
struct Walk {
  int l, base, count, d;
};

__device__ __forceinline__ void enter_limb(Walk& w, const Args& p, int nj) {
  w.d = mfhe::digits_of(mfhe::load_consts(p.consts, w.l).q);
  w.count = (p.M + tile_rows(w.d) - 1) / tile_rows(w.d) * nj;
}

// Moves the walk to the limb of unit u (u never decreases); false past the
// last limb.
__device__ __forceinline__ bool seek(Walk& w, const Args& p, int nj, int u) {
  while (u >= w.base + w.count) {
    w.base += w.count;
    if (++w.l == p.L) return false;
    enter_limb(w, p, nj);
  }
  return true;
}

// The producer thread: for each unit of its block, each K-tile into the next
// stage once the consumers are done with it (empty): the data tile's m64
// boxes and the d table planes, all of the stage's bytes expected on its
// full barrier.
__device__ __forceinline__ void produce(const CUtensorMap& tx, const CUtensorMap& tt,
                                        const Args& p, const Smem& sm) {
  const int nj = (p.W + BW - 1) / BW;
  int s = 0, round = 0;
  Walk wk{0, 0, 0, 0};
  enter_limb(wk, p, nj);
  for (int u = blockIdx.x; seek(wk, p, nj, u); u += gridDim.x) {
    const int v = u - wk.base, rows = tile_rows(wk.d);
    const int kt_n = (wk.d * p.Kp + BK - 1) / BK;
    const int arow = wk.l * p.M + (v / nj) * rows;
    const int trow = (wk.l * nj + v % nj) * p.Dmax * BW;   // plane j at trow + 32 j
    for (int kt = 0; kt < kt_n; ++kt) {
      if (round > 0) mbar_wait(sm.empty + 8 * s, (round - 1) & 1);
      const uint32_t st = sm.ring + s * p.stage_bytes, bar = sm.full + 8 * s;
      mbar_expect(bar, (rows + wk.d * BW) * BK);
      for (int b = 0; b < rows; b += BOX_ROWS)
        tma_load(st + b * BK, tx, kt * BK, arow + b, bar);
      for (int j = 0; j < wk.d; ++j)
        tma_load(st + (rows + j * BW) * BK, tt, kt * BK, trow + j * BW, bar);
      if (++s == p.stages) {
        s = 0;
        ++round;
      }
    }
  }
}

// A consumer warpgroup's NS x 64 data rows (from row0) x 32 table rows (from
// w0) of limb l: fold the d plane sums of each output and reduce them with
// one Montgomery REDC (the planes carry 2^64), out[l, w, m].  A thread's 16
// NS outputs go in chunks of 8, each computed without a branch so that
// their chains of multiplies interleave, then stored.
template <int D, int NS>
__device__ __forceinline__ void epilogue(const int (&acc)[NS][16 * D], const Args& p,
                                         const mfhe::LimbConsts& c, int l, int row0,
                                         int w0) {
  const int lane = threadIdx.x & 31;
  const int rbase = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int wbase = w0 + 2 * (lane & 3);
  uint64_t* out = reinterpret_cast<uint64_t*>(p.out) +
                  static_cast<long long>(l) * p.W * p.M;
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint64_t v[8];                  // v[2 b + e]: column wbase + 8 b + e
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint64_t hi, lo;
        mfhe::fold<D>(acc[t], 4 * (k >> 1) + 2 * h + (k & 1), hi, lo);
        v[k] = mfhe::mont_redc(hi, lo, c);
      }
      const int m = rbase + BOX_ROWS * t + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int w = wbase + 8 * (k >> 1) + (k & 1);
        if (w < p.W) out[static_cast<long long>(w) * p.M + m] = v[k];
      }
    }
  }
}

// A consumer warpgroup (cw 0 or 1: data rows cw NS 64 .. of the block's
// tile) on one unit of limb l with d = D digits: wgmma over the tile's
// K-tiles as they land, each stage released once its products are done,
// then the epilogue.  (s, phase) is the warpgroup's place in the ring.
template <int D>
__device__ __forceinline__ void consume(const Args& p, const Smem& sm, int& s, int& phase,
                                        int l, int row0, int w0) {
  constexpr int NS = subtiles(D);
  const int cw = (threadIdx.x >> 7) - 1;
  const int kt_n = (D * p.Kp + BK - 1) / BK;
  const mfhe::LimbConsts c = mfhe::load_consts(p.consts, l);
  int acc[NS][16 * D];
#pragma unroll
  for (int t = 0; t < NS; ++t)
#pragma unroll
    for (int i = 0; i < 16 * D; ++i) acc[t][i] = 0;
  for (int kt = 0; kt < kt_n; ++kt) {
    mbar_wait(sm.full + 8 * s, phase);
    const uint32_t st = sm.ring + s * p.stage_bytes;
    const uint32_t sa = st + cw * NS * BOX_ROWS * BK, sb = st + tile_rows(D) * BK;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
      for (int t = 0; t < NS; ++t)
        mfhe::wgmma8<D, false>(acc[t], smem_desc(sa + t * BOX_ROWS * BK + 32 * kk),
                               smem_desc(sb + 32 * kk), (kt > 0 || kk > 0) ? 1 : 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < NS; ++t) fence_regs(acc[t]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(sm.empty + 8 * s);   // the stage is done
    if (++s == p.stages) {
      s = 0;
      phase ^= 1;
    }
  }
  epilogue<D, NS>(acc, p, c, l, row0 + cw * NS * BOX_ROWS, w0);
}

__global__ void __launch_bounds__(THREADS, 1)
    wcrt_stage_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tt, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  Smem sm;
  sm.ring = sbase;
  sm.full = sbase + p.stages * p.stage_bytes;
  sm.empty = sm.full + 8 * MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(sm.full + 8 * s, 1);     // the producer's, with the bytes
      mbar_init(sm.empty + 8 * s, 8);    // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) produce(tx, tt, p, sm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int nj = (p.W + BW - 1) / BW;
    int s = 0, phase = 0;
    Walk wk{0, 0, 0, 0};
    enter_limb(wk, p, nj);
    for (int u = blockIdx.x; seek(wk, p, nj, u); u += gridDim.x) {
      const int v = u - wk.base;
      const int row0 = (v / nj) * tile_rows(wk.d), w0 = (v % nj) * BW;
      switch (wk.d) {
        case 1: consume<1>(p, sm, s, phase, wk.l, row0, w0); break;
        case 2: consume<2>(p, sm, s, phase, wk.l, row0, w0); break;
        case 3: consume<3>(p, sm, s, phase, wk.l, row0, w0); break;
        case 4: consume<4>(p, sm, s, phase, wk.l, row0, w0); break;
        case 5: consume<5>(p, sm, s, phase, wk.l, row0, w0); break;
        case 6: consume<6>(p, sm, s, phase, wk.l, row0, w0); break;
        default: consume<7>(p, sm, s, phase, wk.l, row0, w0); break;
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 2-D byte tensor of `rows` rows of `inner` bytes (16-byte aligned, as
// its rows), boxes of BK bytes x box_rows with the 128-byte swizzle, zeros
// past its edges.
bool byte_map(CUtensorMap* map, const void* base, long long inner, long long rows,
              int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The W-CRT stage: X the split pass's data planes [L, M, KBs] bytes (limb
// l's d_l planes of Kp bytes at index c Kp + k, Kp a multiple of 32, at
// most KP_MAX); T K1's side "left" table planes [L, ceil(W / 32), Dmax, 32,
// KBs] (mf_stage_layout's KBs, a multiple of 128, at least Dmax Kp); dmask
// has bit d set for each digit count d of the launch's limbs.  out [L, W,
// M].  Refuses (cudaErrorInvalidValue) what it does not take.
extern "C" int mf_stage_w(const void* X, const void* T, int64_t* out,
                          const int64_t* consts, int L, int M, int W, int Kp, int KBs,
                          int Dmax, int dmask, void* stream) {
  const int nj = (W + BW - 1) / BW;
  if (L < 1 || M < 1 || W < 1 || Kp < 1 || Kp % 32 != 0 || Kp > KP_MAX || Dmax < 1 ||
      Dmax > DMAX || KBs % BK != 0 || KBs < Dmax * Kp || (dmask & 1) != 0 ||
      dmask <= 0 || dmask >= (2 << Dmax) || static_cast<long long>(L) * M > 0x7fffffffLL ||
      static_cast<long long>(L) * nj * Dmax * BW > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int stage_bytes = 0;
  for (int d = 1; d <= Dmax; ++d)
    if ((dmask >> d) & 1 && stage_need(d) > stage_bytes) stage_bytes = stage_need(d);
  const size_t room = (SMEM_LIMIT - ALIGN - BARRIER_BYTES) / stage_bytes;
  const int stages = room < MAX_STAGES ? static_cast<int>(room) : MAX_STAGES;
  const size_t smem = ALIGN + static_cast<size_t>(stages) * stage_bytes + BARRIER_BYTES;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wcrt_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>(L) * ((M + 127) / 128) * nj;
  const long long blocks = units < sms ? units : sms;   // one an SM
  CUtensorMap tx, tt;
  if (!byte_map(&tx, X, KBs, static_cast<long long>(L) * M, BOX_ROWS) ||
      !byte_map(&tt, T, KBs, static_cast<long long>(L) * nj * Dmax * BW, BW))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{out, consts, L, M, W, Kp, Dmax, stages, stage_bytes};
  wcrt_stage_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(tx, tt, a);
  return static_cast<int>(cudaGetLastError());
}
