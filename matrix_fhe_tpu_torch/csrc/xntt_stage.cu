// K1 and K10a on side "right" at short contractions: the X-NTT, and the
// X-NTT times a twiddle, as a kernel of their own on the int8 tensor cores.
//
// Replaces matrix_fhe_tpu/ops/pallas_ntt.py:_sliced_stage_kernel (:1633,
// SlicedStage) and :_stage_kernel (:460, PallasStage with its twiddle) on
// side "right" where the contraction is at most 128 terms: every X-NTT of
// the ring (n = 64), the gl2 ring's 2n = 128, and the four-step stages of
// those sizes.  Per limb
//
//   out[l, r, k] = sum_x D[l, r, x] T[l, k, x] mod q_l,
//
// times tw[l, r mod tw_rows, k] in the storage form tw * 2^64 mod q when a
// twiddle is given.  The arithmetic is csrc/stage.cu's, bit for bit: the
// data's int64 rows read as their bytes (8 u8 digit slots a term, index
// 8 x + c), the table planes of ops/cuda_ntt.slice_tables (the same layout,
// 32 table rows a tile, rows of KBs bytes) as B of wgmma m64n(32 d)k32
// .s32.u8.u8, the fold of the d plane sums and one REDC an output, the
// Montgomery product by the twiddle.  csrc/stage.cu keeps the left sides
// and the longer contractions.
//
// Bound on the H100: the bytes.  At [14, 32768, 64] with a twiddle, the
// data and the twiddle read and the output written are 705 MB, 0.21 ms at
// 3.35 TB/s; the u8 products of 8 slots a term take 0.08 ms at 1,979 TOP/s.
// The general kernel ran that call at 3.5 times the bound: its block holds
// 181 KB of ring for long contractions, so one block runs on an SM, and on
// this side the whole contraction (512 bytes a row) is its four stages, so
// each block loads, waits, multiplies and stores with nothing beside it;
// its table planes come from L2 again for every 128 rows.
//
// The design.  Persistent blocks, one an SM: the blocks of a group, one
// for each 32-column tile of the output, take the same run of 128-row
// tiles of the flattened (limb, row tile) order (the runs split the tiles
// evenly over the SMs), so the second read of a data row is served by L2.
// A block holds its limb's table planes for its 32 columns in shared
// memory (d 32 KBs bytes, 112 KB at most at K <= 64; reloaded where its
// run crosses into the next limb, once both consumers are done with the
// last one); where they would leave room for fewer than four ring stages
// (K = 128 at 6 or 7 digits) each stage carries its K-tile of the planes
// instead.  A producer warp issues TMA copies (the 128-byte swizzle
// applied by the copy) of the data's 128-row x 128-byte K-tiles into a
// ring of stages tracked by mbarriers (full: the bytes landed; empty:
// every consumer warp's products on the stage are done); a second one
// copies each consumer's 64 x 32 twiddle tile (a key or a ciphertext: a
// full-height twiddle) into shared memory ahead of its epilogue, and a
// one-row twiddle is read once a limb.  Two consumer warpgroups take rows
// 0-63 and 64-127 of each stage and hold the 16 d s32 sums of their 64 x
// 32 outputs; they take turns at the tensor cores (named barriers), so
// that one's products run under the other's epilogue, and the loads of
// the next tiles run under both.  The epilogue is integer-bound (a fold,
// a REDC and a Montgomery product an output): a thread computes 8 outputs
// at a time without branches so that their chains of 64-bit multiplies
// interleave, then stores them as 16-byte pairs.  setmaxnreg moves the
// producer's registers to the consumers.  One launch covers limbs of
// every width (d read from q); no workspace.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "wgmma8.cuh"

namespace {

constexpr int BM = 128;            // data rows a stage: two consumer warpgroups
constexpr int BW = 32;             // output columns a block; N = 32 d
constexpr int BK = 128;            // contraction bytes a K-tile (one swizzle row)
constexpr int DMAX = 7;            // digits of a modulus below 2^56
constexpr int KB_MAX = 8 * 128;    // the longest contraction taken, in bytes
constexpr int THREADS = 384;       // the producer warpgroup, two consumers
constexpr int PRODUCER_REGS = 72;
constexpr int CONSUMER_REGS = 216;
constexpr int MAX_STAGES = 8;
constexpr int MIN_RESIDENT_STAGES = 4;
constexpr int A_BYTES = BM * BK;   // a stage's data, 16 KB
constexpr int T_TILE = BW * BK;    // one plane's K-tile of 32 rows, 4 KB
constexpr int TW_BYTES = 64 * BW * 8;   // a consumer's twiddle tile, 16 KB
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t ALIGN = 1024;     // 128-byte swizzle atoms
constexpr size_t BARRIER_BYTES = (2 * MAX_STAGES + 6) * 8;
// setmaxnreg moves registers within what the block holds from its launch:
// __launch_bounds__(384, 1) gives 65,536 / 384 rounded down to 8 a thread
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 168 * THREADS,
              "the warpgroups' registers fit what the block was given");
static_assert(255LL * 255 * KB_MAX < (1LL << 26),
              "a plane sum of a whole contraction stays below 2^26 (fold_short)");
constexpr int TURN0 = 1, TURN1 = 2;   // named barriers: a consumer's turn

// The data [L R rows, KB bytes], the table planes [L NJ Dmax 32 rows, KBs
// bytes] and, where tw_rows is a multiple of 64, the twiddle [L tw_rows
// rows, 8 W bytes] come through TMA tensor maps; the rest through Args.
struct Args {
  int64_t* out;          // [L, R, W]
  const int64_t* consts;
  const int64_t* tw;     // null, or [L, tw_rows, W] in storage form
  int L, R, W, KB, KBs, Dmax, tw_rows, groups, stages, resident, tw_tma;
};

// Where a launch keeps the table planes: resident (for the block's life,
// reloaded where its row tiles cross into the next limb) or a K-tile in
// each stage; the ring's stages; the shared-memory bytes, tw_bytes of
// twiddle tiles included.
struct Plan {
  int resident, stages;
  size_t smem;
};

Plan plan_for(int KBs, int Dmax, size_t tw_bytes) {
  const size_t free_bytes = SMEM_LIMIT - ALIGN - BARRIER_BYTES - tw_bytes;
  const size_t table = static_cast<size_t>(Dmax) * BW * KBs;
  const bool resident = table + MIN_RESIDENT_STAGES * A_BYTES <= free_bytes;
  const size_t stage = A_BYTES + (resident ? 0 : static_cast<size_t>(Dmax) * T_TILE);
  const size_t room = (free_bytes - (resident ? table : 0)) / stage;
  const int stages = room < MAX_STAGES ? static_cast<int>(room) : MAX_STAGES;
  return {resident ? 1 : 0, stages,
          ALIGN + BARRIER_BYTES + tw_bytes + (resident ? table : 0) + stages * stage};
}

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

// Shared memory of a block: [table planes][ring of stages][two twiddle
// tiles][barriers: full, empty a stage; the table's tbar and tfree; the
// twiddle tiles' twfull, twempty].
struct Smem {
  uint32_t table, ring, tws, full, empty, tbar, tfree, twfull, twempty;
  int stage_bytes;
};

// The block's work: column tile jt, and the row tiles u0 .. u1 - 1 of the
// flattened (limb, row tile) order, u = l nt + t; the blocks of a group's
// column tiles are neighbours in the grid and take the same row tiles, so
// the second read of a data row is served by L2.
struct Work {
  int jt, nj, nt, kt_n, u0, u1;
};

__device__ __forceinline__ Work work_of(const Args& p) {
  Work w;
  w.nj = (p.W + BW - 1) / BW;
  w.nt = (p.R + BM - 1) / BM;
  w.kt_n = p.KB / BK + (p.KB % BK ? 1 : 0);
  w.jt = blockIdx.x % w.nj;
  const long long g = blockIdx.x / w.nj, lt = static_cast<long long>(p.L) * w.nt;
  w.u0 = static_cast<int>(g * lt / p.groups);
  w.u1 = static_cast<int>((g + 1) * lt / p.groups);
  return w;
}

// Producer warp 0: lane 0 issues the TMA copies: for each limb the block
// reaches, its table planes (resident: once the consumers are done with
// the last limb's, tfree), then each row tile's K-tiles into the ring, each
// stage's bytes expected on its full barrier.
__device__ __forceinline__ void produce(const CUtensorMap& tx, const CUtensorMap& tt,
                                        const Args& p, const Smem& sm, const Work& wk) {
  const int lane = threadIdx.x & 31;
  int s = 0, round = 0, seg = 0;
  for (int u = wk.u0; u < wk.u1; ++seg) {
    const int l = u / wk.nt, end = min(wk.u1, (l + 1) * wk.nt);
    const int d = mfhe::digits_of(mfhe::load_consts(p.consts, l).q);
    const int trow = (l * wk.nj + wk.jt) * p.Dmax * BW;   // plane j at trow + 32 j
    if (p.resident) {
      if (seg > 0) mbar_wait(sm.tfree, (seg - 1) & 1);
      if (lane == 0) {
        mbar_expect(sm.tbar, wk.kt_n * d * T_TILE);
        for (int kt = 0; kt < wk.kt_n; ++kt)
          for (int j = 0; j < d; ++j)
            tma_load(sm.table + (kt * p.Dmax + j) * T_TILE, tt, kt * BK, trow + j * BW,
                     sm.tbar);
      }
    }
    for (; u < end; ++u) {
      const int row = l * p.R + (u - l * wk.nt) * BM;
      for (int kt = 0; kt < wk.kt_n; ++kt) {
        if (round > 0) mbar_wait(sm.empty + 8 * s, (round - 1) & 1);
        if (lane == 0) {
          const uint32_t sa = sm.ring + s * sm.stage_bytes, bar = sm.full + 8 * s;
          mbar_expect(bar, A_BYTES + (p.resident ? 0 : d * T_TILE));
          tma_load(sa, tx, kt * BK, row, bar);
          if (!p.resident)
            for (int j = 0; j < d; ++j)
              tma_load(sa + A_BYTES + j * T_TILE, tt, kt * BK, trow + j * BW, bar);
        }
        __syncwarp();
        if (++s == p.stages) {
          s = 0;
          ++round;
        }
      }
    }
  }
}

// Producer warp 1 (tw_tma): each consumer's 64 x 32 twiddle tile of each
// row tile, once that consumer has read its last one (twempty).  Its rows
// are contiguous in the twiddle: tw_rows is a multiple of 64.
__device__ __forceinline__ void produce_twiddles(const CUtensorMap& tm, const Args& p,
                                                 const Smem& sm, const Work& wk) {
  if ((threadIdx.x & 31) != 0) return;
  for (int u = wk.u0, k = 0; u < wk.u1; ++u, ++k) {
    const int l = u / wk.nt, t = u - l * wk.nt;
    for (int cw = 0; cw < 2; ++cw) {
      if (k > 0) mbar_wait(sm.twempty + 8 * cw, (k - 1) & 1);
      mbar_expect(sm.twfull + 8 * cw, TW_BYTES);
      tma_load(sm.tws + cw * TW_BYTES, tm, wk.jt * BW * 8,
               l * p.tw_rows + (t * BM + 64 * cw) % p.tw_rows, sm.twfull + 8 * cw);
    }
  }
}

// a b + c, 32 x 32 -> 64 bits, one IMAD.WIDE.U32.
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// mfhe::fold for plane sums below 2^26 (a contraction of at most KB_MAX
// bytes): S = sum_j diag_j 2^(8 j) as (hi, lo), the same 128-bit value.
// The first five planes sum below 2^59 in one word (one multiply-add a
// plane); planes 5 and 6 come in as b 2^40, b < 2^35.
template <int D>
__device__ __forceinline__ void fold_short(const int (&a)[16 * D], int idx,
                                           uint64_t& hi, uint64_t& lo) {
  uint64_t s = static_cast<uint32_t>(a[idx]);
#pragma unroll
  for (int j = 1; j < (D < 4 ? D : 4); ++j)
    s = mad_wide(static_cast<uint32_t>(a[16 * j + idx]), 1u << (8 * j), s);
  if (D >= 5) s += static_cast<uint64_t>(static_cast<uint32_t>(a[16 * 4 + idx])) << 32;
  if (D <= 5) {
    lo = s;
    hi = 0;
    return;
  }
  const uint64_t b = D > 6 ? mad_wide(static_cast<uint32_t>(a[16 * 6 + idx]), 256,
                                      static_cast<uint32_t>(a[16 * 5 + idx]))
                           : static_cast<uint32_t>(a[16 * 5 + idx]);
  const uint64_t t = b << 40;
  lo = s + t;
  hi = (b >> 24) + (lo < t ? 1ull : 0ull);
}

// The twiddles of a consumer warpgroup's 64 x 32 outputs, tv[8 h + 2 t + e]
// for row rbase + 8 h, column wbase + 8 t + e: loaded as its tile's
// products begin, so that they arrive under them.  A row past R reads row
// (row mod tw_rows), a real one; its output is never stored.
__device__ __forceinline__ void load_twiddles(uint64_t (&tv)[16], const Args& p,
                                              int l, int row0, int jt) {
  const int lane = threadIdx.x & 31;
  const int rbase = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int wbase = jt * BW + 2 * (lane & 3);
  const uint64_t* tw = reinterpret_cast<const uint64_t*>(p.tw) +
                       static_cast<long long>(l) * p.tw_rows * p.W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t* f = tw + static_cast<long long>((rbase + 8 * h) % p.tw_rows) * p.W;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int w = wbase + 8 * t, i = 8 * h + 2 * t;
      if ((p.W & 1) == 0 && w < p.W) {    // w even and W even: w + 1 < W
        const ulonglong2 m = *reinterpret_cast<const ulonglong2*>(f + w);
        tv[i] = m.x;
        tv[i + 1] = m.y;
      } else {
        tv[i] = w < p.W ? f[w] : 0;
        tv[i + 1] = w + 1 < p.W ? f[w + 1] : 0;
      }
    }
  }
}

// mfhe::mont_redc without its last conditional subtraction: a value below
// 2 q congruent to (hi 2^64 + lo) 2^-64, for hi < q.  Its product with a
// twiddle below q is below q 2^64, so one mont_mul makes it canonical.
__device__ __forceinline__ uint64_t redc_2q(uint64_t hi, uint64_t lo,
                                            const mfhe::LimbConsts& c) {
  const uint64_t m = lo * c.qinv_neg;
  return hi + __umul64hi(m, c.q) + (lo != 0 ? 1ull : 0ull);
}

// The twiddles of a consumer warpgroup's outputs from its tile in shared
// memory (64 rows of 32 columns), tv as load_twiddles lays them out.
__device__ __forceinline__ void smem_twiddles(uint64_t (&tv)[16], uint32_t buf) {
  const int lane = threadIdx.x & 31;
  const uint32_t a = buf + (((threadIdx.x >> 5) & 3) * 16 + (lane >> 2)) * (BW * 8) +
                     16 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];\n"
                   : "=l"(tv[8 * h + 2 * t]), "=l"(tv[8 * h + 2 * t + 1])
                   : "r"(a + 8 * h * (BW * 8) + 64 * t)
                   : "memory");
}

// A consumer warpgroup's 64 x 32 outputs: fold the d plane sums of each and
// reduce them with one Montgomery REDC (the planes carry 2^64), or times
// the twiddle, then store two neighbouring columns as one 16-byte store.
// A thread's 16 outputs go in chunks of EPI_CHUNK, each computed without a
// branch (a row past R or a column past W computes what is never stored)
// so that their chains of multiplies interleave, then stored.
constexpr int EPI_CHUNK = 8;

template <int D>
__device__ __forceinline__ void epilogue(const int (&acc)[16 * D],
                                         const uint64_t (&tv)[16], const Args& p,
                                         const mfhe::LimbConsts& c, int l,
                                         int row0, int jt) {
  const int lane = threadIdx.x & 31;
  const int rbase = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int wbase = jt * BW + 2 * (lane & 3);
  uint64_t* out = reinterpret_cast<uint64_t*>(p.out) + static_cast<long long>(l) * p.R * p.W;
#pragma unroll
  for (int i0 = 0; i0 < 16; i0 += EPI_CHUNK) {
    uint64_t v[EPI_CHUNK];            // v[i - i0], i = 8 h + 2 t + e: acc index 4 t + 2 h + e
    if (p.tw) {
#pragma unroll
      for (int k = 0; k < EPI_CHUNK; ++k) {
        const int i = i0 + k;
        uint64_t hi, lo;
        fold_short<D>(acc, 4 * ((i >> 1) & 3) + 2 * (i >> 3) + (i & 1), hi, lo);
        v[k] = mfhe::mont_mul(redc_2q(hi, lo, c), tv[i], c);
      }
    } else {
#pragma unroll
      for (int k = 0; k < EPI_CHUNK; ++k) {
        const int i = i0 + k;
        uint64_t hi, lo;
        fold_short<D>(acc, 4 * ((i >> 1) & 3) + 2 * (i >> 3) + (i & 1), hi, lo);
        v[k] = mfhe::mont_redc(hi, lo, c);
      }
    }
#pragma unroll
    for (int k = 0; k < EPI_CHUNK; k += 2) {
      const int i = i0 + k, row = rbase + 8 * (i >> 3), w = wbase + 8 * ((i >> 1) & 3);
      if (row >= p.R) continue;
      uint64_t* o = out + static_cast<long long>(row) * p.W;
      if ((p.W & 1) == 0 && w < p.W) {    // w even and W even: w + 1 < W
        *reinterpret_cast<ulonglong2*>(o + w) = make_ulonglong2(v[k], v[k + 1]);
      } else {
        if (w < p.W) o[w] = v[k];
        if (w + 1 < p.W) o[w + 1] = v[k + 1];
      }
    }
  }
}

// A consumer's state across the limbs of its block: the ring position, the
// stage to release, the limbs and twiddle tiles seen.
struct Ring {
  int s, round, prev, seg, twk;
};

// A consumer warpgroup (cw 0 or 1: rows 64 cw .. 64 cw + 63 of each tile)
// on the row tiles u .. end - 1 of limb l (d digits): wgmma over each
// tile's K-tiles as they land, each stage released once its products are
// done, then the epilogue.  Where the ring holds a whole tile's K-tiles
// (K <= 64: a consumer never waits for a stage the other has not reached)
// the two take turns at the tensor cores (named barriers TURN0, TURN1):
// consumer 1 issues its products of a tile while consumer 0 runs that
// tile's epilogue, and consumer 0 those of the next tile under consumer
// 1's.  Otherwise they run side by side.
template <int D>
__device__ __forceinline__ void consume(const Args& p, const Smem& sm, const Work& wk,
                                        Ring& rg, int l, int u, int end) {
  const int cw = (threadIdx.x >> 7) - 1, lane = threadIdx.x & 31;
  const mfhe::LimbConsts c = mfhe::load_consts(p.consts, l);
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  const bool turns = p.stages >= wk.kt_n;
  const int mine = cw ? TURN1 : TURN0, other = cw ? TURN0 : TURN1;
  int acc[16 * D];
#pragma unroll
  for (int i = 0; i < 16 * D; ++i) acc[i] = 0;
  uint64_t tv[16];
  // where tw_rows divides the 128 rows of a tile, every tile has the
  // same twiddles: loaded once for the limb
  const bool tw_fixed = p.tw && !p.tw_tma && BM % p.tw_rows == 0;
  if (tw_fixed) load_twiddles(tv, p, l, 64 * cw, wk.jt);
  if (p.resident) mbar_wait(sm.tbar, rg.seg & 1);
  for (; u < end; ++u) {
    const int row0 = (u - l * wk.nt) * BM + 64 * cw;
    if (p.tw && !p.tw_tma && !tw_fixed) load_twiddles(tv, p, l, row0, wk.jt);
    if (turns) asm volatile("bar.sync %0, 256;\n" ::"r"(mine) : "memory");
    for (int kt = 0; kt < wk.kt_n; ++kt) {
      mbar_wait(sm.full + 8 * rg.s, rg.round & 1);
      const uint32_t stage = sm.ring + rg.s * sm.stage_bytes;
      const uint32_t sa = stage + cw * (64 * BK);
      const uint32_t sb = p.resident ? sm.table + kt * p.Dmax * T_TILE : stage + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        mfhe::wgmma8<D, false>(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk),
                               (kt > 0 || kk > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(acc);
      if (kt > 0) release(sm.empty + 8 * rg.prev);   // the K-tile before is done
      rg.prev = rg.s;
      if (++rg.s == p.stages) {
        rg.s = 0;
        ++rg.round;
      }
    }
    // the other's turn: its products of this tile (consumer 0) or of the
    // next (consumer 1, if the block has one)
    if (turns && (cw == 0 || u + 1 < wk.u1))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    release(sm.empty + 8 * rg.prev);
    if (p.tw_tma) {
      mbar_wait(sm.twfull + 8 * cw, rg.twk & 1);
      smem_twiddles(tv, sm.tws + cw * TW_BYTES);
    }
    ++rg.twk;
    epilogue<D>(acc, tv, p, c, l, row0, wk.jt);
    // the tile's twiddles are consumed (their loads completed), so the
    // producer's next copy into the buffer cannot overtake them
    if (p.tw_tma) release(sm.twempty + 8 * cw);
  }
  if (p.resident) release(sm.tfree);   // done with this limb's table planes
  ++rg.seg;
}

__global__ void __launch_bounds__(THREADS, 1)
    xntt_stage_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tt,
                      const __grid_constant__ CUtensorMap tm, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const Work wk = work_of(p);
  Smem sm;
  sm.table = sbase;
  sm.ring = sbase + (p.resident ? p.Dmax * BW * p.KBs : 0);
  sm.stage_bytes = A_BYTES + (p.resident ? 0 : p.Dmax * T_TILE);
  sm.tws = sm.ring + p.stages * sm.stage_bytes;
  sm.full = sm.tws + (p.tw_tma ? 2 * TW_BYTES : 0);
  sm.empty = sm.full + 8 * MAX_STAGES;
  sm.tbar = sm.empty + 8 * MAX_STAGES;
  sm.tfree = sm.tbar + 8;
  sm.twfull = sm.tfree + 8;
  sm.twempty = sm.twfull + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(sm.full + 8 * s, 1);        // the producer's, with the bytes
      mbar_init(sm.empty + 8 * s, 8);       // every consumer warp
    }
    mbar_init(sm.tbar, 1);
    mbar_init(sm.tfree, 8);
    for (int cw = 0; cw < 2; ++cw) {
      mbar_init(sm.twfull + 8 * cw, 1);
      mbar_init(sm.twempty + 8 * cw, 4);    // the consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32)
      produce(tx, tt, p, sm, wk);
    else if (threadIdx.x < 64 && p.tw_tma)
      produce_twiddles(tm, p, sm, wk);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = (threadIdx.x >> 7) - 1;
    const bool turns = p.stages >= wk.kt_n;
    if (turns && cw == 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(TURN0) : "memory");
    Ring rg{0, 0, 0, 0, 0};
    for (int u = wk.u0; u < wk.u1;) {
      const int l = u / wk.nt, end = min(wk.u1, (l + 1) * wk.nt);
      switch (mfhe::digits_of(mfhe::load_consts(p.consts, l).q)) {
        case 1: consume<1>(p, sm, wk, rg, l, u, end); break;
        case 2: consume<2>(p, sm, wk, rg, l, u, end); break;
        case 3: consume<3>(p, sm, wk, rg, l, u, end); break;
        case 4: consume<4>(p, sm, wk, rg, l, u, end); break;
        case 5: consume<5>(p, sm, wk, rg, l, u, end); break;
        case 6: consume<6>(p, sm, wk, rg, l, u, end); break;
        default: consume<7>(p, sm, wk, rg, l, u, end); break;
      }
      u = end;
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
// its rows), boxes of box_inner bytes x box_rows, the 128-byte swizzle
// (swizzled) or none, zeros past its edges.
bool byte_map(CUtensorMap* map, const void* base, long long inner, long long rows,
              int box_inner, int box_rows, bool swizzled) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The X-NTT stage: X the int64 data [L, R, Kp] (Kp = K rounded up to even,
// the rows 16-byte aligned), read as bytes; T K1's side "right" table planes
// [L, ceil(W / 32), Dmax, 32, KBs] (mf_stage_layout's KBs, 8 Kp <= KBs <=
// 1,024); tw null or [L, tw_rows, W] in storage form (16-byte aligned),
// tw_rows dividing R.  out [L, R, W].  Refuses (cudaErrorInvalidValue) what
// it does not take.
extern "C" int mf_stage_x(const void* X, const void* T, int64_t* out,
                          const int64_t* consts, const int64_t* tw, int L, int R,
                          int W, int Kp, int tw_rows, int KBs, int Dmax,
                          void* stream) {
  const int KB = 8 * Kp;
  if (L < 1 || R < 1 || W < 1 || Kp < 1 || KB > KB_MAX || KBs != (KB + BK - 1) / BK * BK ||
      Dmax < 1 || Dmax > DMAX || (tw != nullptr && (tw_rows < 1 || R % tw_rows != 0)) ||
      static_cast<long long>(L) * R > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the twiddle through TMA where a consumer's 64 rows of it are contiguous
  const bool tw_tma = tw != nullptr && tw_rows % 64 == 0 && W % 2 == 0;
  const Plan plan = plan_for(KBs, Dmax, tw_tma ? 2 * TW_BYTES : 0);
  if (plan.stages < 2 || plan.smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(xntt_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nj = (W + BW - 1) / BW, nt = (R + BM - 1) / BM;
  const long long lt = static_cast<long long>(L) * nt;
  long long groups = sms / nj;                 // one wave: a group an SM per column tile
  groups = groups < 1 ? 1 : (groups > lt ? lt : groups);
  const long long blocks = groups * nj;
  CUtensorMap tx, tt, tm = {};
  if (blocks > 0x7fffffffLL || !byte_map(&tx, X, KB, static_cast<long long>(L) * R, BK, BM, true) ||
      !byte_map(&tt, T, KBs, static_cast<long long>(L) * nj * Dmax * BW, BK, BW, true) ||
      (tw_tma && !byte_map(&tm, tw, 8LL * W, static_cast<long long>(L) * tw_rows, BW * 8, 64,
                           false)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{out, consts, tw, L, R, W, KB, KBs, Dmax, tw ? tw_rows : 1,
               static_cast<int>(groups), plan.stages, plan.resident, tw_tma ? 1 : 0};
  xntt_stage_kernel<<<static_cast<unsigned>(blocks), THREADS, plan.smem,
                      static_cast<cudaStream_t>(stream)>>>(tx, tt, tm, a);
  return static_cast<int>(cudaGetLastError());
}
