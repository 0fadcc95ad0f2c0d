// Hopper warpgroup tensor-core products on 8-bit digits, unsigned or signed.
//
// wgmma8<D, S8>(acc, da, db, accumulate): one wgmma.mma_async
// m64n(32 D)k32 .s32.u8.u8 (S8 false: the u8 digit planes of K1, K2, K6,
// K7) or .s32.s8.s8 (S8 true: K4's balanced s8 digits, K12's s8 dots), A [64 x 32] and
// B [32 D x 32] both K-major in shared memory (descriptors da, db), 16 D s32
// sums a thread; with `accumulate` 0 the sums are overwritten, else added
// to.  The register lists are written out for D = 1..7 (N = 32..224), one
// per digit count of a modulus below 2^56.  Register fragment of the
// accumulator (PTX ISA, wgmma .m64nNk32): warp i of the warpgroup holds
// rows 16 i .. 16 i + 15; a[4 b + 2 h + e] is row 16 i + lane / 4 + 8 h,
// column 8 b + 2 (lane % 4) + e.  With them the helpers the kernels share
// to fill their operand tiles (cp.async, the 128-byte-swizzle descriptor
// and addresses, byte transposes) and to fold, reduce and store an
// output's u8 plane sums.
#pragma once

#include <cstdint>

#include "modarith.cuh"

// One wgmma with N columns on operand type AB ("u8.u8" or "s8.s8"): REGS
// names the 16 D accumulator operands, SC the operand of `accumulate`, DA
// and DB the descriptors'; the output constraints follow.
#define MFHE_WGMMA8(N, AB, REGS, DA, DB, SC, ...)                              \
  asm volatile("{\n.reg .pred p;\n"                                          \
               "setp.ne.b32 p, " SC ", 0;\n"                                  \
               "wgmma.mma_async.sync.aligned.m64n" N "k32.s32." AB " {" REGS  \
               "}, " DA ", " DB ", p;\n}\n"                                  \
               : __VA_ARGS__                                                  \
               : "l"(da), "l"(db), "r"(accumulate))

namespace mfhe {

// cp.async copies of 16 bytes (fewer read, the rest zero-filled) into the
// shared-memory operand tiles.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K-major operand, 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024
// bytes apart (SBO), leading offset unused (encoded 1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The fold of a u8 digit-plane GEMM whose N holds D table planes of 32
// columns (K1, K2, K7): S = sum_j diag_j 2^(8 j) of the output whose plane
// sums are a[16 j + idx], as (hi, lo); hi < 2^16, since every diag_j <
// 2^31 and D <= 7.
template <int D>
__device__ __forceinline__ void fold(const int (&a)[16 * D], int idx,
                                     uint64_t& hi, uint64_t& lo) {
  lo = hi = 0;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const uint64_t x = static_cast<uint32_t>(a[16 * j + idx]);
    const uint64_t tlo = x << (8 * j);
    lo += tlo;
    hi += (j ? x >> (64 - 8 * j) : 0) + (lo < tlo ? 1ull : 0ull);
  }
}

// Shared-memory address of the 8 bytes at contraction byte kb (a multiple
// of 8) of row r in a K-tiled operand at `base` (128-byte swizzle rows),
// K-tiles `tile` bytes apart.
__device__ __forceinline__ uint32_t swz(uint32_t base, int tile, int r, int kb) {
  return base + (kb >> 7) * tile + r * 128 + ((((kb & 127) >> 4) ^ (r & 7)) << 4) +
         (kb & 8);
}

__device__ __forceinline__ void st_shared8(uint32_t addr, uint64_t v) {
  asm volatile("st.shared.u64 [%0], %1;\n" ::"r"(addr), "l"(v));
}

// w[j] = byte j of x[0], ..., x[7], little-endian: an 8 x 8 byte
// transpose as four 4 x 4 ones, 8 byte permutes each (K6 and K7 cut their
// operands' digit planes with it as they stage them).
__device__ __forceinline__ void byte_planes(const uint64_t (&x)[8], uint64_t (&w)[8]) {
  uint32_t r[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)          // values 4 h .. 4 h + 3
#pragma unroll
    for (int part = 0; part < 2; ++part) {   // their bytes 4 part .. + 3
      const uint32_t a = static_cast<uint32_t>(x[4 * h] >> (32 * part));
      const uint32_t b = static_cast<uint32_t>(x[4 * h + 1] >> (32 * part));
      const uint32_t c = static_cast<uint32_t>(x[4 * h + 2] >> (32 * part));
      const uint32_t d = static_cast<uint32_t>(x[4 * h + 3] >> (32 * part));
      const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(c, d, 0x5140);
      const uint32_t t2 = __byte_perm(a, b, 0x7362), t3 = __byte_perm(c, d, 0x7362);
      r[h][4 * part] = __byte_perm(t0, t1, 0x5410);
      r[h][4 * part + 1] = __byte_perm(t0, t1, 0x7632);
      r[h][4 * part + 2] = __byte_perm(t2, t3, 0x5410);
      r[h][4 * part + 3] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = r[0][j] | (static_cast<uint64_t>(r[1][j]) << 32);
}

// Fold and REDC this thread's 16 outputs of a warpgroup's 64 x 32 tile
// (rows a0 .. a0 + 63, columns b0 .. b0 + 31) of the m x m matrix `out`,
// the d plane sums of each in acc (K6, K7); write them (first flush) or
// add them mod q to what an earlier flush wrote, two neighbouring columns
// a 16-byte store where m is even.
template <int D>
__device__ __forceinline__ void store_tile(const int (&acc)[16 * D], uint64_t* out,
                                           int m, const LimbConsts& c, int a0,
                                           int b0, bool first) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int abase = a0 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int bbase = b0 + 2 * (lane & 3);
  const bool pairs = (m & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = abase + 8 * h;
    if (a >= m) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int b = bbase + 8 * t;
      if (b >= m) continue;
      uint64_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint64_t hi, lo;
        fold<D>(acc, 4 * t + 2 * h + e, hi, lo);
        v[e] = mont_redc(hi, lo, c);
      }
      uint64_t* o = out + static_cast<long long>(a) * m + b;
      if (pairs) {                       // b even, b + 1 < m
        ulonglong2* dst = reinterpret_cast<ulonglong2*>(o);
        if (!first) {
          const ulonglong2 prev = *dst;
          v[0] += prev.x;
          v[1] += prev.y;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (v[e] >= c.q) v[e] -= c.q;
        }
        *dst = make_ulonglong2(v[0], v[1]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (b + e >= m) continue;
        if (!first) {
          v[e] += o[e];
          if (v[e] >= c.q) v[e] -= c.q;
        }
        o[e] = v[e];
      }
    }
  }
}

template <int D, bool S8>
__device__ __forceinline__ void wgmma8(int (&a)[16 * D], uint64_t da,
                                       uint64_t db, int accumulate);

#define MFHE_REGS1 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define MFHE_OUTS1 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15])

template <>
__device__ __forceinline__ void wgmma8<1, false>(int (&a)[16], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("32", "u8.u8", MFHE_REGS1, "%16", "%17", "%18", MFHE_OUTS1);
}

template <>
__device__ __forceinline__ void wgmma8<1, true>(int (&a)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("32", "s8.s8", MFHE_REGS1, "%16", "%17", "%18", MFHE_OUTS1);
}

#define MFHE_REGS2 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MFHE_OUTS2 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15]), \
  "+r"(a[16]), "+r"(a[17]), "+r"(a[18]), "+r"(a[19]), "+r"(a[20]), "+r"(a[21]), "+r"(a[22]), "+r"(a[23]), \
  "+r"(a[24]), "+r"(a[25]), "+r"(a[26]), "+r"(a[27]), "+r"(a[28]), "+r"(a[29]), "+r"(a[30]), "+r"(a[31])

template <>
__device__ __forceinline__ void wgmma8<2, false>(int (&a)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("64", "u8.u8", MFHE_REGS2, "%32", "%33", "%34", MFHE_OUTS2);
}

template <>
__device__ __forceinline__ void wgmma8<2, true>(int (&a)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("64", "s8.s8", MFHE_REGS2, "%32", "%33", "%34", MFHE_OUTS2);
}

#define MFHE_REGS3 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define MFHE_OUTS3 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15]), \
  "+r"(a[16]), "+r"(a[17]), "+r"(a[18]), "+r"(a[19]), "+r"(a[20]), "+r"(a[21]), "+r"(a[22]), "+r"(a[23]), \
  "+r"(a[24]), "+r"(a[25]), "+r"(a[26]), "+r"(a[27]), "+r"(a[28]), "+r"(a[29]), "+r"(a[30]), "+r"(a[31]), \
  "+r"(a[32]), "+r"(a[33]), "+r"(a[34]), "+r"(a[35]), "+r"(a[36]), "+r"(a[37]), "+r"(a[38]), "+r"(a[39]), \
  "+r"(a[40]), "+r"(a[41]), "+r"(a[42]), "+r"(a[43]), "+r"(a[44]), "+r"(a[45]), "+r"(a[46]), "+r"(a[47])

template <>
__device__ __forceinline__ void wgmma8<3, false>(int (&a)[48], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("96", "u8.u8", MFHE_REGS3, "%48", "%49", "%50", MFHE_OUTS3);
}

template <>
__device__ __forceinline__ void wgmma8<3, true>(int (&a)[48], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("96", "s8.s8", MFHE_REGS3, "%48", "%49", "%50", MFHE_OUTS3);
}

#define MFHE_REGS4 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define MFHE_OUTS4 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15]), \
  "+r"(a[16]), "+r"(a[17]), "+r"(a[18]), "+r"(a[19]), "+r"(a[20]), "+r"(a[21]), "+r"(a[22]), "+r"(a[23]), \
  "+r"(a[24]), "+r"(a[25]), "+r"(a[26]), "+r"(a[27]), "+r"(a[28]), "+r"(a[29]), "+r"(a[30]), "+r"(a[31]), \
  "+r"(a[32]), "+r"(a[33]), "+r"(a[34]), "+r"(a[35]), "+r"(a[36]), "+r"(a[37]), "+r"(a[38]), "+r"(a[39]), \
  "+r"(a[40]), "+r"(a[41]), "+r"(a[42]), "+r"(a[43]), "+r"(a[44]), "+r"(a[45]), "+r"(a[46]), "+r"(a[47]), \
  "+r"(a[48]), "+r"(a[49]), "+r"(a[50]), "+r"(a[51]), "+r"(a[52]), "+r"(a[53]), "+r"(a[54]), "+r"(a[55]), \
  "+r"(a[56]), "+r"(a[57]), "+r"(a[58]), "+r"(a[59]), "+r"(a[60]), "+r"(a[61]), "+r"(a[62]), "+r"(a[63])

template <>
__device__ __forceinline__ void wgmma8<4, false>(int (&a)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("128", "u8.u8", MFHE_REGS4, "%64", "%65", "%66", MFHE_OUTS4);
}

template <>
__device__ __forceinline__ void wgmma8<4, true>(int (&a)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("128", "s8.s8", MFHE_REGS4, "%64", "%65", "%66", MFHE_OUTS4);
}

#define MFHE_REGS5 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define MFHE_OUTS5 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15]), \
  "+r"(a[16]), "+r"(a[17]), "+r"(a[18]), "+r"(a[19]), "+r"(a[20]), "+r"(a[21]), "+r"(a[22]), "+r"(a[23]), \
  "+r"(a[24]), "+r"(a[25]), "+r"(a[26]), "+r"(a[27]), "+r"(a[28]), "+r"(a[29]), "+r"(a[30]), "+r"(a[31]), \
  "+r"(a[32]), "+r"(a[33]), "+r"(a[34]), "+r"(a[35]), "+r"(a[36]), "+r"(a[37]), "+r"(a[38]), "+r"(a[39]), \
  "+r"(a[40]), "+r"(a[41]), "+r"(a[42]), "+r"(a[43]), "+r"(a[44]), "+r"(a[45]), "+r"(a[46]), "+r"(a[47]), \
  "+r"(a[48]), "+r"(a[49]), "+r"(a[50]), "+r"(a[51]), "+r"(a[52]), "+r"(a[53]), "+r"(a[54]), "+r"(a[55]), \
  "+r"(a[56]), "+r"(a[57]), "+r"(a[58]), "+r"(a[59]), "+r"(a[60]), "+r"(a[61]), "+r"(a[62]), "+r"(a[63]), \
  "+r"(a[64]), "+r"(a[65]), "+r"(a[66]), "+r"(a[67]), "+r"(a[68]), "+r"(a[69]), "+r"(a[70]), "+r"(a[71]), \
  "+r"(a[72]), "+r"(a[73]), "+r"(a[74]), "+r"(a[75]), "+r"(a[76]), "+r"(a[77]), "+r"(a[78]), "+r"(a[79])

template <>
__device__ __forceinline__ void wgmma8<5, false>(int (&a)[80], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("160", "u8.u8", MFHE_REGS5, "%80", "%81", "%82", MFHE_OUTS5);
}

template <>
__device__ __forceinline__ void wgmma8<5, true>(int (&a)[80], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("160", "s8.s8", MFHE_REGS5, "%80", "%81", "%82", MFHE_OUTS5);
}

#define MFHE_REGS6 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define MFHE_OUTS6 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15]), \
  "+r"(a[16]), "+r"(a[17]), "+r"(a[18]), "+r"(a[19]), "+r"(a[20]), "+r"(a[21]), "+r"(a[22]), "+r"(a[23]), \
  "+r"(a[24]), "+r"(a[25]), "+r"(a[26]), "+r"(a[27]), "+r"(a[28]), "+r"(a[29]), "+r"(a[30]), "+r"(a[31]), \
  "+r"(a[32]), "+r"(a[33]), "+r"(a[34]), "+r"(a[35]), "+r"(a[36]), "+r"(a[37]), "+r"(a[38]), "+r"(a[39]), \
  "+r"(a[40]), "+r"(a[41]), "+r"(a[42]), "+r"(a[43]), "+r"(a[44]), "+r"(a[45]), "+r"(a[46]), "+r"(a[47]), \
  "+r"(a[48]), "+r"(a[49]), "+r"(a[50]), "+r"(a[51]), "+r"(a[52]), "+r"(a[53]), "+r"(a[54]), "+r"(a[55]), \
  "+r"(a[56]), "+r"(a[57]), "+r"(a[58]), "+r"(a[59]), "+r"(a[60]), "+r"(a[61]), "+r"(a[62]), "+r"(a[63]), \
  "+r"(a[64]), "+r"(a[65]), "+r"(a[66]), "+r"(a[67]), "+r"(a[68]), "+r"(a[69]), "+r"(a[70]), "+r"(a[71]), \
  "+r"(a[72]), "+r"(a[73]), "+r"(a[74]), "+r"(a[75]), "+r"(a[76]), "+r"(a[77]), "+r"(a[78]), "+r"(a[79]), \
  "+r"(a[80]), "+r"(a[81]), "+r"(a[82]), "+r"(a[83]), "+r"(a[84]), "+r"(a[85]), "+r"(a[86]), "+r"(a[87]), \
  "+r"(a[88]), "+r"(a[89]), "+r"(a[90]), "+r"(a[91]), "+r"(a[92]), "+r"(a[93]), "+r"(a[94]), "+r"(a[95])

template <>
__device__ __forceinline__ void wgmma8<6, false>(int (&a)[96], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("192", "u8.u8", MFHE_REGS6, "%96", "%97", "%98", MFHE_OUTS6);
}

template <>
__device__ __forceinline__ void wgmma8<6, true>(int (&a)[96], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("192", "s8.s8", MFHE_REGS6, "%96", "%97", "%98", MFHE_OUTS6);
}

#define MFHE_REGS7 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define MFHE_OUTS7 \
  "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), \
  "+r"(a[8]), "+r"(a[9]), "+r"(a[10]), "+r"(a[11]), "+r"(a[12]), "+r"(a[13]), "+r"(a[14]), "+r"(a[15]), \
  "+r"(a[16]), "+r"(a[17]), "+r"(a[18]), "+r"(a[19]), "+r"(a[20]), "+r"(a[21]), "+r"(a[22]), "+r"(a[23]), \
  "+r"(a[24]), "+r"(a[25]), "+r"(a[26]), "+r"(a[27]), "+r"(a[28]), "+r"(a[29]), "+r"(a[30]), "+r"(a[31]), \
  "+r"(a[32]), "+r"(a[33]), "+r"(a[34]), "+r"(a[35]), "+r"(a[36]), "+r"(a[37]), "+r"(a[38]), "+r"(a[39]), \
  "+r"(a[40]), "+r"(a[41]), "+r"(a[42]), "+r"(a[43]), "+r"(a[44]), "+r"(a[45]), "+r"(a[46]), "+r"(a[47]), \
  "+r"(a[48]), "+r"(a[49]), "+r"(a[50]), "+r"(a[51]), "+r"(a[52]), "+r"(a[53]), "+r"(a[54]), "+r"(a[55]), \
  "+r"(a[56]), "+r"(a[57]), "+r"(a[58]), "+r"(a[59]), "+r"(a[60]), "+r"(a[61]), "+r"(a[62]), "+r"(a[63]), \
  "+r"(a[64]), "+r"(a[65]), "+r"(a[66]), "+r"(a[67]), "+r"(a[68]), "+r"(a[69]), "+r"(a[70]), "+r"(a[71]), \
  "+r"(a[72]), "+r"(a[73]), "+r"(a[74]), "+r"(a[75]), "+r"(a[76]), "+r"(a[77]), "+r"(a[78]), "+r"(a[79]), \
  "+r"(a[80]), "+r"(a[81]), "+r"(a[82]), "+r"(a[83]), "+r"(a[84]), "+r"(a[85]), "+r"(a[86]), "+r"(a[87]), \
  "+r"(a[88]), "+r"(a[89]), "+r"(a[90]), "+r"(a[91]), "+r"(a[92]), "+r"(a[93]), "+r"(a[94]), "+r"(a[95]), \
  "+r"(a[96]), "+r"(a[97]), "+r"(a[98]), "+r"(a[99]), "+r"(a[100]), "+r"(a[101]), "+r"(a[102]), "+r"(a[103]), \
  "+r"(a[104]), "+r"(a[105]), "+r"(a[106]), "+r"(a[107]), "+r"(a[108]), "+r"(a[109]), "+r"(a[110]), "+r"(a[111])

template <>
__device__ __forceinline__ void wgmma8<7, false>(int (&a)[112], uint64_t da,
                                                 uint64_t db, int accumulate) {
  MFHE_WGMMA8("224", "u8.u8", MFHE_REGS7, "%112", "%113", "%114", MFHE_OUTS7);
}

template <>
__device__ __forceinline__ void wgmma8<7, true>(int (&a)[112], uint64_t da,
                                                uint64_t db, int accumulate) {
  MFHE_WGMMA8("224", "s8.s8", MFHE_REGS7, "%112", "%113", "%114", MFHE_OUTS7);
}

}  // namespace mfhe

#undef MFHE_WGMMA8
#undef MFHE_REGS1
#undef MFHE_OUTS1
#undef MFHE_REGS2
#undef MFHE_OUTS2
#undef MFHE_REGS3
#undef MFHE_OUTS3
#undef MFHE_REGS4
#undef MFHE_OUTS4
#undef MFHE_REGS5
#undef MFHE_OUTS5
#undef MFHE_REGS6
#undef MFHE_OUTS6
#undef MFHE_REGS7
#undef MFHE_OUTS7
