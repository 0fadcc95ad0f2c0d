// Exact 64-bit modular arithmetic shared by the Hopper kernels.
//
// Residues are canonical int64 values below q < 2^56, read as uint64.  A
// product of two residues is < 2^112, so a lazy 128-bit sum over a
// contraction of K <= 2^16 terms is exact and is reduced once per output:
// the high word modulo q (one 64-bit remainder), then a Montgomery REDC
// with R = 2^64 and one Montgomery multiply by R^2 mod q to undo the 2^-64.
#pragma once

#include <cstdint>

namespace mfhe {

// Per-limb constants as the wrappers pack them: [q, -q^-1 mod 2^64, 2^128 mod q].
struct LimbConsts {
  uint64_t q, qinv_neg, r2;
};

// u8 digits of a residue mod q: ceil(bits(q) / 8), at most 7 below 2^56.
__device__ __forceinline__ int digits_of(uint64_t q) {
  return (71 - __clzll(static_cast<long long>(q))) >> 3;
}

__device__ __forceinline__ LimbConsts load_consts(const int64_t* c, int l) {
  const uint64_t* u = reinterpret_cast<const uint64_t*>(c) + 3 * l;
  return LimbConsts{u[0], u[1], u[2]};
}

// (hi * 2^64 + lo) * 2^-64 mod q, for hi < q (so the value is < q * 2^64).
__device__ __forceinline__ uint64_t mont_redc(uint64_t hi, uint64_t lo,
                                              const LimbConsts& c) {
  uint64_t m = lo * c.qinv_neg;
  uint64_t mq_hi = __umul64hi(m, c.q);
  // lo + (m*q mod 2^64) is 0 mod 2^64 and carries exactly when lo != 0
  uint64_t t = hi + mq_hi + (lo != 0 ? 1ull : 0ull);
  return t >= c.q ? t - c.q : t;
}

// a * b * 2^-64 mod q for a * b < q * 2^64.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b,
                                             const LimbConsts& c) {
  return mont_redc(__umul64hi(a, b), a * b, c);
}

// (hi * 2^64 + lo) mod q for any 128-bit value.
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo,
                                              const LimbConsts& c) {
  uint64_t t = mont_redc(hi % c.q, lo, c);  // value * 2^-64 mod q
  return mont_mul(t, c.r2, c);              // * 2^128 * 2^-64
}

// (hi, lo) += a * b, unsigned 64 x 64 -> 128.
__device__ __forceinline__ void mac_u128(uint64_t& hi, uint64_t& lo,
                                         uint64_t a, uint64_t b) {
  uint64_t plo = a * b;
  uint64_t phi = __umul64hi(a, b);
  lo += plo;
  hi += phi + (lo < plo ? 1ull : 0ull);
}

}  // namespace mfhe
