// Exact 64-bit modular arithmetic shared by the Hopper kernels.
//
// Residues are canonical int64 values below q < 2^56, read as uint64.  The
// digit-plane GEMMs reduce each output's folded plane sums S < q 2^64 by
// one Montgomery REDC with R = 2^64 (their operands carry the factor 2^64);
// Montgomery products and Shoup products by a constant serve the twiddles,
// the pointwise product of K2 and the pre-reductions of K6 and K7.
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

// x w mod q by Shoup's method, wp = floor(w 2^64 / q), w < q < 2^56.
__device__ __forceinline__ uint64_t shoup_mul(uint64_t x, uint64_t w, uint64_t wp,
                                              uint64_t q) {
  const uint64_t r = x * w - __umul64hi(x, wp) * q;   // in [0, 2 q)
  return r >= q ? r - q : r;
}

}  // namespace mfhe
