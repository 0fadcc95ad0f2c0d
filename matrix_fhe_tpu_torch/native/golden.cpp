// Native golden-model oracle for matrix_fhe_tpu_torch (the port's own copy
// of the JAX package's matrix_fhe_tpu/native/golden.cpp, same functions):
// an independent scalar C++ implementation of the scheme's numerical
// contracts, used by the tests and chip_smoke.py to cross-check the port's
// transforms and kernels against a second native implementation (the same
// role the host-side re-computations play in the reference's test programs,
// e.g. test_custom_ntt_roundtrip.cu:169-319).
//
// Everything here is written from the math, not ported: schoolbook
// polynomial products with an arbitrary X^n wrap constant, dense modular
// matvecs, the deterministic RNG streams (uniform_random_kernel
// HE.cu:564-578, ternary_secret_kernel HE.cu:690-713), and an exact
// little-endian word bigint CRT compose / center-lift (the contract of
// crt_compose_centerlift_big_kernel, encoder.cu:191-245).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

static inline u64 mulmod(u64 a, u64 b, u64 q) {
    return (u64)((u128)a * b % q);
}

static inline u64 powmod(u64 a, u64 e, u64 q) {
    u64 r = 1;
    a %= q;
    while (e) {
        if (e & 1) r = mulmod(r, a, q);
        a = mulmod(a, a, q);
        e >>= 1;
    }
    return r;
}

extern "C" {

// out[k] = sum_j a[j] b[k-j] with X^n == wrap (mod q); covers negacyclic
// (wrap = q-1) and the GL twist ring (wrap = psi4n^n).
void mf_polymul_wrap(u64 q, u64 wrap, long long n,
                     const u64* a, const u64* b, u64* out) {
    for (long long k = 0; k < n; ++k) out[k] = 0;
    for (long long i = 0; i < n; ++i) {
        if (!a[i]) continue;
        for (long long j = 0; j < n; ++j) {
            u64 p = mulmod(a[i], b[j], q);
            long long k = i + j;
            if (k >= n) {
                k -= n;
                p = mulmod(p, wrap, q);
            }
            out[k] = (out[k] + p) % q;
        }
    }
}

// dense out[w] = sum_r T[w*cols + r] * x[r] (mod q): one W-CRT / X-NTT
// matvec (wntt_forward_matrix_kernel contract, HE.cu:716-747)
void mf_mod_matvec(u64 q, long long rows, long long cols,
                   const u64* table, const u64* x, u64* out) {
    for (long long w = 0; w < rows; ++w) {
        u128 acc = 0;
        for (long long r = 0; r < cols; ++r) {
            acc += (u128)table[w * cols + r] * x[r] % q;
        }
        out[w] = (u64)(acc % q);
    }
}

// reference-exact uniform stream (uniform_random_kernel, HE.cu:564-578):
// LCG of (123456789 + flat ref-layout index), reduced mod q_l
void mf_uniform_a(long long L, long long W, long long n,
                  const u64* moduli, u64* out /* [L][W][n][n] */) {
    for (long long l = 0; l < L; ++l) {
        for (long long w = 0; w < W; ++w) {
            for (long long y = 0; y < n; ++y) {
                for (long long x = 0; x < n; ++x) {
                    u64 idx = ((u64)w * L + l) * (u64)(n * n)
                              + (u64)y * n + x;
                    u64 seed = 123456789ULL + idx;
                    seed = seed * 6364136223846793005ULL
                           + 1442695040888963407ULL;
                    out[((l * W + w) * n + y) * n + x] = seed % moduli[l];
                }
            }
        }
    }
}

// reference-exact ternary secret (ternary_secret_kernel, HE.cu:690-713)
void mf_ternary_secret(long long L, long long W, long long n,
                       const u64* moduli, u64* out /* [L][W][n] */) {
    for (long long l = 0; l < L; ++l) {
        for (long long w = 0; w < W; ++w) {
            for (long long x = 0; x < n; ++x) {
                u64 t = (u64)w * 1315423911ULL + (u64)x * 2654435761ULL;
                u64 r = (t * 11400714819323198485ULL) % 3;
                u64 v = r == 0 ? 0 : (r == 1 ? 1 : moduli[l] - 1);
                out[(l * W + w) * n + x] = v;
            }
        }
    }
}

// reference-exact discrete Gaussian noise (gaussian_noise_kernel,
// HE.cu:581-627): splitmix64 counter hash -> Box-Muller -> llround with
// native libm (independent of XLA's emulated-f64 log/cos/sqrt), the same
// integer mapped into every limb.
static u64 splitmix64(u64 x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

void mf_gaussian_noise(long long L, long long W, long long n, double sigma,
                       const u64* moduli, u64* out /* [L][W][n][n] */) {
    long long per = W * n * n;
    for (long long c = 0; c < per; ++c) {
        u64 seed = 0xD6E8FEB86659FD93ULL ^ (u64)c;
        u64 r1 = splitmix64(seed);
        u64 r2 = splitmix64(r1);
        double inv53 = 1.0 / 9007199254740992.0;  // 2^-53
        double u1 = ((double)(r1 >> 11) + 1.0) * inv53;
        double u2 = ((double)(r2 >> 11) + 1.0) * inv53;
        double mag = sigma * sqrt(-2.0 * log(u1));
        double z = mag * cos(6.283185307179586 * u2);
        long long v = llround(z);
        for (long long l = 0; l < L; ++l) {
            u64 q = moduli[l];
            out[l * per + c] = v >= 0 ? (u64)v : q - (u64)(-v);
        }
    }
}

// exact CRT compose + center-lift of one coefficient:
//   x = sum_l r_l * (Q/q_l) * ((Q/q_l)^-1 mod q_l)  (mod Q), centered to
//   (-Q/2, Q/2]; returns magnitude words (little-endian, `words` of them)
//   and sign.  Contract of crt_compose_centerlift_big_kernel
//   (encoder.cu:191-245) with BIGINT word count = `words`.
// Scratch-free fixed-size word arithmetic, words <= 16.
static void big_add(u64* a, const u64* b, int w) {
    u128 c = 0;
    for (int i = 0; i < w; ++i) {
        c += (u128)a[i] + b[i];
        a[i] = (u64)c;
        c >>= 64;
    }
}
static void big_sub(u64* a, const u64* b, int w) {  // a -= b (a >= b)
    u128 borrow = 0;
    for (int i = 0; i < w; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}
static int big_cmp(const u64* a, const u64* b, int w) {
    for (int i = w - 1; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}
static void big_mul_u64(const u64* a, u64 m, u64* out, int w) {
    u128 c = 0;
    for (int i = 0; i < w; ++i) {
        c += (u128)a[i] * m;
        out[i] = (u64)c;
        c >>= 64;
    }
}
static void big_mod(u64* a, const u64* q, int w) {  // a %= q, a < 2^small*q
    while (big_cmp(a, q, w) >= 0) big_sub(a, q, w);
}

void mf_crt_compose_centered(
    long long L, const u64* residues /* [L] */,
    const u64* m_tables /* [L][words]: Q/q_l */,
    const u64* inv_tables /* [L]: (Q/q_l)^-1 mod q_l */,
    const u64* moduli, const u64* q_big /* [words] */,
    const u64* q_half /* [words] */, long long words,
    u64* mag_out /* [words] */, long long* neg_out) {
    std::vector<u64> acc(words, 0), term(words);
    for (long long l = 0; l < L; ++l) {
        u64 rl = mulmod(residues[l], inv_tables[l], moduli[l]);
        big_mul_u64(m_tables + l * words, rl, term.data(), (int)words);
        big_add(acc.data(), term.data(), (int)words);
        big_mod(acc.data(), q_big, (int)words);
    }
    if (big_cmp(acc.data(), q_half, (int)words) > 0) {
        std::vector<u64> q(q_big, q_big + words);
        big_sub(q.data(), acc.data(), (int)words);
        std::memcpy(mag_out, q.data(), words * sizeof(u64));
        *neg_out = 1;
    } else {
        std::memcpy(mag_out, acc.data(), words * sizeof(u64));
        *neg_out = 0;
    }
}

// full X-axis NTT roundtrip check helper: forward matvec, pointwise square,
// inverse matvec (a convenience for the polymul cross-oracle)
void mf_ntt_polymul(u64 q, long long n, const u64* fwd, const u64* inv,
                    const u64* a, const u64* b, u64* out) {
    std::vector<u64> fa(n), fb(n), prod(n);
    mf_mod_matvec(q, n, n, fwd, a, fa.data());
    mf_mod_matvec(q, n, n, fwd, b, fb.data());
    for (long long i = 0; i < n; ++i) prod[i] = mulmod(fa[i], fb[i], q);
    mf_mod_matvec(q, n, n, inv, prod.data(), out);
}

}  // extern "C"
