"""Scheme parameter registry (a copy of matrix_fhe_tpu/config.py, which the
port cannot import without importing jax).

The reference keeps all parameters as compile-time constants
(include/core/config.h:7-52).  Here they form a runtime registry of named,
validated parameter sets so tests can run tiny geometries on CPU while the
flagship preset reproduces the reference exactly.

Reference values mirrored by the "ref" preset (config.h):
  n = MATRIX_N = 64, p = BATCH_PRIME_P = 771 = 3*257, phi(p) = 512,
  L = RNS_NUM_LIMBS = 11 (1x45-bit + 10x35-bit primes, all == 1 mod
  lcm(4n, p) = 197376), Delta = 2^35, and 3 reserved P-primes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Reference constants (include/core/config.h:32-52)
# ---------------------------------------------------------------------------

REF_RNS_MODULI: Tuple[int, ...] = (
    17592186435073,  # 45 bits
    17182765057,     # 35 bits
    17184541441,
    17186120449,
    17186515201,
    17186909953,
    17188883713,
    17190462721,
    17190857473,
    17191844353,
    17192831233,
)

REF_P_MODULI: Tuple[int, ...] = (
    18014398515156481,  # 55 bits — reserved key-switch basis (config.h:48-52)
    549757491457,
    549759662593,
)

REF_PARAMS_NAME = "ref"


def _is_prime(x: int) -> bool:
    """Deterministic Miller-Rabin for 64-bit integers."""
    if x < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if x % sp == 0:
            return x == sp
    d = x - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        y = pow(a, d, x)
        if y in (1, x - 1):
            continue
        for _ in range(r - 1):
            y = y * y % x
            if y == x - 1:
                break
        else:
            return False
    return True


def generate_ntt_primes(count: int, bits: int, n: int, p: int,
                        below: bool = False) -> Tuple[int, ...]:
    """Find `count` distinct primes q == 1 (mod lcm(4n, p)) near 2^bits.

    Mirrors the constraint in config.h:27-31 (Lattigo-style prime search):
    both the 4n-th X-axis root of unity and the order-p W-axis root must
    exist mod q.  `below=True` searches downward so every prime has bit
    length exactly `bits` (generate_primes_1mod).
    """
    m = math.lcm(4 * n, p)
    if below:
        return generate_primes_1mod(count, bits, m)
    primes = []
    q = ((1 << bits) // m) * m + 1
    while len(primes) < count:
        if q.bit_length() > bits + 1:
            raise ValueError("prime search overflow; lower count or raise bits")
        if _is_prime(q):
            primes.append(q)
        q += m
    return tuple(primes)


def generate_primes_1mod(count: int, bits: int, modulus: int) -> Tuple[int, ...]:
    """`count` distinct primes == 1 (mod modulus) of bit length exactly
    `bits`, searched downward from 2^bits (the reference's "35-bit" moduli
    are < 2^35, config.h:27-31); matrix_fhe_tpu/ops/ntt_large.py."""
    primes = []
    q = ((1 << bits) // modulus) * modulus + 1
    while q >= (1 << bits):
        q -= modulus
    floor = 1 << (bits - 1)
    while len(primes) < count and q > floor:
        if _is_prime(q):
            primes.append(q)
        q -= modulus
    if len(primes) < count:
        raise ValueError(
            f"not enough {bits}-bit primes == 1 mod {modulus}")
    return tuple(primes)


@dataclasses.dataclass(frozen=True)
class GLParams:
    """GL Matrix-FHE parameter set.

    Attributes mirror config.h plus derived tables used everywhere:
      n:      matrix dimension / X-axis polynomial degree (MATRIX_N)
      p:      W-axis cyclotomic index, product of two distinct odd primes
      moduli: RNS modulus chain Q = prod(q_i)
      p_moduli: reserved key-switch extension primes (unused by ops; kept for
                parity with config.h:48)
      delta:  CKKS scaling factor (power of two in the reference)
      sigma:  discrete-Gaussian noise stddev (HE.cu:615)
    """

    name: str
    n: int
    p: int
    moduli: Tuple[int, ...]
    delta: float
    p_moduli: Tuple[int, ...] = ()
    sigma: float = 3.2

    def __post_init__(self):
        f1, f2 = self.p_factors
        assert f1 * f2 == self.p and _is_prime(f1) and _is_prime(f2)
        m = math.lcm(4 * self.n, self.p)
        for q in self.moduli:
            if (q - 1) % m != 0:
                raise ValueError(f"modulus {q} != 1 mod lcm(4n,p)={m}")
        if self.n & (self.n - 1):
            raise ValueError("n must be a power of two")

    # -- derived geometry ---------------------------------------------------

    @property
    def p_factors(self) -> Tuple[int, int]:
        """The two prime factors (f1 < f2) of p; ref: 3, 257 (HE.cu:121-122)."""
        for f in range(3, self.p):
            if self.p % f == 0:
                return f, self.p // f
        raise ValueError("p must be composite")

    @property
    def phi(self) -> int:
        """Euler phi(p) = number of W lanes (BATCH_SIZE; config.h:14)."""
        f1, f2 = self.p_factors
        return (f1 - 1) * (f2 - 1)

    @property
    def num_limbs(self) -> int:
        return len(self.moduli)

    @property
    def pack_n(self) -> int:
        """Logical packed degree n*phi (PACK_N; config.h:17)."""
        return self.n * self.phi

    @property
    def q_total(self) -> int:
        return math.prod(self.moduli)

    @functools.cached_property
    def w_exponents(self) -> Tuple[int, ...]:
        """Evaluation-point exponent table exp[w].

        The reference hard-codes k_wntt_exp[512] (HE.cu:72-105) and re-derives
        it as {(a*257 + b*3) mod 771 : a in 1..2 outer, b in 1..256 inner}
        (batched_encoder.cu:277-282).  Generalized to p = f1*f2: exponents
        (a*f2 + b*f1) mod p for a in 1..f1-1 (outer), b in 1..f2-1 (inner) —
        a CRT bijection onto the units of Z_p.
        """
        f1, f2 = self.p_factors
        out = []
        for a in range(1, f1):
            for b in range(1, f2):
                out.append((a * f2 + b * f1) % self.p)
        assert len(out) == self.phi
        return tuple(out)

    @property
    def max_modulus_bits(self) -> int:
        return max(q.bit_length() for q in self.moduli)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, GLParams] = {}


def register_params(params: GLParams) -> GLParams:
    _REGISTRY[params.name] = params
    return params


def get_params(name: str = REF_PARAMS_NAME) -> GLParams:
    if name not in _REGISTRY:
        raise KeyError(f"unknown parameter preset {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_params() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# The reference parameter set (config.h), bit-for-bit.
register_params(
    GLParams(
        name=REF_PARAMS_NAME,
        n=64,
        p=771,
        moduli=REF_RNS_MODULI,
        p_moduli=REF_P_MODULI,
        delta=float(1 << 35),  # SCALING_FACTOR (config.h:25)
    )
)

# Single-limb tiny geometry (Q < 2^63): the centered W-CRT roundtrip oracle
# (test_wcrt_roundtrip.cu) is only exactly invertible when the composed value
# fits int64 — see ops/wcrt.py:forward_centered for the analysis.
register_params(
    GLParams(
        name="tiny1",
        n=8,
        p=15,
        moduli=generate_ntt_primes(1, 30, 8, 15),
        delta=float(1 << 12),
    )
)

# Tiny geometry for fast CPU tests: p=15=3*5 -> phi=8 lanes, n=8.
register_params(
    GLParams(
        name="tiny",
        n=8,
        p=15,
        moduli=generate_ntt_primes(3, 30, 8, 15),
        delta=float(1 << 12),
    )
)

# Small geometry exercising two-prime W structure with more lanes:
# p=51=3*17 -> phi=32 lanes, n=16.
register_params(
    GLParams(
        name="small",
        n=16,
        p=51,
        moduli=generate_ntt_primes(4, 35, 16, 51),
        delta=float(1 << 16),
    )
)

# Mid-size: same W axis as ref (p=771, phi=512) but fewer limbs, for
# single-chip perf experiments without the full 1.48 GB ciphertext.
register_params(
    GLParams(
        name="mid",
        n=64,
        p=771,
        moduli=REF_RNS_MODULI[:4],
        delta=float(1 << 35),
    )
)
