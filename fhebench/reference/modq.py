"""Exact arithmetic mod word-size primes, on int64 tensors of any device.

The benchmark's own plain reference: it imports torch, numpy and the
standard library only, never the program under test.  Residues are
canonical int64 values in [0, q) with q < 2^57.

  * mul_mod: a * b mod q by Horner steps over digits of b, every
    intermediate below 2^63;
  * modmatmul: A @ B mod q as float64 matmuls of 19-bit digits (each
    product below 2^38, each sum of up to 2^15 of them exact in float64),
    folded mod q with mul_mod;
  * the scheme's two root conventions, written from their definitions in
    the upstream (Matrix-FHE-GPU src/HE.cu h_find_eta, ntt_core.cu
    find_psi4n): they fix where the W-CRT evaluates and which i the GL
    ring's X^n equals, so the reference reads ciphertexts in the layout
    the scheme defines.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

I64 = torch.int64
F64 = torch.float64
DIGIT = 19
MAX_K = 1 << (53 - 2 * DIGIT)    # terms a float64 digit sum holds exactly


def bits_of(moduli: Sequence[int]) -> int:
    return max(int(q).bit_length() for q in moduli)


def col(moduli: Sequence[int], ndim: int, device) -> torch.Tensor:
    """The moduli as an int64 column [L, 1, ...] of `ndim` dimensions."""
    t = torch.tensor([int(q) for q in moduli], dtype=I64, device=device)
    return t.reshape((-1,) + (1,) * (ndim - 1))


def mul_mod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
            bits: int) -> torch.Tensor:
    """a * b mod q for a, b in [0, q), q < 2^bits <= 2^57."""
    step = 62 - bits
    mask = (1 << step) - 1
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape, q.shape),
                      dtype=I64, device=a.device)
    for i in reversed(range(-(-bits // step))):
        acc = (acc * (1 << step) + a * ((b >> (i * step)) & mask)) % q
    return acc


def modmatmul(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
              bits: int) -> torch.Tensor:
    """(a @ b) mod q, batched as torch.matmul; a, b canonical, q broadcast
    over the product."""
    if a.shape[-1] > MAX_K:
        raise ValueError(f"contraction {a.shape[-1]} > {MAX_K}")
    nd = -(-bits // DIGIT)
    mask = (1 << DIGIT) - 1
    ad = [((a >> (DIGIT * i)) & mask).to(F64) for i in range(nd)]
    bd = [((b >> (DIGIT * i)) & mask).to(F64) for i in range(nd)]
    out = None
    for k in range(2 * nd - 1):
        s = None
        for i in range(max(0, k - nd + 1), min(k, nd - 1) + 1):
            p = torch.matmul(ad[i], bd[k - i]).to(I64)
            s = p if s is None else s + p
        scale = torch.tensor([pow(2, DIGIT * k, int(v))
                              for v in q.flatten().tolist()],
                             dtype=I64, device=q.device).reshape(q.shape)
        term = mul_mod(s % q, scale, q, bits)
        out = term if out is None else (out + term) % q
    return out


def centered(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.where(x > q // 2, x - q, x)


# ---------------------------------------------------------------------------
# The scheme's conventions (host, exact Python ints)
# ---------------------------------------------------------------------------

def p_factors(p: int):
    for f in range(3, p):
        if p % f == 0:
            return f, p // f
    raise ValueError(f"{p} has no odd factor pair")


def w_exponents(p: int) -> List[int]:
    """Evaluation exponents of the W-CRT: (a f2 + b f1) mod p, a outer in
    1..f1-1, b inner in 1..f2-1 (upstream batched_encoder.cu:277-282)."""
    f1, f2 = p_factors(p)
    return [(a * f2 + b * f1) % p for a in range(1, f1) for b in range(1, f2)]


def find_eta(q: int, p: int) -> int:
    """Order-p root: the first g = 2, 3, ... whose g^((q-1)/p) has order
    exactly p (upstream HE.cu h_find_eta)."""
    f1, f2 = p_factors(p)
    e = (q - 1) // p
    for g in range(2, q):
        eta = pow(g, e, q)
        if (eta != 1 and pow(eta, p, q) == 1 and pow(eta, p // f1, q) != 1
                and pow(eta, p // f2, q) != 1):
            return eta
    raise ValueError(f"no order-{p} root mod {q}")


def find_psi4n(q: int, n: int) -> int:
    """Order-4n root: the first g^((q-1)/4n), g = 2, 3, ..., whose 2n-th
    power is -1 (upstream ntt_core.cu find_psi4n)."""
    for g in range(2, 100001):
        psi = pow(g, (q - 1) // (4 * n), q)
        if pow(psi, 2 * n, q) == q - 1:
            return psi
    raise ValueError(f"no order-{4 * n} root mod {q}")


def cyclotomic(p: int) -> List[int]:
    """Coefficients (low first) of Phi_p for p = f1 f2, two odd primes:
    (X^p - 1)(X - 1) / ((X^f1 - 1)(X^f2 - 1))."""
    f1, f2 = p_factors(p)
    num = [0] * (p + 2)
    num[0], num[1], num[p], num[p + 1] = 1, -1, -1, 1      # (X^p-1)(X-1)
    den = [0] * (f1 + f2 + 1)
    den[0], den[f1], den[f2], den[f1 + f2] = 1, -1, -1, 1  # (X^f1-1)(X^f2-1)
    quo = [0] * (len(num) - len(den) + 1)
    for k in range(len(quo) - 1, -1, -1):
        c = num[k + len(den) - 1]
        quo[k] = c
        if c:
            for j, d in enumerate(den):
                num[k + j] -= c * d
    if any(num):
        raise ArithmeticError("Phi_p division left a remainder")
    return quo


def w_tables(q: int, p: int):
    """(V, V^-1) of the W-CRT mod q as int64 numpy [phi, phi]:
    V[w, r] = eta^(exp[w] r), and V^-1 by Lagrange interpolation over the
    roots of Phi_p, V^-1[r, w] = coeff_r(Phi / (X - x_w)) / Phi'(x_w)."""
    eta = find_eta(q, p)
    exps = np.array(w_exponents(p), dtype=np.int64)
    phi = len(exps)
    pw = [1] * p
    for k in range(1, p):
        pw[k] = pw[k - 1] * eta % q
    pw = np.array(pw, dtype=np.int64)
    v = pw[(exps[:, None] * np.arange(phi)[None, :]) % p]
    x = np.array([int(pw[e]) for e in exps], dtype=object)
    m = [c % q for c in cyclotomic(p)]
    quo = np.empty((phi, phi), dtype=object)        # [r, w]
    quo[phi - 1] = m[phi]
    for k in range(phi - 1, 0, -1):
        quo[k - 1] = (m[k] + x * quo[k]) % q
    dm = np.zeros(phi, dtype=object)                # Phi'(x_w)
    for k in range(phi, 0, -1):
        dm = (dm * x + k * m[k]) % q
    inv_dm = np.array([pow(int(d), q - 2, q) for d in dm], dtype=object)
    vinv = (quo * inv_dm[None, :]) % q
    return v, vinv.astype(np.int64)


def x_tables(q: int, n: int, ring: str):
    """(F, F^-1), int64 numpy [n, n], of the X transform that turns the
    product mod X^n - beta^n into a pointwise one: F[k, x] = beta^x w^(kx),
    F^-1[x, k] = n^-1 beta^-x w^(-kx), w = psi^4 of order n, beta = psi^2
    for the negacyclic ring (X^n = -1) and psi for the GL ring
    (X^n = psi^n, a primitive 4th root of unity)."""
    psi = find_psi4n(q, n)
    beta = {"nega": psi * psi % q, "gl": psi}[ring]
    w = pow(psi, 4, q)
    bi, wi, ni = pow(beta, q - 2, q), pow(w, q - 2, q), pow(n, q - 2, q)
    f = np.empty((n, n), dtype=np.int64)
    finv = np.empty((n, n), dtype=np.int64)
    for k in range(n):
        for x in range(n):
            f[k, x] = pow(beta, x, q) * pow(w, k * x, q) % q
            finv[x, k] = ni * pow(bi, x, q) * pow(wi, k * x, q) % q
    return f, finv
