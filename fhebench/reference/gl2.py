"""The plain reference of the ciphertext-out trace GEMM C = Y^H X on the
gl2 double ring.

The GL ring Z[i][X]/(X^n - i) is carried as D = Z[X]/(X^{2n} + 1), i = X^n:
a complex X-coefficient a + b i sits in the integer slots j (a) and n + j
(b).  A plaintext is the stored layout [L, W, y, x] (W-eval, X-coeff,
y < n, x < 2n) of the packing ring

    Z_Q[W]/Phi_p  (x)  Z[Y, X]/(Y^n - X^n, X^{2n} + 1).

Written from the scheme's derivation (the JAX package's
models/he_matmul2.py docstring), on exact int64 residues:

  * decryption b + a s, with s the ternary secret [W, 2n] (W-coeff,
    X-coeff): a negacyclic product on the 2n-point X axis, here as a
    Toeplitz matrix through modq.modmatmul.  modq.x_tables does not serve:
    it seeks a primitive 4 (2n)-th root, and for most of ref's limbs (and
    P's 549757491457) 2^8 is the largest power of two dividing q - 1;
  * sigma, full complex conjugation, the automorphism (W, Y, X) ->
    (W^-1, Y^-1, X^-1): the lane of exponent e takes the lane of -e, and
    the monomial Y^y X^x goes to Y^-y X^-x, reduced by Y^-n = X^-n and
    X^{2n} = -1;
  * the owed plaintext of the GEMM from the decryptions m_x, m_y of its
    inputs: T[x1, x2] = n sum_y RY(sigma(m_y))[y, x1] TW(m_x)[y, x2] a
    (limb, lane), RY the Y reversal y -> -y mod n and TW the X^n twist of
    the rows y >= 1 (the pairs y1 + y2 = n meet Y^n = X^n), then rho, the
    ring map X1 -> Y of the 2D tensor ring D (x) D, which folds row n + y
    onto row y times X^n (Y^{n+y} = Y^y X^n);
  * the exact compose of W-coefficients across every limb to float64
    (Garner's mixed radix in balanced digits, as leveled.composed_max_abs),
    and the decode of the gl2 packing: slots j and n + j as the real and
    imaginary planes of scheme.Codec.

It imports torch, numpy and the standard library only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import modq
from .scheme import Codec, Ring

I64 = torch.int64


def shift_xn(z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """z X^n along the last axis (2n points, X^{2n} = -1)."""
    n = z.shape[-1] // 2
    return torch.cat([(q - z[..., n:]) % q, z[..., :n]], dim=-1)


def sigma_targets(n: int):
    """Where sigma sends each monomial Y^y X^x of a [n, 2n] frame:
    (row, column, negated), each [n, 2n]."""
    m = 2 * n
    y = torch.arange(n)[:, None].expand(n, m)
    x = torch.arange(m)[None, :].expand(n, m)
    e = -x - n * (y >= 1).to(I64)          # X's exponent after Y^-n = X^-n
    wraps = torch.div(e, m, rounding_mode="floor")
    return (-y) % n, e - m * wraps, wraps % 2 != 0


class Gl2Ring:
    """The gl2 ring's plain operations over one RNS basis, on one device."""

    def __init__(self, moduli: Sequence[int], n: int, p: int, device):
        self.ring = Ring(moduli, n, p, "nega", device)      # its W-CRT
        self.moduli, self.bits = self.ring.moduli, self.ring.bits
        self.n, self.m = n, 2 * n
        self.device = self.ring.device
        exps = modq.w_exponents(p)
        lane = {e: w for w, e in enumerate(exps)}
        self.flip = torch.tensor([lane[-e % p] for e in exps],
                                 device=self.device)
        self.sig = tuple(t.to(self.device) for t in sigma_targets(n))

    def q(self, ndim: int) -> torch.Tensor:
        return self.ring.q(ndim)

    # -- the secret and decryption -------------------------------------------

    def secret(self, s_signed: torch.Tensor) -> torch.Tensor:
        """A ternary secret [W, 2n] -> its negacyclic product matrices
        [L, W, 2n, 2n] in W-eval: row j is X^j s."""
        s = self.ring.w_forward(self.ring.residues(s_signed))   # [L, W, m]
        m = self.m
        j = torch.arange(m, device=self.device)[:, None]
        k = torch.arange(m, device=self.device)[None, :]
        t = s[..., (k - j) % m]
        q = self.q(t.dim())
        return torch.where(k < j, (q - t) % q, t)

    def x_product(self, a: torch.Tensor, s_mat: torch.Tensor) -> torch.Tensor:
        """a s on every row of a [L, W, y, 2n], s as secret() makes it."""
        return modq.modmatmul(a, s_mat, self.q(a.dim()), self.bits)

    def decrypt(self, b: torch.Tensor, a: torch.Tensor,
                s_mat: torch.Tensor) -> torch.Tensor:
        """b + a s, stored layout [L, W, y, 2n]."""
        return (b + self.x_product(a, s_mat)) % self.q(b.dim())

    # -- the GEMM's owed plaintext -------------------------------------------

    def sigma(self, z: torch.Tensor) -> torch.Tensor:
        """Full conjugation of [L, W, n, 2n]: the lane flip and the
        monomial map with its signs."""
        q = self.q(z.dim())
        z = z.index_select(1, self.flip)
        rows, cols, neg = self.sig
        out = torch.empty_like(z)
        out[:, :, rows, cols] = torch.where(neg, (q - z) % q, z)
        return out

    def owed(self, m_x: torch.Tensor, m_y: torch.Tensor) -> torch.Tensor:
        """rho(n sum_y RY(sigma(m_y))[y] (x) TW(m_x)[y]): what a ciphertext
        of Y^H X decrypts to, less the key switch's noise, [L, W, n, 2n]."""
        n = self.n
        q = self.q(m_x.dim())
        u = self.sigma(m_y)
        u = u.index_select(2, (-torch.arange(n, device=u.device)) % n)
        v = torch.cat([m_x[:, :, :1], shift_xn(m_x[:, :, 1:], q)], dim=2)
        t = modq.modmatmul(u.transpose(-1, -2).contiguous(), v, q, self.bits)
        t = modq.mul_mod(t, n % q, q, self.bits)
        return (t[:, :, :n] + shift_xn(t[:, :, n:], q)) % q

    # -- compose and decode --------------------------------------------------

    def composed(self, x_eval: torch.Tensor) -> torch.Tensor:
        """The W-coefficients of x [L, W, y, 2n], each composed exactly
        from every limb to its centered integer mod Q, in float64."""
        c = self.ring.w_inverse(x_eval)
        digits, radices = [], []        # balanced mixed-radix digits d_k, R_k
        radix = 1
        for k, qk in enumerate(self.moduli):
            q = torch.tensor(qk)
            acc = torch.zeros_like(c[k])        # sum_{i<k} d_i R_i mod q_k
            for d, r in zip(digits, radices):
                acc = (acc + modq.mul_mod(d % qk, torch.tensor(r % qk), q,
                                          self.bits)) % qk
            t = modq.mul_mod((c[k] - acc) % qk,
                             torch.tensor(pow(radix % qk, -1, qk)), q,
                             self.bits)
            digits.append(modq.centered(t, q))
            radices.append(radix)
            radix *= qk
        return sum(d.to(torch.float64) * float(r)
                   for d, r in zip(digits, radices))

    def decode(self, x_eval: torch.Tensor, codec: Codec) -> torch.Tensor:
        """The complex [W, y, n] matrices of a gl2 plaintext at the codec's
        scale."""
        f = self.composed(x_eval)
        return torch.complex(*codec.decode(f[..., :self.n], f[..., self.n:]))
