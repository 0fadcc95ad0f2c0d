"""The plain reference of two chained encrypted GEMMs on the gl2 double
ring,

    B = Q^H A (level 0, scale Delta^2),  B' = rescale(B) (level 1,
    scale Delta^2 / q_last),  G = B'^H B' (level 1, its square),

the second stage of a randomized SVD (Halko, Martinsson, Tropp 2011,
sec. 5.1): project A on a basis Q, then form the projection's Gram
matrix, whose eigendecomposition gives B's right singular vectors.

Built from the two plain references it reuses, on exact int64 residues:

  * gl2.Gl2Ring at a limb prefix (level 1 is level 0 with the last limb
    dropped, its tables sliced): decryption b + a s, the GEMM a
    ciphertext of Y^H X owes the decryptions of its inputs, the exact
    compose of W-coefficients across every limb, the decode;
  * leveled.rescale's exact division by the last prime with rounding,
    round(y / q) = (y - [y]_q) / q on every W-coefficient.

Departures from the scheme, each on purpose:

  * no key is made or switched: each step is held against what its
    decrypted inputs owe, so every reading is that one step's error
    alone, and a fault shows in the step that makes it;
  * the rescale is applied to the decrypted plaintext dec(B), where the
    scheme divides each component: dec(B') - round(dec(B) / q) is the
    components' rounding, (r_b + r_a s) with |r| <= 1/2, which is what
    rescale_noise reads;
  * the ring products are Toeplitz matrix products (gl2.Gl2Ring), not
    NTTs;
  * the matrices' own product G_true = (Q^H A)^H (Q^H A) is formed in
    complex128 from the messages, not from any ciphertext.

It imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch

from . import leveled
from .gl2 import Gl2Ring
from .scheme import Codec, max_abs


def prefix(ring: Gl2Ring, k: int) -> Gl2Ring:
    """The gl2 ring of the first k limbs of `ring` (its tables sliced)."""
    out = copy.copy(ring)
    out.ring = leveled.prefix(ring.ring, k)
    out.moduli, out.bits = out.ring.moduli, out.ring.bits
    return out


def rescale(ring: Gl2Ring, y_eval: torch.Tensor) -> torch.Tensor:
    """round(y / q_last) over the first L - 1 limbs, W-eval in and out."""
    return leveled.rescale(ring.ring, y_eval)


def noise(ring: Gl2Ring, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |centered W-coefficient| of got - want, composed exactly across
    the ring's limbs: a wrong residue in any limb reads near half of Q."""
    return max_abs(ring.composed((got - want) % ring.q(got.dim())))


def product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Y^H X per lane, [W, n, n] complex."""
    return y.conj().transpose(-1, -2) @ x


class Gl2ChainReference:
    """The readings of chained requests under one secret.

    moduli, n, p, delta: the level-0 parameters; s_signed: the ternary
    secret [W, 2n]; contract: the first GEMM's max |C - Y^H X|, which
    chain_err carries through the second product; dtype: the codec's
    (complex128, or complex64 for a lower-precision control)."""

    def __init__(self, moduli: Sequence[int], n: int, p: int, delta: float,
                 s_signed: torch.Tensor, contract: float,
                 dtype=torch.complex128):
        dev = s_signed.device
        self.ring0 = Gl2Ring(moduli, n, p, dev)
        self.ring1 = prefix(self.ring0, len(self.ring0.moduli) - 1)
        self.s0 = self.ring0.secret(s_signed)
        self.s1 = self.s0[:-1]
        self.n, self.contract = n, contract
        scale1 = delta * delta / self.ring0.moduli[-1]
        self.codec1 = Codec(n, p, scale1, dev, dtype)
        self.codec_g = Codec(n, p, scale1 * scale1, dev, dtype)

    def readings(self, ct_a, ct_q, ct_b, ct_b1, ct_g, m_a: torch.Tensor,
                 m_q: torch.Tensor) -> dict:
        """One request: A = ct_a, Q = ct_q (level 0), B = matmul(A, Q),
        B' = rescale(B), G = matmul(B', B'), each a (b, a) pair of stored
        residues; m_a, m_q the complex messages [W, n, n].

          chain_noise0   dec(B) less the GEMM owed dec(A), dec(Q);
          rescale_noise  dec(B') less round(dec(B) / q_last);
          chain_noise1   dec(G) less the GEMM owed dec(B'), dec(B');
          chain_gap      max |decode(dec(G)) - B'd^H B'd|, B'd the decode
                         of dec(B'), each at its scale;
          chain_err      max |decode(dec(G)) - G_true| over
                         2 n max |B_true| contract, G_true and B_true from
                         the messages in complex128."""
        r0, r1 = self.ring0, self.ring1
        dec_a, dec_q = (r0.decrypt(c.b, c.a, self.s0) for c in (ct_a, ct_q))
        dec_b = r0.decrypt(ct_b.b, ct_b.a, self.s0)
        noise0 = noise(r0, dec_b, r0.owed(dec_a, dec_q))
        del dec_a, dec_q
        dec_b1 = r1.decrypt(ct_b1.b, ct_b1.a, self.s1)
        rescale_noise = noise(r1, dec_b1, rescale(r0, dec_b))
        del dec_b
        dec_g = r1.decrypt(ct_g.b, ct_g.a, self.s1)
        noise1 = noise(r1, dec_g, r1.owed(dec_b1, dec_b1))
        g = r1.decode(dec_g, self.codec_g)
        del dec_g
        b1d = r1.decode(dec_b1, self.codec1)
        gap = max_abs(g - product(b1d, b1d))
        b_true = product(m_a, m_q)
        err = max_abs(g - product(b_true, b_true)) / (
            2 * self.n * max_abs(b_true) * self.contract)
        return {"chain_noise0": noise0, "rescale_noise": rescale_noise,
                "chain_noise1": noise1, "chain_gap": gap, "chain_err": err}
