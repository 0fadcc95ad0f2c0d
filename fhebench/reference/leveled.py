"""The plain reference of the leveled chain's depth-2 circuit

    w = tau_j( rescale(m_x m_y) * m_x )

on the decrypted inputs m_x, m_y (stored layout [L, W, y, x], W-eval and
X-coeff, over the chain's L limbs), and the noise reading that compares a
decrypted result with it.

  * the exact ring product of the scheme.Ring;
  * the rescale: the exact division by the last prime q with rounding,
    round(y / q) = (y - [y]_q) / q with [y]_q the centered residue mod q,
    on every W-coefficient, which is exact in the remaining limbs
    (q is a unit there); the last limb is dropped;
  * the product with m_x on the remaining limbs (mod_switch drops m_x's
    last limb, exact for a small integer);
  * the W automorphism tau_j as a lane permutation built from the W-CRT's
    evaluation exponents: out[w] = in[perm[w]], exp[perm[w]] = j exp[w].

rescaled() is the first multiply and the rescale, rotated_product() the
second multiply and the rotation; each step can be held apart by
rotated_product() of the decrypted rescale.

noise() composes the difference exactly across every limb (Garner's mixed
radix in balanced digits, one exact int64 step a limb), so a value past
half a limb is read whole, and a wrong residue in any one limb reads near
half the level's modulus.

It imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from . import modq
from .scheme import Ring


def prefix(ring: Ring, k: int) -> Ring:
    """The ring of the first k limbs of `ring` (its tables sliced)."""
    out = copy.copy(ring)
    out.moduli = ring.moduli[:k]
    out.bits = modq.bits_of(out.moduli)
    for name in ("v", "vinv", "f_t", "finv_t"):
        setattr(out, name, getattr(ring, name)[:k])
    return out


def w_perm(p: int, j: int) -> torch.Tensor:
    """Lane permutation of W -> W^j (j a unit mod p): out[w] = in[perm[w]]
    with exp[perm[w]] = j exp[w] mod p."""
    if math.gcd(j, p) != 1:
        raise ValueError(f"{j} is not a unit mod {p}")
    exps = modq.w_exponents(p)
    lane = {e: w for w, e in enumerate(exps)}
    return torch.tensor([lane[j * e % p] for e in exps], dtype=torch.int64)


def units(p: int) -> list:
    """The units mod p, in increasing order."""
    return [j for j in range(1, p) if math.gcd(j, p) == 1]


def rescale(ring: Ring, y_eval: torch.Tensor) -> torch.Tensor:
    """round(y / q_last) over the first L - 1 limbs, W-eval in and out."""
    y = ring.w_inverse(y_eval)
    L = len(ring.moduli)
    q_last = ring.moduli[-1]
    r = modq.centered(y[-1], torch.tensor(q_last))          # [y]_q, signed
    rest = prefix(ring, L - 1)
    q = rest.q(y.dim())
    inv = torch.tensor([pow(q_last, -1, qi) for qi in rest.moduli],
                       dtype=torch.int64,
                       device=y.device).reshape(q.shape)
    diff = (y[:-1] - r[None]) % q
    return rest.w_forward(modq.mul_mod(diff, inv, q, rest.bits))


def rescaled(ring: Ring, m_x: torch.Tensor, m_y: torch.Tensor
             ) -> torch.Tensor:
    """rescale(m_x m_y): the first step's plaintext at level 1."""
    return rescale(ring, ring.x_product(m_x, ring.x_hat(m_y)))


def rotated_product(ring1: Ring, m_z: torch.Tensor, m_x1: torch.Tensor,
                    j: int) -> torch.Tensor:
    """tau_j(m_z m_x1) at level 1: the second multiply and the rotation."""
    w = ring1.x_product(m_z, ring1.x_hat(m_x1))
    return w.index_select(1, w_perm(ring1.p, j).to(w.device))


def composed_max_abs(ring: Ring, x_eval: torch.Tensor) -> float:
    """max |x| over the W-coefficients of x (stored layout, ring's limbs),
    each composed exactly from every limb to its centered integer mod Q."""
    c = ring.w_inverse(x_eval)
    digits, radices = [], []        # balanced mixed-radix digits d_k, R_k
    radix = 1
    for k, qk in enumerate(ring.moduli):
        q = torch.tensor(qk)
        acc = torch.zeros_like(c[k])            # sum_{i<k} d_i R_i mod q_k
        for d, r in zip(digits, radices):
            acc = (acc + modq.mul_mod(d % qk, torch.tensor(r % qk), q,
                                      ring.bits)) % qk
        t = modq.mul_mod((c[k] - acc) % qk,
                         torch.tensor(pow(radix % qk, -1, qk)), q, ring.bits)
        digits.append(modq.centered(t, q))
        radices.append(radix)
        radix *= qk
    total = sum(d.to(torch.float64) * float(r)
                for d, r in zip(digits, radices))
    v = float(total.abs().max()) if total.numel() else 0.0
    return v if np.isfinite(v) else math.inf


def noise(ring1: Ring, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |centered W-coefficient| of got - want, composed exactly across
    the level's limbs."""
    return composed_max_abs(ring1, (got - want) % ring1.q(got.dim()))
