"""The plain reference of the scheme: its transforms, decryption and float
codec, rebuilt from the parameter set alone.

  * Ring: the W-CRT (evaluation at the primitive p-th roots, in the
    upstream's order) and the X ring product (negacyclic, or the GL ring's
    X^n = psi^n), per RNS limb, on exact int64 residues; decrypt(b, a, s)
    = b + a s in the stored (W-eval, X-coeff) layout.
  * Codec: the complex encoding of [W, n, n] matrices (the sigma embedding
    V M V^T a lane, the W-DFT across lanes) in complex128, or complex64
    for a lower-precision control.

It imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import modq

I64 = torch.int64


class Ring:
    """Per-limb tables of one RNS basis, on one device."""

    def __init__(self, moduli: Sequence[int], n: int, p: int, ring: str,
                 device):
        self.moduli = tuple(int(q) for q in moduli)
        self.n, self.p, self.ring = n, p, ring
        self.phi = len(modq.w_exponents(p))
        self.bits = modq.bits_of(self.moduli)
        self.device = torch.device(device)
        w = [modq.w_tables(q, p) for q in self.moduli]
        x = [modq.x_tables(q, n, ring) for q in self.moduli]

        def stack(arrs):
            return torch.from_numpy(np.stack(arrs)).to(self.device)

        self.v, self.vinv = stack([t[0] for t in w]), stack([t[1] for t in w])
        self.f_t = stack([t[0].T for t in x])        # x @ F^T is F x
        self.finv_t = stack([t[1].T for t in x])

    def q(self, ndim: int) -> torch.Tensor:
        return modq.col(self.moduli, ndim, self.device)

    # -- W axis (axis 1 of [L, W, ...]) --------------------------------------

    def _w(self, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        L, W = x.shape[0], x.shape[1]
        flat = x.reshape(L, W, -1)
        return modq.modmatmul(table, flat, self.q(3), self.bits).reshape(
            x.shape)

    def w_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._w(self.v, x)

    def w_inverse(self, x: torch.Tensor) -> torch.Tensor:
        return self._w(self.vinv, x)

    # -- X axis (the last axis) ----------------------------------------------

    def _x(self, table_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        L, n = x.shape[0], x.shape[-1]
        flat = x.reshape(L, -1, n)
        return modq.modmatmul(flat, table_t, self.q(3), self.bits).reshape(
            x.shape)

    def x_product(self, u: torch.Tensor, v_hat: torch.Tensor) -> torch.Tensor:
        """u (X-coeff) times a factor already in the X transform's domain,
        v_hat broadcasting over u's rows."""
        uh = self._x(self.f_t, u)
        return self._x(self.finv_t, modq.mul_mod(uh, v_hat,
                                                 self.q(uh.dim()), self.bits))

    def x_hat(self, u: torch.Tensor) -> torch.Tensor:
        return self._x(self.f_t, u)

    # -- keys and decryption -------------------------------------------------

    def residues(self, small: torch.Tensor) -> torch.Tensor:
        """Small signed integers [...] -> canonical residues [L, ...]."""
        q = self.q(small.dim() + 1)
        return torch.remainder(small.to(I64)[None], q)

    def secret_hat(self, s_signed: torch.Tensor) -> torch.Tensor:
        """A ternary secret [W, n] (W-coeff, X-coeff) -> the X transform of
        its W evaluation [L, W, 1, n], ready to multiply rows."""
        return self.x_hat(self.w_forward(self.residues(s_signed)))[:, :, None]

    def decrypt(self, b: torch.Tensor, a: torch.Tensor,
                s_hat: torch.Tensor) -> torch.Tensor:
        """b + a s, stored layout [L, W, y, x]."""
        return (b + self.x_product(a, s_hat)) % self.q(b.dim())

    def centered_wcoeff(self, x_eval: torch.Tensor) -> torch.Tensor:
        """Stored layout -> centered W-coefficients, limb by limb."""
        q = self.q(x_eval.dim())
        return modq.centered(self.w_inverse(x_eval), q)


class Codec:
    """Complex [W, n, n] matrices <-> real W-coefficient planes (re, im)
    scaled by Delta, in `dtype` (complex128, or complex64 for a control)."""

    def __init__(self, n: int, p: int, delta: float, device,
                 dtype=torch.complex128):
        self.n, self.delta, self.dtype = n, float(delta), dtype
        exps = np.array(modq.w_exponents(p), dtype=np.int64)
        phi = len(exps)
        ang = 2 * np.pi * ((exps[:, None] * np.arange(phi)[None, :]) % p) / p
        wdft = np.exp(1j * ang)
        five = np.array([pow(5, j, 4 * n) for j in range(n)], dtype=np.int64)
        ang_v = 2 * np.pi * ((five[:, None] * np.arange(n)[None, :])
                             % (4 * n)) / (4 * n)
        v = np.exp(1j * ang_v)                         # V[j, k] = z_j^k
        dev = torch.device(device)
        self.wdft = torch.from_numpy(wdft).to(dev)
        self.wdft_inv = torch.linalg.inv(self.wdft)
        self.v = torch.from_numpy(v).to(dev)
        self.vinv = self.v.conj().T / n               # the z_j are orthogonal
        for name in ("wdft", "wdft_inv", "v", "vinv"):
            setattr(self, name, getattr(self, name).to(dtype))

    def encode(self, m_re: torch.Tensor, m_im: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[W, n, n] -> Delta-scaled real coefficient planes (unrounded)."""
        m = torch.complex(m_re, m_im).to(self.dtype)
        c = self.vinv @ m @ self.vinv.T
        W = c.shape[0]
        d = (self.wdft_inv @ c.reshape(W, -1)).reshape(c.shape) * self.delta
        return d.real, d.imag

    def decode(self, x_re: torch.Tensor, x_im: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Delta-scaled coefficient planes [W, n, n] -> the matrices."""
        f = torch.complex(x_re, x_im).to(self.dtype) / self.delta
        W = f.shape[0]
        e = (self.wdft @ f.reshape(W, -1)).reshape(f.shape)
        out = self.v @ e @ self.v.T
        return out.real, out.imag


def max_abs(x: torch.Tensor) -> float:
    v = float(x.abs().max()) if x.numel() else 0.0
    return v if math.isfinite(v) else math.inf
