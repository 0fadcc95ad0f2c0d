"""RNS basis extension (fast base conversion) for key switching.

Counterpart of matrix_fhe_tpu/ops/rns_ext.py on int64 tensors.  Given x's
residues over a source basis Q_s = prod(q_l), it produces the residues of a
bounded representative over any target basis:

    r'_l = x_l * (Q_s/q_l)^-1 mod q_l           (per-limb modular product)
    k    = round(sum_l r'_l / q_l)               (f64 quotient estimate)
    x~   = sum_l r'_l * (Q_s/q_l)  -  k * Q_s    (|x~| <= Q_s)
    out_r = x~ mod r  for each target prime r

The f64 sum runs in limb order with the JAX package's constants 1/q_l, so
that k, and with it the representative, is the JAX package's.  Integer
parts are exact.  The JAX function broadcasts over both limb axes and
leaves it to XLA's fusion that the [Ls, Ld, ...] intermediate never exists;
here the source limbs are a loop, so the largest temporary is [Ld, ...].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.profiler import span
from .modmath import mul_mod, sub_mod

I64 = torch.int64
F64 = torch.float64


class BasisExtender:
    """x mod Q_src (limb-major [Ls, ...]) -> bounded-representative residues
    over dst_moduli ([Ld, ...]), constants on `device`."""

    def __init__(self, src_moduli: Sequence[int], dst_moduli: Sequence[int],
                 device):
        self.src = tuple(int(q) for q in src_moduli)
        self.dst = tuple(int(r) for r in dst_moduli)
        q_src = 1
        for q in self.src:
            q_src *= q
        self.q_src = q_src

        def t(values):
            return torch.tensor(np.array(values, dtype=np.int64), device=device)

        self._q = t(self.src)
        self._inv = t([pow(q_src // q % q, -1, q) for q in self.src])
        self._inv_q_f64 = [1.0 / q for q in self.src]
        self._rd = t(self.dst)
        # (Q/q_l) mod r per (src l, dst r) and Q mod r, plain residues
        self._m_mod_r = t([[(q_src // q) % r for r in self.dst]
                           for q in self.src])
        self._qsrc_mod_r = t([q_src % r for r in self.dst])

    @staticmethod
    def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
        return v.reshape((-1,) + (1,) * (ndim - 1))

    def scaled_residues(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(r'_l planes [Ls, ...], k [...] int64)."""
        with span("rns.scaled_residues"):
            rp = mul_mod(x, self._col(self._inv, x.dim()),
                         self._col(self._q, x.dim()))
            kf = None
            for l, inv_q in enumerate(self._inv_q_f64):
                term = rp[l].to(F64) * inv_q
                kf = term if kf is None else kf + term
            return rp, torch.round(kf).to(I64)

    def extend(self, x: torch.Tensor,
               dst_slice: Tuple[int, int] | None = None) -> torch.Tensor:
        """[Ls, ...] -> [Ld, ...]: residues of the bounded representative;
        dst_slice=(lo, hi) emits only target limbs lo:hi."""
        rp, k = self.scaled_residues(x)
        return self.extend_from(rp, k, dst_slice)

    def extend_from(self, rp: torch.Tensor, k: torch.Tensor,
                    dst_slice: Tuple[int, int] | None = None) -> torch.Tensor:
        """Second half of extend(): (rp, k) from scaled_residues -> target
        limb residues, so that limb-chunked callers compute the source side
        once and extend one chunk of targets at a time."""
        lo, hi = (0, len(self.dst)) if dst_slice is None else dst_slice
        nd = rp.dim()
        rd = self._col(self._rd[lo:hi], nd)                     # [Ld, 1, ...]
        with span("rns.extend_from"):
            acc = None
            for l in range(len(self.src)):
                # r'_l may exceed r: reduce first
                term = mul_mod(rp[l][None] % rd,
                               self._col(self._m_mod_r[l, lo:hi], nd), rd)
                acc = term if acc is None else acc + term   # Ls terms < 2^63
            acc = acc % rd
            kq = mul_mod(k[None] % rd,
                         self._col(self._qsrc_mod_r[lo:hi], nd), rd)
            return sub_mod(acc, kq, rd)
