"""RNS basis extension (fast base conversion) for key switching.

Counterpart of matrix_fhe_tpu/ops/rns_ext.py on int64 tensors.  Given x's
residues over a source basis Q_s = prod(q_l), it produces the residues of a
bounded representative over any target basis:

    r'_l = x_l * (Q_s/q_l)^-1 mod q_l           (per-limb modular product)
    k    = round(sum_l r'_l / q_l)               (f64 quotient estimate)
    x~   = sum_l r'_l * (Q_s/q_l)  -  k * Q_s    (|x~| <= Q_s)
    out_r = x~ mod r  for each target prime r

and, given a dividend y over the targets, the exact division of ModDown
and the rescale in place of x~: (y_r - x~) * Q_s^-1 mod r, which is
round(y / Q_s) mod r when x is y's residue over the source basis.

The f64 sum runs in limb order with the JAX package's constants 1/q_l, so
that k, and with it the representative, is the JAX package's.  Integer
parts are exact.  On a CUDA tensor, extend() is one launch of
csrc/base_conv.cu (launch key base_conv), which reads the source limbs
once and writes every requested target from registers; a caller that
extends one chunk of targets at a time calls it once a chunk, and the
kernel forms r' and k again from the source limbs.  On a CPU tensor
extend() runs the plain version below, in the JAX package's two halves
(scaled_residues, then extend_from), whose source limbs are a loop of
int64 products (the JAX function broadcasts over both limb axes and
leaves it to XLA's fusion that the [Ls, Ld, ...] intermediate never
exists), so that its largest temporary is [Ld, ...].
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.profiler import span
from . import _backend as be
from .modmath import mul_mod, sub_mod

I64 = torch.int64
F64 = torch.float64

MAX_SRC = 8     # source limbs the kernel holds in registers
MAX_DST = 64    # target limbs of one launch (their constants in shared memory)


def _shoup(w: int, q: int) -> int:
    """floor(w 2^64 / q), the companion of a Shoup product by w mod q."""
    return (w << 64) // q


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
        inv = [pow(q_src // q % q, -1, q) for q in self.src]
        self._inv = t(inv)
        self._inv_q_f64 = [1.0 / q for q in self.src]
        self._rd = t(self.dst)
        # (Q/q_l) mod r per (src l, dst r) and Q mod r, plain residues
        m_mod_r = [[(q_src // q) % r for r in self.dst] for q in self.src]
        self._m_mod_r = t(m_mod_r)
        self._qsrc_mod_r = t([q_src % r for r in self.dst])
        # Q^-1 mod r, the exact division's factor (0 where r divides Q)
        div_inv = [pow(q_src % r, -1, r) if math.gcd(q_src, r) == 1 else 0
                   for r in self.dst]
        self._div_inv = t(div_inv)
        self._divisible = tuple(w != 0 for w in div_inv)
        # the kernel's constants, uint64 words: per source limb q, (Q/q)^-1
        # mod q with its Shoup companion, the bits of 1/q; per target r,
        # floor(2^64 / r), -Q mod r and Q^-1 mod r with theirs, then
        # (Q/q_l) mod r with its companion for each source limb
        src_rows = [[q, w, _shoup(w, q),
                     int(np.array([f]).view(np.uint64)[0])]
                    for q, w, f in zip(self.src, inv, self._inv_q_f64)]
        dst_rows = []
        for j, r in enumerate(self.dst):
            row = [r, (1 << 64) // r]
            for w in ((-q_src) % r, div_inv[j]):
                row += [w, _shoup(w, r)]
            for l in range(len(self.src)):
                row += [m_mod_r[l][j], _shoup(m_mod_r[l][j], r)]
            dst_rows.append(row)
        self._src_table, self._dst_table = (
            torch.from_numpy(np.array(rows, dtype=np.uint64).view(np.int64)
                             ).to(device)
            for rows in (src_rows, dst_rows))

    @staticmethod
    def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
        return v.reshape((-1,) + (1,) * (ndim - 1))

    def _slice(self, dst_slice) -> Tuple[int, int]:
        return (0, len(self.dst)) if dst_slice is None else dst_slice

    def extend(self, x: torch.Tensor,
               dst_slice: Tuple[int, int] | None = None,
               dividend: torch.Tensor | None = None) -> torch.Tensor:
        """[Ls, ...] -> [Ld, ...]: residues of the bounded representative;
        dst_slice=(lo, hi) emits only target limbs lo:hi.  With a dividend
        y (target limbs lo:hi, [hi - lo, ...]), (y - x~) * Q_s^-1 mod r in
        place of x~: ModDown's and the rescale's exact division."""
        with span("rns.extend"):
            extra = () if dividend is None else (dividend,)
            if be.on_device(x, self._src_table, *extra):
                return self.kernel(x, dst_slice, dividend)
            return self.plain(x, dst_slice, dividend)

    def kernel(self, x: torch.Tensor,
               dst_slice: Tuple[int, int] | None = None,
               dividend: torch.Tensor | None = None) -> torch.Tensor:
        """One launch of csrc/base_conv.cu on x [Ls, ...]."""
        lo, hi = self._slice(dst_slice)
        ls, ld = len(self.src), hi - lo
        if not 1 <= ls <= MAX_SRC:
            raise ValueError(f"base_conv takes 1 to {MAX_SRC} source limbs, "
                             f"not {ls}")
        if not 0 <= lo < hi <= len(self.dst) or ld > MAX_DST:
            raise ValueError(f"base_conv takes a target slice of 1 to "
                             f"{MAX_DST} of the {len(self.dst)} limbs, not "
                             f"{(lo, hi)}")
        rest = tuple(x.shape[1:])
        be.check(x, "x", I64, (ls,) + rest)
        if dividend is not None:
            self._check_divisible(lo, hi)
            be.check(dividend, "dividend", I64, (ld,) + rest)
        out = torch.empty((ld,) + rest, dtype=I64, device=x.device)
        be.launch("base_conv", "mf_base_conv", x.device, x, dividend, out,
                  self._src_table, self._dst_table[lo:hi], ls, ld,
                  math.prod(rest))
        return out

    def _check_divisible(self, lo: int, hi: int) -> None:
        if not all(self._divisible[lo:hi]):
            raise ValueError("the exact division needs Q_src prime to every "
                             "target limb")

    # -- the plain version (CPU tensors), in the JAX package's two halves ----

    def plain(self, x: torch.Tensor,
              dst_slice: Tuple[int, int] | None = None,
              dividend: torch.Tensor | None = None) -> torch.Tensor:
        rp, k = self.scaled_residues(x)
        c = self.extend_from(rp, k, dst_slice)
        if dividend is None:
            return c
        lo, hi = self._slice(dst_slice)
        self._check_divisible(lo, hi)
        rd = self._col(self._rd[lo:hi], c.dim())
        return mul_mod(sub_mod(dividend, c, rd),
                       self._col(self._div_inv[lo:hi], c.dim()), rd)

    def scaled_residues(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The source half: (r'_l planes [Ls, ...], k [...] int64)."""
        rp = mul_mod(x, self._col(self._inv, x.dim()),
                     self._col(self._q, x.dim()))
        kf = None
        for l, inv_q in enumerate(self._inv_q_f64):
            term = rp[l].to(F64) * inv_q
            kf = term if kf is None else kf + term
        return rp, torch.round(kf).to(I64)

    def extend_from(self, rp: torch.Tensor, k: torch.Tensor,
                    dst_slice: Tuple[int, int] | None = None) -> torch.Tensor:
        """The target half: (rp, k) from scaled_residues -> the bounded
        representative's residues over target limbs lo:hi."""
        lo, hi = self._slice(dst_slice)
        nd = rp.dim()
        rd = self._col(self._rd[lo:hi], nd)                     # [Ld, 1, ...]
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
