"""RNS-hybrid key switching: the part the gl2 ciphertext GEMM needs.

Counterpart of matrix_fhe_tpu/models/keyswitch.py (the P basis choice,
RelinContext's constructor, _lift_ternary and _mod_down):

  * gadget = CRT idempotent decomposition over consecutive limb groups G_i
    with prod(G_i) < P: digits are plain limb subsets D_i = [x]_{Q_i},
    extended to the full QP basis by the exact base conversion
    (ops/rns_ext.py);
  * g_i = P * (Q/Q_i) * ((Q/Q_i)^-1 mod Q_i) mod QP per digit;
  * ModDown: round(y / P) mod Q by the same base conversion and P^-1 mod q.

The switch keys themselves and the switch over the gl2 GEMM tensor are in
models/he_matmul2.py (Gl2GemmRelin).  Integer constants are kept as the
JAX package keeps them (numpy uint64 for g_i) so that both can be compared.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import GLParams, generate_ntt_primes
from ..ops import modmath as mm
from ..ops.ntt import XNTT
from ..ops.rns_ext import BasisExtender
from ..ops.wcrt import WTransform
from ..tables import build_tables


def _greedy_groups(q_moduli: Sequence[int], big_p: int
                   ) -> List[Tuple[int, ...]]:
    """Consecutive limb groups with product < P (the gadget digit bound)."""
    groups: List[Tuple[int, ...]] = []
    cur: List[int] = []
    prod = 1
    for l, q in enumerate(q_moduli):
        if cur and prod * q >= big_p:
            groups.append(tuple(cur))
            cur, prod = [], 1
        cur.append(l)
        prod *= q
    groups.append(tuple(cur))
    return groups


def _grid(bits: int) -> int:
    """Relative MXU MAC weight of one limb in the TPU stage kernels: the
    int8 digit grid is ceil(bits/7) digits a side."""
    d = -(-bits // 7)
    return d * d


def _default_p_moduli(params: GLParams) -> Tuple[int, ...]:
    """The key-switch extension basis P, chosen exactly as the JAX package
    chooses it (copied verbatim so that both packages use the same P).

    The cost model is the TPU's: dnum x (W-CRT + X-NTT over QP) with each
    limb weighted by its int8 digit grid ceil(bits/7)^2.  On the H100 the
    64-bit kernels cost the same at every width below 2^56, so this is not
    the best basis for the card; it is kept for parity and not re-ranked
    here.  Presets with explicit p_moduli keep them."""
    if params.p_moduli:
        return tuple(int(q) for q in params.p_moduli)
    qs = [int(q) for q in params.moduli]
    q_bits = [q.bit_length() for q in qs]
    q_cost = sum(_grid(b) for b in q_bits)
    widths = sorted({w for w in
                     (28, 35, 42, max(q_bits) - 1, *q_bits) if w >= 21})
    best = None
    for w in widths:
        try:
            cand = generate_ntt_primes(len(qs) + 6, w, params.n, params.p,
                                       below=True)
        except ValueError:
            continue
        pool = [q for q in cand if q not in qs]
        for k in range(2, min(len(pool), len(qs) + 3) + 1):
            ps = pool[:k]
            big_p = 1
            for q in ps:
                big_p *= q
            groups = _greedy_groups(qs, big_p)
            if any(_prod(qs[l] for l in g) >= big_p for g in groups):
                continue
            cost = len(groups) * (q_cost
                                  + sum(_grid(q.bit_length()) for q in ps))
            key = (cost, k, sum(q.bit_length() for q in ps))
            if best is None or key < best[0]:
                best = (key, tuple(ps))
    if best is None:
        raise ValueError("could not find a valid P basis")
    return best[1]


def _prod(it) -> int:
    out = 1
    for v in it:
        out *= v
    return out


class RelinContext:
    """Key-switch machinery bound to one context of ring "nega" or "gl2"
    (HEContext or Gl2Context), on that context's device."""

    def __init__(self, ctx):
        if ctx.ring not in ("nega", "gl2"):
            # the folded GL ring wraps X-convolutions by i_q, a different
            # integer per modulus, so no integer ring underlies the limbs
            # and ModDown's slop times s is not limb-consistent
            raise ValueError("relinearization requires ring='nega' or 'gl2'")
        self.ctx = ctx
        p = ctx.params
        dev = ctx.device
        self.q_moduli = tuple(int(q) for q in p.moduli)
        self.p_moduli = _default_p_moduli(p)
        self.qp_moduli = self.q_moduli + self.p_moduli
        self.L = len(self.q_moduli)
        self.big_p = _prod(self.p_moduli)
        groups = _greedy_groups(self.q_moduli, self.big_p)
        for g in groups:   # noise guarantee: P exceeds each group product
            gp = _prod(self.q_moduli[l] for l in g)
            if gp >= self.big_p:
                raise ValueError(
                    f"key-switch group product {gp} >= P {self.big_p}")
        self.groups = groups
        self.dnum = len(groups)
        # transforms over QP
        self.ext_params = dataclasses.replace(
            p, name=p.name + "-qp", moduli=self.qp_moduli, p_moduli=())
        ext_tables = build_tables(self.ext_params)
        self.xntt_qp = XNTT(self.ext_params, ring=ctx.ring, tables=ext_tables,
                            device=dev)
        self.wt_qp = WTransform(self.ext_params, ext_tables, device=dev)
        # per-group exact base conversion to the full QP basis
        self._extenders = [
            BasisExtender([self.q_moduli[l] for l in g], self.qp_moduli, dev)
            for g in groups]
        # ModDown: P -> Q conversion and P^-1 mod q
        self._moddown = BasisExtender(self.p_moduli, self.q_moduli, dev)
        self._pinv = mm.moduli_col(
            [pow(self.big_p % q, -1, q) for q in self.q_moduli], 3, dev)
        big_q = _prod(self.q_moduli)
        gs = []
        for g in groups:
            q_i = _prod(self.q_moduli[l] for l in g)
            q_tilde = big_q // q_i
            g_int = self.big_p * q_tilde * pow(q_tilde % q_i, -1, q_i)
            gs.append(np.array([g_int % r for r in self.qp_moduli],
                               dtype=np.uint64))
        self._g_consts = gs
        self._q = mm.moduli_col(self.q_moduli, 3, dev)
        # ciphertext frame [W, y_dim, x_dim]: gl2 doubles the X axis
        self.y_dim = p.n
        self.x_dim = getattr(ctx, "m", p.n)

    def _lift_ternary(self, s_coeff: torch.Tensor) -> torch.Tensor:
        """Ternary secret (per-limb residues [L, W, n], limb-consistent)
        -> X-NTT(W-CRT(s)) over the QP basis [Lqp, W, n]."""
        s0 = s_coeff[0]
        sign = torch.where(s0 == 0, 0, torch.where(s0 == 1, 1, -1))
        q = mm.moduli_col(self.qp_moduli, sign.dim(), sign.device)
        s_qp = torch.where(sign >= 0, sign, q + sign)
        return self.xntt_qp.forward(self.wt_qp.forward(s_qp))

    def _mod_down(self, y_qp: torch.Tensor) -> torch.Tensor:
        """round(y / P) mod Q, exact centered division by the P basis
        ((W-coeff, X-coeff) domain input [Lqp, ...])."""
        c = self._moddown.extend(y_qp[self.L:])
        diff = mm.sub_mod(y_qp[:self.L], c, self._q)
        return mm.mul_mod(diff, self._pinv, self._q)
