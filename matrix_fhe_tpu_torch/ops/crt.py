"""Exact RNS -> Z CRT reconstruction with center-lift.

Counterpart of matrix_fhe_tpu/ops/crt.py (CRTComposer) on int64 tensors.
Big integers are lists of 32-bit digits, one int64 tensor each, so that

    acc = sum_l M_l * ((x_l * inv_l) mod q_l)   (mod Q, reduced per step)
    centered = acc > Q/2 ? -(Q - acc) : acc

runs element-wise over any coefficient shape with no limit on |x| (the
fused compose of ops/ddfloat.py needs |x| < 2^63; Delta^2-scaled products
exceed that at ref scale).  The JAX digits live in uint64 lanes; torch has
only signed int64, so a digit product (< 2^64) wraps and its high word is
taken with a logical shift (modmath.shr_logical).  Every other
intermediate is below 2^35.

On a CUDA tensor compose_to_float is one launch of csrc/crt_compose.cu
(launch key crt_compose), the same arithmetic on 64-bit words in
registers; on a CPU tensor it runs the digit code below, its plain twin.
The other composes run the digit code on either device.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, List, Sequence, Tuple

import numpy as np
import torch

from . import _backend as be
from .modmath import mul_mod, shr_logical
from .rns_ext import _shoup

if TYPE_CHECKING:
    from ..tables import GLTables

M32 = 0xFFFFFFFF
I64 = torch.int64
F64 = torch.float64
I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
MAX_WORDS = 8       # 64-bit words of Q the kernel holds in registers
MAX_LIMBS = 64      # limbs whose constants fit the kernel's shared memory


def _digits32(words: np.ndarray) -> List[int]:
    """uint64 words (least significant first) -> 32-bit digits as ints."""
    out = []
    for w in np.asarray(words, dtype=np.uint64).tolist():
        out += [w & M32, w >> 32]
    return out


class CRTComposer:
    """Exact CRT compose / center-lift for one parameter set.  Its
    constants are Python ints, so one composer serves every device."""

    def __init__(self, tables: "GLTables"):
        p = tables.params
        self.moduli = tuple(int(q) for q in p.moduli)
        self.n_digits = 2 * tables.crt_limbs64
        self.m_digits = [_digits32(row) for row in tables.crt_m]
        self.q_digits = _digits32(tables.crt_q_big)
        self.q_half_digits = _digits32(tables.crt_q_half)
        self.inv = [int(v) for v in tables.crt_inv]
        self.q_big = math.prod(self.moduli)
        # the kernel's constants, uint64 words: per limb q, inv and its
        # Shoup companion, M_l's words; then Q's and floor(Q/2)'s words
        rows = [[q, w, _shoup(w, q)] + [int(v) for v in m]
                for q, w, m in zip(self.moduli, self.inv, tables.crt_m)]
        rows.append([int(v) for v in tables.crt_q_big]
                    + [int(v) for v in tables.crt_q_half])
        self._table = torch.from_numpy(np.array(
            [v for row in rows for v in row], dtype=np.uint64).view(np.int64))
        self._device_tables = {}

    # -- digit-vector helpers (digits < 2^32 in int64 tensors) --------------------

    @staticmethod
    def _normalize(cols: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        carry = None
        for c in cols:
            if carry is not None:
                c = c + carry
            out.append(c & M32)
            carry = c >> 32
        return out

    @staticmethod
    def _ge(a: List[torch.Tensor], b: List[int]) -> torch.Tensor:
        """Lexicographic a >= b (b constant digits); the most significant
        digit decides last."""
        ge = torch.ones_like(a[0], dtype=torch.bool)
        for ai, bi in zip(a, b):
            ge = torch.where(ai == bi, ge, ai > bi)
        return ge

    @staticmethod
    def _gt(a: List[torch.Tensor], b: List[int]) -> torch.Tensor:
        gt = torch.zeros_like(a[0], dtype=torch.bool)
        for ai, bi in zip(a, b):
            gt = torch.where(ai == bi, gt, ai > bi)
        return gt

    @staticmethod
    def _sub(a: List[torch.Tensor], b: List[int], mask) -> List[torch.Tensor]:
        """a - b where mask, digitwise with borrow."""
        out = []
        borrow = torch.zeros_like(a[0])
        for ai, bd in zip(a, b):
            bi = torch.where(mask, bd, 0) + borrow
            under = ai < bi
            out.append(torch.where(under, ai + (1 << 32) - bi, ai - bi))
            borrow = under.to(I64)
        return out

    @staticmethod
    def _rsub(b: List[int], a: List[torch.Tensor]) -> List[torch.Tensor]:
        """b - a for constant digits b >= a."""
        out = []
        borrow = torch.zeros_like(a[0])
        for bd, ad in zip(b, a):
            ai = ad + borrow
            under = ai > bd
            out.append(torch.where(under, bd + (1 << 32) - ai, bd - ai))
            borrow = under.to(I64)
        return out

    # -- composes ------------------------------------------------------------------

    def compose_magnitude(self, x_rns: torch.Tensor
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x_rns [L, ...] residues -> (digits of |centered value|, neg);
        neg marks acc > Q/2 (strict, encoder.cu:219-225)."""
        D = self.n_digits
        shape, dev = x_rns.shape[1:], x_rns.device
        acc = [torch.zeros(shape, dtype=I64, device=dev) for _ in range(D)]
        for l, q in enumerate(self.moduli):
            t = mul_mod(x_rns[l], torch.tensor(self.inv[l], device=dev),
                        torch.tensor(q, device=dev))
            t0 = t & M32
            t1 = t >> 32
            cols = [torch.zeros(shape, dtype=I64, device=dev)
                    for _ in range(D + 2)]
            for d in range(D):
                md = self.m_digits[l][d]
                p0 = md * t0                                # wraps mod 2^64
                p1 = md * t1
                cols[d] = cols[d] + (p0 & M32)
                cols[d + 1] = cols[d + 1] + shr_logical(p0, 32) + (p1 & M32)
                cols[d + 2] = cols[d + 2] + shr_logical(p1, 32)
            term = self._normalize(cols)[:D]      # M_l * t < Q fits in D digits
            # acc += term, then a conditional -Q (encoder.cu:130-134)
            acc = self._normalize([a + b for a, b in zip(acc, term)])
            acc = self._sub(acc, self.q_digits, self._ge(acc, self.q_digits))
        neg = self._gt(acc, self.q_half_digits)
        qa = self._rsub(self.q_digits, acc)
        return [torch.where(neg, r, a) for r, a in zip(qa, acc)], neg

    def compose_to_float(self, x_rns: torch.Tensor, delta: float) -> torch.Tensor:
        """Centered value / delta as float64, folded from the most
        significant 64-bit word down (HE.cu:1007-1027)."""
        if be.on_device(x_rns):
            return self.compose_to_float_kernel(x_rns.contiguous(), delta)
        return self.compose_to_float_plain(x_rns, delta)

    def compose_to_float_kernel(self, x_rns: torch.Tensor, delta: float
                                ) -> torch.Tensor:
        """One launch of csrc/crt_compose.cu on x_rns [L, ...]."""
        L, words = len(self.moduli), self.n_digits // 2
        if not 1 <= L <= MAX_LIMBS:
            raise ValueError(f"crt_compose takes 1 to {MAX_LIMBS} limbs, "
                             f"not {L}")
        if not 1 <= words <= MAX_WORDS:
            raise ValueError(f"crt_compose takes Q of 1 to {MAX_WORDS} "
                             f"64-bit words, not {words}")
        if 2 * self.q_big >= 1 << (64 * words):
            raise ValueError("crt_compose needs 2 Q to fit Q's words")
        rest = tuple(x_rns.shape[1:])
        be.check(x_rns, "x_rns", I64, (L,) + rest)
        dev = x_rns.device
        if dev not in self._device_tables:
            self._device_tables[dev] = self._table.to(dev)
        out = torch.empty(rest, dtype=F64, device=dev)
        be.launch("crt_compose", "mf_crt_compose", dev, x_rns, out,
                  self._device_tables[dev], L, words, math.prod(rest),
                  float(delta))
        return out

    def compose_to_float_plain(self, x_rns: torch.Tensor, delta: float
                               ) -> torch.Tensor:
        """compose_to_float's digit code (the kernel's plain twin)."""
        mag, neg = self.compose_magnitude(x_rns)
        v = torch.zeros(x_rns.shape[1:], dtype=F64, device=x_rns.device)
        for i in range(self.n_digits // 2 - 1, -1, -1):
            # the u64 word rounded once to f64, as a uint64 -> f64 convert
            word = mag[2 * i + 1].to(F64) * 2.0 ** 32 + mag[2 * i].to(F64)
            v = v * 2.0 ** 64 + word
        return torch.where(neg, -v, v) / float(delta)

    def _low_word_saturated(self, mag, neg) -> torch.Tensor:
        """The signed low word, saturated when |value| >= 2^63
        (he_big_to_i64_checked, HE.cu:904-915)."""
        low = mag[0] | (mag[1] << 32)
        over = low < 0                       # low word >= 2^63
        for d in mag[2:]:
            over = over | (d != 0)
        v = torch.where(neg, -low, low)
        sat = torch.where(neg, torch.full_like(v, I64_MIN),
                          torch.full_like(v, I64_MAX))
        return torch.where(over, sat, v)

    def compose_centered_i64(self, x_rns: torch.Tensor) -> torch.Tensor:
        """Centered value as int64, saturated where it does not fit."""
        return self._low_word_saturated(*self.compose_magnitude(x_rns))

    def compose_round_div_delta_i64(self, x_rns: torch.Tensor, delta: float
                                    ) -> torch.Tensor:
        """Exact nearest-integer |v| / Delta with sign, Delta a power of two
        (round_big_centered_by_delta_kernel, HE.cu:964-1005)."""
        shift = int(delta).bit_length() - 1
        if float(1 << shift) != delta:
            raise ValueError("delta must be a power of two")
        mag, neg = self.compose_magnitude(x_rns)
        if shift > 0:
            cols = list(mag)
            add_digit = (shift - 1) // 32
            cols[add_digit] = cols[add_digit] + (1 << ((shift - 1) % 32))
            cols = self._normalize(cols)
            digit_sh, bit_sh = shift // 32, shift % 32
            zero = torch.zeros_like(cols[0])
            mag = []
            for i in range(self.n_digits):
                lo = cols[i + digit_sh] if i + digit_sh < self.n_digits else zero
                hi = (cols[i + digit_sh + 1]
                      if i + digit_sh + 1 < self.n_digits else zero)
                mag.append(lo if bit_sh == 0 else
                           ((lo >> bit_sh) | (hi << (32 - bit_sh))) & M32)
        return self._low_word_saturated(mag, neg)


def centered_i64_to_rns(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Centered int64 [...] -> residues [L, ...]
    (centered_int_to_rns_matrix_kernel, HE.cu:815-835)."""
    return torch.stack([torch.remainder(x, int(q)) for q in moduli])
